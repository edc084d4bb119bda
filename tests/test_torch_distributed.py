"""The port's Trainer on 2 gloo ranks: the counterpart of
`tests/test_distributed.py` (the JAX package's 2-process run, marked slow
there), at tiny widths on the toy data.

One spawn of 2 ranks, joined under a timeout and killed on expiry, trains
`Trainer(cfg, device="cpu")` for 2 steps with FSDP over data 2
(`fsdp_min_size` 1000: some tensors sharded, the rest whole), then
restores the step-2 checkpoint into a Trainer on a tp 2 mesh. This process
holds it against a one-process Trainer on the same global batch (every toy
sample is the same image and prompt, so any rows are the same batch):

  * the ranks' loader shards are disjoint;
  * `metrics.jsonl` and `params.jsonl` are written once, and a TensorBoard
    writer opened, by the lead alone;
  * the step-2 loss and every parameter equal the one-process run's
    (bf16 compute on both sides: the ranks' gradients are summed from
    two halves of the batch, each rounded to bf16 apart, so the losses
    agree to bf16 precision and the parameters to 2 x lr a step, the most
    by which Adam's update can move a parameter whose gradient's sign a
    rounding flips);
  * the checkpoint, gathered to the lead, restores into the tp 2 Trainer
    and into a one-process Trainer with parameters equal to the ranks';
  * `validate` on the FSDP mesh (`plan` on the toy data, one batch): every
    rank validates an unsharded copy of the model, the lead alone logs the
    `val/` metrics; the layouts and metrics equal those of a one-process
    Trainer restored from the ranks' checkpoint.
"""

from __future__ import annotations

import json
import multiprocessing
import queue
import socket
import sys
import traceback
import types

import numpy as np
import pytest
import torch

from plangen_tpu_torch.config import FlowConfig, PlanGenConfig, PlanGenModelConfig, \
    apply_overrides

TINY = PlanGenModelConfig.tiny()
BS = 2  # per data shard
STEPS = 2
SPAWN_TIMEOUT = 150.0


def toy_config(out_dir, bs=BS, **train):
    return apply_overrides(PlanGenConfig(model=TINY, janus_hw=32), {
        "train.train_data": (FlowConfig("uni", "toy", bs), FlowConfig("mmu", "toy", bs),
                             FlowConfig("plan", "toy", bs)),
        "train.output_dir": str(out_dir),
        "train.checkpointing_steps": STEPS,
        "train.num_workers": 0,
        "train.prefetch_depth": 0,
        "train.test_data": FlowConfig("plan", "toy", 2),
        "train.val_max_len": 1,
        "generation.max_new_text_tokens": 4,
        **{f"train.{k}": v for k, v in train.items()},
    })


def full_params(model) -> dict:
    from torch.distributed.tensor import DTensor

    out = {}
    for name, p in model.named_parameters():
        t = p.full_tensor() if isinstance(p, DTensor) else p
        out[name] = t.detach().float().numpy().copy()
    return out


class FakeSummaryWriter:
    """Stands in for TensorBoard's writer (whose import alone takes seconds):
    it records where each writer was opened."""

    opened: list = []

    def __init__(self, logdir):
        self.opened.append(logdir)

    def add_scalar(self, *args):
        pass

    def close(self):
        pass


def fake_tensorboard():
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = FakeSummaryWriter
    return fake


def recording(trainer) -> list:
    """The step metrics of every step the trainer runs."""
    seen, step_fn = [], trainer.step_fn

    def step(state, batches):
        state, metrics = step_fn(state, batches)
        seen.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    trainer.step_fn = step
    return seen


def _rank_main(rank, world, port, out_dir, results):
    import torch.distributed as dist

    from plangen_tpu_torch.data.loader import BatchLoader
    from plangen_tpu_torch.parallel.mesh import init_distributed
    from plangen_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = fake_tensorboard()
    try:
        init_distributed(f"localhost:{port}", world, rank, device="cpu")
        fetched = []
        fetch = BatchLoader._fetch
        BatchLoader._fetch = lambda self, idxs: (  # (the flow's seed, sample)
            fetched.extend((self.seed, int(i)) for i in idxs), fetch(self, idxs))[1]
        # fsdp_min_size 1000, as JAX's own tests: a mix of sharded and whole tensors
        t = Trainer(toy_config(out_dir, fsdp=True, fsdp_min_size=1000), device="cpu")
        losses = recording(t)
        t.fit(max_steps=STEPS)
        out = {"losses": losses, "fetched": fetched, "params": full_params(t.model),
               "mesh": tuple(t.mesh.shape)}
        t.validate(STEPS)
        out["val_sharded"] = any(hasattr(p, "full_tensor") for p in t.model.parameters())
        tp = Trainer(toy_config(out_dir, mesh_shape={"data": 1, "model": 2}), device="cpu")
        out["tp_resumed"] = tp.maybe_resume()
        out["tp_params"] = full_params(tp.model)
        out["tp_placements"] = str(tp.model.language_model.lm_head.weight.placements)
        out["writers"] = len(FakeSummaryWriter.opened)
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world, out_dir, timeout=SPAWN_TIMEOUT):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, str(out_dir), results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(world):
            rank, res = results.get(timeout=timeout)
            assert not isinstance(res, str), f"rank {rank} failed:\n{res}"
            out[rank] = res
    except queue.Empty:
        pytest.fail(f"{world} ranks: no result within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(the run directory, {rank: result}) of the one spawn."""
    run = tmp_path_factory.mktemp("two_ranks") / "run"
    return run, spawn(2, run)


def val_tree(root) -> dict:
    """{relative path: bytes} of a validation output tree."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_two_rank_trainer_matches_one_process(two_ranks, tmp_path, monkeypatch):
    from plangen_tpu_torch.train.trainer import Trainer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake_tensorboard())
    run, ranks = two_ranks
    assert ranks[0]["mesh"] == (2, 1)

    # each rank loads its own stride of each flow's shuffled dataset
    assert len(ranks[0]["fetched"]) == len(ranks[1]["fetched"]) == 3 * BS * STEPS
    assert not set(ranks[0]["fetched"]) & set(ranks[1]["fetched"])

    # one writer (the step metrics; validation's line is checked below)
    lines = [x for x in (run / "metrics.jsonl").read_text().splitlines() if "val/" not in x]
    assert len(lines) == 1 and '"step": 1' in lines[0]
    one = Trainer(toy_config(tmp_path / "one", bs=2 * BS), device="cpu")
    n_trainable = sum(one.mask.values())
    assert (run / "params.jsonl").read_text().count("\n") == n_trainable
    assert ranks[0]["writers"] == 2 and ranks[1]["writers"] == 0  # TensorBoard on the lead

    # the same numbers as one process on the global batch
    losses = recording(one)
    one.fit(max_steps=STEPS)
    lr = one.cfg.train.optim.learning_rate
    for rank in ranks.values():
        assert len(rank["losses"]) == STEPS and sorted(rank["losses"][-1]) == sorted(losses[-1])
        for k, v in losses[-1].items():
            np.testing.assert_allclose(rank["losses"][-1][k], v, rtol=4e-3, err_msg=k)
        assert rank["losses"] == ranks[0]["losses"]
    want = full_params(one.model)
    for name, p in ranks[0]["params"].items():
        np.testing.assert_allclose(p, want[name], rtol=0, atol=2 * lr * STEPS, err_msg=name)
        np.testing.assert_array_equal(ranks[1]["params"][name], p, err_msg=name)

    # the gathered checkpoint restores into tp 2 and into one process
    for rank in ranks.values():
        assert rank["tp_resumed"] == STEPS and "Shard(dim=0)" in rank["tp_placements"]
        for name, p in rank["tp_params"].items():
            np.testing.assert_array_equal(p, ranks[0]["params"][name], err_msg=name)
    back = Trainer(toy_config(run), device="cpu")
    assert back.maybe_resume() == STEPS and back.mesh is None
    for name, p in full_params(back.model).items():
        np.testing.assert_array_equal(p, ranks[0]["params"][name], err_msg=name)


def test_two_rank_trainer_validate_matches_one_process(two_ranks, tmp_path, monkeypatch):
    """`validate` on the FSDP mesh: the model stays sharded, each rank
    writes its own tree (the lead `val`, rank 1 `val_rank1`), the lead alone
    logs `val/` metrics, and the layout files and metrics equal a one-process
    Trainer's `validate` on the ranks' checkpoint."""
    import shutil

    from plangen_tpu_torch.train.trainer import Trainer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake_tensorboard())
    run, ranks = two_ranks
    assert all(rank["val_sharded"] for rank in ranks.values())
    val = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()
           if "val/" in x]
    assert len(val) == 1 and val[0]["step"] == STEPS and "val/miou" in val[0]
    got = val_tree(run / "val")
    assert any(k.endswith("_layout.json") for k in got)
    assert val_tree(run / "val_rank1") == got

    one_dir = tmp_path / "one"
    shutil.copytree(run / "checkpoints", one_dir / "checkpoints")
    one = Trainer(toy_config(one_dir), device="cpu")
    assert one.maybe_resume() == STEPS and one.mesh is None
    one.validate(STEPS)
    assert val_tree(one_dir / "val") == got
    want = [json.loads(x) for x in (one_dir / "metrics.jsonl").read_text().splitlines()]
    assert len(want) == 1
    assert {k: v for k, v in val[0].items() if k.startswith("val/")} == \
        {k: v for k, v in want[0].items() if k.startswith("val/")}
