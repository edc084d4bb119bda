"""Parallelism of the port (`plangen_tpu_torch/parallel/mesh.py`) against
the JAX package's mesh, on the CPU.

In this process: the mesh dims against JAX's `create_mesh`, and each
parameter's placement against JAX's `param_shardings` on the conftest's
8-device mesh (TP, FSDP, and both on a data x model mesh). Then one spawn of
2 gloo ranks and one of 4 (data 2 x model 2, and data 1 x model 4 over the
same ranks), each joined under a timeout and killed on expiry, run:

  * one AdamW step (stage3, fp32, the clip active) on `uni` + `mmu` + `plan`
    flows whose data shards hold different numbers of valid tokens, under
    dp 2, FSDP 2, tp 2, dp 2 x tp 2, FSDP 2 x tp 2 and tp 4 (SigLIP's 2
    heads whole on every rank), held against JAX's `make_train_step` on
    the global batch: the loss on every rank and every parameter, rtol 1e-5
    (fp32 on both sides; only the summation order differs); right after
    `shard_params`, every parameter gathered equals the weights it split
    bit for bit, and the sum of squares over the shards (the clip's norm)
    equals the whole model's;
  * greedy and temperature-1 `generate_image_tokens` under tp 2 and 2 x 2
    (the batch's rows split over "data", a generator per row), held
    against JAX's single-device tokens (greedy) and the port's unsharded
    run (both), with every rank's tokens equal; the 2 x 2 sampled case runs
    160 steps, as JAX's `test_growing_cache_under_dp_and_tp`;
  * the int8 KV cache under tp 2 against the port's unsharded int8 run;
  * LoRA ('lora' under FSDP 2, 'lora_tokens' under tp 2 and dp 2 x tp 2)
    and Adafactor (stage3 under FSDP 2, tp 2, dp 2 x tp 2 and FSDP 2 x
    tp 2, on `tiny_af`, whose 128-wide matrices factor) train steps against
    JAX's (optax's) step on the global batch, as the AdamW step;
  * under FSDP 2 x tp 2, the checkpoint gathered after the step: restored
    into one process it equals the sharded model, restored onto the mesh
    it equals the saved state, optimizer state included;
  * under tp 4, `tiny_7b`'s greedy tokens (its 6 heads whole on every
    rank) against JAX's;
  * the Trainer with `fsdp` on the data 2 x model 2 mesh: a step, then
    `validate` on every rank against a one-process Trainer's;
  * the weight-quantized forms under tp 2: a TP-split dense model
    quantized in place and a quantized model split by `shard_params` hold
    the same bytes on every rank, and greedy int8 / int4 / int4_a8
    decoding (fp32, the int8 cache) on either gives JAX's tokens on its
    quantized tree and the unsharded port's.

The ranks' code lives in this file and imports no JAX: JAX is imported
inside the test functions only.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
import pickle
import queue
import re
import socket
import tempfile
import traceback

from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from plangen_tpu_torch.config import OptimConfig, PlanGenModelConfig, TrainConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.parallel import mesh as pm

PAD = 2
FLOWS = ((0, "uni"), (1, "mmu"), (2, "plan"))
TINY = PlanGenModelConfig.tiny()
# tiny with 128-wide LLaMA matrices, which Adafactor factors (tiny has none)
TINY_AF = replace(TINY, llama=replace(TINY.llama, hidden_size=128, intermediate_size=256,
                                      head_dim=32),
                  aligner=replace(TINY.aligner, n_embed=128),
                  gen_aligner=replace(TINY.gen_aligner, n_embed=128), image_token_embed=128)
CONFIGS = {"tiny": TINY, "tiny_7b": PlanGenModelConfig.tiny_7b(), "tiny_af": TINY_AF}
# the clip is active: the tiny model's first gradient norm is well above 0.05
TCFGS = {"adamw": TrainConfig(optim=OptimConfig(max_grad_norm=0.05)),
         "adafactor": TrainConfig(optim=OptimConfig(optimizer="adafactor", learning_rate=1e-3,
                                                    max_grad_norm=0.05)),
         # the chunked lm_head CE (train.fused_lm_ce) on the vocab-split head
         "adamw_fused_ce": TrainConfig(optim=OptimConfig(max_grad_norm=0.05),
                                       fused_lm_ce=True)}
TCFG = TCFGS["adamw"]
TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT = 150.0
GREEDY_STEPS = 12
SAMPLED_STEPS = {2: 12, 4: 160}
PROMPT_LEN = 6
LORA_RANK, LORA_ALPHA = 4, 8.0
QUANT_MODES = ("int8", "int4", "int4_a8")
TRAIN_CASES = {  # name: (mesh shape, fsdp, world); stage3, AdamW, tiny
    "dp2": ({"data": 2, "model": 1}, False, 2),
    "fsdp2": ({"data": 2, "model": 1}, True, 2),
    "tp2": ({"data": 1, "model": 2}, False, 2),
    "dp2_tp2": ({"data": 2, "model": 2}, False, 4),
    "fsdp2_tp2": ({"data": 2, "model": 2}, True, 4),
    "tp4": ({"data": 1, "model": 4}, False, 4),  # SigLIP's 2 heads stay whole
}
OPTION_CASES = {  # name: (mesh shape, fsdp, world, model, tuning mode, optimizer)
    "lora_fsdp2": ({"data": 2, "model": 1}, True, 2, "tiny", "lora", "adamw"),
    "lora_tokens_tp2": ({"data": 1, "model": 2}, False, 2, "tiny", "lora_tokens", "adamw"),
    "lora_tokens_dp2_tp2": ({"data": 2, "model": 2}, False, 4, "tiny", "lora_tokens",
                            "adamw"),
    "adafactor_fsdp2": ({"data": 2, "model": 1}, True, 2, "tiny_af", "stage3", "adafactor"),
    "adafactor_tp2": ({"data": 1, "model": 2}, False, 2, "tiny_af", "stage3", "adafactor"),
    "adafactor_dp2_tp2": ({"data": 2, "model": 2}, False, 4, "tiny_af", "stage3",
                          "adafactor"),
    "adafactor_fsdp2_tp2": ({"data": 2, "model": 2}, True, 4, "tiny_af", "stage3",
                            "adafactor"),
}
FUSED_CE_CASES = {  # as OPTION_CASES: the fused lm_head CE under TP
    "fused_ce_tp2": ({"data": 1, "model": 2}, False, 2, "tiny", "stage3", "adamw_fused_ce"),
    "fused_ce_fsdp2_tp2": ({"data": 2, "model": 2}, True, 4, "tiny", "stage3",
                           "adamw_fused_ce"),
}
CHECKPOINT_CASES = ("fsdp2_tp2", "adafactor_fsdp2_tp2")  # saved, then restored
REMAT_CASES = ("fsdp2_tp2",)  # under gradient_checkpointing


# ------------------------------------------------------------ shared data


def make_global_batches(cfg, B=4, L=8, seed=0):
    """numpy batches of the three flows, B rows each. The rows of data shard
    0 (rows 0-1) are left-padded by 3 and 5, those of shard 1 not, so the
    shards hold different numbers of valid tokens."""
    rs = np.random.RandomState(seed)
    n, size = cfg.image_seq_len, cfg.vision.image_size
    ids = rs.randint(3, 100, size=(B, L)).astype(np.int32)
    img = rs.uniform(-1, 1, size=(B, size, size, 3)).astype(np.float32)
    seq_mask = np.zeros((B, L), dtype=bool)
    seq_mask[:, 1:1 + n] = True
    text_mask = np.ones((B, L), dtype=np.int32)
    padded = ids.copy()
    for row, pads in ((0, 3), (1, 5)):
        text_mask[row, :pads] = 0
        padded[row, :pads] = PAD
    mmu_mask = np.ones((B, L), np.int32)
    mmu_mask[0, -2:] = 0
    mmu_ids = np.where(mmu_mask > 0, ids, PAD).astype(np.int32)
    return {
        0: {"input_ids": padded,
            "attn_mask": np.concatenate([text_mask, np.ones((B, n), np.int32)], axis=1),
            "images": img},
        1: {"input_ids": mmu_ids, "attn_mask": mmu_mask, "images": img,
            "images_seq_mask": seq_mask},
        2: {"input_ids": padded, "attn_mask": text_mask},
    }


def decode_inputs(B=2, seed=3):
    """The prompt ids [2B, L] of an image decode (B cond/uncond pairs)."""
    rs = np.random.RandomState(seed)
    return rs.randint(0, 100, size=(2 * B, PROMPT_LEN)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def weights(name: str = "tiny") -> dict:
    """The model's HF-named weights (numpy): the port's seeded init, with
    every bias and norm scale moved off its constant by seeded noise, so
    that a split bias shows in the numbers."""
    from plangen_tpu_torch.convert.from_jax import init_params

    model = PlanGenModel(CONFIGS[name], dtype=torch.float32)
    with torch.no_grad():
        init_params(model, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        if k.endswith(".bias") or "norm" in k:
            v += 0.02 * rs.standard_normal(v.shape).astype(np.float32)
    return sd


def build_model(sd, name: str = "tiny") -> PlanGenModel:
    model = PlanGenModel(CONFIGS[name], dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


@functools.lru_cache(maxsize=None)
def lora_adapters(seed: int = 5) -> dict:
    """{target: (a [L, in, r], b [L, r, out])}: tiny's adapters in the JAX
    layout, drawn from numpy, b non-zero so that every adapter moves the
    loss."""
    from plangen_tpu_torch.train.lora import TARGETS

    cfg = TINY.llama
    dims = {"q_proj": (cfg.hidden_size, cfg.q_dim), "k_proj": (cfg.hidden_size, cfg.kv_dim),
            "v_proj": (cfg.hidden_size, cfg.kv_dim), "o_proj": (cfg.q_dim, cfg.hidden_size)}
    rs = np.random.RandomState(seed)
    L = cfg.num_layers
    return {t: ((rs.standard_normal((L, dims[t][0], LORA_RANK)) / LORA_RANK).astype(np.float32),
                (0.1 * rs.standard_normal((L, LORA_RANK, dims[t][1]))).astype(np.float32))
            for t in TARGETS}


def with_lora(model, adapters) -> PlanGenModel:
    """`model` with `add_lora(LORA_RANK, LORA_ALPHA)` holding `adapters`."""
    from plangen_tpu_torch.train.lora import add_lora

    add_lora(model, LORA_RANK, LORA_ALPHA)
    with torch.no_grad():
        for t, (a, b) in adapters.items():
            for i, layer in enumerate(model.language_model.model.layers):
                layer.self_attn.lora[t].a.copy_(torch.from_numpy(a[i]))
                layer.self_attn.lora[t].b.copy_(torch.from_numpy(b[i]))
    return model


def full_params(model) -> dict:
    """{name: numpy} of every parameter, DTensors gathered whole
    (`parallel/mesh.py::full_tensor`)."""
    return {name: pm.full_tensor(p).detach().numpy().copy()
            for name, p in model.named_parameters()}


def row_generators(rows, seed=11):
    return [torch.Generator().manual_seed(seed + r) for r in rows]


def decode(model, ids, steps, temperature, quantized=False, rows=None, cfg=TINY):
    """The port's image decode of prompt `ids` (2B rows, cond/uncond
    pairs); `rows` are the global indices of the B rows it holds."""
    from plangen_tpu_torch.runtime.generate import generate_image_tokens

    ids = torch.from_numpy(ids)
    rows = range(ids.shape[0] // 2) if rows is None else rows
    with torch.no_grad():
        embeds = model.embed_text(ids)
    mask = torch.ones((ids.shape[0], ids.shape[1] + steps), dtype=torch.int32)
    gens = row_generators(rows) if temperature else None
    return generate_image_tokens(model, cfg, embeds, mask, gens, 5.0, temperature,
                                 num_tokens=steps, quantized_cache=quantized)


# ------------------------------------------------------------------ ranks


def _case(name):
    """(mesh shape, fsdp, world, model, tuning mode, optimizer) of a case."""
    if name in TRAIN_CASES:
        return TRAIN_CASES[name] + ("tiny", "stage3", "adamw")
    return {**OPTION_CASES, **FUSED_CE_CASES}[name]


def _sharded_state(name, inputs, mesh, compute_dtype=torch.float32):
    """The case's model (its weights, adapters under LoRA) placed on `mesh`
    as the case says, FSDP2 casting to `compute_dtype`, and its train
    state."""
    from plangen_tpu_torch.train import optim as toptim
    from plangen_tpu_torch.train import step as tstep

    shape, fsdp, _, model_name, mode, optimizer = _case(name)
    model = build_model(inputs["weights"][model_name], model_name)
    if mode.startswith("lora"):
        with_lora(model, inputs["lora"])
    mask = toptim.trainable_mask(model, mode)
    if fsdp:
        for pname, trainable in mask.items():
            model.get_parameter(pname).requires_grad_(trainable)
    pm.shard_params(model, mesh, tp_axis="model" if shape["model"] > 1 else None,
                    fsdp_axis="data" if fsdp else None, param_dtype=compute_dtype)
    opt, mask = toptim.make_optimizer(TCFGS[optimizer].optim, model, mode)
    return tstep.init_train_state(model, opt), mask


def _train_case(name, inputs, directory):
    """One step of the case; right after `shard_params` the gathered
    parameters against the weights and the sum of squares over the shards;
    for `CHECKPOINT_CASES` the checkpoint after the step."""
    from plangen_tpu_torch.train import optim as toptim
    from plangen_tpu_torch.train import step as tstep

    shape, fsdp, _, model_name, mode, optimizer = _case(name)
    tcfg, batches = TCFGS[optimizer], inputs["batches"]
    tcfg = replace(tcfg, gradient_checkpointing=name in REMAT_CASES)
    mesh = pm.create_mesh(shape, device="cpu")
    state, mask = _sharded_state(name, inputs, mesh)
    sd = inputs["weights"][model_name]
    placed = {n: pm.full_tensor(p).detach().numpy() for n, p in state.model.named_parameters()}
    unequal = [n for n, w in sd.items() if n in placed and not np.array_equal(placed[n], w)]
    sq = (float(toptim.global_sq_norm([p.detach() for p in state.model.parameters()])),
          sum(float(np.sum(v.astype(np.float64) ** 2)) for v in placed.values()))
    group = mesh["data"].get_group() if shape["data"] > 1 else None
    step = tstep.make_train_step(CONFIGS[model_name], tcfg, PAD, FLOWS,
                                 compute_dtype=torch.float32, trainable_mask=mask, group=group)
    local = {f: {k: pm.shard_rows(torch.from_numpy(np.array(v)), mesh) for k, v in b.items()}
             for f, b in batches.items()}
    state, metrics = step(state, local)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": full_params(state.model), "unequal_after_shard": unequal,
           "sq_after_shard": sq}
    if name in CHECKPOINT_CASES:
        out["checkpoint"] = _checkpoint_case(name, inputs, mesh, state, directory)
    return out


def _remat_bf16_case(inputs):
    """`fsdp2_tp2`'s step with fp32 masters and bf16 compute, without and
    with gradient_checkpointing (the recompute must see the bf16 casts of
    the TP-split parameters, as the forward did): each run's parameters
    and AdamW first moments after the step, gathered."""
    from plangen_tpu_torch.train import step as tstep

    mesh = pm.create_mesh(TRAIN_CASES["fsdp2_tp2"][0], device="cpu")
    local = {f: {k: pm.shard_rows(torch.from_numpy(np.array(v)), mesh) for k, v in b.items()}
             for f, b in inputs["batches"].items()}
    out = []
    for remat in (False, True):
        state, mask = _sharded_state("fsdp2_tp2", inputs, mesh, torch.bfloat16)
        step = tstep.make_train_step(TINY, replace(TCFG, gradient_checkpointing=remat), PAD,
                                     FLOWS, compute_dtype=torch.bfloat16, trainable_mask=mask,
                                     group=mesh["data"].get_group())
        state, _ = step(state, local)
        out.append({"params": full_params(state.model),
                    "mu": {n: pm.full_tensor(m).numpy() for n, m in state.opt.mu.items()}})
    return out


def _checkpoint_case(name, inputs, mesh, state, directory):
    """Save `state` (gathered to rank 0), restore it into a fresh state on
    the same mesh; the restored model and optimizer state gathered against
    the saved file (the names that differ), and the saved model (rank 0)."""
    import torch.distributed as dist

    from plangen_tpu_torch.train import checkpoint as tckpt

    ckpt = tckpt.PlanGenCheckpointer(os.path.join(directory, name), group=dist.group.WORLD)
    ckpt.save(1, state)
    fresh, _ = _sharded_state(name, inputs, mesh)
    ckpt.restore(fresh)
    saved = torch.load(os.path.join(directory, name, "1", "state.pt"), weights_only=True)
    restored = tckpt._gathered({"model": fresh.model.state_dict(),
                                "optimizer": fresh.opt.state_dict()}, True)

    def unequal(a, b, prefix=""):
        if isinstance(a, dict):
            keys = sorted(set(a) | set(b))
            return [n for k in keys for n in unequal(a.get(k), b.get(k), f"{prefix}{k}.")]
        if isinstance(a, torch.Tensor):
            same = isinstance(b, torch.Tensor) and a.shape == b.shape and torch.equal(a, b)
        else:
            same = a == b
        return [] if same else [prefix]

    return {"restore_unequal": unequal(restored, {"model": saved["model"],
                                                  "optimizer": saved["optimizer"]}),
            "saved_model": ({k: v.numpy() for k, v in saved["model"].items()}
                            if dist.get_rank() == 0 else None)}


def _decode_case(shape, sd, ids, world):
    """Greedy and sampled tokens (and, on 2 ranks, the int8 cache's) of the
    TP-sharded model, this data shard's rows gathered back whole."""
    mesh = pm.create_mesh(shape, device="cpu")
    model = pm.shard_params(build_model(sd), mesh, tp_axis="model")
    n, shard = pm.batch_sharding(mesh)
    B = ids.shape[0] // 2
    rows = range(shard * B // n, (shard + 1) * B // n)
    local = pm.shard_rows(torch.from_numpy(ids), mesh).numpy()
    out = {}
    for label, steps, temp, q8 in (("greedy", GREEDY_STEPS, 0.0, False),
                                   ("sampled", SAMPLED_STEPS[world], 1.0, False),
                                   ("int8_kv", GREEDY_STEPS, 0.0, True)):
        if q8 and world != 2:
            continue
        tokens = decode(model, local, steps, temp, quantized=q8, rows=rows)
        out[label] = pm.gather_rows(tokens, mesh).numpy()
    return out


def _quantized_case(sd, ids):
    """Under tp 2, for each quantized form: the buffers of the dense TP
    model quantized in place (route a) against those of the quantized model
    split by `shard_params` (route b), and each route's greedy tokens."""
    from plangen_tpu_torch.ops.quant import quantize_model_

    mesh = pm.create_mesh({"data": 1, "model": 2}, device="cpu")
    out = {}
    for mode in QUANT_MODES:
        a = quantize_model_(pm.shard_params(build_model(sd), mesh, tp_axis="model"), mode)
        b = pm.shard_params(quantize_model_(build_model(sd), mode), mesh, tp_axis="model")
        bufs_a, bufs_b = dict(a.named_buffers()), dict(b.named_buffers())
        attn = a.language_model.model.layers[0].self_attn
        out[mode] = {
            "names": (sorted(bufs_a), sorted(bufs_b)),
            "unequal": [n for n in bufs_a if n in bufs_b and not torch.equal(bufs_a[n], bufs_b[n])],
            "local_out": {k: getattr(attn, k).out_features for k in ("q_proj", "qkv_proj")
                          if hasattr(attn, k)},
            "tokens": [decode(m, ids, GREEDY_STEPS, 0.0, quantized=True).numpy() for m in (a, b)],
        }
    return out


def _tp4_case(sd, ids):
    """Under tp 4 (`tiny_7b`'s 6 heads do not split over 4): greedy tokens,
    and the widths of layer 0's q_proj and MLP on this rank."""
    mesh = pm.create_mesh({"data": 1, "model": 4}, device="cpu")
    model = pm.shard_params(build_model(sd, "tiny_7b"), mesh, tp_axis="model")
    layer = model.language_model.model.layers[0]
    return {"tokens": decode(model, ids, GREEDY_STEPS, 0.0, cfg=CONFIGS["tiny_7b"]).numpy(),
            "local_out": {k: pm._local(m.weight).shape[0] for k, m in
                          (("q_proj", layer.self_attn.q_proj), ("up_proj", layer.mlp.up_proj))}}


def _placements_case():
    """`full_tensor` and `distribute_like` against DTensor's own placing
    over each dim of the data 2 x model 2 mesh (`shard_params` places every
    DTensor over one): even, uneven, replicated and per-part placements,
    and a DTensor over both dims refused; the cases that differ."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.placement_types import _StridedShard

    mesh = pm.create_mesh({"data": 2, "model": 2}, device="cpu")
    x = torch.arange(84, dtype=torch.float32).reshape(12, 7)
    cases = [(mesh["data"], [Shard(0)]), (mesh["model"], [Shard(1)]),
             (mesh["data"], [Replicate()])]
    bad = []
    try:
        pm.full_tensor(distribute_tensor(x, mesh, [Shard(0), Shard(1)]))
        bad.append("2-D gathered")
    except ValueError:
        pass
    for m, placements in cases:
        d = distribute_tensor(x, m, placements)
        if not torch.equal(pm.full_tensor(d), x) or \
                not torch.equal(pm.distribute_like(x, d).to_local(), d.to_local()):
            bad.append(str(placements))
    rank = mesh["model"].get_local_rank()  # q, k and v each split, as SigLIP's qkv
    local = torch.cat([part.chunk(2)[rank] for part in x.chunk(3)])
    d = DTensor.from_local(local, mesh["model"], [_StridedShard(0, split_factor=3)],
                           run_check=False, shape=x.shape, stride=x.stride())
    if not torch.equal(pm.full_tensor(d), x) or \
            not torch.equal(pm.distribute_like(x, d).to_local(), local):
        bad.append("per part")
    return bad


def _trainer_case(directory):
    """The Trainer with `fsdp` on the data 2 x model 2 mesh (tiny, the toy
    data of `tests/test_torch_distributed.py`): one step, then `validate`
    on every rank; this rank's validation tree."""
    import sys

    import torch.distributed as dist

    from plangen_tpu_torch.train.trainer import Trainer
    from tests.test_torch_distributed import fake_tensorboard, toy_config, val_tree

    sys.modules["torch.utils.tensorboard"] = fake_tensorboard()
    out_dir = os.path.join(directory, "trainer")
    t = Trainer(toy_config(out_dir, fsdp=True, mesh_shape={"data": 2, "model": 2}),
                device="cpu")
    t.fit(max_steps=1)
    t.validate(1)
    rank = dist.get_rank()
    return {"mesh": tuple(t.mesh.shape), "params": full_params(t.model),
            "fsdp_ignored": sorted(pm.fsdp_ignored(t.model)),
            "val": val_tree(Path(out_dir) / ("val" if rank == 0 else f"val_rank{rank}"))}


def _rank_main(rank, world, port, inputs, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        directory = os.path.dirname(inputs)
        with open(inputs, "rb") as f:
            inputs = pickle.load(f)
        sd, ids = inputs["weights"]["tiny"], inputs["ids"]
        pm.init_distributed(f"localhost:{port}", world, rank, device="cpu")
        out = {name: _train_case(name, inputs, directory)
               for name in (*TRAIN_CASES, *OPTION_CASES, *FUSED_CE_CASES)
               if _case(name)[2] == world}
        shape = {"data": 1, "model": 2} if world == 2 else {"data": 2, "model": 2}
        out["decode"] = _decode_case(shape, sd, ids, world)
        if world == 2:
            out["quantized"] = _quantized_case(sd, ids)
        else:
            out["tp4_7b"] = _tp4_case(inputs["weights"]["tiny_7b"], ids)
            out["trainer"] = _trainer_case(directory)
            out["placements"] = _placements_case()
            out["remat_bf16"] = _remat_bf16_case(inputs)
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


def spawn(world, inputs, timeout=SPAWN_TIMEOUT):
    """Run `_rank_main` on `world` gloo ranks over `inputs` (handed over in
    a file, so that no rank waits on another's start); {rank: result}.
    Every rank is joined under the timeout and killed when it expires."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, path, results))
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
        tmp.cleanup()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return out


# --------------------------------------------------------- the JAX side


@functools.lru_cache(maxsize=None)
def _jax_params(name: str = "tiny", lora: bool = False):
    """`weights(name)` as the JAX package's parameter tree, with
    `lora_adapters()` under `language_model/lora` when `lora`."""
    import jax
    import jax.numpy as jnp

    from plangen_tpu.convert.torch_to_jax import convert_state_dict

    params = convert_state_dict(weights(name), CONFIGS[name])
    if lora:
        tree = {t: {"a": a, "b": b} for t, (a, b) in lora_adapters().items()}
        tree["scaling"] = np.float32(LORA_ALPHA / LORA_RANK)
        params["language_model"] = {**params["language_model"], "lora": tree}
    return jax.tree_util.tree_map(jnp.asarray, params)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _named(tree, cfg) -> dict:
    """A JAX-layout tree (adapters included) by the port's parameter names."""
    from plangen_tpu.convert.jax_to_torch import export_state_dict

    lm = dict(tree["language_model"])
    lora = lm.pop("lora", None)
    named = export_state_dict(_np_tree({**tree, "language_model": lm}), cfg)
    if lora is not None:
        named["language_model.model.lora_scaling"] = np.asarray(lora["scaling"])
        for t, pair in lora.items():
            if t == "scaling":
                continue
            for ab in ("a", "b"):
                for i, arr in enumerate(np.asarray(pair[ab])):
                    named[f"language_model.model.layers.{i}.self_attn.lora.{t}.{ab}"] = arr
    return named


@functools.lru_cache(maxsize=None)
def _jax_step(model: str = "tiny", mode: str = "stage3", optimizer: str = "adamw"):
    """(loss, {HF name: parameter}) after one JAX train step on the global
    batch (optax's AdamW or Adafactor)."""
    import jax
    import jax.numpy as jnp

    from plangen_tpu.train import optim as joptim
    from plangen_tpu.train import step as jstep

    cfg, tcfg = CONFIGS[model], TCFGS[optimizer]
    params = _jax_params(model, lora=mode.startswith("lora"))
    tx, jmask = joptim.make_optimizer(tcfg.optim, params, mode)
    fn = jstep.make_train_step(cfg, tcfg, tx, PAD, FLOWS, compute_dtype=jnp.float32,
                               donate=False, trainable_mask=jmask)
    batches = jax.tree_util.tree_map(jnp.asarray, make_global_batches(cfg))
    state, metrics = fn(jstep.init_train_state(params, tx), batches)
    return {k: float(v) for k, v in metrics.items()}, _named(state.params, cfg)


@functools.lru_cache(maxsize=None)
def _jax_greedy_tokens(mode=None, name="tiny"):
    """JAX's greedy tokens on its tree (of model `name`), or on its
    `mode`-quantized tree over the int8 cache, the int4 matmuls through the
    JAX package's own XLA references (its Pallas kernel wants O/2 % 128 ==
    0, which tiny's projections are not)."""
    from unittest import mock

    import jax
    import jax.numpy as jnp

    from plangen_tpu.models import vlm as jvlm
    from plangen_tpu.ops import pallas_int4_matmul as jint4
    from plangen_tpu.ops import quant as jquant
    from plangen_tpu.runtime.generate import generate_image_tokens

    params = _jax_params(name)
    ids = jnp.asarray(decode_inputs())
    embeds = jvlm.embed_text(params, ids).astype(jnp.float32)
    if mode == "int8":
        params = jquant.quantize_lm_params(params)
    elif mode is not None:
        # under jax.jit, as the JAX pipeline quantizes int4 (tasks/eval.py)
        params = jax.jit(functools.partial(jquant.quantize_lm_params_int4,
                                           act_int8=mode == "int4_a8"))(params)
    dense = jint4.int4_matmul

    def through_reference(x, q, layer=None, interpret=None):
        if x.reshape(-1, x.shape[-1]).shape[0] > 256:
            return dense(x, q, layer=layer, interpret=interpret)
        ref = jint4.int4_matmul_a8_reference if "a8" in q else jint4.int4_matmul_reference
        return ref(x, q, layer=0 if layer is None else layer)

    mask = jnp.ones((ids.shape[0], ids.shape[1] + GREEDY_STEPS), dtype=jnp.int32)
    with mock.patch.object(jint4, "int4_matmul", through_reference):
        out = generate_image_tokens(params, CONFIGS[name], embeds, mask,
                                    rng=jax.random.PRNGKey(0),
                                    cfg_weight=jnp.float32(5.0), temperature=jnp.float32(0.0),
                                    num_tokens=GREEDY_STEPS, quantized_cache=mode is not None)
    return np.asarray(out.tokens)


@functools.lru_cache(maxsize=None)
def _spawned(world):
    return spawn(world, {"weights": {name: weights(name) for name in CONFIGS},
                         "lora": lora_adapters(), "batches": make_global_batches(TINY),
                         "ids": decode_inputs()})


# -------------------------------------------------------- one process


@pytest.mark.parametrize("shape,n", [
    ({"data": -1, "model": 1}, 8), ({"data": 2, "model": -1}, 8),
    ({"data": 2, "model": 2}, 4), ({"data": -1, "model": 4}, 8), ({"model": 2}, 2),
], ids=["dp_wild", "tp_wild", "2x2", "dp_wild_tp4", "tp_only"])
def test_mesh_dims_match_jax(shape, n):
    import jax

    from plangen_tpu.parallel.mesh import create_mesh

    want = dict(create_mesh(shape, devices=jax.devices()[:n]).shape)
    assert pm.mesh_dims(shape, n) == {a: want.get(a, 1) for a in pm.AXES}


def test_mesh_that_needs_more_devices_raises_as_jax():
    import jax

    from plangen_tpu.parallel.mesh import create_mesh

    shape = {"data": 4, "model": 4}
    with pytest.raises(AssertionError) as want:
        create_mesh(shape, devices=jax.devices())
    with pytest.raises(AssertionError) as got:
        pm.mesh_dims(shape, 8)
    assert str(got.value) == str(want.value) == f"mesh {shape} needs 16 devices, have 8"


def _jax_kinds(name, tp, fsdp):
    """{HF name: kind} of JAX's `param_shardings` on the 8-device mesh."""
    import jax

    from plangen_tpu.convert.jax_to_torch import export_state_dict
    from plangen_tpu.models import vlm as jvlm
    from plangen_tpu.parallel.mesh import create_mesh, param_shardings

    cfg = CONFIGS[name]
    shapes = jax.eval_shape(lambda: jvlm.init(jax.random.PRNGKey(0), cfg))
    mesh = create_mesh({"data": 8 // tp, "model": tp})
    specs = param_shardings(shapes, mesh, fsdp_axis="data" if fsdp else None,
                            fsdp_min_size=1000)

    def code(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(tuple(sh.spec)))
        if "data" in spec:
            kind = "fsdp"
        elif "model" not in spec:
            kind = "replicated"
        elif spec.index("model") == len(spec) - 1:
            kind = "column"
        elif len(spec) == 2:  # the [V, H] token embedding
            kind = "vocab"
        else:  # [L, in, out]: the in dim
            kind = "row"
        return np.full(leaf.shape, pm.KINDS.index(kind), np.int8)

    codes = jax.tree_util.tree_map(code, shapes, specs)
    out = {}
    for k, v in export_state_dict(codes, cfg).items():
        assert np.all(v == v.flat[0]), k
        out[k] = pm.KINDS[int(v.flat[0])]
    return out


_ATTENTION = re.compile(r"\.self_attn\.|\.attn\.(qkv|proj)\.")


@pytest.mark.parametrize("name", ["tiny", "tiny_7b"])
@pytest.mark.parametrize("tp,fsdp", [(2, False), (4, False), (1, True), (2, True)],
                         ids=["tp2", "tp4", "fsdp_min_size_1000", "tp2_fsdp"])
def test_param_placements_match_jax(name, tp, fsdp):
    """Every parameter of the port takes JAX's placement: the TP kinds
    exactly (a column-parallel layer's bias is split with its output, where
    JAX keeps it whole and lets XLA slice it); under FSDP every tensor JAX
    shards is sharded (FSDP2 shards the small ones too), and on a data x
    model mesh a TP-split tensor takes its TP placement alone, as in JAX.

    One departure: where a tower's heads do not split over the TP axis
    (`tiny_7b`'s 6 LLaMA heads and both configs' 2 SigLIP heads over tp 4), the
    port keeps that tower's attention projections whole on every rank,
    where JAX splits them by their dim (GSPMD reshards at the head
    reshape)."""
    want = _jax_kinds(name, tp, fsdp)
    model = PlanGenModel(CONFIGS[name], dtype=torch.float32, device="meta")
    got = pm.param_shardings(model, tp=tp if tp > 1 else None,
                             fsdp=8 // tp if fsdp else None)
    whole = pm.whole_attention(CONFIGS[name], tp)
    assert whole == ({"siglip"} | ({"llama"} if name == "tiny_7b" else set())
                     if tp == 4 else set())
    assert sorted(got) == sorted(want)
    split = 0
    for pname, kind in got.items():
        tower = "siglip" if pname.startswith("vision_model") else "llama"
        if tower in whole and _ATTENTION.search(pname):
            assert want[pname] in ("column", "row", "replicated"), pname
            assert kind == ("fsdp" if fsdp else "replicated"), pname
        elif kind in ("fsdp", "replicated") and want[pname] in ("fsdp", "replicated"):
            # FSDP2 shards what JAX leaves whole under fsdp_min_size
            assert kind == ("fsdp" if fsdp else want[pname]), pname
        elif pname.endswith(".bias") and kind == "column":
            assert want[pname] in ("fsdp", "replicated"), pname
            split += 1
        else:
            assert kind == want[pname], pname
            split += kind in ("vocab", "column", "row")
    if tp > 1:
        assert {"vocab", "column", "row"} <= set(got.values())
        # lm_head [V, H] and the 7B-shaped MLP split where their dims divide
        assert got["language_model.lm_head.weight"] == "column"
        assert split > 0
    if tp > 1 and fsdp:
        assert "fsdp" in set(got.values())
    for tower in whole:  # the attention whole, the MLP split
        prefix, attn, mlp = {
            "siglip": ("vision_model.vision_tower.blocks.0.", "attn.qkv", "mlp.fc1"),
            "llama": ("language_model.model.layers.0.", "self_attn.q_proj", "mlp.up_proj"),
        }[tower]
        assert got[prefix + attn + ".weight"] == ("fsdp" if fsdp else "replicated")
        assert got[prefix + mlp + ".weight"] == "column"


@pytest.fixture
def world1_mesh():
    """A 1 x 1 gloo mesh in this process, destroyed after the test."""
    import torch.distributed as dist

    mesh = pm.create_mesh({"data": 1, "model": 1}, device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("tp", [2, 4])
def test_lora_placements(tp):
    """With adapters every base parameter keeps JAX's placement; JAX
    replicates every adapter (and lets XLA make its gradient whole), the
    port splits q/k/v's b [r, out] by columns with its projection and
    o_proj's a [in, r] by rows with its input, and keeps the other factor
    and the scaling whole. (Over tp 4 SigLIP's 2 heads keep its attention
    whole, as `test_param_placements_match_jax` documents.) The spawned
    LoRA steps hold the numbers."""
    from plangen_tpu_torch.train.lora import add_lora

    want = _jax_kinds("tiny", tp, False)
    model = add_lora(PlanGenModel(TINY, dtype=torch.float32, device="meta"), LORA_RANK,
                     LORA_ALPHA)
    got = pm.param_shardings(model, tp=tp)
    adapters = {n: k for n, k in got.items() if ".lora." in n or "lora_scaling" in n}
    assert len(adapters) == 8 * TINY.llama.num_layers + 1
    for name, kind in got.items():
        if name in adapters:
            split = {"b": ("q_proj", "k_proj", "v_proj"), "a": ("o_proj",)}[name[-1]] \
                if ".lora." in name else ()
            target = name.split(".")[-2]
            assert kind == ({"b": "column", "a": "row"}[name[-1]] if target in split
                            else "replicated"), name
        elif name.startswith("vision_model") and _ATTENTION.search(name) and tp == 4:
            # SigLIP's 2 heads do not split over 4: its attention stays whole
            assert kind == "replicated", name
        else:
            assert kind == want[name] or (name.endswith(".bias") and kind == "column"), name


def test_kernel_wrappers_refuse_a_dtensor(world1_mesh):
    """A DTensor reaches neither a kernel nor its plain version."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from plangen_tpu_torch.ops.decode_attention import prefix_decode_attention
    from plangen_tpu_torch.ops.flash_attention import flash_attention
    from plangen_tpu_torch.ops.int4_matmul import int4_matmul_w16, quantize_weight_int4

    q = distribute_tensor(torch.zeros(1, 8, 2, 64), world1_mesh["model"], [Replicate()])
    cache = torch.zeros(1, 1, 128, 2, 64)
    with pytest.raises(TypeError, match="prefix_decode_attention takes local tensors"):
        prefix_decode_attention(q[:, :1], cache, cache, torch.ones(1, 128, dtype=torch.int32),
                                0, torch.tensor([7], dtype=torch.int32))
    with pytest.raises(TypeError, match="flash_attention takes local tensors"):
        flash_attention(q, q, q, torch.ones(1, 8, dtype=torch.int32))
    w = quantize_weight_int4(torch.randn(64, 64))
    x = distribute_tensor(torch.zeros(2, 64), world1_mesh["model"], [Replicate()])
    with pytest.raises(TypeError, match="int4_matmul_w16 takes local tensors"):
        int4_matmul_w16(x, w["w_p4"], w["s_lo"], w["s_hi16"])


# ------------------------------------------------------------ the spawns


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_on_a_mesh_matches_jax_global_batch(world):
    """dp 2, FSDP 2 and tp 2 on 2 ranks; dp 2 x tp 2, FSDP 2 x tp 2 and tp 4
    (SigLIP's 2 heads whole on every rank) on 4: the loss and every
    parameter after the step, on every rank (the replicated copies too),
    equal JAX's step on the global batch."""
    want_metrics, want_params = _jax_step()
    results = _spawned(world)
    for name, (_, _, w) in TRAIN_CASES.items():
        if w != world:
            continue
        for rank, res in results.items():
            got = res[name]["metrics"]
            assert sorted(got) == sorted(want_metrics), name
            for k, v in want_metrics.items():
                np.testing.assert_allclose(got[k], v, err_msg=f"{name} rank {rank} {k}", **TOL)
            for pname, p in res[name]["params"].items():
                np.testing.assert_allclose(p, want_params[pname],
                                           err_msg=f"{name} rank {rank}: {pname}", **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_decode_matches_jax_and_the_unsharded_port(world):
    """Under tp 2 (and 2 x 2 with the rows split over "data"), every rank
    draws the same tokens: greedy equal to JAX's single-device tokens and
    the port's unsharded run, temperature 1 and (tp 2) the int8 cache equal
    to the port's unsharded run with the same per-row generators."""
    results = _spawned(world)
    model = build_model(weights())
    ids = decode_inputs()
    want = {"greedy": decode(model, ids, GREEDY_STEPS, 0.0).numpy(),
            "sampled": decode(model, ids, SAMPLED_STEPS[world], 1.0).numpy()}
    if world == 2:
        want["int8_kv"] = decode(model, ids, GREEDY_STEPS, 0.0, quantized=True).numpy()
    np.testing.assert_array_equal(want["greedy"], _jax_greedy_tokens())
    for rank, res in results.items():
        assert sorted(res["decode"]) == sorted(want)
        for label, tokens in want.items():
            np.testing.assert_array_equal(res["decode"][label], tokens,
                                          err_msg=f"rank {rank}: {label}")


@pytest.mark.parametrize("world", [2, 4])
def test_option_train_steps_on_a_mesh_match_jax_global_batch(world):
    """LoRA ('lora' under FSDP 2, 'lora_tokens' under tp 2 and dp 2 x
    tp 2) and Adafactor (stage3 on tiny_af under FSDP 2, tp 2, dp 2 x tp 2
    and FSDP 2 x tp 2): the loss and every parameter after the step,
    adapters included, on every rank, equal JAX's (optax's) step on the
    global batch.

    One slice is held to its bound instead: the key third of SigLIP's
    fused qkv bias. The softmax ignores a constant added to every key, so
    that bias's gradient is zero up to rounding, and Adafactor's first
    update (epsilon 1e-30) is lr times the sign of that noise on each side
    (AdamW's epsilon 1e-8 keeps its update near 0): the two sides may
    differ by up to 2 lr there."""
    results = _spawned(world)
    cases = [n for n, c in OPTION_CASES.items() if c[2] == world]
    assert len(cases) == (4 if world == 2 else 3)
    for name in cases:
        _, _, _, model, mode, optimizer = OPTION_CASES[name]
        want_metrics, want_params = _jax_step(model, mode, optimizer)
        lr = TCFGS[optimizer].optim.learning_rate
        for rank, res in results.items():
            got = res[name]["metrics"]
            assert sorted(got) == sorted(want_metrics), name
            for k, v in want_metrics.items():
                np.testing.assert_allclose(got[k], v, err_msg=f"{name} rank {rank} {k}", **TOL)
            assert sorted(res[name]["params"]) == sorted(want_params), name
            for pname, p in res[name]["params"].items():
                want, msg = want_params[pname], f"{name} rank {rank}: {pname}"
                if optimizer == "adafactor" and pname.endswith("attn.qkv.bias"):
                    q, k, v = np.split(p, 3)
                    wq, wk, wv = np.split(want, 3)
                    np.testing.assert_allclose(np.concatenate([q, v]), np.concatenate([wq, wv]),
                                               err_msg=msg, **TOL)
                    np.testing.assert_allclose(k, wk, rtol=0, atol=2 * lr + TOL["atol"],
                                               err_msg=msg + " (keys)")
                    continue
                np.testing.assert_allclose(p, want, err_msg=msg, **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_fused_lm_ce_under_tp_matches_jax_global_batch(world):
    """`train.fused_lm_ce` with the lm_head split over "model" (the chunked
    CE gathers the head whole, its gradient back to each rank's rows): tp 2
    on 2 ranks, FSDP 2 x tp 2 on 4; the loss and every parameter after the
    step, on every rank, equal JAX's fused step on the global batch."""
    want_metrics, want_params = _jax_step("tiny", "stage3", "adamw_fused_ce")
    results = _spawned(world)
    (name,) = [n for n, c in FUSED_CE_CASES.items() if c[2] == world]
    for rank, res in results.items():
        got = res[name]["metrics"]
        assert sorted(got) == sorted(want_metrics), name
        for k, v in want_metrics.items():
            np.testing.assert_allclose(got[k], v, err_msg=f"{name} rank {rank} {k}", **TOL)
        assert sorted(res[name]["params"]) == sorted(want_params), name
        for pname, p in res[name]["params"].items():
            np.testing.assert_allclose(p, want_params[pname],
                                       err_msg=f"{name} rank {rank}: {pname}", **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_parameters_gathered_right_after_sharding_equal_the_weights(world):
    """Right after `shard_params`, on every rank of every train case (TP,
    FSDP, both on a data x model mesh, tp 4), each parameter gathered whole
    (`full_tensor`: SigLIP's fused qkv weight and bias part by part) equals
    the weights it split bit for bit, and the sum of squares over the
    shards (`global_sq_norm`, the clip's norm) equals the whole model's:
    every element counts once, a per-part split's too. On 4 ranks
    `full_tensor` and `distribute_like` also undo and redo DTensor's own
    placing over each dim of the 2-D mesh (uneven, replicated and per-part
    placements) and refuse a DTensor over both."""
    results = _spawned(world)
    if world == 4:
        assert all(res["placements"] == [] for res in results.values()), results[0]["placements"]
    cases = [n for n in (*TRAIN_CASES, *OPTION_CASES) if _case(n)[2] == world]
    for name in cases:
        qkv = [k for k in weights(_case(name)[3]) if k.endswith(("attn.qkv.weight",
                                                                 "attn.qkv.bias"))]
        for rank, res in results.items():
            got = res[name]
            assert got["unequal_after_shard"] == [], f"{name} rank {rank}"
            assert qkv and set(qkv) <= set(got["params"]), name
            shards, whole = got["sq_after_shard"]
            np.testing.assert_allclose(shards, whole, rtol=1e-5, err_msg=f"{name} rank {rank}")


def test_fsdp_tp_checkpoint_restores_in_one_process_and_on_the_mesh():
    """Under FSDP 2 x tp 2 (AdamW on tiny, Adafactor on tiny_af), the
    checkpoint saved after the step: restored into one process (a strict
    `load_state_dict`) the model equals the sharded model on every rank,
    bit for bit; restored onto the same mesh (`distribute_like`), the
    model and the optimizer state gathered equal the saved file."""
    results = _spawned(4)
    for name in CHECKPOINT_CASES:
        saved = results[0][name]["checkpoint"]["saved_model"]
        model = build_model(saved, _case(name)[3])
        one = {n: p.detach().numpy() for n, p in model.named_parameters()}
        for rank, res in results.items():
            assert res[name]["checkpoint"]["restore_unequal"] == [], f"{name} rank {rank}"
            assert sorted(res[name]["params"]) == sorted(one), name
            for pname, p in res[name]["params"].items():
                np.testing.assert_array_equal(p, one[pname], err_msg=f"{name} rank {rank}: {pname}")


def test_fsdp_tp_trainer_validates_as_one_process(tmp_path, monkeypatch):
    """`Trainer` with `train.fsdp` on a data 2 x model 2 mesh (tiny, toy
    data): one step, then `validate` on every rank over an unsharded copy;
    the TP-split parameters are those FSDP2 leaves to TP, every rank holds
    the same parameters, and every rank's validation tree equals a
    one-process Trainer's `validate` on those parameters."""
    import sys

    from plangen_tpu_torch.train.trainer import Trainer
    from tests.test_torch_distributed import fake_tensorboard, toy_config, val_tree

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake_tensorboard())
    results = _spawned(4)
    lead = results[0]["trainer"]
    assert lead["mesh"] == (2, 2)
    split = {n for n, k in pm.param_shardings(build_model(weights()), tp=2, fsdp=2).items()
             if k in ("vocab", "column", "row")}
    assert split and set(lead["fsdp_ignored"]) == split
    one = Trainer(toy_config(tmp_path), model=build_model(lead["params"]), device="cpu")
    one.validate(1)
    want = val_tree(tmp_path / "val")
    assert any(k.endswith("_layout.json") for k in want)
    for rank, res in results.items():
        assert res["trainer"]["val"] == want, f"rank {rank}"
        for name, p in res["trainer"]["params"].items():
            np.testing.assert_array_equal(p, lead["params"][name], err_msg=f"rank {rank}: {name}")


def test_fsdp_tp_remat_in_bf16_equals_the_step_without_remat():
    """Under FSDP 2 x tp 2 with fp32 masters and bf16 compute, a step under
    gradient_checkpointing equals the step without, bit for bit, on every
    rank: the recompute of each FSDP2 unit runs on the bf16 casts of its
    TP-split parameters (which FSDP2 ignores), as the forward did. (The
    fp32 step under remat is held against JAX's in
    `test_train_step_on_a_mesh_matches_jax_global_batch[4]`.)"""
    results = _spawned(4)
    for rank, res in results.items():
        plain, remat = res["remat_bf16"]
        for what in ("params", "mu"):
            assert sorted(remat[what]) == sorted(plain[what])
            for name, want in plain[what].items():
                np.testing.assert_array_equal(remat[what][name], want,
                                              err_msg=f"rank {rank} {what} {name}")


def test_tp4_heads_that_do_not_split_stay_whole_and_match_jax():
    """Over tp 4, `tiny_7b`'s 6 heads do not split: its attention stays
    whole on every rank (q_proj's 96 outputs) while its MLP splits (224 / 4
    of up_proj's), and its greedy tokens equal JAX's on every rank. (The
    tiny step over tp 4, SigLIP's 2 heads whole, is held against JAX's in
    `test_train_step_on_a_mesh_matches_jax_global_batch[4]`.)"""
    results = _spawned(4)
    cfg = CONFIGS["tiny_7b"].llama
    want = _jax_greedy_tokens(name="tiny_7b")
    for rank, res in results.items():
        got = res["tp4_7b"]
        assert got["local_out"] == {"q_proj": cfg.q_dim, "up_proj": cfg.intermediate_size // 4}
        np.testing.assert_array_equal(got["tokens"], want, err_msg=f"rank {rank}")


def _forced_logit_gaps(model, tokens) -> list:
    """Teacher-forced on `tokens` [B, N], the port's CFG-combined logits at
    each step: (step, row, port's argmax, the logit gap from it to the
    forced token, the logits' largest magnitude) wherever the two part."""
    from plangen_tpu_torch.ops.sampling import cfg_combine
    from plangen_tpu_torch.runtime.generate import generate_image_tokens

    seen, logits = [], model.image_gen_logits
    model.image_gen_logits = lambda h: (seen.append(logits(h)), seen[-1])[1]
    ids = torch.from_numpy(decode_inputs())
    with torch.no_grad():
        embeds = model.embed_text(ids)
    forced = torch.from_numpy(np.array(tokens)).long()
    generate_image_tokens(model, TINY, embeds, torch.ones((ids.shape[0], ids.shape[1] + GREEDY_STEPS),
                                                          dtype=torch.int32),
                          None, 5.0, 0.0, gt_tokens=forced,
                          regen_mask=torch.zeros(forced.shape, dtype=torch.int32),
                          num_tokens=GREEDY_STEPS, quantized_cache=True)
    del model.image_gen_logits
    gaps = []
    for step, raw in enumerate(seen):
        c = cfg_combine(raw, 5.0)
        for row in range(c.shape[0]):
            top, want = int(c[row].argmax()), int(tokens[row, step])
            if top != want:
                gaps.append((step, row, top, float(c[row, top] - c[row, want]),
                             float(c[row].abs().max())))
    return gaps


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantized_tp_decode_matches_jax_and_the_unsharded_port(mode):
    """Under tp 2: the TP model quantized in place on each rank's shards
    and the quantized model split by `shard_params` hold the same buffers,
    byte for byte, on every rank (the fused q|k|v at half its width); the
    greedy tokens of either (fp32, the int8 cache) equal the port's
    unsharded quantized model's, and that model's equal JAX's on its
    quantized tree. int4_a8 may part from JAX: its per-row int8
    activations, like the int8 cache, turn a one-ulp difference upstream
    (XLA's and torch's summation orders) into a flipped int8 code; where a
    token parts, the port's logits teacher-forced on JAX's tokens must be a
    near tie there (the gap to JAX's token within 1% of the logits' scale),
    and the gap is reported."""
    from plangen_tpu_torch.ops.quant import quantize_model_

    results = _spawned(2)
    model = quantize_model_(build_model(weights()), mode)
    want = decode(model, decode_inputs(), GREEDY_STEPS, 0.0, quantized=True).numpy()
    jax_tokens = _jax_greedy_tokens(mode)
    if mode != "int4_a8" or np.array_equal(want, jax_tokens):
        np.testing.assert_array_equal(want, jax_tokens)
    else:
        gaps = _forced_logit_gaps(model, jax_tokens)
        print(f"{mode}: tokens part from JAX's at (step, row, port token, logit gap, "
              f"logits' scale) {gaps}")
        assert gaps and all(gap <= 1e-2 * scale for *_, gap, scale in gaps), gaps
    width = {"int8": ("q_proj", TINY.llama.q_dim // 2),
             "int4": ("qkv_proj", 3 * TINY.llama.q_dim // 2),
             "int4_a8": ("qkv_proj", 3 * TINY.llama.q_dim // 2)}[mode]
    for rank, res in results.items():
        got = res["quantized"][mode]
        assert got["names"][0] == got["names"][1] and got["names"][0], f"rank {rank}"
        assert not got["unequal"], f"rank {rank}: {got['unequal'][:5]}"
        assert got["local_out"] == dict([width]), f"rank {rank}: {got['local_out']}"
        for route, tokens in zip("ab", got["tokens"]):
            np.testing.assert_array_equal(tokens, want, err_msg=f"rank {rank} route {route}")
