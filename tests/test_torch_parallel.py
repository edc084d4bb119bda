"""Parallelism of the port (`plangen_tpu_torch/parallel/mesh.py`) against
the JAX package's mesh, on the CPU.

In this process: the mesh dims against JAX's `create_mesh`, each parameter's
placement against JAX's `param_shardings` on the conftest's 8-device mesh,
and the combinations left unported raising. Then one spawn of 2 gloo ranks
and one of 4 (data 2 x model 2), each joined under a timeout and killed on
expiry, run:

  * one AdamW step (stage3, fp32, the clip active) on `uni` + `mmu` + `plan`
    flows whose data shards hold different numbers of valid tokens, under
    dp 2, FSDP 2, tp 2 and 2 x 2, held against JAX's `make_train_step` on
    the global batch: the loss on every rank and every parameter, rtol 1e-5
    (fp32 on both sides; only the summation order differs);
  * greedy and temperature-1 `generate_image_tokens` under tp 2 and 2 x 2
    (the batch's rows split over "data", a generator per row), held
    against JAX's single-device tokens (greedy) and the port's unsharded
    run (both), with every rank's tokens equal; the 2 x 2 sampled case runs
    160 steps, as JAX's `test_growing_cache_under_dp_and_tp`;
  * the int8 KV cache under tp 2 against the port's unsharded int8 run.

The ranks' code lives in this file and imports no JAX: JAX is imported
inside the test functions only.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
import pickle
import queue
import socket
import tempfile
import traceback

import numpy as np
import pytest
import torch

from plangen_tpu_torch.config import OptimConfig, PlanGenModelConfig, TrainConfig
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.parallel import mesh as pm

PAD = 2
FLOWS = ((0, "uni"), (1, "mmu"), (2, "plan"))
TINY = PlanGenModelConfig.tiny()
CONFIGS = {"tiny": TINY, "tiny_7b": PlanGenModelConfig.tiny_7b()}
# the clip is active: the tiny model's first gradient norm is well above 0.05
TCFG = TrainConfig(optim=OptimConfig(max_grad_norm=0.05))
TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT = 150.0
GREEDY_STEPS = 12
SAMPLED_STEPS = {2: 12, 4: 160}
PROMPT_LEN = 6
TRAIN_CASES = {  # name: (mesh shape, fsdp, world)
    "dp2": ({"data": 2, "model": 1}, False, 2),
    "fsdp2": ({"data": 2, "model": 1}, True, 2),
    "tp2": ({"data": 1, "model": 2}, False, 2),
    "dp2_tp2": ({"data": 2, "model": 2}, False, 4),
}


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
def weights() -> dict:
    """The tiny model's HF-named weights (numpy): the port's seeded init,
    with every bias and norm scale moved off its constant by seeded noise,
    so that a split bias shows in the numbers."""
    from plangen_tpu_torch.convert.from_jax import init_params

    model = PlanGenModel(TINY, dtype=torch.float32)
    with torch.no_grad():
        init_params(model, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        if k.endswith(".bias") or "norm" in k:
            v += 0.02 * rs.standard_normal(v.shape).astype(np.float32)
    return sd


def build_model(sd) -> PlanGenModel:
    model = PlanGenModel(TINY, dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def full_params(model) -> dict:
    """{name: numpy} of every parameter, DTensors gathered whole."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, p in model.named_parameters():
        t = p.full_tensor() if isinstance(p, DTensor) else p
        out[name] = t.detach().numpy().copy()
    return out


def row_generators(rows, seed=11):
    return [torch.Generator().manual_seed(seed + r) for r in rows]


def decode(model, ids, steps, temperature, quantized=False, rows=None):
    """The port's image decode of prompt `ids` (2B rows, cond/uncond
    pairs); `rows` are the global indices of the B rows it holds."""
    from plangen_tpu_torch.runtime.generate import generate_image_tokens

    ids = torch.from_numpy(ids)
    rows = range(ids.shape[0] // 2) if rows is None else rows
    with torch.no_grad():
        embeds = model.embed_text(ids)
    mask = torch.ones((ids.shape[0], ids.shape[1] + steps), dtype=torch.int32)
    gens = row_generators(rows) if temperature else None
    return generate_image_tokens(model, TINY, embeds, mask, gens, 5.0, temperature,
                                 num_tokens=steps, quantized_cache=quantized)


# ------------------------------------------------------------------ ranks


def _train_case(name, sd, batches):
    from plangen_tpu_torch.train import optim as toptim
    from plangen_tpu_torch.train import step as tstep

    shape, fsdp, _ = TRAIN_CASES[name]
    mesh = pm.create_mesh(shape, device="cpu")
    model = build_model(sd)
    mask = toptim.trainable_mask(model, "stage3")
    if fsdp:
        for pname, trainable in mask.items():
            model.get_parameter(pname).requires_grad_(trainable)
    pm.shard_params(model, mesh, tp_axis="model" if shape["model"] > 1 else None,
                    fsdp_axis="data" if fsdp else None)
    opt, mask = toptim.make_optimizer(TCFG.optim, model, "stage3")
    group = mesh["data"].get_group() if shape["data"] > 1 else None
    step = tstep.make_train_step(TINY, TCFG, PAD, FLOWS, compute_dtype=torch.float32,
                                 trainable_mask=mask, group=group)
    state = tstep.init_train_state(model, opt)
    local = {f: {k: pm.shard_rows(torch.from_numpy(np.array(v)), mesh) for k, v in b.items()}
             for f, b in batches.items()}
    state, metrics = step(state, local)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": full_params(model)}


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


def _rank_main(rank, world, port, inputs, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        with open(inputs, "rb") as f:
            sd, batches, ids = pickle.load(f)
        pm.init_distributed(f"localhost:{port}", world, rank, device="cpu")
        out = {name: _train_case(name, sd, batches)
               for name, (_, _, w) in TRAIN_CASES.items() if w == world}
        shape = {"data": 1, "model": 2} if world == 2 else {"data": 2, "model": 2}
        out["decode"] = _decode_case(shape, sd, ids, world)
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


def spawn(world, *inputs, timeout=SPAWN_TIMEOUT):
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
def _jax_params():
    """`weights()` as the JAX package's parameter tree."""
    import jax
    import jax.numpy as jnp

    from plangen_tpu.convert.torch_to_jax import convert_state_dict

    return jax.tree_util.tree_map(jnp.asarray, convert_state_dict(weights(), TINY))


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """(loss, {HF name: parameter}) after one JAX train step on the global
    batch."""
    import jax
    import jax.numpy as jnp

    from plangen_tpu.convert.jax_to_torch import export_state_dict
    from plangen_tpu.train import optim as joptim
    from plangen_tpu.train import step as jstep

    params = _jax_params()
    tx, jmask = joptim.make_optimizer(TCFG.optim, params, "stage3")
    fn = jstep.make_train_step(TINY, TCFG, tx, PAD, FLOWS, compute_dtype=jnp.float32,
                               donate=False, trainable_mask=jmask)
    batches = jax.tree_util.tree_map(jnp.asarray, make_global_batches(TINY))
    state, metrics = fn(jstep.init_train_state(params, tx), batches)
    return ({k: float(v) for k, v in metrics.items()},
            export_state_dict(_np_tree(state.params), TINY))


@functools.lru_cache(maxsize=None)
def _jax_greedy_tokens():
    import jax
    import jax.numpy as jnp

    from plangen_tpu.models import vlm as jvlm
    from plangen_tpu.runtime.generate import generate_image_tokens

    params = _jax_params()
    ids = jnp.asarray(decode_inputs())
    embeds = jvlm.embed_text(params, ids).astype(jnp.float32)
    mask = jnp.ones((ids.shape[0], ids.shape[1] + GREEDY_STEPS), dtype=jnp.int32)
    out = generate_image_tokens(params, TINY, embeds, mask, rng=jax.random.PRNGKey(0),
                                cfg_weight=jnp.float32(5.0), temperature=jnp.float32(0.0),
                                num_tokens=GREEDY_STEPS)
    return np.asarray(out.tokens)


@functools.lru_cache(maxsize=None)
def _spawned(world):
    return spawn(world, weights(), make_global_batches(TINY), decode_inputs())


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


@pytest.mark.parametrize("name", ["tiny", "tiny_7b"])
@pytest.mark.parametrize("tp,fsdp", [(2, False), (4, False), (1, True)],
                         ids=["tp2", "tp4", "fsdp_min_size_1000"])
def test_param_placements_match_jax(name, tp, fsdp):
    """Every parameter of the port takes JAX's placement: the TP kinds
    exactly (a column-parallel layer's bias is split with its output, where
    JAX keeps it whole and lets XLA slice it); under FSDP every tensor JAX
    shards is sharded (FSDP2 shards the small ones too)."""
    want = _jax_kinds(name, tp, fsdp)
    model = PlanGenModel(CONFIGS[name], dtype=torch.float32, device="meta")
    got = pm.param_shardings(model, tp=tp if tp > 1 else None, fsdp=8 if fsdp else None)
    assert sorted(got) == sorted(want)
    for pname, kind in got.items():
        if fsdp:
            assert kind == "fsdp", pname
        elif pname.endswith(".bias") and kind == "column":
            assert want[pname] == "replicated", pname
        else:
            assert kind == want[pname], pname
    if not fsdp:
        assert {"vocab", "column", "row", "replicated"} <= set(got.values())
        # lm_head [V, H] and the 7B-shaped MLP split where their dims divide
        assert got["language_model.lm_head.weight"] == "column"


@pytest.fixture
def world1_mesh():
    """A 1 x 1 gloo mesh in this process, destroyed after the test."""
    import torch.distributed as dist

    mesh = pm.create_mesh({"data": 1, "model": 1}, device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_unported_combinations_raise(world1_mesh, tmp_path):
    """LoRA and the weight-quantized forms under TP, Adafactor under FSDP,
    a head count that does not split over the TP axis: each raises
    NotImplementedError naming itself."""
    from plangen_tpu_torch.ops.quant import quantize_model_
    from plangen_tpu_torch.train.lora import add_lora
    from plangen_tpu_torch.train.optim import make_optimizer

    model = PlanGenModel(TINY, dtype=torch.float32)
    add_lora(model, 4, 8.0)
    with pytest.raises(NotImplementedError, match="LoRA"):
        pm.shard_params(model, world1_mesh)
    model = PlanGenModel(TINY, dtype=torch.float32)
    quantize_model_(model, "int8")
    with pytest.raises(NotImplementedError, match="int8 weight-quantized"):
        pm.shard_params(model, world1_mesh)
    with pytest.raises(NotImplementedError, match="heads 6 do not split over a TP axis of 4"):
        pm._check_tp(PlanGenModel(CONFIGS["tiny_7b"], device="meta"), 4)
    model = pm.shard_params(PlanGenModel(TINY, dtype=torch.float32), world1_mesh,
                            tp_axis=None, fsdp_axis="data")
    with pytest.raises(NotImplementedError, match="Adafactor under FSDP"):
        make_optimizer(OptimConfig(optimizer="adafactor"), model, "stage3")


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
    """dp 2, FSDP 2 and tp 2 on 2 ranks, 2 x 2 on 4: the loss and every
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
