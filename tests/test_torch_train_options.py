"""The port's training options against the JAX package: Adafactor, gradient
accumulation, bf16 masters, remat, the chunked lm_head CE and LoRA.

Weights come from `vlm.init(PRNGKey(0), cfg, float32)` and reach the port
through `load_jax_params` (a `language_model/lora` subtree included);
batches and gradients come from numpy seeds. `tiny` has no dimension of 128
or more, so nothing factors there; `tiny_hd128` (widths 256) is where
Adafactor's factored statistics and the flash branch of both LLaMA and
SigLIP run; `tiny_7b` has the 7B member's shape relationships. The JAX side
runs its Pallas flash kernel in interpret mode. Every case states its
tolerance.
"""

import functools
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from plangen_tpu.config import OptimConfig, TrainConfig
from plangen_tpu.convert.jax_to_torch import export_state_dict
from plangen_tpu.models import llama as jllama
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.ops import pallas_attention
from plangen_tpu.runtime.kvcache import init_kv_cache as jinit_kv_cache
from plangen_tpu.train import lora as jlora
from plangen_tpu.train import loss as jloss
from plangen_tpu.train import optim as joptim
from plangen_tpu.train import step as jstep
from plangen_tpu_torch.config import PlanGenModelConfig as TPlanGenModelConfig
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops import remat as tremat
from plangen_tpu_torch.runtime.kvcache import init_kv_cache
from plangen_tpu_torch.train import lora as tlora
from plangen_tpu_torch.train import loss as tloss
from plangen_tpu_torch.train import optim as toptim
from plangen_tpu_torch.train import step as tstep

from test_torch_train import (  # noqa: E402  (same test dir)
    CONFIGS, FLOWS, PAD, TINY, _close, _grads_by_name, _jax, _params, _port_model, _torch,
    make_batches,
)

TINY_7B = TPlanGenModelConfig.tiny_7b()
RANK, ALPHA = 4, 8
POLICIES = ("full", "dots", "dots_no_batch")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(pallas_attention, "flash_attention",
                        functools.partial(pallas_attention.flash_attention, interpret=True))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_grads(params, rs, scale=1.0):
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32) * scale), params)


def _named(tree, cfg):
    """A JAX-layout tree (adapters included) by the port's parameter names."""
    lm = dict(tree["language_model"])
    lora = lm.pop("lora", None)
    named = export_state_dict(_np_tree({**tree, "language_model": lm}), cfg)
    if lora is not None:
        named["language_model.model.lora_scaling"] = np.asarray(lora["scaling"])
        for t in tlora.TARGETS:
            for ab in ("a", "b"):
                for i, arr in enumerate(np.asarray(lora[t][ab])):
                    named[f"language_model.model.layers.{i}.self_attn.lora.{t}.{ab}"] = arr
    return named


def _lora_params(name, seed=2):
    """The JAX tree of `name` with rank-RANK adapters, B non-zero."""
    cfg, params = CONFIGS.get(name, TINY_7B), _params_of(name)
    tree = jlora.init_lora(jax.random.PRNGKey(seed), cfg.llama, rank=RANK, alpha=ALPHA)
    rs = np.random.RandomState(seed)
    for t in jlora.TARGETS:
        tree[t]["b"] = jnp.asarray(rs.randn(*tree[t]["b"].shape).astype(np.float32) * 0.1)
    return jlora.add_lora(params, tree)


@functools.lru_cache(maxsize=None)
def _params_of(name):
    if name in CONFIGS:
        return _params(name)
    return jvlm.init(jax.random.PRNGKey(0), TINY_7B, dtype=jnp.float32)


def _model(name, params=None, dtype=torch.float32):
    cfg = CONFIGS.get(name, TINY_7B)
    if params is None and name in CONFIGS:
        return _port_model(name).to(dtype)
    model = PlanGenModel(cfg, dtype=torch.float32)
    load_jax_params(model, _np_tree(params if params is not None else _params_of(name)), cfg)
    return model.to(dtype)


def _ulps(got: torch.Tensor, want: np.ndarray, floor: float) -> np.ndarray:
    """|got - want| in bf16 ulps (8 significant bits: 2^(exponent - 7)) of
    max(|want|, floor). An update of up to lr moves a parameter, so one ulp
    of the update is counted at lr where the parameter itself is smaller."""
    w = np.maximum(np.abs(np.asarray(want, np.float64)), floor)
    spacing = 2.0 ** (np.floor(np.log2(w)) - 7)
    return np.abs(got.detach().double().numpy() - np.asarray(want, np.float64)) / spacing


# ------------------------------------------------------------------ Adafactor


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adafactor_matches_optax(grad_scale):
    """Three updates from the same gradients: the port's Adafactor against
    the JAX package's optax chain (mask, clip, adafactor, set_to_zero),
    stage3, fp32, at tiny_hd128: its 256-wide matrices factor, its norms,
    biases and narrow tables do not. The stacked q_proj leaf [L, 256, 256]
    is given a gradient uneven between the layers so that its block RMS
    (over the whole leaf) clips and differs from each layer's: a per-layer
    clip would miss. Updates atol 1e-9 + rtol 2e-5 (summation order of the
    means), parameters 1e-7 or an ulp."""
    name = "tiny_hd128"
    cfg, params = CONFIGS[name], _params(name)
    ocfg = OptimConfig(optimizer="adafactor", learning_rate=1e-3)
    tx, _ = joptim.make_optimizer(ocfg, params, "stage3")
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    model = _port_model(name)
    opt, mask = toptim.make_optimizer(ocfg, model, "stage3")
    assert isinstance(opt, toptim.Adafactor)
    rs = np.random.RandomState(7)
    jp = params
    for i in range(3):
        grads = _random_grads(jp, rs, grad_scale)
        q = grads["language_model"]["layers"]["q_proj"]
        grads["language_model"]["layers"]["q_proj"] = q.at[0, :16, :16].multiply(30.0)
        if i == 0:
            clipped, _ = optax.clip_by_global_norm(1.0).update(grads, None)
            pre, _ = optax.scale_by_factored_rms().update(
                clipped, optax.scale_by_factored_rms().init(jp), jp)
            u = np.asarray(pre["language_model"]["layers"]["q_proj"], np.float64)
            leaf_rms = np.sqrt(np.mean(u * u))
            layer_rms = np.sqrt(np.mean(u * u, axis=(1, 2)))
            assert u.shape == (2, 256, 256) and leaf_rms > 1.5, leaf_rms
            assert abs(layer_rms[1] - leaf_rms) > 0.3 * leaf_rms, (layer_rms, leaf_rms)
        updates, opt_state = update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tgrads = {k: torch.from_numpy(np.array(v)) for k, v in _grads_by_name(grads, cfg).items()}
        if i < 2:
            opt.step(tgrads)
            continue
        got = {}
        with torch.no_grad():
            for pname, p, u in opt.updates(tgrads):
                got[pname] = u.clone()
                p.add_(u)
        want = export_state_dict(_np_tree(updates), cfg)
        for pname, u in want.items():
            if mask[pname]:
                _close(got[pname], u, msg=pname, atol=1e-9, rtol=2e-5)
            else:
                assert not np.any(u), pname
    assert opt.count == 3
    assert "language_model.model.layers.*.self_attn.q_proj.weight" in opt.v_row
    assert "gen_embed.weight" in opt.v  # [16384, 8]: too narrow to factor
    want = export_state_dict(_np_tree(jp), cfg)
    for pname, p in model.named_parameters():
        _close(p.detach(), want[pname], msg=pname, atol=1e-7, rtol=2.4e-7)


def test_factored_dims_follow_optax():
    from optax._src.factorized import _factored_dims

    for shape in [(5,), (3, 4), (2, 256, 256), (24, 2048, 5632), (30, 4096), (128, 128),
                  (1, 576, 1024), (3, 3, 128, 256), (16384, 8), (200, 129, 130)]:
        assert toptim.factored_dims(shape) == _factored_dims(shape, True, 128), shape


# ------------------------------------------------------- gradient accumulation


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_accumulation_matches_multisteps(optimizer):
    """k = 2 over four micro-steps of different gradients, against
    optax.MultiSteps around the JAX chain: the parameters stay bit-for-bit
    the same after micro-steps 1 and 3 and follow JAX's after 2 and 4 (1e-7
    or an ulp); the inner count advances once per update."""
    cfg, params = TINY, _params("tiny")
    ocfg = OptimConfig(optimizer=optimizer, learning_rate=1e-3, gradient_accumulation_steps=2)
    tx, _ = joptim.make_optimizer(ocfg, params, "stage3")
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    model = _port_model("tiny")
    opt, _ = toptim.make_optimizer(ocfg, model, "stage3")
    assert isinstance(opt, toptim.Accumulate)
    rs = np.random.RandomState(3)
    jp = params
    for i in range(4):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        grads = _random_grads(jp, rs)
        updates, opt_state = update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step({k: torch.from_numpy(np.array(v)) for k, v in _grads_by_name(grads, cfg).items()})
        assert opt.mini_step == (i + 1) % 2 and opt.count == (i + 1) // 2
        assert int(opt_state.gradient_step) == opt.count
        if i % 2 == 0:
            for n, p in model.named_parameters():
                assert torch.equal(p, before[n]), n
            continue
        want = export_state_dict(_np_tree(jp), cfg)
        for n, p in model.named_parameters():
            _close(p.detach(), want[n], msg=f"micro-step {i}: {n}", atol=1e-7, rtol=2.4e-7)


# ----------------------------------------------------------------- bf16 masters


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_bf16_masters_optimizer_within_an_ulp(optimizer):
    """bf16 masters (the JAX package casts its parameters to bf16 and optax
    keeps its state in bf16): two updates from the same bf16 gradients.
    Every parameter within 2 bf16 ulps of JAX's (one an update: XLA on the
    CPU fuses the bf16 elementwise chains and rounds once per fusion, torch
    after every op) and at least 99% bit-equal. Ulps of max(|JAX's value|,
    lr)."""
    cfg = TINY
    params = jstep._cast(_params("tiny"), jnp.bfloat16)
    ocfg = OptimConfig(optimizer=optimizer, learning_rate=1e-3)
    tx, _ = joptim.make_optimizer(ocfg, params, "stage3")
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    model = _port_model("tiny").to(torch.bfloat16)
    opt, _ = toptim.make_optimizer(ocfg, model, "stage3")
    rs = np.random.RandomState(5)
    jp = params
    for _ in range(2):
        grads = jstep._cast(_random_grads(jp, rs), jnp.bfloat16)
        updates, opt_state = update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        named = _grads_by_name(jax.tree_util.tree_map(lambda g: g.astype(jnp.float32), grads),
                               cfg)
        opt.step({k: torch.from_numpy(np.array(v)).to(torch.bfloat16) for k, v in named.items()})
    want = export_state_dict(_np_tree(jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32), jp)), cfg)
    n_equal = n_all = 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        ulps = _ulps(p, want[n], ocfg.learning_rate)
        assert ulps.max() <= 2, (n, ulps.max())
        n_equal += int((ulps == 0).sum())
        n_all += ulps.size
    assert n_equal >= 0.99 * n_all, n_equal / n_all


def test_bf16_masters_two_train_steps():
    """Two train steps with bf16 masters and bf16 compute (the compute cast
    is the identity), AdamW, against JAX's: the losses within 2e-2 of JAX's
    (bf16 forwards), every master bf16, and the parameters within 2 bf16
    ulps of JAX's in at least 99% of their elements (the gradients differ
    by bf16 rounding, which Adam turns into updates of up to lr). Ulps of
    max(|JAX's value|, lr)."""
    cfg = TINY
    params = _params("tiny")
    tcfg = TrainConfig(master_dtype="bfloat16", optim=OptimConfig(learning_rate=1e-4))
    tx, jmask = joptim.make_optimizer(tcfg.optim, params, "stage3")
    jstep_fn = jstep.make_train_step(cfg, tcfg, tx, PAD, FLOWS, donate=False,
                                     trainable_mask=jmask)
    jstate = jstep.init_train_state(params, tx, master_dtype=jnp.bfloat16)
    model = _port_model("tiny").to(torch.bfloat16)
    opt, mask = toptim.make_optimizer(tcfg.optim, model, "stage3")
    step_fn = tstep.make_train_step(cfg, tcfg, PAD, FLOWS, trainable_mask=mask)
    state = tstep.init_train_state(model, opt, torch.bfloat16)
    batches = make_batches(cfg)
    for i in range(2):
        jstate, jm = jstep_fn(jstate, _jax(batches))
        state, m = step_fn(state, _torch(batches))
        for k in jm:
            _close(m[k], jm[k], msg=f"step {i}: {k}", atol=0, rtol=2e-2)
    want = export_state_dict(_np_tree(jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32), jstate.params)), cfg)
    n_close = n_all = 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16, n
        ulps = _ulps(p, want[n], tcfg.optim.learning_rate)
        n_close += int((ulps <= 2).sum())
        n_all += ulps.size
    assert n_close >= 0.99 * n_all, n_close / n_all


def test_init_train_state_wants_the_master_dtype():
    model = _port_model("tiny")
    opt, _ = toptim.make_optimizer(OptimConfig(), model)
    with pytest.raises(ValueError, match="masters required"):
        tstep.init_train_state(model, opt, torch.bfloat16)


# ------------------------------------------------------------------------ remat


def _loss_and_grads(model, tcfg, batches, compute_dtype, cfg):
    mask = toptim.trainable_mask(model, "stage3")
    loss_fn = tstep.make_loss_fn(cfg, tcfg, PAD, FLOWS, compute_dtype=compute_dtype,
                                 trainable_mask=mask)
    model.zero_grad(set_to_none=True)
    loss, ld = loss_fn(model, batches)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), {k: v.detach() for k, v in ld.items()}, grads


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_bitwise_equal_to_no_remat(policy, compute):
    """Each policy, on the CPU: the loss and every gradient bitwise equal to
    the step without remat, at tiny_hd128 with the flash branch (LLaMA and
    SigLIP both rematerialized). In bf16 compute over fp32 masters the
    recompute must run on the bf16 copy the step swapped in: had it read
    the fp32 masters, its saved tensors would differ (and torch would
    refuse their metadata)."""
    cfg = CONFIGS["tiny_hd128"]
    model = _port_model("tiny_hd128")
    batches = _torch(make_batches(cfg))
    dtype = torch.float32 if compute == "fp32" else torch.bfloat16
    base = TrainConfig(use_flash_attention=True)
    want = _loss_and_grads(model, base, batches, dtype, cfg)
    got = _loss_and_grads(model, replace(base, gradient_checkpointing=True, remat_policy=policy),
                          batches, dtype, cfg)
    assert torch.equal(got[0], want[0])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert sorted(got[2]) == sorted(want[2])
    for n, g in want[2].items():
        assert torch.equal(got[2][n], g), n


class _Wrap(torch.nn.Module):
    def __init__(self, layer, remat):
        super().__init__()
        self.layer, self.remat = layer, remat

    def forward(self, *args):
        return tremat.remat_call(self.layer, self.remat, *args)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_recomputes_with_the_swapped_in_weights(policy):
    """The train step swaps the compute copy in for the forward only. With
    the module's own (master) parameters moved between the forward and the
    backward, the rematerialized layer's gradients must still be those of
    the copy, bitwise: a recompute that read the module's attributes would
    see the moved masters."""
    from plangen_tpu_torch.models.llama import rope_cos_sin
    from plangen_tpu_torch.ops.attention import make_causal_bias

    cfg = TINY
    layer = _port_model("tiny").language_model.model.layers[0]
    x = torch.randn(2, 5, cfg.llama.hidden_size, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(2, 5, dtype=torch.int32)
    pos = torch.arange(5, dtype=torch.int32)
    cos, sin = rope_cos_sin(pos, cfg.llama.head_dim, cfg.llama.rope_theta)
    args = (x, cos, sin, make_causal_bias(mask, pos, pos), pos, mask)
    masters = {n: p.detach().clone() for n, p in layer.named_parameters()}
    grads = {}
    for remat in (False, policy):
        copy = {"layer." + n: p.clone().requires_grad_(True) for n, p in masters.items()}
        out = torch.func.functional_call(_Wrap(layer, remat), copy, args)
        with torch.no_grad():
            for p in layer.parameters():
                p.add_(1.0)
        grads[remat] = torch.autograd.grad(out.sum(), list(copy.values()))
        with torch.no_grad():
            for n, p in layer.named_parameters():
                p.copy_(masters[n])
    for a, b in zip(grads[False], grads[policy]):
        assert torch.equal(a, b)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        tremat.policy_name("everything")
    cfg = TINY
    tcfg = TrainConfig(gradient_checkpointing=True, remat_policy="everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        tstep.make_loss_fn(cfg, tcfg, PAD, FLOWS)


@functools.lru_cache(maxsize=None)
def _jax_checkpointed_step():
    """JAX's loss and gradients at tiny with `jax.checkpoint` (its `full`
    policy; every policy computes the same function) and the chunked CE."""
    cfg, params = TINY, _params("tiny")
    tcfg = TrainConfig(gradient_checkpointing=True, fused_lm_ce=True)
    _, jmask = joptim.make_optimizer(tcfg.optim, params, "stage3")
    jloss_fn = jstep.make_loss_fn(cfg, tcfg, PAD, FLOWS, compute_dtype=jnp.float32,
                                  trainable_mask=jmask)
    (want, want_ld), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        params, _jax(make_batches(cfg)))
    return want, want_ld, _grads_by_name(jgrads, cfg)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_and_fused_ce_match_jax_checkpoint(policy):
    """The weighted multi-flow loss and every gradient with
    gradient_checkpointing (each policy) and fused_lm_ce, fp32, at tiny on
    the plain attention path (the flash branch under remat is held bitwise
    against the step without remat above), against JAX's step under
    `jax.checkpoint` with the chunked CE: atol/rtol 1e-5, the tolerance of
    the step without them."""
    name = "tiny"
    cfg = CONFIGS[name]
    tcfg = TrainConfig(gradient_checkpointing=True, remat_policy=policy, fused_lm_ce=True)
    want, want_ld, jg = _jax_checkpointed_step()
    batches = make_batches(cfg)
    model = _port_model(name)
    got, got_ld, grads = _loss_and_grads(model, tcfg, _torch(batches), torch.float32, cfg)
    _close(got, want)
    for k in want_ld:
        _close(got_ld[k], want_ld[k], msg=k)
    assert sorted(grads) == sorted(n for n in jg if not n.startswith("gen_vision_model"))
    for n, g in grads.items():
        _close(g, jg[n], msg=n)


# --------------------------------------------------------------- fused CE


@pytest.mark.parametrize("labels", ["mixed", "all_pad"])
def test_fused_ce_matches_unfused_and_jax(labels):
    """The chunked CE over 2 chunks of 256 (299 positions) against the
    unfused CE (1e-6) and JAX's shift_cross_entropy_fused (1e-5), value and
    the gradients of hidden and the head weight; all-pad labels give 0 and
    zero gradients on both sides."""
    rs = np.random.RandomState(11)
    B, S, H, V = 2, 300, 16, 50
    hidden = rs.randn(B, S, H).astype(np.float32)
    w = (rs.randn(V, H) * 0.3).astype(np.float32)  # nn.Linear layout [V, H]
    lab = rs.randint(0, V, size=(B, S))
    lab[1, :40] = PAD
    if labels == "all_pad":
        lab[:] = PAD

    def port(fused):
        h = torch.from_numpy(hidden).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        t = torch.from_numpy(lab)
        if fused:
            loss = tloss.shift_cross_entropy_fused(h, wt, t, PAD)
        else:
            loss = tloss.shift_cross_entropy(torch.nn.functional.linear(h, wt).float(), t, PAD)
        loss.backward()
        return loss.detach(), h.grad, wt.grad

    fused, plain = port(True), port(False)
    for a, b in zip(fused, plain):
        _close(a, b, atol=1e-6, rtol=1e-6)
    jfn = lambda h, wj: jloss.shift_cross_entropy_fused(h, wj, jnp.asarray(lab), PAD)  # noqa: E731
    want, (gh, gw) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(hidden),
                                                             jnp.asarray(w.T))
    _close(fused[0], want)
    _close(fused[1], gh)
    _close(fused[2], np.asarray(gw).T)
    if labels == "all_pad":
        assert float(fused[0]) == 0.0 and not fused[1].any() and not fused[2].any()


def test_fused_ce_takes_the_plain_path_for_a_quantized_head():
    from plangen_tpu_torch.ops.quant import quantize_model_

    model = quantize_model_(_port_model("tiny"), "int8")
    rs = np.random.RandomState(2)
    hidden = torch.from_numpy(rs.randn(2, 7, TINY.llama.hidden_size).astype(np.float32))
    labels = torch.from_numpy(rs.randint(3, 100, size=(2, 7)))
    want = tloss.shift_cross_entropy(model.language_model.logits(hidden), labels, PAD)
    assert torch.equal(tloss._lm_shift_ce(model, hidden, labels, PAD, fused=True), want)


# ------------------------------------------------------------------------ LoRA


def test_lora_with_zero_b_is_the_identity():
    """Fresh adapters (A drawn, B zero) leave every output bitwise equal."""
    model = _port_model("tiny")
    x, mask = torch.randn(2, 6, TINY.llama.hidden_size), torch.ones(2, 6, dtype=torch.int32)
    with torch.no_grad():
        want = model.language_model(x, mask)
        tlora.add_lora(model, RANK, ALPHA)
        tlora.init_lora(model, torch.Generator().manual_seed(0))
        got = model.language_model(x, mask)
    layer = model.language_model.model.layers[0].self_attn.lora
    assert layer["q_proj"].a.abs().sum() > 0 and not layer["q_proj"].b.any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,path", [
    ("tiny", "no_cache"), ("tiny", "cache"), ("tiny", "int8_cache"), ("tiny_7b", "cache"),
])
def test_lora_forward_matches_jax(name, path):
    """Non-zero adapters carried across from the JAX tree: the no-cache
    forward, and the cached prefill plus one decode step (the adapters in
    both, as the JAX layer applies `_lora_delta` in prefill and decode), dense
    or with the LM quantized to int8 (the JAX quantizers leave the adapters
    dense beside the quantized projections), and at tiny_7b's shapes;
    atol/rtol 1e-5."""
    from plangen_tpu.ops.quant import quantize_lm_params
    from plangen_tpu_torch.convert.from_jax import load_jax_quantized_params

    cfg = CONFIGS.get(name, TINY_7B)
    params = _lora_params(name)
    if path == "int8_cache":
        params = quantize_lm_params(params)
        model = PlanGenModel(cfg, dtype=torch.float32)
        load_jax_quantized_params(model, _np_tree(params), cfg)
    else:
        model = _model(name, params)
    assert tlora.has_lora(model)
    lm = params["language_model"]
    rs = np.random.RandomState(4)
    B, Q, S = 2, 7, 128
    x = rs.randn(B, Q, cfg.llama.hidden_size).astype(np.float32)
    mask = np.ones((B, Q), np.int32)
    mask[1, :2] = 0
    if path == "no_cache":
        want, _ = jllama.forward(lm, cfg.llama, jnp.asarray(x), jnp.asarray(mask))
        with torch.no_grad():
            got = model.language_model(torch.from_numpy(x), torch.from_numpy(mask))
        _close(got, want)
        return
    full = np.concatenate([mask, np.ones((B, S - Q), np.int32)], axis=1)
    step = rs.randn(B, 1, cfg.llama.hidden_size).astype(np.float32)
    jcache = jinit_kv_cache(cfg.llama, B, S, dtype=jnp.float32)
    want_p, jcache = jllama.forward(lm, cfg.llama, jnp.asarray(x), jnp.asarray(full),
                                    positions=jnp.arange(Q, dtype=jnp.int32), kv_cache=jcache)
    want_s, _ = jllama.forward(lm, cfg.llama, jnp.asarray(step), jnp.asarray(full),
                               positions=jnp.array([Q], jnp.int32), kv_cache=jcache)
    cache = init_kv_cache(cfg.llama, B, S, dtype=torch.float32)
    tm = torch.from_numpy(full)
    with torch.no_grad():
        got_p = model.language_model(torch.from_numpy(x), tm,
                                     torch.arange(Q, dtype=torch.int32), cache)
        got_s = model.language_model(torch.from_numpy(step), tm,
                                     torch.tensor([Q], dtype=torch.int32), cache)
    _close(got_p, want_p)
    _close(got_s, want_s)


def test_merge_lora_matches_jax_and_the_adapter_forward():
    """The port's merge_lora of a model: every weight within 1e-6 of JAX's
    merge_lora, the adapters gone, and the merged forward within 1e-5 of the
    adapter forward."""
    cfg = TINY
    params = _lora_params("tiny")
    model = _model("tiny", params)
    x, mask = torch.randn(2, 6, cfg.llama.hidden_size), torch.ones(2, 6, dtype=torch.int32)
    with torch.no_grad():
        adapted = model.language_model(x, mask)
        tlora.merge_lora(model)
        merged = model.language_model(x, mask)
    assert not tlora.has_lora(model)
    assert not any(".lora." in n or "lora_scaling" in n for n, _ in model.named_parameters())
    want = export_state_dict(_np_tree(jlora.merge_lora(params)), cfg)
    sd = model.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        _close(sd[k], v, msg=k, atol=1e-6, rtol=1e-6)
    _close(merged, adapted)


def test_merge_lora_refuses_a_quantized_projection():
    from plangen_tpu_torch.ops.quant import quantize_model_

    model = quantize_model_(_model("tiny", _lora_params("tiny")), "int8")
    with pytest.raises(ValueError, match="quantized"):
        tlora.merge_lora(model)


def test_lora_two_train_steps_match_jax():
    """Two train steps in the 'lora_tokens' mode at tiny (fp32): the
    losses of both steps and the gradients each step hands its optimizer
    (the adapters and the token embeddings only) against JAX's, atol/rtol
    1e-5 (the token embeddings' rtol 1e-4: a scatter-add over the batch's
    tokens, summed in another order); every base weight bit-for-bit
    unchanged."""
    cfg = TINY
    params = _lora_params("tiny")
    tcfg = TrainConfig()
    tx, jmask = joptim.make_optimizer(tcfg.optim, params, "lora_tokens")
    jstep_fn = jstep.make_train_step(cfg, tcfg, tx, PAD, FLOWS, compute_dtype=jnp.float32,
                                     donate=False, trainable_mask=jmask)
    jgrad_fn = jax.grad(jstep.make_loss_fn(cfg, tcfg, PAD, FLOWS, compute_dtype=jnp.float32,
                                           trainable_mask=jmask), has_aux=True)
    jstate = jstep.init_train_state(params, tx)
    model = _model("tiny", params)
    opt, mask = toptim.make_optimizer(tcfg.optim, model, "lora_tokens")
    assert toptim.count_params(model, mask) == joptim.count_params(params, jmask)
    step_fn = tstep.make_train_step(cfg, tcfg, PAD, FLOWS, compute_dtype=torch.float32,
                                    trainable_mask=mask)
    state = tstep.init_train_state(model, opt)
    base = {n: p.detach().clone() for n, p in model.named_parameters() if not mask[n]}
    seen = []
    real_step = opt.step
    opt.step = lambda grads: (seen.append({n: g.clone() for n, g in grads.items()
                                           if g is not None}), real_step(grads))
    batches = make_batches(cfg, left_pads=True)
    for i in range(2):
        jg = _named(jgrad_fn(jstate.params, _jax(batches))[0], cfg)
        jstate, jm = jstep_fn(jstate, _jax(batches))
        state, m = step_fn(state, _torch(batches))
        for k in jm:
            _close(m[k], jm[k], msg=f"step {i}: {k}")
        assert sorted(seen[i]) == sorted(n for n in mask if mask[n])
        for n, g in seen[i].items():  # the embeddings' scatter-add sums in another order
            tol = dict(atol=1e-5, rtol=1e-4) if "embed_tokens" in n else {}
            _close(g, jg[n], msg=f"step {i}: {n}", **tol)
    for n, p in model.named_parameters():
        if n in base:
            assert torch.equal(p, base[n]), n


# -------------------------------------------------------------------- Trainer


def _options_config(tmp_path, **train):
    from test_torch_train import _toy_config

    return _toy_config(tmp_path, **{
        "tuning_mode": "lora", "lora_rank": RANK, "lora_alpha": ALPHA,
        "master_dtype": "bfloat16", "optim.optimizer": "adafactor",
        "optim.gradient_accumulation_steps": 2, "gradient_checkpointing": True,
        "remat_policy": "dots", "fused_lm_ce": True, **train})


def test_trainer_options_fit_save_and_resume(tmp_path):
    """Adafactor + accumulation 2 + LoRA + bf16 masters + remat + fused CE:
    fit(3) saves at step 2 (an update) and 3 (mid-accumulation); a new
    Trainer resumes at 3 with equal weights, adapters, Adafactor statistics,
    running mean and micro-step, and takes step 4, the second update. Only
    the adapters and the token embeddings change; the masters stay bf16."""
    from plangen_tpu_torch.train.trainer import Trainer

    cfg = _options_config(tmp_path)
    t1 = Trainer(cfg, device="cpu")
    assert t1.tuning_mode == "lora_tokens" and tlora.has_lora(t1.model)
    assert all(p.dtype == torch.bfloat16 for p in t1.model.parameters())
    assert isinstance(t1.state.opt, toptim.Accumulate)
    start = {n: p.detach().clone() for n, p in t1.model.named_parameters()}
    m = t1.fit(max_steps=3)
    assert np.isfinite(m["loss"]) and t1.ckpt.all_steps() == [2, 3]
    assert t1.state.opt.mini_step == 1 and t1.state.opt.count == 1
    for n, p in t1.model.named_parameters():
        if not t1.mask[n]:
            assert torch.equal(p, start[n]), n
    assert not torch.equal(t1.model.language_model.model.embed_tokens.weight,
                           start["language_model.model.embed_tokens.weight"])

    t2 = Trainer(cfg, device="cpu")
    assert t2.maybe_resume() == 3 and t2.state.step == 3
    assert t2.state.opt.mini_step == 1 and t2.state.opt.count == 1
    for (k, a), b in zip(t1.model.state_dict().items(), t2.model.state_dict().values()):
        assert torch.equal(a, b), k
    o1, o2 = t1.state.opt, t2.state.opt
    for name in ("v_row", "v_col", "v"):
        for k, v in getattr(o1.inner, name).items():
            assert torch.equal(v, getattr(o2.inner, name)[k]), (name, k)
    for k, v in o1.acc.items():
        assert torch.equal(v, o2.acc[k]), k
    t2.fit(max_steps=4)
    assert t2.state.opt.count == 2 and t2.state.opt.mini_step == 0


def test_cli_train_with_the_lora_mode(tmp_path, capsys):
    from plangen_tpu_torch import cli

    cli.main(["train", "--device", "cpu", "--cfg", "configs/toy_smoke.py", "--max-steps", "1",
              "--opt", f"train.output_dir={tmp_path}", "train.tuning_mode=lora",
              "train.lora_rank=4", "train.optim.optimizer=adafactor",
              "train.master_dtype=bfloat16",
              'train.train_data=[{"task_type":"uni","data_name":"toy","batch_size":2}]'])
    out = capsys.readouterr().out
    assert "tuning_mode=lora" in out
