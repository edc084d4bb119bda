"""The port's training slice against the JAX package, same weights, fp32.

Parameters come from `vlm.init(PRNGKey(0), cfg, float32)` and reach the port
through `load_jax_params`; batches come from numpy seeds. The JAX side runs
the Pallas flash kernel in interpret mode, as tests/test_models.py does.
Tolerances: losses and gradients atol/rtol 1e-5 (fp32 on both sides; only
summation order differs), AdamW updates atol 1e-7 against optax.

`tiny` runs the LLaMA attention on the bias path (head_dim 16) and SigLIP
through the flash branch; `tiny_hd128` (head_dim 128, SigLIP head_dim 64) also
sends the LLaMA attention through the flash branch on both sides.
"""

import functools
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from plangen_tpu.config import (
    FlowConfig, OptimConfig, PlanGenConfig, PlanGenModelConfig, TrainConfig, apply_overrides,
)
from plangen_tpu.convert.jax_to_torch import export_state_dict
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.ops import pallas_attention
from plangen_tpu.train import loss as jloss
from plangen_tpu.train import optim as joptim
from plangen_tpu.train import step as jstep
from plangen_tpu_torch.convert import load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops import flash_attention as tfa
from plangen_tpu_torch.train import loss as tloss
from plangen_tpu_torch.train import optim as toptim
from plangen_tpu_torch.train import step as tstep

TOL = dict(atol=1e-5, rtol=1e-5)
PAD = 2
FLOWS = ((0, "uni"), (1, "mmu"), (2, "plan"))
TINY = PlanGenModelConfig.tiny()
TINY_HD128 = replace(
    TINY,
    llama=replace(TINY.llama, num_heads=2, num_kv_heads=1, head_dim=128, hidden_size=256,
                  intermediate_size=256),
    vision=replace(TINY.vision, width=128, heads=2),
    aligner=replace(TINY.aligner, input_dim=128, n_embed=256),
    gen_aligner=replace(TINY.gen_aligner, n_embed=256),
)
CONFIGS = {"tiny": TINY, "tiny_hd128": TINY_HD128}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(pallas_attention, "flash_attention",
                        functools.partial(pallas_attention.flash_attention, interpret=True))


@functools.lru_cache(maxsize=None)
def _params(name):
    return jvlm.init(jax.random.PRNGKey(0), CONFIGS[name], dtype=jnp.float32)


def _port_model(name):
    cfg = CONFIGS[name]
    model = PlanGenModel(cfg, dtype=torch.float32)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, _params(name)), cfg)
    return model


def make_batches(cfg, left_pads=True, B=2, L=8, seed=0):
    """numpy batches of the three flows; with `left_pads`, row 1 of the uni
    and plan flows is left-padded."""
    rs = np.random.RandomState(seed)
    n, size = cfg.image_seq_len, cfg.vision.image_size
    ids = rs.randint(3, 100, size=(B, L)).astype(np.int32)
    img = rs.uniform(-1, 1, size=(B, size, size, 3)).astype(np.float32)
    seq_mask = np.zeros((B, L), dtype=bool)
    seq_mask[:, 1:1 + n] = True
    text_mask = np.ones((B, L), dtype=np.int32)
    padded_ids = ids.copy()
    if left_pads:
        text_mask[1, :3] = 0
        padded_ids[1, :3] = PAD
    return {
        0: {"input_ids": padded_ids,
            "attn_mask": np.concatenate([text_mask, np.ones((B, n), np.int32)], axis=1),
            "images": img,
            "edit_region": (rs.uniform(size=(B, n)) > 0.5).astype(np.int32)},
        1: {"input_ids": ids, "attn_mask": np.ones((B, L), np.int32), "images": img,
            "images_seq_mask": seq_mask},
        2: {"input_ids": padded_ids, "attn_mask": text_mask},
    }


def _jax(batches):
    return jax.tree_util.tree_map(jnp.asarray, batches)


def _torch(batches):
    return {f: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
            for f, b in batches.items()}


def _close(a, b, msg="", **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               err_msg=msg, **(tol or TOL))


# ------------------------------------------------------------------ losses


def test_shift_cross_entropy_matches_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(3, 7, 11).astype(np.float32)
    labels = rs.randint(0, 11, size=(3, 7))
    labels[1, :4] = PAD
    want = jloss.shift_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), PAD)
    got = tloss.shift_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), PAD)
    _close(got, want)
    all_pad = np.full((2, 5), PAD)
    assert float(tloss.shift_cross_entropy(torch.zeros(2, 5, 4),
                                           torch.from_numpy(all_pad), PAD)) == 0.0


@pytest.mark.parametrize("case", ["uni", "t2i", "uni_edit_region", "mmu", "plan"])
@pytest.mark.parametrize("use_flash", [False, True], ids=["bias", "flash"])
def test_each_loss_matches_jax(case, use_flash):
    cfg, params, model = TINY, _params("tiny"), _port_model("tiny")
    jb, tb = _jax(make_batches(cfg)), _torch(make_batches(cfg))
    if case.startswith(("uni", "t2i")):
        region = "edit_region" if case == "uni_edit_region" else None
        b, c = jb[0], tb[0]
        want = jloss.t2i_loss(params, cfg, b["input_ids"], b["attn_mask"], b["images"], PAD,
                              is_uni=case != "t2i",
                              local_edit_region=b[region] if region else None,
                              use_flash=use_flash)
        got = tloss.t2i_loss(model, c["input_ids"], c["attn_mask"], c["images"], PAD,
                             is_uni=case != "t2i",
                             local_edit_region=c[region] if region else None,
                             use_flash=use_flash)
    elif case == "mmu":
        b, c = jb[1], tb[1]
        want = jloss.mmu_loss(params, cfg, b["input_ids"], b["attn_mask"], b["images"],
                              b["images_seq_mask"], PAD, use_flash=use_flash)
        got = tloss.mmu_loss(model, c["input_ids"], c["attn_mask"], c["images"],
                             c["images_seq_mask"], PAD, use_flash=use_flash)
    else:
        b, c = jb[2], tb[2]
        want = jloss.plan_loss(params, cfg, b["input_ids"], b["attn_mask"], PAD,
                               use_flash=use_flash)
        got = tloss.plan_loss(model, c["input_ids"], c["attn_mask"], PAD, use_flash=use_flash)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].detach(), want[k], msg=k)


# ------------------------------------------------------------- the optimizer


def _hf_mask(params, cfg, mode):
    """JAX's trainable mask, by HF name."""
    mask = joptim.trainable_mask(params, mode)
    as_arrays = jax.tree_util.tree_map(
        lambda p, m: np.full(p.shape, 1.0 if m else 0.0, np.float32), params, mask)
    sd = export_state_dict(as_arrays, cfg)
    flags = {}
    for k, v in sd.items():
        assert v.min() == v.max(), k
        flags[k] = bool(v.max() > 0)
    return flags


@pytest.mark.parametrize("mode", ["all", "lm", "stage1", "stage2", "stage3"])
def test_trainable_set_per_mode_matches_jax(mode):
    params, model = _params("tiny"), _port_model("tiny")
    want = _hf_mask(params, TINY, mode)
    got = toptim.trainable_mask(model, mode)
    assert got == want
    counts = toptim.count_params(model, got)
    jcounts = joptim.count_params(params, joptim.trainable_mask(params, mode))
    assert counts == jcounts


@pytest.mark.parametrize("mode", ["lora", "lora_tokens"])
def test_lora_modes_raise(mode):
    with pytest.raises(NotImplementedError):
        toptim.trainable_mask(_port_model("tiny"), mode)


@pytest.mark.parametrize("optim", [
    dict(),
    dict(lr_warmup_steps=2),
    dict(lr_scheduler="cosine", lr_warmup_steps=1),
    dict(lr_scheduler="cosine"),
], ids=["constant", "warmup", "cosine_warmup", "cosine"])
def test_lr_schedule_matches_optax(optim):
    cfg = OptimConfig(**optim)
    want = joptim.make_lr_schedule(cfg)
    got = toptim.make_lr_schedule(cfg)
    for step in (0, 1, 2, 3, 10, 999_999, 1_000_001):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("optim", [
    dict(learning_rate=1e-3),
    dict(learning_rate=1e-3, lr_warmup_steps=2),
    dict(learning_rate=1e-3, lr_scheduler="cosine", lr_warmup_steps=1, adam_weight_decay=0.1),
], ids=["constant", "warmup", "cosine"])
def test_adamw_with_clip_matches_optax(optim, grad_scale):
    """Three updates from the same gradients: the port's AdamW against the
    JAX package's optax chain (mask, clip, adamw, set_to_zero), stage3."""
    cfg = OptimConfig(**optim)
    params = _params("tiny")
    tx, jmask = joptim.make_optimizer(cfg, params, "stage3")
    opt_state = tx.init(params)
    model = _port_model("tiny")
    opt, mask = toptim.make_optimizer(cfg, model, "stage3")
    rs = np.random.RandomState(7)
    jp = params
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32) * grad_scale), jp)
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        want = export_state_dict(jax.tree_util.tree_map(np.asarray, updates), TINY)
        tgrads = {k: torch.from_numpy(np.array(v)) for k, v in _grads_by_name(grads, TINY).items()}
        if i < 2:
            opt.step(tgrads)
            continue
        got = {}
        with torch.no_grad():
            for name, p, u in opt.updates(tgrads):
                got[name] = u.clone()
                p.add_(u)
        for name, u in want.items():
            if mask[name]:
                _close(got[name], u, msg=name, atol=1e-7, rtol=0)
            else:
                assert name.startswith("gen_vision_model") and not np.any(u), name
    assert opt.count == 3
    want = export_state_dict(jax.tree_util.tree_map(np.asarray, jp), TINY)
    for name, p in model.named_parameters():  # the updates' 1e-7, or an ulp of p
        _close(p.detach(), want[name], msg=name, atol=1e-7, rtol=2.4e-7)


def test_unported_optimizer_options_raise():
    model = _port_model("tiny")
    with pytest.raises(NotImplementedError):
        toptim.make_optimizer(OptimConfig(optimizer="adafactor"), model)
    with pytest.raises(NotImplementedError):
        toptim.make_optimizer(OptimConfig(gradient_accumulation_steps=2), model)
    with pytest.raises(ValueError):
        toptim.make_optimizer(OptimConfig(optimizer="sgd"), model)


# ------------------------------------------------------ the slice as a whole


def _grads_by_name(grads, cfg):
    return export_state_dict(jax.tree_util.tree_map(np.asarray, grads), cfg)


@pytest.mark.parametrize("name,left_pads", [
    ("tiny", True), ("tiny_hd128", False), ("tiny_hd128", True),
], ids=["tiny", "tiny_hd128", "tiny_hd128_left_pads"])
def test_loss_and_gradients_match_jax(name, left_pads):
    """The weighted multi-flow loss and the gradient of every parameter.
    Rows with no allowed key (left pads) follow the JAX package's XLA path
    (see ops/flash_attention.py), so with left pads the JAX side runs that
    path for the LLaMA stack; without them, the Pallas kernel."""
    cfg, params = CONFIGS[name], _params(name)
    tcfg = TrainConfig(use_flash_attention=True, loss_scales={"loss_mmu_1": 0.5},
                       plan_lr_scale=0.7)
    jcfg = replace(tcfg, use_flash_attention=not (left_pads and name == "tiny_hd128"))
    _, jmask = joptim.make_optimizer(tcfg.optim, params, "stage3")
    jloss_fn = jstep.make_loss_fn(cfg, jcfg, PAD, FLOWS, compute_dtype=jnp.float32,
                                  trainable_mask=jmask)
    batches = make_batches(cfg, left_pads=left_pads)
    (want, want_ld), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        params, _jax(batches))

    model = _port_model(name)
    mask = toptim.trainable_mask(model, "stage3")
    loss_fn = tstep.make_loss_fn(cfg, tcfg, PAD, FLOWS, compute_dtype=torch.float32,
                                 trainable_mask=mask)
    calls = tfa.flash_attention_reference.calls
    got, got_ld = loss_fn(model, _torch(batches))
    got.backward()
    n_flash = cfg.vision.layers + (3 * cfg.llama.num_layers if name == "tiny_hd128" else 0)
    assert tfa.flash_attention_reference.calls - calls == n_flash
    _close(got.detach(), want)
    for k in want_ld:
        _close(got_ld[k].detach(), want_ld[k], msg=k)
    jg = _grads_by_name(jgrads, cfg)
    for pname, p in model.named_parameters():
        if mask[pname]:
            _close(p.grad, jg[pname], msg=pname)
        else:
            assert p.grad is None and not np.any(jg[pname]), pname


@pytest.mark.parametrize("name", ["tiny", "tiny_hd128"])
def test_two_train_steps_match_jax(name):
    """Two `train_step`s (stage3, fp32 compute, the recipe's AdamW): the
    losses of both steps and the gradients each step hands its optimizer,
    against JAX's `make_train_step` and the gradient of its loss at the same
    state. (Adam turns a gradient at rounding-noise level into an update of
    up to lr, so the two trajectories part by about lr times that noise.)"""
    cfg, params = CONFIGS[name], _params(name)
    tcfg = TrainConfig(use_flash_attention=True)
    tx, jmask = joptim.make_optimizer(tcfg.optim, params, "stage3")
    jstep_fn = jstep.make_train_step(cfg, tcfg, tx, PAD, FLOWS, compute_dtype=jnp.float32,
                                     donate=False, trainable_mask=jmask)
    jgrad_fn = jax.grad(jstep.make_loss_fn(cfg, tcfg, PAD, FLOWS, compute_dtype=jnp.float32,
                                           trainable_mask=jmask), has_aux=True)
    jstate = jstep.init_train_state(params, tx)
    model = _port_model(name)
    opt, mask = toptim.make_optimizer(tcfg.optim, model, "stage3")
    step_fn = tstep.make_train_step(cfg, tcfg, PAD, FLOWS, compute_dtype=torch.float32,
                                    trainable_mask=mask)
    state = tstep.init_train_state(model, opt)
    seen = []
    real_step = opt.step
    opt.step = lambda grads: (seen.append({n: g.clone() for n, g in grads.items()
                                           if g is not None}), real_step(grads))
    batches = make_batches(cfg, left_pads=name == "tiny")
    for i in range(2):
        jg = _grads_by_name(jgrad_fn(jstate.params, _jax(batches))[0], cfg)
        jstate, jm = jstep_fn(jstate, _jax(batches))
        state, m = step_fn(state, _torch(batches))
        assert sorted(m) == sorted(jm)
        for k in jm:
            _close(m[k], jm[k], msg=f"step {i}: {k}")
        assert sorted(seen[i]) == sorted(n for n in jg if mask[n])
        for pname, g in seen[i].items():
            _close(g, jg[pname], msg=f"step {i}: {pname}")
    assert state.step == 2 and opt.count == 2


def test_bf16_compute_casts_trainable_differentiably_and_frozen_detached():
    """bf16 compute: the gradient lands on the fp32 masters in fp32, frozen
    masters get none, and the loss is within bf16 reach of the fp32 one."""
    model = _port_model("tiny")
    mask = toptim.trainable_mask(model, "stage3")
    batches = _torch(make_batches(TINY))
    tcfg = TrainConfig()
    loss16, _ = tstep.make_loss_fn(TINY, tcfg, PAD, FLOWS, trainable_mask=mask)(model, batches)
    loss16.backward()
    for pname, p in model.named_parameters():
        assert p.dtype == torch.float32
        if mask[pname]:
            assert p.grad is not None and p.grad.dtype == torch.float32, pname
        else:
            assert p.grad is None, pname
    with torch.no_grad():
        loss32, _ = tstep.make_loss_fn(TINY, tcfg, PAD, FLOWS, compute_dtype=torch.float32,
                                       trainable_mask=mask)(model, batches)
    np.testing.assert_allclose(float(loss16), float(loss32), rtol=2e-2)


@pytest.mark.parametrize("option", ["gradient_checkpointing", "fused_lm_ce"])
def test_unported_step_options_raise(option):
    with pytest.raises(NotImplementedError):
        tstep.make_loss_fn(TINY, TrainConfig(**{option: True}), PAD, FLOWS)


# ------------------------------------------------------------------ Trainer


def _toy_config(tmp_path, **train):
    return apply_overrides(PlanGenConfig(model=TINY, janus_hw=32), {
        "train.train_data": (FlowConfig("uni", "toy", 2), FlowConfig("mmu", "toy", 2),
                             FlowConfig("plan", "toy", 2)),
        "train.output_dir": str(tmp_path / "run"),
        "train.checkpointing_steps": 2,
        "train.num_workers": 0,
        "train.prefetch_depth": 0,
        "train.use_flash_attention": True,
        **{f"train.{k}": v for k, v in train.items()},
    })


def test_trainer_fit_save_and_resume(tmp_path):
    """fit(2) logs finite losses, saves step 2 (FIFO-limited), leaves the VQ
    untouched; a new Trainer resumes at step 2 with equal weights and
    moments and trains on to step 3."""
    from plangen_tpu_torch.train.trainer import Trainer

    cfg = _toy_config(tmp_path, checkpoints_total_limit=1)
    t1 = Trainer(cfg, device="cpu")
    vq = {k: v.clone() for k, v in t1.model.gen_vision_model.state_dict().items()}
    lm0 = t1.model.language_model.lm_head.weight.detach().clone()
    m = t1.fit(max_steps=2)
    assert np.isfinite(m["loss"]) and t1.ckpt.all_steps() == [2]
    for k, v in t1.model.gen_vision_model.state_dict().items():
        torch.testing.assert_close(v, vq[k], rtol=0, atol=0)
    assert not torch.equal(t1.model.language_model.lm_head.weight, lm0)
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and "loss_mmu_1" in lines[0]
    assert (tmp_path / "run" / "params.jsonl").read_text().count("\n") == sum(t1.mask.values())

    t2 = Trainer(cfg, device="cpu")
    assert t2.maybe_resume() == 2 and t2.state.step == 2 and t2.state.opt.count == 2
    for (k, a), b in zip(t1.model.state_dict().items(), t2.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    for k, mu in t1.state.opt.mu.items():
        torch.testing.assert_close(mu, t2.state.opt.mu[k], rtol=0, atol=0)
    t2.fit(max_steps=3)
    assert t2.ckpt.all_steps() == [3]


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without `device` the Trainer takes the card, and raises when there is
    none; with device="cpu" it trains there."""
    from plangen_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_toy_config(tmp_path))
    t = Trainer(_toy_config(tmp_path), device="cpu")
    assert t.device.type == "cpu" and next(t.model.parameters()).device.type == "cpu"
    assert np.isfinite(t.fit(max_steps=1)["loss"])


def test_trainer_nonfinite_loss_checkpoints_and_raises(tmp_path):
    from plangen_tpu_torch.train.trainer import Trainer

    t = Trainer(_toy_config(tmp_path), device="cpu")
    real_step = t.step_fn

    def poisoned(state, batches):
        state, metrics = real_step(state, batches)
        metrics["loss"] = torch.tensor(float("nan"))
        return state, metrics

    t.step_fn = poisoned
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        t.fit(max_steps=1)
    assert t.ckpt.latest_step() == 1


@pytest.mark.parametrize("override", [
    {"train.gradient_checkpointing": True},
    {"train.fsdp": True},
    {"train.mesh_shape": {"data": 2, "model": 1}},
    {"train.tuning_mode": "lora"},
    {"train.master_dtype": "bfloat16"},
    {"train.fused_lm_ce": True},
    {"params_path": "weights"},
], ids=lambda o: next(iter(o)))
def test_trainer_unported_options_raise(tmp_path, override):
    from plangen_tpu_torch.train.trainer import Trainer

    cfg = apply_overrides(_toy_config(tmp_path), override)
    with pytest.raises(NotImplementedError):
        Trainer(cfg, device="cpu").fit(max_steps=1)


def test_trainer_unknown_dataset_raises(tmp_path):
    """An unknown flow name raises KeyError, as the JAX registry does (the
    real datasets are ported: tests/test_torch_datasets.py)."""
    from plangen_tpu_torch.train.trainer import Trainer

    cfg = apply_overrides(_toy_config(tmp_path),
                          {"train.train_data": (FlowConfig("uni", "layoutsam", 2),)})
    with pytest.raises(KeyError, match="unknown dataset"):
        Trainer(cfg, device="cpu").fit(max_steps=1)
