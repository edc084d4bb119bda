"""The port's model modules against the JAX package, same weights, fp32.

Parameters come from `vlm.init(PRNGKey(0), cfg, float32)` and reach the port
through `load_jax_params`; inputs come from numpy seeds. Tolerance atol 1e-5
/ rtol 1e-5 (fp32 on both sides; only summation order differs), except the
VQ decoder's deep conv stack (atol 1e-4) and its uint8 output (equal up to
one level: truncation at a level boundary can fall either way). One bf16
check holds a prefill plus a decode step to rtol 2e-2 of JAX bf16.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu.models import llama as jllama
from plangen_tpu.models import projector as jproj
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.models import vq as jvq
from plangen_tpu.runtime.kvcache import init_kv_cache as jinit_kv_cache
from plangen_tpu_torch.convert import init_params, load_jax_params
from plangen_tpu_torch.convert.from_jax import SKIPPED_PREFIXES
from plangen_tpu_torch.models import llama as tllama
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.runtime.kvcache import init_kv_cache

TOL = dict(atol=1e-5, rtol=1e-5)
CONFIGS = {"tiny": PlanGenModelConfig.tiny(), "tiny_7b": PlanGenModelConfig.tiny_7b()}


@functools.lru_cache(maxsize=None)
def _load(name):
    cfg = CONFIGS[name]
    params = jvlm.init(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    model = PlanGenModel(cfg, dtype=torch.float32)
    skipped = load_jax_params(model, params, cfg)
    return cfg, params, model.eval(), skipped


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return _load(request.param)[:3]


def _np(t):
    return t.detach().float().numpy()


def _left_padded_batch(cfg, rs, B=3, Q=9):
    x = rs.randn(B, Q, cfg.llama.hidden_size).astype(np.float32)
    mask = np.ones((B, Q), dtype=np.int32)
    # left pads of 0, 3, 5, ... slots: positions stay absolute (HF
    # cache_position), so padded rows see shifted RoPE phases
    for r in range(B):
        mask[r, :(0, 3, 5)[r % 3]] = 0
    return x, mask


def test_rms_norm(pair):
    cfg, params, model = pair
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, cfg.llama.hidden_size).astype(np.float32)
    w = rs.randn(cfg.llama.hidden_size).astype(np.float32)
    want = jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), cfg.llama.rms_norm_eps)
    got = tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), cfg.llama.rms_norm_eps)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_rope(pair):
    cfg, _, _ = pair
    rs = np.random.RandomState(2)
    D = cfg.llama.head_dim
    pos = np.array([0, 3, 17, 400], dtype=np.int32)
    x = rs.randn(2, len(pos), cfg.llama.num_heads, D).astype(np.float32)
    jc, js = jllama.rope_cos_sin(jnp.asarray(pos), D, cfg.llama.rope_theta)
    tc, ts = tllama.rope_cos_sin(torch.from_numpy(pos), D, cfg.llama.rope_theta)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)
    want = jllama.apply_rope(jnp.asarray(x), jc, js)
    got = tllama.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_mlp_block(pair):
    cfg, params, model = pair
    rs = np.random.RandomState(3)
    x = rs.randn(2, 4, cfg.llama.hidden_size).astype(np.float32)
    lp = jllama.index_layer_params(params["language_model"]["layers"], 1)
    want = jllama.mlp_block(lp, jnp.asarray(x))
    got = model.language_model.model.layers[1].mlp(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_llama_forward_no_cache_left_padded(pair):
    cfg, params, model = pair
    x, mask = _left_padded_batch(cfg, np.random.RandomState(4))
    want, _ = jllama.forward(params["language_model"], cfg.llama,
                             jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = model.language_model(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_llama_prefill_with_cache_left_padded(pair):
    cfg, params, model = pair
    x, mask = _left_padded_batch(cfg, np.random.RandomState(5))
    B, Q, _ = x.shape
    S = 128
    full_mask = np.concatenate([mask, np.ones((B, S - Q), np.int32)], axis=1)
    jcache = jinit_kv_cache(cfg.llama, B, S, dtype=jnp.float32)
    want, jcache = jllama.forward(
        params["language_model"], cfg.llama, jnp.asarray(x),
        jnp.asarray(full_mask), positions=jnp.arange(Q, dtype=jnp.int32),
        kv_cache=jcache,
    )
    cache = init_kv_cache(cfg.llama, B, S, dtype=torch.float32)
    with torch.no_grad():
        got = model.language_model(
            torch.from_numpy(x), torch.from_numpy(full_mask),
            torch.arange(Q, dtype=torch.int32), cache,
        )
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]), **TOL)


def test_llama_decode_step_through_prefix_kernel(pair):
    """A cached decode step (Q = 1, the prefix kernel's plain version on the
    CPU) matches the JAX cached step (XLA full-buffer attention)."""
    cfg, params, model = pair
    rs = np.random.RandomState(6)
    x, mask = _left_padded_batch(cfg, rs)
    B, Q, hidden = x.shape
    S = 128
    full_mask = np.concatenate([mask, np.ones((B, S - Q), np.int32)], axis=1)
    step = rs.randn(B, 1, hidden).astype(np.float32)
    jcache = jinit_kv_cache(cfg.llama, B, S, dtype=jnp.float32)
    lm = params["language_model"]
    _, jcache = jllama.forward(lm, cfg.llama, jnp.asarray(x), jnp.asarray(full_mask),
                               positions=jnp.arange(Q, dtype=jnp.int32), kv_cache=jcache)
    want, _ = jllama.forward(lm, cfg.llama, jnp.asarray(step), jnp.asarray(full_mask),
                             positions=jnp.array([Q], jnp.int32), kv_cache=jcache)
    cache = init_kv_cache(cfg.llama, B, S, dtype=torch.float32)
    tm = torch.from_numpy(full_mask)
    with torch.no_grad():
        model.language_model(torch.from_numpy(x), tm, torch.arange(Q, dtype=torch.int32), cache)
        got = model.language_model(torch.from_numpy(step), tm,
                                   torch.tensor([Q], dtype=torch.int32), cache)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_projector_and_gen_head(pair):
    cfg, params, model = pair
    rs = np.random.RandomState(7)
    codes = rs.randn(3, 2, cfg.gen_embed_dim).astype(np.float32)
    want = jproj.forward(params["gen_aligner"], jnp.asarray(codes))
    got = model.gen_aligner(torch.from_numpy(codes))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    hidden = rs.randn(3, cfg.llama.hidden_size).astype(np.float32)
    want = jproj.gen_head_forward(params["gen_head"], jnp.asarray(hidden))
    got = model.image_gen_logits(torch.from_numpy(hidden))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_lm_head(pair):
    cfg, params, model = pair
    hidden = np.random.RandomState(12).randn(2, 3, cfg.llama.hidden_size).astype(np.float32)
    want = jllama.lm_head(params["language_model"], jnp.asarray(hidden))
    got = model.language_model.logits(torch.from_numpy(hidden))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_gen_img_embeds_and_embed_text(pair):
    cfg, params, model = pair
    rs = np.random.RandomState(8)
    ids = rs.randint(0, cfg.image_token_size, size=(4, 1))
    want = jvlm.gen_img_embeds(params, jnp.asarray(ids))
    got = model.gen_img_embeds(torch.from_numpy(ids))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    text = rs.randint(0, cfg.llama.vocab_size, size=(2, 6))
    np.testing.assert_array_equal(
        _np(model.embed_text(torch.from_numpy(text))),
        np.asarray(jvlm.embed_text(params, jnp.asarray(text))),
    )


def test_bf16_prefill_and_decode_step_logits():
    """bf16 on both sides: one prefill plus one decode step; the gen-head
    logits agree within rtol 2e-2 of their scale (the rounding points of
    rms_norm, RoPE, attention and gen_head are mirrored)."""
    cfg, params32, _, _ = _load("tiny")
    # the init values rounded to bf16, as vlm.init(..., dtype=bfloat16) makes
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params32)
    model = PlanGenModel(cfg, dtype=torch.bfloat16)
    load_jax_params(model, params, cfg)
    rs = np.random.RandomState(9)
    x, mask = _left_padded_batch(cfg, rs, B=2)
    B, Q, hidden = x.shape
    S = 128
    full_mask = np.concatenate([mask, np.ones((B, S - Q), np.int32)], axis=1)
    step = rs.randn(B, 1, hidden).astype(np.float32)
    lm = params["language_model"]
    jcache = jinit_kv_cache(cfg.llama, B, S, dtype=jnp.bfloat16)
    _, jcache = jllama.forward(lm, cfg.llama, jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(full_mask),
                               positions=jnp.arange(Q, dtype=jnp.int32), kv_cache=jcache)
    jh, _ = jllama.forward(lm, cfg.llama, jnp.asarray(step, jnp.bfloat16),
                           jnp.asarray(full_mask), positions=jnp.array([Q], jnp.int32),
                           kv_cache=jcache)
    want = np.asarray(jvlm.image_gen_logits(params, jh[:, -1]))

    cache = init_kv_cache(cfg.llama, B, S, dtype=torch.bfloat16)
    tm = torch.from_numpy(full_mask)
    with torch.no_grad():
        model.language_model(torch.from_numpy(x).bfloat16(), tm,
                             torch.arange(Q, dtype=torch.int32), cache)
        th = model.language_model(torch.from_numpy(step).bfloat16(), tm,
                                  torch.tensor([Q], dtype=torch.int32), cache)
        got = _np(model.image_gen_logits(th[:, -1]))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=2e-2)


# --------------------------------------------------------------- weights


def test_load_jax_params_skips_only_later_slices():
    """Every exported key loads strictly: no module is left for a later
    slice, SigLIP, the understanding aligner and the VQ encoder included."""
    cfg, params, model, skipped = _load("tiny")
    assert SKIPPED_PREFIXES == () and skipped == []
    from plangen_tpu.convert.jax_to_torch import export_state_dict

    exported = export_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    assert set(exported) == set(model.state_dict())
    for key in ("gen_vision_model.quant_conv.weight", "vision_model.vision_tower.pos_embed",
                "aligner.layers.0.weight", "gen_vision_model.encoder.conv_in.weight"):
        assert key in exported, key
        np.testing.assert_array_equal(_np(model.state_dict()[key]), exported[key])
    np.testing.assert_array_equal(
        _np(model.language_model.model.layers[1].self_attn.q_proj.weight),
        np.asarray(params["language_model"]["layers"]["q_proj"][1]).T,
    )


def test_init_params_seeded_scales():
    cfg = CONFIGS["tiny"]
    a = init_params(PlanGenModel(cfg, dtype=torch.float32),
                    torch.Generator().manual_seed(3))
    b = init_params(PlanGenModel(cfg, dtype=torch.float32),
                    torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    q = a.language_model.model.layers[0].self_attn.q_proj.weight
    assert abs(q.std().item() * cfg.llama.hidden_size ** 0.5 - 1) < 0.1
    emb = a.language_model.model.embed_tokens.weight
    assert abs(emb.std().item() / 0.02 - 1) < 0.1
    cb = a.gen_vision_model.quantize.embedding.weight
    assert cb.dtype == torch.float32
    assert cb.abs().max().item() <= 1.0 / cfg.vq.codebook_size
    assert torch.all(a.language_model.model.norm.weight == 1)


def test_codebook_stays_fp32_in_a_bf16_model():
    cfg = CONFIGS["tiny"]
    m = PlanGenModel(cfg, dtype=torch.bfloat16)
    assert m.gen_vision_model.quantize.embedding.weight.dtype == torch.float32
    assert m.gen_head.vision_head.weight.dtype == torch.bfloat16


# ------------------------------------------------------------ VQ decode

VQ_GRID = CONFIGS["tiny"].vision.image_size // CONFIGS["tiny"].vq.downsample_factor


@pytest.fixture(scope="module")
def vq_pair():
    cfg, params, model, _ = _load("tiny")
    return cfg, params["gen_vision_model"], model.gen_vision_model


@pytest.fixture(scope="module")
def vq_ids():
    rs = np.random.RandomState(10)
    cfg = CONFIGS["tiny"]
    return rs.randint(0, cfg.vq.codebook_size, size=(3, VQ_GRID * VQ_GRID))


def test_vq_normalized_codebook(vq_pair):
    cfg, jparams, vq = vq_pair
    want = jvq._normalized_codebook(jparams, cfg.vq)
    np.testing.assert_allclose(_np(vq.normalized_codebook()), np.asarray(want), atol=1e-6)


def test_vq_decode_code(vq_pair, vq_ids):
    cfg, jparams, vq = vq_pair
    grid = (VQ_GRID, VQ_GRID)
    want = jvq.decode_code(jparams, cfg.vq, jnp.asarray(vq_ids), grid)
    with torch.no_grad():
        got = vq.decode_code(torch.from_numpy(vq_ids), grid)
    assert got.shape == want.shape  # NHWC at the public function
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


def test_vq_decode_code_uint8(vq_pair, vq_ids):
    cfg, jparams, vq = vq_pair
    grid = (VQ_GRID, VQ_GRID)
    want = np.asarray(jvq.decode_code_uint8(jparams, cfg.vq, jnp.asarray(vq_ids), grid))
    with torch.no_grad():
        got = vq.decode_code_uint8(torch.from_numpy(vq_ids), grid).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_vq_blocks(vq_pair):
    """resblock with a shortcut, attnblock and the 2x upsample, channels-first
    inside, against the NHWC JAX functions."""
    from plangen_tpu_torch.models.vq import upsample_nearest2x

    cfg, jparams, vq = vq_pair
    dec, jdec = vq.decoder, jparams["decoder"]
    rs = np.random.RandomState(11)
    to_t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    to_np = lambda t: _np(t.permute(0, 2, 3, 1))  # noqa: E731
    level = next(i for i, lv in enumerate(dec.conv_blocks)
                 if hasattr(lv.res[0], "nin_shortcut"))
    res, jres = dec.conv_blocks[level].res[0], jdec["levels"][level]["res"][0]
    x = rs.randn(2, 4, 4, res.norm1.num_channels).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            to_np(res(to_t(x))),
            np.asarray(jvq.resblock(jres, cfg.vq, jnp.asarray(x))), atol=1e-5)
        x = rs.randn(2, 3, 3, dec.mid[1].norm.num_channels).astype(np.float32)
        np.testing.assert_allclose(
            to_np(dec.mid[1](to_t(x))),
            np.asarray(jvq.attnblock(jdec["mid"]["attn"], cfg.vq, jnp.asarray(x))),
            atol=1e-5)
    np.testing.assert_array_equal(to_np(upsample_nearest2x(to_t(x))),
                                  np.asarray(jvq.upsample_nearest2x(jnp.asarray(x))))
