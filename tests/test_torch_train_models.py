"""The modules the training slice adds to the port, against the JAX package:
SigLIP, the understanding aligner and splice, and the VQ encoder side.

Same weights (`vlm.init(PRNGKey(0), cfg, float32)` through
`load_jax_params`), inputs from numpy seeds, fp32, atol/rtol 1e-5. The JAX
SigLIP's flash branch runs the Pallas kernel in interpret mode. VQ indices
must be equal, except where the two nearest codes' squared distances differ
by less than 1e-6 (a tie within fp32 summation order).
"""

import functools
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.config import PlanGenModelConfig
from plangen_tpu.models import siglip as jsiglip
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.models import vq as jvq
from plangen_tpu.ops import pallas_attention
from plangen_tpu_torch.convert import init_params, load_jax_params
from plangen_tpu_torch.models.vlm import PlanGenModel, splice_image_embeddings
from plangen_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)
TINY = PlanGenModelConfig.tiny()
# SigLIP at head_dim 64 (the kernel's size) and 4 x 4 patches
WIDE = replace(TINY, vision=replace(TINY.vision, image_size=64, width=128, heads=2),
               aligner=replace(TINY.aligner, input_dim=128))
CONFIGS = {"tiny": TINY, "wide_siglip": WIDE}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(pallas_attention, "flash_attention",
                        functools.partial(pallas_attention.flash_attention, interpret=True))


@functools.lru_cache(maxsize=None)
def _pair(name):
    cfg = CONFIGS[name]
    params = jvlm.init(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    model = PlanGenModel(cfg, dtype=torch.float32)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params), cfg)
    return cfg, params, model.eval()


def _images(B, size, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (B, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [False, True], ids=["bias", "flash"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_siglip_matches_jax(name, use_flash):
    cfg, params, model = _pair(name)
    img = _images(3, cfg.vision.image_size)
    want = jsiglip.forward(params["vision_model"], cfg.vision, jnp.asarray(img),
                           use_flash=use_flash)
    calls = tfa.flash_attention_reference.calls
    with torch.no_grad():
        got = model.vision_model(torch.from_numpy(img), use_flash)
    assert tfa.flash_attention_reference.calls - calls == (cfg.vision.layers if use_flash else 0)
    assert got.shape == (3, cfg.vision.num_patches, cfg.vision.width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_images_for_understanding_matches_jax(name):
    cfg, params, model = _pair(name)
    img = _images(2, cfg.vision.image_size, seed=1)
    want = jvlm.encode_images_for_understanding(params, cfg, jnp.asarray(img))
    with torch.no_grad():
        got = model.encode_images_for_understanding(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_splice_image_embeddings_matches_jax():
    rs = np.random.RandomState(2)
    B, L, N, H = 3, 12, 4, 8
    tok = rs.randn(B, L, H).astype(np.float32)
    img = rs.randn(B, N, H).astype(np.float32)
    mask = np.zeros((B, L), bool)
    mask[0, 1:5] = True
    mask[1, 6:10] = True
    mask[2, [0, 3, 7, 11]] = True  # not contiguous
    want = jvlm.splice_image_embeddings(jnp.asarray(tok), jnp.asarray(img), jnp.asarray(mask))
    got = splice_image_embeddings(torch.from_numpy(tok), torch.from_numpy(img),
                                  torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[2, 7], img[2, 2])


@pytest.mark.parametrize("use_flash", [False, True], ids=["bias", "flash"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prepare_inputs_embeds_matches_jax(name, use_flash):
    cfg, params, model = _pair(name)
    n = cfg.vision.num_patches
    rs = np.random.RandomState(3)
    ids = rs.randint(3, cfg.llama.vocab_size, (2, n + 6)).astype(np.int32)
    mask = np.zeros(ids.shape, bool)
    mask[0, 2:2 + n] = True
    mask[1, 5:5 + n] = True
    img = _images(2, cfg.vision.image_size, seed=4)
    want = jvlm.prepare_inputs_embeds(params, cfg, jnp.asarray(ids), jnp.asarray(img),
                                      jnp.asarray(mask), use_flash=use_flash)
    with torch.no_grad():
        got = model.prepare_inputs_embeds(torch.from_numpy(ids), torch.from_numpy(img),
                                          torch.from_numpy(mask), use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [32, 64])
def test_vq_encoder_matches_jax(size):
    cfg, params, model = _pair("tiny")
    img = _images(2, size, seed=5)
    p = params["gen_vision_model"]
    h = jvq.conv2d(p["quant_conv"], jvq.encoder_forward(p["encoder"], cfg.vq, jnp.asarray(img)))
    with torch.no_grad():
        z = model.gen_vision_model.quant_conv(
            model.gen_vision_model.encoder(torch.from_numpy(img).permute(0, 3, 1, 2)))
    np.testing.assert_allclose(z.permute(0, 2, 3, 1).numpy(), np.asarray(h), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("size,seed", [(32, 6), (64, 7), (128, 8)])
def test_vq_encode_to_indices_matches_jax(size, seed):
    cfg, params, model = _pair("tiny")
    img = _images(3, size, seed=seed)
    p = params["gen_vision_model"]
    want = np.asarray(jvq.encode_to_indices(p, cfg.vq, jnp.asarray(img)))
    with torch.no_grad():
        got = model.gen_vision_model.encode_to_indices(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (3, (size // 16) ** 2)
    flips = np.argwhere(got != want)
    if len(flips):  # only near-ties may differ
        h = jvq.conv2d(p["quant_conv"], jvq.encoder_forward(p["encoder"], cfg.vq,
                                                            jnp.asarray(img)))
        zf = np.asarray(h, np.float64).reshape(-1, cfg.vq.codebook_dim)
        zf /= np.linalg.norm(zf, axis=-1, keepdims=True)
        cb = np.asarray(jvq._normalized_codebook(p, cfg.vq), np.float64)
        d = ((zf[:, None, :] - cb[None]) ** 2).sum(-1).reshape(3, -1, cb.shape[0])
        for b, i in flips:
            assert abs(d[b, i, got[b, i]] - d[b, i, want[b, i]]) < 1e-6, (b, i)


def test_vq_quantize_latents_matches_jax():
    cfg, params, model = _pair("tiny")
    z = np.random.RandomState(9).randn(2, 3, 4, cfg.vq.codebook_dim).astype(np.float32)
    zq_j, idx_j = jvq.quantize(params["gen_vision_model"], cfg.vq, jnp.asarray(z))
    with torch.no_grad():
        zq, idx = model.gen_vision_model.quantize_latents(torch.from_numpy(z).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(zq.numpy(), np.asarray(zq_j), **TOL)


def test_init_params_draws_the_new_modules_at_jax_scales():
    cfg = PlanGenModelConfig.tiny()
    m = init_params(PlanGenModel(replace(cfg, vision=replace(cfg.vision, width=256, heads=4),
                                         aligner=replace(cfg.aligner, input_dim=256)),
                                 dtype=torch.float32), torch.Generator().manual_seed(0))
    tower = m.vision_model.vision_tower
    assert abs(tower.pos_embed.std().item() / 0.02 - 1) < 0.1
    assert abs(tower.patch_embed.proj.weight.std().item() / 0.02 - 1) < 0.1
    assert torch.all(tower.patch_embed.proj.bias == 0)
    qkv = tower.blocks[0].attn.qkv.weight
    assert abs(qkv.std().item() * 256 ** 0.5 - 1) < 0.1 and torch.all(tower.blocks[0].attn.qkv.bias == 0)
    for norm in (tower.blocks[0].norm1, tower.norm):
        assert torch.all(norm.weight == 1) and torch.all(norm.bias == 0)
    enc = m.gen_vision_model.encoder.conv_in.weight
    assert abs(enc.std().item() * enc[0].numel() ** 0.5 - 1) < 0.1
