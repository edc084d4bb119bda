"""The port's prefix decode attention (K1) against the JAX package.

On the CPU, `plangen_tpu_torch.ops.decode_attention.prefix_decode_attention`
runs its plain version; it is held against both Pallas kernels in interpret
mode and the XLA `dot_product_attention` with a causal bias, at the
tolerance of tests/test_pallas.py (atol 3e-5, fp32), at q_pos on each side
of every edge of the CUDA kernel's split plan. The split plan, the kernel's
split-and-combine arithmetic (emulated here) and the wrapper's input checks
are exercised here too; the CUDA kernel itself is tested on the card
(tests/test_torch_gpu.py).
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from plangen_tpu.ops.attention import dot_product_attention, make_causal_bias
from plangen_tpu.ops.pallas_decode_attention import (
    prefix_decode_attention as jax_prefix_v2,
)
from plangen_tpu.ops.pallas_decode_attention_v3 import (
    prefix_decode_attention_v3 as jax_prefix_v3,
)
from plangen_tpu_torch.ops import decode_attention as da

L, B, S, H, D = 2, 4, 256, 4, 128
ATOL = 3e-5

# (L, B, S, H, D, left pads per row, zero tail from) of the inputs beyond the
# module's `inputs`: a pad longer than one split of the kernel's plan, a row
# whose live prefix is all pads up to 299, a zero tail
VARIANTS = {
    "s1024": (2, 4, 1024, 2, 64, (0, 131, 300, 3), 600),
    "s2048": (2, 4, 2048, 2, 64, (0, 300, 7, 1), 1500),
}


def _edges(S_):
    """q_pos on each side of every split edge of the kernel's plan, and the
    last slot."""
    n_split, slots = da.split_plan(S_)
    return [e for i in range(1, n_split) for e in (i * slots - 1, i * slots)] + [S_ - 1]


# (layer, q_pos, inputs): the module's own inputs, then every split edge of
# each variant
CASES = [pytest.param(layer, pos, "base", id=f"{layer}-{pos}")
         for layer, pos in [(0, 6), (1, 127), (1, 128), (0, 255)]] + [
    pytest.param(i % 2, pos, name, id=f"{i % 2}-{pos}-{name}")
    for name, spec in VARIANTS.items() for i, pos in enumerate(_edges(spec[2]))]


@functools.lru_cache(maxsize=None)
def _variant(name):
    L_, B_, S_, H_, D_, pads, tail = VARIANTS[name]
    rs = np.random.RandomState(len(name) + S_)
    k = rs.randn(L_, B_, S_, H_, D_).astype(np.float32)
    v = rs.randn(L_, B_, S_, H_, D_).astype(np.float32)
    q = rs.randn(B_, 1, H_, D_).astype(np.float32)
    mask = np.ones((B_, S_), dtype=np.int32)
    for row, pad in enumerate(pads):
        mask[row, :pad] = 0
    mask[-1, tail:] = 0
    return q, k, v, mask


def _compared_rows(mask, pos, chunk_ends_at_q_pos):
    """The rows a reference defines as the plain version does: every row
    with an unpadded slot in [0, q_pos]; a row whose live prefix is all pads
    only where the reference's softmax ends at q_pos too (the Pallas kernels
    score whole 128-slot chunks, the XLA path the whole buffer)."""
    live = (mask[:, :pos + 1] > 0).any(axis=1)
    return np.ones_like(live) if chunk_ends_at_q_pos else live


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    k = rs.randn(L, B, S, H, D).astype(np.float32)
    v = rs.randn(L, B, S, H, D).astype(np.float32)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    mask = np.ones((B, S), dtype=np.int32)
    # left pads; q_pos >= 6 keeps every row's prefix partly unmasked (an
    # all-masked softmax is undefined on both sides)
    mask[0, :5] = 0
    mask[2, :3] = 0
    mask[3, 200:] = 0  # a zero tail, like the 128-rounded cache's
    return q, k, v, mask


def _case(inputs, variant):
    return inputs if variant == "base" else _variant(variant)


def _port(q, k, v, mask, layer, pos):
    return da.prefix_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), layer, torch.tensor([pos], dtype=torch.int32),
    ).numpy()


@pytest.mark.parametrize("layer,pos,variant", CASES)
@pytest.mark.parametrize("jax_kernel", [jax_prefix_v2, jax_prefix_v3],
                         ids=["pallas_v2", "pallas_v3"])
def test_plain_version_matches_pallas_kernels(inputs, jax_kernel, layer, pos, variant):
    q, k, v, mask = _case(inputs, variant)
    want = jax_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.int32(layer), jnp.int32(pos), interpret=True,
    )
    rows = _compared_rows(mask, pos, (pos + 1) % 128 == 0)
    np.testing.assert_allclose(_port(q, k, v, mask, layer, pos)[rows],
                               np.asarray(want)[rows], atol=ATOL)


@pytest.mark.parametrize("layer,pos,variant", CASES)
def test_plain_version_matches_xla_attention(inputs, layer, pos, variant):
    q, k, v, mask = _case(inputs, variant)
    bias = make_causal_bias(jnp.asarray(mask), jnp.array([pos]), jnp.arange(mask.shape[1]))
    want = dot_product_attention(
        jnp.asarray(q), jnp.asarray(k[layer]), jnp.asarray(v[layer]), bias=bias
    )
    rows = _compared_rows(mask, pos, pos + 1 == mask.shape[1])
    np.testing.assert_allclose(_port(q, k, v, mask, layer, pos)[rows],
                               np.asarray(want)[rows], atol=ATOL)


def test_batch_of_one_matches_pallas_kernel():
    """B = 1 (the v3 kernel takes rows in fours, so v2 only), q_pos at the
    edges of a 4-split plan."""
    rs = np.random.RandomState(5)
    k = rs.randn(1, 1, 512, 2, 128).astype(np.float32)
    v = rs.randn(1, 1, 512, 2, 128).astype(np.float32)
    q = rs.randn(1, 1, 2, 128).astype(np.float32)
    mask = np.ones((1, 512), dtype=np.int32)
    mask[0, :9] = 0
    for pos in [9] + _edges(512):
        want = jax_prefix_v2(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                             jnp.int32(0), jnp.int32(pos), interpret=True)
        np.testing.assert_allclose(_port(q, k, v, mask, 0, pos), np.asarray(want), atol=ATOL)


def test_all_pad_live_prefix_is_the_mean_of_v_up_to_q_pos():
    """Slots past q_pos take no part: a live prefix of pads only averages V
    over slots 0..q_pos, and no live slot at all (q_pos < 0) gives zeros."""
    q, k, v, mask = _variant("s1024")
    for pos in (100, 128, 299):  # row 2 is padded up to slot 299
        got = _port(q, k, v, mask, 1, pos)
        np.testing.assert_allclose(got[2, 0], v[1, 2, :pos + 1].mean(axis=0), atol=1e-5)
    assert not _port(q, k, v, mask, 1, -1).any()


@pytest.mark.parametrize("S_,plan", [(128, (1, 128)), (256, (2, 128)), (1024, (8, 128)),
                                     (1152, (5, 256)), (2048, (8, 256)), (4096, (8, 512))])
def test_split_plan(S_, plan):
    """At most 8 splits of whole 128-slot chunks, the last one holding slot
    S - 1 and none empty: the kernel's grid depends on S alone."""
    assert da.split_plan(S_) == plan
    n_split, slots = plan
    assert n_split <= da.MAX_SPLITS and slots % da.CHUNK == 0
    assert (n_split - 1) * slots < S_ <= n_split * slots


@pytest.mark.parametrize("S_,plan", [(128, (1, 128)), (256, (2, 128)), (1024, (4, 256)),
                                     (1152, (3, 384)), (2048, (4, 512)),
                                     (da.A8_MAX_SLOTS, (4, da.A8_MAX_SLOTS // 4))])
def test_a8_split_plan(S_, plan):
    """K1-a8's grid: at most A8_MAX_SPLITS splits of whole 128-slot chunks,
    up to the largest cache its wrapper takes."""
    assert da.split_plan(S_, da.A8_MAX_SPLITS) == plan
    n_split, slots = plan
    assert n_split <= da.A8_MAX_SPLITS and slots % da.CHUNK == 0
    assert (n_split - 1) * slots < S_ <= n_split * slots


def test_split_plan_refuses_ragged_caches():
    for bad in (0, 100, 1000):
        with pytest.raises(ValueError):
            da.split_plan(bad)


def _split_kv_emulation(q, k, v, mask, pos, dtype):
    """The CUDA kernel's arithmetic in torch: per split of `split_plan`, an
    online softmax over 64-slot tiles with p rounded to `dtype` relative to
    the split's running max; the live splits combined in split order."""
    S_ = k.shape[1]
    n_split, slots = da.split_plan(S_)
    last = min(pos, S_ - 1)
    s_all = torch.einsum("bhd,bshd->bhs", q[:, 0] * q.shape[-1] ** -0.5, k)
    s_all = torch.where(mask[:, None, :] > 0, s_all, torch.tensor(-1e30))
    parts = []
    for split in range(last // slots + 1):
        m = torch.full(s_all.shape[:2] + (1,), float("-inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape[0], q.shape[2], q.shape[3])
        for t0 in range(split * slots, min((split + 1) * slots, last + 1), 64):
            t1 = min(t0 + 64, last + 1)
            s = s_all[..., t0:t1]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv = torch.einsum("bhs,bshd->bhd", p.to(dtype).float(), v[:, t0:t1])
            acc = acc * alpha + pv
            m = m_new
        parts.append((m, l, acc))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l_all = sum(torch.exp(m - m_all) * l for m, l, _ in parts)
    a_all = sum(torch.exp(m - m_all) * a for m, _, a in parts)
    return a_all / l_all.clamp_min(1e-30)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_split_kv_arithmetic_matches_plain_version(variant, dtype, tol):
    """Rounding p per split (against the plain version's global max), an
    all-pad split weighted by exp(-1e30 - m) = 0 beside live ones, a live
    prefix of pads only: within the kernel's tolerances at every edge."""
    q, k, v, mask = (torch.from_numpy(a) for a in _variant(variant))
    k, v = (t.to(dtype).float() for t in (k, v))
    for i, pos in enumerate([5, 200] + _edges(k.shape[2])):
        layer = i % 2
        got = _split_kv_emulation(q, k[layer], v[layer], mask, pos, dtype)
        want = da.prefix_decode_attention_reference(
            q, k.to(dtype), v.to(dtype), mask, layer, pos).float()[:, 0]
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=tol, rtol=0, msg=lambda m: f"{pos}: {m}")


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_prefill_attention_matches_jax(kv_heads):
    """The port's `dot_product_attention` + `make_causal_bias` (the prefill
    path) against the JAX functions: a left-padded batch, queries at
    absolute positions 3..10 over a 16-slot cache, fp32."""
    from plangen_tpu_torch.ops import attention as ta

    rs = np.random.RandomState(3)
    q = rs.randn(3, 8, 4, 64).astype(np.float32)
    k = rs.randn(3, 16, kv_heads, 64).astype(np.float32)
    v = rs.randn(3, 16, kv_heads, 64).astype(np.float32)
    mask = np.ones((3, 16), dtype=np.int32)
    mask[1, :2] = 0
    mask[2, :3] = 0
    q_pos, kv_pos = np.arange(3, 11, dtype=np.int32), np.arange(16, dtype=np.int32)
    jbias = make_causal_bias(jnp.asarray(mask), jnp.asarray(q_pos), jnp.asarray(kv_pos))
    tbias = ta.make_causal_bias(torch.from_numpy(mask), torch.from_numpy(q_pos),
                                torch.from_numpy(kv_pos))
    np.testing.assert_array_equal(tbias.numpy(), np.asarray(jbias))
    want = dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jbias)
    got = ta.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), bias=tbias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cpu_path_counts_plain_calls_not_launches(inputs):
    q, k, v, mask = inputs
    launches = da.prefix_decode_attention.launches
    calls = da.prefix_decode_attention_reference.calls
    _port(q, k, v, mask, 0, 10)
    assert da.prefix_decode_attention.launches == launches
    assert da.prefix_decode_attention_reference.calls == calls + 1


def test_q_pos_as_int_or_tensor_agree(inputs):
    q, k, v, mask = (torch.from_numpy(a) for a in inputs)
    a = da.prefix_decode_attention(q, k, v, mask, 1, 40)
    b = da.prefix_decode_attention(q, k, v, mask, 1, torch.tensor([40], dtype=torch.int32))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_rounds_probabilities_like_the_kernel():
    """bf16 cache: fp32 softmax, p rounded to bf16 before PV, bf16 output —
    within bf16 resolution of the fp32 computation on the same values."""
    rs = np.random.RandomState(1)
    k = torch.from_numpy(rs.randn(1, 2, 128, 2, 64).astype(np.float32))
    v = torch.from_numpy(rs.randn(1, 2, 128, 2, 64).astype(np.float32))
    q = torch.from_numpy(rs.randn(2, 1, 2, 64).astype(np.float32))
    mask = torch.ones((2, 128), dtype=torch.int32)
    lo = [t.bfloat16() for t in (q, k, v)]
    out = da.prefix_decode_attention(*lo, mask, 0, 100)
    ref = da.prefix_decode_attention(*(t.float() for t in lo), mask, 0, 100)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)


@pytest.mark.parametrize("bad", ["q_rank", "gqa", "ragged_s", "mask_shape",
                                 "layer", "dtype_mix"])
def test_wrapper_rejects_bad_inputs(inputs, bad):
    q, k, v, mask = (torch.from_numpy(a) for a in inputs)
    layer = 0
    if bad == "q_rank":
        q = q[:, 0]
    elif bad == "gqa":
        q = torch.zeros(B, 1, 2 * H, D)
    elif bad == "ragged_s":
        k, v, mask = k[:, :, :200], v[:, :, :200], mask[:, :200]
    elif bad == "mask_shape":
        mask = mask[:1]
    elif bad == "layer":
        layer = L
    elif bad == "dtype_mix":
        q = q.bfloat16()
    with pytest.raises((ValueError, TypeError)):
        da.prefix_decode_attention(q, k, v, mask, layer, 10)
