"""The port's prefix decode attention (K1) against the JAX package.

On the CPU, `plangen_tpu_torch.ops.decode_attention.prefix_decode_attention`
runs its plain version; it is held against both Pallas kernels in interpret
mode and the XLA `dot_product_attention` with a causal bias, at the
tolerance of tests/test_pallas.py (atol 3e-5, fp32). The wrapper's input
checks are exercised here too; the CUDA kernel itself is tested on the card
(tests/test_torch_gpu.py).
"""

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
CASES = [(0, 6), (1, 127), (1, 128), (0, 255)]
ATOL = 3e-5


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


def _port(q, k, v, mask, layer, pos):
    return da.prefix_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), layer, torch.tensor([pos], dtype=torch.int32),
    ).numpy()


@pytest.mark.parametrize("layer,pos", CASES)
@pytest.mark.parametrize("jax_kernel", [jax_prefix_v2, jax_prefix_v3],
                         ids=["pallas_v2", "pallas_v3"])
def test_plain_version_matches_pallas_kernels(inputs, jax_kernel, layer, pos):
    q, k, v, mask = inputs
    want = jax_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.int32(layer), jnp.int32(pos), interpret=True,
    )
    np.testing.assert_allclose(_port(q, k, v, mask, layer, pos),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("layer,pos", CASES)
def test_plain_version_matches_xla_attention(inputs, layer, pos):
    q, k, v, mask = inputs
    bias = make_causal_bias(jnp.asarray(mask), jnp.array([pos]), jnp.arange(S))
    want = dot_product_attention(
        jnp.asarray(q), jnp.asarray(k[layer]), jnp.asarray(v[layer]), bias=bias
    )
    np.testing.assert_allclose(_port(q, k, v, mask, layer, pos),
                               np.asarray(want), atol=ATOL)


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
