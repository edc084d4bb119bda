"""K3: the port's flash attention against the JAX package's, on the CPU.

On a CPU tensor `flash_attention` runs its plain version
(`flash_attention_reference`); it is held against the JAX package's Pallas
`flash_attention` in interpret mode (forward, on the rows that have an
allowed key: the Pallas kernel leaves the others unspecified) and against
`jax.vjp` of it (gradients, every row). Tolerances: fp32 1e-5, bf16 2e-2.
Rows with no allowed key follow the JAX package's XLA path (`_reference`):
the mean of V over all S keys.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.ops import pallas_attention as jpa
from plangen_tpu_torch.ops import flash_attention as tfa

CASES = {
    # name: (B, S, H, Hkv, D, causal, pads)
    "causal_left_pads": (2, 200, 2, 2, 64, True, "left"),
    "causal_dense_s128": (1, 128, 2, 2, 128, True, None),
    "non_causal_key_pads": (2, 150, 2, 2, 64, False, "right"),
    "non_causal_576": (1, 576, 2, 2, 64, False, None),
    "short_s9": (2, 9, 2, 2, 128, True, "left"),
    "gqa": (2, 70, 4, 2, 64, True, "left"),
}


def _inputs(B, S, H, Hkv, D, pads, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, H, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    g = rs.randn(B, S, H, D).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    if pads == "left":
        mask[-1, : max(1, S // 3)] = 0
    elif pads == "right":
        mask[-1, S - S // 5:] = 0
    return q, k, v, g, mask


def _rows_with_a_key(mask, causal):
    if causal:
        return np.cumsum(mask > 0, axis=1) > 0
    return np.broadcast_to((mask > 0).any(axis=1, keepdims=True), mask.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_pallas_forward(case, dtype):
    B, S, H, Hkv, D, causal, pads = CASES[case]
    q, k, v, _, mask = _inputs(B, S, H, Hkv, D, pads)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jpa.flash_attention(*(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(mask),
                               causal, None, interpret=True)
    calls, launches = tfa.flash_attention_reference.calls, tfa.flash_attention_fwd.launches
    got = tfa.flash_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                              torch.from_numpy(mask), causal=causal)
    assert tfa.flash_attention_reference.calls == calls + 1
    assert tfa.flash_attention_fwd.launches == launches
    assert got.dtype == td and got.shape == (B, S, H, D)
    assert bool(torch.isfinite(got).all())
    ok = _rows_with_a_key(mask, causal)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy()[ok], np.asarray(want, np.float32)[ok],
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_gradients_match_jax_vjp(case):
    B, S, H, Hkv, D, causal, pads = CASES[case]
    q, k, v, g, mask = _inputs(B, S, H, Hkv, D, pads, seed=1)
    fn = functools.partial(jpa.flash_attention, pad_mask=jnp.asarray(mask), causal=causal,
                           interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c), jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*leaves, torch.from_numpy(mask), causal=causal).backward(
        torch.from_numpy(g))
    for name, a, b in zip("qkv", leaves, want):
        assert bool(torch.isfinite(a.grad).all()), name
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_rows_without_keys_follow_the_xla_path(causal):
    """A row with no allowed key is the mean of V over all S keys, equal to
    the JAX package's XLA path `_reference` on every row; a fully padded
    sequence included."""
    B, S, H, D = 3, 40, 2, 16
    q, k, v, _, mask = _inputs(B, S, H, H, D, "left")
    mask[0] = 0
    want = jpa._reference(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask), causal,
                          D ** -0.5)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(mask), causal=causal).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    no_key = ~_rows_with_a_key(mask, causal)
    assert no_key[0].all() and no_key.sum() == (S + S // 3 if causal else S)
    mean_v = np.broadcast_to(v.mean(axis=1, keepdims=True), v.shape)
    np.testing.assert_allclose(got[no_key], mean_v[no_key], atol=1e-5, rtol=1e-5)


def test_scale_and_mask_dtypes():
    q, k, v, _, mask = _inputs(2, 33, 2, 2, 64, "left")
    t = [torch.from_numpy(x) for x in (q, k, v)]
    want = jpa._reference(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask), True, 0.3)
    for m in (torch.from_numpy(mask), torch.from_numpy(mask).bool(),
              torch.from_numpy(mask).long()):
        got = tfa.flash_attention(*t, m, scale=0.3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad", ["rank3", "kv_len", "heads", "mask_shape"])
def test_bad_shapes_raise(bad):
    q, k, v, _, mask = (torch.from_numpy(x) for x in _inputs(2, 16, 4, 2, 64, None))
    if bad == "rank3":
        q = q[0]
    elif bad == "kv_len":
        k, v = k[:, :8], v[:, :8]
    elif bad == "heads":
        k, v = (torch.cat([t, t[:, :, :1]], dim=2) for t in (k, v))
    else:
        mask = mask[:, :8]
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, mask)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU only `flash_attention` dispatches (to the plain version);
    the kernel wrappers take CUDA tensors and count no launch."""
    q, k, v, g, mask = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 2, 64, None))
    launches = tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, v, mask, True, 0.125)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(q, k, v, mask, q, g, lse, True, 0.125)
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches) == launches
