"""The port's quantization ops against the JAX package (CPU, plain versions).

  * packing: int4 `w_p4` / `s_lo` / `s_hi16`, int8 `quantize_weight`,
    `quantize_kv` and `quantize_activations_int8` are byte-equal to JAX's
    as JAX runs each: `jax.jit` of it where the JAX package runs it jitted
    (the decode's `quantize_kv` and activations, the pipeline's int4
    weights), eagerly where it runs eagerly (int8 weights, `cli
    convert`'s int4 weights: the port's `eager=True`). XLA turns a jitted
    division by a constant into a product by its float32 reciprocal;
  * K2 (W4A16) plain version against JAX `int4_matmul` (Pallas in interpret
    mode) and `int4_matmul_reference`, fp32;
  * K4 (W4A8) plain version against JAX `int4_matmul_a8_reference` and the
    interpret-mode Pallas kernel: exactly equal;
  * K1-q8 plain version against JAX `dot_product_attention_q8` and
    `segmented_decode_attention` over int8 segments, fp32 atol 1e-5.

Inputs come from `np.random.RandomState`; weights at the JAX init scale
(normal * fan_in^-0.5).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plangen_tpu.ops import attention as jattn
from plangen_tpu.ops import pallas_int4_matmul as jint4
from plangen_tpu.ops import quant as jquant
from plangen_tpu_torch.ops import attention as attn
from plangen_tpu_torch.ops import decode_attention as da
from plangen_tpu_torch.ops import int4_matmul as im
from plangen_tpu_torch.ops import quant


def _w(rs, *shape):
    return (rs.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)


# JAX's int4 quantization where its pipeline runs it (`tasks/eval.py`: under
# jax.jit) and where `cli convert` does (eagerly)
JAX_INT4 = {"pipeline": jax.jit(jint4.quantize_weight_int4, static_argnames="act_int8"),
            "convert": jint4.quantize_weight_int4}


def _assert_tree_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


# ------------------------------------------------------------------ packing


@pytest.mark.parametrize("route", ["pipeline", "convert"])
@pytest.mark.parametrize("case", ["2d", "stacked", "fused", "zero_column", "half_steps"])
@pytest.mark.parametrize("act_int8", [False, True], ids=["w16", "a8"])
def test_int4_packing_byte_equal(case, act_int8, route):
    rs = np.random.RandomState(0)
    if case == "2d":
        w = _w(rs, 256, 512)
    elif case == "stacked":
        w = _w(rs, 3, 256, 512)
    elif case == "fused":  # q|k|v concatenated along out, as the fused leaf
        w = np.concatenate([_w(rs, 2, 256, 256) for _ in range(3)], axis=-1)
    elif case == "zero_column":
        w = _w(rs, 256, 512)
        w[:, 7] = 0.0
        w[:, 300] = 0.0
    else:  # every value an exact half step of its column's scale
        scale = np.float32(0.25)
        codes = rs.randint(-7, 7, size=(256, 512)).astype(np.float32) + 0.5
        w = codes * scale
        w[0] = 7 * scale  # pins absmax so the scale is exactly 0.25
    want = JAX_INT4[route](jnp.asarray(w), act_int8=act_int8)
    got = im.quantize_weight_int4(torch.from_numpy(w), act_int8=act_int8,
                                  eager=route == "convert")
    assert im.is_quantized_int4(got) and not im.is_quantized_int4(torch.from_numpy(w))
    _assert_tree_equal(want, got)
    np.testing.assert_array_equal(
        np.asarray(jint4.dequantize_weight_int4(want, dtype=jnp.float32)),
        im.dequantize_weight_int4(got, dtype=torch.float32).numpy())


def test_int4_stacked_packing_equals_per_layer():
    """The port quantizes per layer; the JAX tree is stacked: same bytes."""
    rs = np.random.RandomState(1)
    w = _w(rs, 3, 256, 512)
    stacked = JAX_INT4["pipeline"](jnp.asarray(w))
    for layer in range(3):
        got = im.quantize_weight_int4(torch.from_numpy(w[layer]))
        _assert_tree_equal({k: v[layer] for k, v in stacked.items()}, got)


@pytest.mark.parametrize("stacked", [False, True])
def test_int8_weight_quantization_byte_equal(stacked):
    rs = np.random.RandomState(2)
    w = _w(rs, *((2, 256, 384) if stacked else (256, 384)))
    w[..., 5] = 0.0
    want = jquant.quantize_weight(jnp.asarray(w))
    got = quant.quantize_weight(torch.from_numpy(w))
    _assert_tree_equal(want, got)
    np.testing.assert_array_equal(
        np.asarray(jquant.dequantize_weight(want, dtype=jnp.float32)),
        quant.dequantize_weight(got, dtype=torch.float32).numpy())


def test_quantize_kv_byte_equal():
    rs = np.random.RandomState(3)
    k = rs.randn(4, 9, 2, 128).astype(np.float32)
    v = rs.randn(4, 9, 2, 128).astype(np.float32)
    k[1, 3, 0] = 0.0  # an all-zero row: scale 1
    want = jax.jit(jattn.quantize_kv)(jnp.asarray(k), jnp.asarray(v))  # as the decode runs it
    got = attn.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    for a, b in zip(want, got):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_quantize_activations_int8_byte_equal():
    rs = np.random.RandomState(4)
    x = rs.randn(9, 256).astype(np.float32)
    x[2] = 0.0
    want = jax.jit(jint4.quantize_activations_int8)(jnp.asarray(x))  # as the decode runs it
    got = im.quantize_activations_int8(torch.from_numpy(x))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ----------------------------------------------------------------- K2 / K4


def _int4_pair(seed, stacked=False, act_int8=False, I=256, O=512):
    rs = np.random.RandomState(seed)
    w = _w(rs, *((2, I, O) if stacked else (I, O)))
    return (rs, JAX_INT4["pipeline"](jnp.asarray(w), act_int8=act_int8),
            im.quantize_weight_int4(torch.from_numpy(w), act_int8=act_int8))


def _cancellation_bound(x, q, layer):
    """What the TPU kernel's lincomb form loses to fp32 cancellation:
    (y1 - y2) * s_hi16 with |y1| <= sum |x| * 128, and the same for the lo
    half, one fp32 epsilon each (its outputs are off its own dequantized
    reference by about this much)."""
    s = {k: np.asarray(v)[layer] if np.asarray(v).ndim == 3 else np.asarray(v)
         for k, v in q.items() if k != "a8"}
    mag = np.abs(x).sum(axis=-1, keepdims=True) * 128.0 * np.finfo(np.float32).eps
    return np.concatenate([mag * 16 * s["s_lo"], mag * 16 * s["s_hi16"]], axis=-1)


@pytest.mark.parametrize("rows", [1, 8, 256, 257])
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked_layer1"])
def test_k2_plain_version_matches_jax(rows, stacked):
    """R <= 256 takes the kernel route (the plain version here), 257 the
    dense route, as in JAX. Against JAX's dequantized reference: atol 1e-5
    (fp32 sums in another order). Against the Pallas kernel: atol 1e-5
    plus that kernel's own cancellation error (`_cancellation_bound`)."""
    rs, jq, tq = _int4_pair(5, stacked=stacked)
    x = rs.randn(rows, 256).astype(np.float32)
    layer = 1 if stacked else 0
    got = im.int4_matmul(torch.from_numpy(x), tq, layer=layer if stacked else None)
    assert got.dtype == torch.float32 and got.shape == (rows, 512)
    ref = np.asarray(jint4.int4_matmul_reference(jnp.asarray(x), jq, layer=layer))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    kernel = np.asarray(jint4.int4_matmul(
        jnp.asarray(x), jq, layer=jnp.int32(layer) if stacked else None, interpret=True))
    err = np.abs(got.numpy() - kernel)
    assert (err <= 1e-5 + _cancellation_bound(x, jq, layer)).all(), err.max()


def test_k2_routes_rows_like_jax():
    """<= 256 rows run the kernel's plain version, > 256 the dense route,
    leading dims flattened."""
    rs, _, tq = _int4_pair(6)
    calls = im.int4_matmul_w16_reference.calls
    out = im.int4_matmul(torch.from_numpy(rs.randn(2, 128, 256).astype(np.float32)), tq)
    assert out.shape == (2, 128, 512)
    assert im.int4_matmul_w16_reference.calls == calls + 1
    im.int4_matmul(torch.from_numpy(rs.randn(3, 100, 256).astype(np.float32)), tq)
    assert im.int4_matmul_w16_reference.calls == calls + 1


@pytest.mark.parametrize("rows", [1, 8, 256, 257])
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked_layer1"])
def test_k4_plain_version_exactly_jax(rows, stacked):
    """W4A8: per-row int8 activations, exact integer dots, the same fp32
    scaling order: bit-equal to JAX's `int4_matmul_a8_reference` at every
    kernel-route row count, and to its Pallas kernel (interpret mode) at
    decode row counts. From 64 rows on, that kernel itself differs from its
    own reference by up to 2 ulp (XLA reorders the two fp32 scalings inside
    the interpreted kernel), so there the port is held to those 2 ulp. The
    257-row case takes the dense route on both sides."""
    rs, jq, tq = _int4_pair(7, stacked=stacked, act_int8=True)
    x = rs.randn(rows, 256).astype(np.float32)
    layer = 1 if stacked else 0
    got = im.int4_matmul(torch.from_numpy(x), tq, layer=layer if stacked else None).numpy()
    # jitted, as the JAX decode runs them: the activations' scale is their
    # absmax times the float32 reciprocal of 127
    kernel = np.asarray(jax.jit(functools.partial(jint4.int4_matmul, interpret=True))(
        jnp.asarray(x), jq, layer=jnp.int32(layer) if stacked else None))
    if rows > 256:
        np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)
        return
    ref = np.asarray(jax.jit(jint4.int4_matmul_a8_reference, static_argnames="layer")(
        jnp.asarray(x), jq, layer=layer))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        im.int4_matmul_a8_reference(torch.from_numpy(x), tq, layer=layer).numpy(), ref)
    if rows <= 8:
        np.testing.assert_array_equal(got, kernel)
    else:
        np.testing.assert_array_max_ulp(got, kernel, maxulp=2)


def test_k4_extreme_values_exact():
    """Full-range codes: activations at +-127, every nibble value, I = 512:
    the integer dots leave no room for rounding."""
    rs = np.random.RandomState(8)
    I, OH = 512, 256
    w_p4 = rs.randint(-128, 128, size=(I, OH)).astype(np.int8)
    q = {"w_p4": w_p4, "s_lo": rs.rand(1, OH).astype(np.float32),
         "s_hi16": rs.rand(1, OH).astype(np.float32) / 16, "a8": np.zeros((), np.int8)}
    x = np.sign(rs.randn(8, I)).astype(np.float32) * 3.0  # quantizes to +-127
    want = np.asarray(jax.jit(jint4.int4_matmul_a8_reference)(jnp.asarray(x),
                                                               jax.tree.map(jnp.asarray, q)))
    got = im.int4_matmul(torch.from_numpy(x), {k: torch.from_numpy(np.asarray(v)) for k, v in q.items()})
    np.testing.assert_array_equal(got.numpy(), want)


def test_int4_linear_modules_match_dense_reference():
    """Int4Linear / Int8Linear with a bias: qmatmul(x, w) + b, as gen_head.fc2."""
    rs = np.random.RandomState(9)
    w = _w(rs, 256, 512)
    b = rs.randn(512).astype(np.float32)
    x = rs.randn(5, 256).astype(np.float32)
    jq4 = JAX_INT4["pipeline"](jnp.asarray(w))
    mod4 = quant.Int4Linear.from_dense(torch.from_numpy(w), bias=torch.from_numpy(b))
    ref4 = np.asarray(jint4.int4_matmul_reference(jnp.asarray(x), jq4)) + b
    np.testing.assert_allclose(mod4(torch.from_numpy(x)).numpy(), ref4, atol=1e-5, rtol=0)
    jq8 = jquant.quantize_weight(jnp.asarray(w))
    want8 = np.asarray(jquant.qmatmul(jnp.asarray(x), jq8) + b)
    mod8 = quant.Int8Linear.from_dense(torch.from_numpy(w), bias=torch.from_numpy(b))
    np.testing.assert_allclose(mod8(torch.from_numpy(x)).numpy(), want8, atol=1e-5, rtol=0)


# ------------------------------------------------------------------- K1-q8


def _q8_cache(rs, L=2, B=4, S=256, H=2, D=128):
    k = rs.randn(L, B, S, H, D).astype(np.float32)
    v = rs.randn(L, B, S, H, D).astype(np.float32)
    k8, ks, v8, vs = (np.array(a) for a in jattn.quantize_kv(jnp.asarray(k), jnp.asarray(v)))
    mask = np.ones((B, S), np.int32)
    for row, pads in enumerate((0, 3, 5, 1)):  # left pads, all before q_pos 6
        mask[row, :pads] = 0
    q = rs.randn(B, 1, H, D).astype(np.float32)
    return q, k8, ks, v8, vs, mask


def _port_q8(q, k8, ks, v8, vs, mask, layer, q_pos):
    t = torch.from_numpy
    return da.prefix_decode_attention_q8(
        t(q), t(k8), t(ks), t(v8), t(vs), t(mask), layer, torch.tensor([q_pos], dtype=torch.int32)
    ).numpy()


@pytest.mark.parametrize("q_pos", [6, 127, 128, 255])
def test_k1_q8_plain_version_matches_dot_product_attention_q8(q_pos):
    rs = np.random.RandomState(10)
    q, k8, ks, v8, vs, mask = _q8_cache(rs)
    S = k8.shape[2]
    bias = jattn.make_causal_bias(jnp.asarray(mask), jnp.asarray([q_pos], jnp.int32),
                                  jnp.arange(S, dtype=jnp.int32))
    for layer in (0, 1):
        want = jattn.dot_product_attention_q8(
            jnp.asarray(q), jnp.asarray(k8[layer]), jnp.asarray(ks[layer]),
            jnp.asarray(v8[layer]), jnp.asarray(vs[layer]), bias=bias)
        got = _port_q8(q, k8, ks, v8, vs, mask, layer, q_pos)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("q_pos", [6, 127, 128, 255])
def test_k1_q8_plain_version_matches_segmented_decode_attention(q_pos):
    """JAX's default growing cache: int8 segments of 128 slots, the live
    ones combined by an exact online softmax."""
    rs = np.random.RandomState(11)
    q, k8, ks, v8, vs, mask = _q8_cache(rs)
    layer = 1
    segs, biases = [], []
    for off in range(0, q_pos + 1, 128):
        sl = slice(off, off + 128)
        segs.append(tuple(jnp.asarray(a[layer][:, sl]) for a in (k8, ks, v8, vs)))
        biases.append(jattn.make_causal_bias(
            jnp.asarray(mask[:, sl]), jnp.asarray([q_pos], jnp.int32),
            off + jnp.arange(128, dtype=jnp.int32)))
    want = jattn.segmented_decode_attention(jnp.asarray(q), segs, biases)
    got = _port_q8(q, k8, ks, v8, vs, mask, layer, q_pos)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_q8_prefill_attention_matches_jax():
    """Prefill over the int8 cache: `dot_product_attention_q8` with Q > 1."""
    rs = np.random.RandomState(12)
    B, Q, S, H, D = 3, 7, 128, 2, 128
    q = rs.randn(B, Q, H, D).astype(np.float32)
    k8 = rs.randint(-127, 128, size=(B, S, H, D)).astype(np.int8)
    v8 = rs.randint(-127, 128, size=(B, S, H, D)).astype(np.int8)
    ks = (rs.rand(B, S, H) / 127).astype(np.float32)
    vs = (rs.rand(B, S, H) / 127).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :2] = 0
    pos = np.arange(Q, dtype=np.int32)
    jbias = jattn.make_causal_bias(jnp.asarray(mask), jnp.asarray(pos), jnp.arange(S, dtype=jnp.int32))
    want = jattn.dot_product_attention_q8(*map(jnp.asarray, (q, k8, ks, v8, vs)), bias=jbias)
    tbias = attn.make_causal_bias(torch.from_numpy(mask), torch.from_numpy(pos),
                                  torch.arange(S, dtype=torch.int32))
    got = attn.dot_product_attention_q8(*map(torch.from_numpy, (q, k8, ks, v8, vs)), bias=tbias)
    np.testing.assert_allclose(got.numpy()[:, 2:], np.asarray(want)[:, 2:], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want)[0], atol=1e-5, rtol=0)


# ------------------------------------------------------------------ wrappers


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain versions; a device with no kernel
    raises rather than falling back."""
    kw = dict(device="meta")
    x = torch.empty(4, 256, **kw)
    w = torch.empty(256, 128, dtype=torch.int8, **kw)
    s = torch.empty(1, 128, **kw)
    launches = (im.int4_matmul_w16.launches, im.int4_matmul_w4a8.launches)
    with pytest.raises(ValueError, match="no int4 matmul"):
        im.int4_matmul_w16(x, w, s, s)
    with pytest.raises(ValueError, match="no int4 matmul"):
        im.int4_matmul_w4a8(torch.empty(4, 256, dtype=torch.int8, **kw),
                            torch.empty(4, 1, **kw), w, s, s, torch.float32)
    L, B, S, H, D = 1, 1, 128, 1, 64
    k8 = torch.empty(L, B, S, H, D, dtype=torch.int8, **kw)
    sc = torch.empty(L, B, S, H, **kw)
    with pytest.raises(ValueError, match="no prefix decode attention"):
        da.prefix_decode_attention_q8(torch.empty(B, 1, H, D, **kw), k8, sc, k8, sc,
                                      torch.empty(B, S, dtype=torch.int32, **kw), 0, 3)
    assert (im.int4_matmul_w16.launches, im.int4_matmul_w4a8.launches) == launches
    assert da.prefix_decode_attention_q8.launches == 0


@pytest.mark.parametrize("bad", ["w_dtype", "w_rows", "scale_size", "x_dims", "xs_shape"])
def test_int4_wrappers_check_inputs(bad):
    x = torch.zeros(4, 256)
    w = torch.zeros(256, 128, dtype=torch.int8)
    s = torch.ones(1, 128)
    x8, xs = torch.zeros(4, 256, dtype=torch.int8), torch.ones(4, 1)
    if bad == "w_dtype":
        w = w.to(torch.int32)
    elif bad == "w_rows":
        w = w[:128]
    elif bad == "scale_size":
        s = s[:, :64]
    elif bad == "x_dims":
        x, x8 = x[None], x8[None]
    else:
        xs = xs[:2]
    if bad != "xs_shape":  # W4A16 has no activation scales
        with pytest.raises((TypeError, ValueError)):
            im.int4_matmul_w16(x, w, s, s)
    with pytest.raises((TypeError, ValueError)):
        im.int4_matmul_w4a8(x8, xs, w, s, s, torch.float32)


def test_split_k_covers_the_input_dim():
    """The grid's split of the input dim: about two blocks per SM at decode
    shapes, one split when the columns and rows already fill the card, and
    never a split without a K tile."""
    n_sm = 132
    for R, I, OH in [(8, 2048, 3072), (8, 2048, 1024), (8, 5632, 1024),
                     (8, 2048, 5632), (8, 2048, 8192), (256, 2048, 5632), (1, 256, 256)]:
        ks = im.split_k(R, I, OH, n_sm)
        k_tiles = -(-I // im.K_TILE)
        per = -(-k_tiles // ks)
        assert 1 <= ks <= k_tiles and (ks - 1) * per < k_tiles
    assert im.split_k(256, 2048, 5632, n_sm) == 1
    assert im.split_k(8, 2048, 1024, n_sm) == 16
