"""Tests of the port that need an NVIDIA card (marker `gpu`).

They skip without one. On the card, which has no jax, run them without the
suite's conftest (it imports jax):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

This file imports torch and the port only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from plangen_tpu_torch.config import LlamaConfig, PlanGenModelConfig
from plangen_tpu_torch.convert import init_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops import decode_attention as da
from plangen_tpu_torch.ops import int4_matmul as im
from plangen_tpu_torch.ops.attention import quantize_kv
from plangen_tpu_torch.ops.quant import quantize_model_
from plangen_tpu_torch.runtime.generate import (
    generate_image_tokens, greedy_decode_text, text_decode_steps,
)

pytestmark = pytest.mark.gpu

TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _inputs(dev, dtype, L=3, B=5, S=256, H=3, D=128, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn((L, B, S, H, D), generator=g, device=dev).to(dtype)
    v = torch.randn((L, B, S, H, D), generator=g, device=dev).to(dtype)
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(dtype)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    mask[1, :7] = 0
    mask[3, :60] = 0
    mask[4, 200:] = 0
    return q, k, v, mask


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_matches_plain_version(cuda, dtype, D):
    q, k, v, mask = _inputs(cuda, dtype, D=D)
    for layer, pos in [(0, 60), (1, 127), (2, 128), (0, 200), (1, 255), (2, 300)]:
        q_pos = torch.tensor([pos], dtype=torch.int32, device=cuda)
        launches = da.prefix_decode_attention.launches
        got = da.prefix_decode_attention(q, k, v, mask, layer, q_pos)
        assert da.prefix_decode_attention.launches == launches + 1
        want = da.prefix_decode_attention_reference(q, k, v, mask, layer, q_pos)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOLERANCE[dtype], (layer, pos, err)


def test_kernel_reads_q_pos_from_device_memory(cuda):
    """One launch per value written into the same q_pos buffer, as a decode
    step captured in a CUDA graph would advance it, forwards and back across
    changes in the number of live splits (S 256: 2 splits, S 1024: 8)."""
    for S, positions in ((256, (70, 127, 128, 180, 255, 0, 129)),
                         (1024, (70, 128, 300, 511, 512, 900, 1023, 127, 640))):
        q, k, v, mask = _inputs(cuda, torch.float32, S=S)
        q_pos = torch.zeros(1, dtype=torch.int32, device=cuda)
        for pos in positions:
            q_pos.fill_(pos)
            got = da.prefix_decode_attention(q, k, v, mask, 1, q_pos)
            want = da.prefix_decode_attention_reference(q, k, v, mask, 1, pos)
            assert (got - want).abs().max().item() <= 1e-4, (S, pos)


def _edge_inputs(dev, dtype, S, D, B=4, L=2, H=2, seed=0):
    """Rows: no pad; a left pad longer than one split; pads up to 2 splits +
    5 (its live prefix is all pads before that); a zero tail from S / 2."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k, v = (torch.randn((L, B, S, H, D), generator=g, device=dev) for _ in range(2))
    q = torch.randn((B, 1, H, D), generator=g, device=dev)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    _, slots = da.split_plan(S)
    if B > 1:
        mask[1, :slots + 37] = 0
        mask[2, :min(2 * slots + 5, S)] = 0
        mask[3 % B, S // 2:] = 0
    parts = [quantize_kv(k[layer], v[layer]) for layer in range(L)]
    q8 = tuple(torch.stack([p[i] for p in parts]) for i in range(4))
    return (q.to(dtype), k.to(dtype), v.to(dtype), mask), q8


def _split_edges(S):
    n_split, slots = da.split_plan(S)
    edges = [e for i in range(1, n_split) for e in (i * slots - 1, i * slots)]
    return [0, 5] + edges + [S - 1]


def _k1_and_q8_errors(q, k, v, mask, q8, layer, pos, dev):
    q_pos = torch.tensor([pos], dtype=torch.int32, device=dev)
    got = da.prefix_decode_attention(q, k, v, mask, layer, q_pos)
    want = da.prefix_decode_attention_reference(q, k, v, mask, layer, q_pos)
    got8 = da.prefix_decode_attention_q8(q, *q8, mask, layer, q_pos)
    want8 = da.prefix_decode_attention_q8_reference(q, *q8, mask, layer, q_pos)
    torch.cuda.synchronize()
    for t in (got, got8):
        assert t.dtype == q.dtype and t.shape == q.shape and bool(torch.isfinite(t).all())
    return ((got.float() - want.float()).abs().max().item(),
            (got8.float() - want8.float()).abs().max().item())


@pytest.mark.parametrize("S", [256, 1024, 2048])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_split_kv_edges_match_plain_version(cuda, dtype, D, S):
    """K1 and K1-q8 on the same values with q_pos on each side of every
    split edge: rows with a left pad longer than a split (an all-pad split
    beside live ones), with a live prefix of pads only (the mean of V over
    slots 0..q_pos), and a zero tail."""
    (q, k, v, mask), q8 = _edge_inputs(cuda, dtype, S, D)
    for i, pos in enumerate(_split_edges(S)):
        err, err8 = _k1_and_q8_errors(q, k, v, mask, q8, i % 2, pos, cuda)
        assert err <= TOLERANCE[dtype], ("K1", pos, err)
        assert err8 <= TOLERANCE[dtype], ("K1-q8", pos, err8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_split_kv_batch_of_one(cuda, dtype):
    (q, k, v, mask), q8 = _edge_inputs(cuda, dtype, 1024, 128, B=1)
    for pos in (0, 127, 128, 677, 1023):
        err, err8 = _k1_and_q8_errors(q, k, v, mask, q8, 1, pos, cuda)
        assert max(err, err8) <= TOLERANCE[dtype], (pos, err, err8)


def test_split_kv_all_pad_prefix_is_the_mean_of_v(cuda):
    """A row whose live prefix is all pads, across splits: the mean of V
    over slots 0..q_pos."""
    (q, k, v, mask), _ = _edge_inputs(cuda, torch.float32, 1024, 128)
    for pos in (5, 200, 260):  # row 2 is padded up to slot 260
        q_pos = torch.tensor([pos], dtype=torch.int32, device=cuda)
        got = da.prefix_decode_attention(q, k, v, mask, 0, q_pos)
        torch.testing.assert_close(got[2, 0], v[0, 2, :pos + 1].mean(dim=0),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_split_kv_is_bitwise_deterministic(cuda, dtype):
    """The splits are combined in a fixed order: two calls, the same bits."""
    (q, k, v, mask), q8 = _edge_inputs(cuda, dtype, 2048, 128, B=8, H=16)
    for pos in (677, 2047):
        q_pos = torch.tensor([pos], dtype=torch.int32, device=cuda)
        a = da.prefix_decode_attention(q, k, v, mask, 1, q_pos)
        b = da.prefix_decode_attention(q, k, v, mask, 1, q_pos)
        a8 = da.prefix_decode_attention_q8(q, *q8, mask, 1, q_pos)
        b8 = da.prefix_decode_attention_q8(q, *q8, mask, 1, q_pos)
        assert torch.equal(a, b) and torch.equal(a8, b8), pos


def _misaligned(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.parametrize("bad", ["mask_int64", "q_pos_int", "fp16", "head_dim_32",
                                 "non_contiguous", "q_pos_cpu", "misaligned_q",
                                 "misaligned_k", "misaligned_mask"])
def test_kernel_wrapper_raises(cuda, bad):
    q, k, v, mask = _inputs(cuda, torch.float32)
    q_pos = torch.tensor([100], dtype=torch.int32, device=cuda)
    if bad == "mask_int64":
        mask = mask.long()
    elif bad == "q_pos_int":
        q_pos = 100
    elif bad == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim_32":
        q, k, v = q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous()
    elif bad == "non_contiguous":
        k = k.transpose(3, 4).contiguous().transpose(3, 4)
    elif bad == "q_pos_cpu":
        q_pos = q_pos.cpu()
    elif bad == "misaligned_q":
        q = _misaligned(q)
    elif bad == "misaligned_k":
        k = _misaligned(k)
    elif bad == "misaligned_mask":
        mask = _misaligned(mask)
    launches = da.prefix_decode_attention.launches
    with pytest.raises((TypeError, ValueError)):
        da.prefix_decode_attention(q, k, v, mask, 0, q_pos)
    assert da.prefix_decode_attention.launches == launches


def _tiny_d64() -> PlanGenModelConfig:
    """The tiny model with the kernels' smallest head_dim (64)."""
    tiny = PlanGenModelConfig.tiny()
    return dataclasses.replace(
        tiny,
        llama=LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                          num_layers=2, num_heads=2, num_kv_heads=2, head_dim=64),
        gen_aligner=dataclasses.replace(tiny.gen_aligner, n_embed=128),
        image_token_embed=128,
    )


def test_decode_loop_on_card_equals_cpu(cuda):
    """Greedy tokens of a tiny model with the kernel's smallest head_dim
    (64), fp32: the card (every decode step through the kernel) equals the
    CPU (the plain version)."""
    cfg = _tiny_d64()
    cpu_model = init_params(PlanGenModel(cfg, dtype=torch.float32),
                            torch.Generator().manual_seed(0)).eval()
    gpu_model = PlanGenModel(cfg, dtype=torch.float32, device=cuda).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    rs = np.random.RandomState(0)
    embeds = torch.from_numpy(rs.randn(4, 12, cfg.llama.hidden_size).astype(np.float32))
    n = 8
    mask = torch.ones((4, 12 + n), dtype=torch.int32)
    mask[1, :3] = 0
    kw = dict(generator=None, cfg_weight=5.0, temperature=0.0, num_tokens=n)
    want = generate_image_tokens(cpu_model, cfg, embeds, mask, **kw)
    launches = da.prefix_decode_attention.launches
    got = generate_image_tokens(gpu_model, cfg, embeds.to(cuda), mask.to(cuda), **kw)
    assert da.prefix_decode_attention.launches - launches == n * cfg.llama.num_layers
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# ------------------------------------------------- K2 / K4 (int4 matmuls)

INT4_CASES = [(1, 256, 512), (8, 2048, 6144), (8, 5632, 2048), (37, 200, 1000),
              (256, 2048, 11264)]  # ragged rows, a K tail, O/2 % 128 != 0


def _int4_inputs(dev, R, I, O, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    OH = O // 2
    w = torch.randint(-128, 128, (I, OH), generator=g, device=dev, dtype=torch.int8)
    s_lo = torch.rand((1, OH), generator=g, device=dev) * 0.02
    s_hi16 = torch.rand((1, OH), generator=g, device=dev) * 0.02 / 16
    x = torch.randn((R, I), generator=g, device=dev).to(dtype)
    return x, w, s_lo, s_hi16


# bf16 only (the tensor-core route): 2, 8 and 16 n-tiles of rows, and a
# shape whose I (100) is not a multiple of 8 and whose O/2 (132) is not a
# multiple of 16 (x staged by plain loads, the weight by 4-byte copies)
K2_BF16_CASES = [(16, 2048, 6144), (64, 200, 1000), (128, 5632, 2048), (5, 100, 264)]
K2_CASES = ([(dtype, *case) for case in INT4_CASES for dtype in (torch.float32, torch.bfloat16)]
            + [(torch.bfloat16, *case) for case in K2_BF16_CASES])


@pytest.mark.parametrize("dtype,R,I,O", K2_CASES,
                         ids=[f"{'bf16' if d == torch.bfloat16 else 'fp32'}-{R}-{I}-{O}"
                              for d, R, I, O in K2_CASES])
def test_k2_matches_plain_version(cuda, dtype, R, I, O):
    x, w, s_lo, s_hi16 = _int4_inputs(cuda, R, I, O, dtype)
    launches = (im.int4_matmul_w16.launches, im.int4_matmul_w16.tc_launches)
    got = im.int4_matmul_w16(x, w, s_lo, s_hi16)
    # bf16 runs on the tensor cores, fp32 on the CUDA cores (the check route)
    tc = int(dtype == torch.bfloat16)
    assert (im.int4_matmul_w16.launches, im.int4_matmul_w16.tc_launches) == (
        launches[0] + 1, launches[1] + tc)
    want = im.int4_matmul_w16_reference(x, w, s_lo, s_hi16)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (R, O)
    # fp32: sums in another order (fp32 epsilon times sqrt(I)-sized values);
    # bf16: plus one rounding of the output
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("R,I,O", [(8, 2048, 2048), (64, 2048, 11264), (256, 2048, 11264),
                                   (37, 200, 1000)])
def test_k2_tensor_cores_are_deterministic(cuda, R, I, O):
    """Split-K partials added in a fixed order, no atomics: two calls give
    the same bits."""
    x, w, s_lo, s_hi16 = _int4_inputs(cuda, R, I, O, torch.bfloat16, seed=2)
    a = im.int4_matmul_w16(x, w, s_lo, s_hi16)
    b = im.int4_matmul_w16(x, w, s_lo, s_hi16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# K4 beyond INT4_CASES: R = 64 (8 n-tiles at gate|up; and I % 16 != 0 with
# O/2 % 16 != 0: x8 and the weight by 4-byte copies), 256 rows at down_proj,
# and K2's extra cases (2 and 16 n-tiles, I = 100)
K4_CASES = INT4_CASES + [(64, 2048, 11264), (64, 200, 1000), (256, 5632, 2048),
                         (16, 2048, 6144), (128, 5632, 2048), (5, 100, 264)]


@pytest.mark.parametrize("R,I,O", K4_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k4_equals_plain_version_exactly(cuda, dtype, R, I, O):
    x, w, s_lo, s_hi16 = _int4_inputs(cuda, R, I, O, dtype, seed=1)
    x8, xs = im.quantize_activations_int8(x)
    launches = (im.int4_matmul_w4a8.launches, im.int4_matmul_w4a8.tc_launches)
    got = im.int4_matmul_w4a8(x8, xs, w, s_lo, s_hi16, dtype)
    # every K4 launch runs on the tensor cores
    assert (im.int4_matmul_w4a8.launches, im.int4_matmul_w4a8.tc_launches) == (
        launches[0] + 1, launches[1] + 1)
    want = im.int4_matmul_w4a8_reference(x8, xs, w, s_lo, s_hi16, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (R, O)
    assert torch.equal(got, want)


@pytest.mark.parametrize("R,I,O", [(8, 2048, 2048), (64, 2048, 11264), (256, 2048, 11264),
                                   (37, 200, 1000)])
def test_k4_tensor_cores_are_deterministic(cuda, R, I, O):
    """Exact int32 sums, split-K partials added in a fixed order: two calls
    give the same bits."""
    x, w, s_lo, s_hi16 = _int4_inputs(cuda, R, I, O, torch.bfloat16, seed=2)
    x8, xs = im.quantize_activations_int8(x)
    a = im.int4_matmul_w4a8(x8, xs, w, s_lo, s_hi16, torch.bfloat16)
    b = im.int4_matmul_w4a8(x8, xs, w, s_lo, s_hi16, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["x_fp16", "rows_257", "oh_not_4", "w_on_cpu", "x_strided",
                                 "a8_i_not_4"])
def test_int4_wrappers_raise(cuda, bad):
    R, I, O = 8, 256, 512
    x, w, s_lo, s_hi16 = _int4_inputs(cuda, R, I, O, torch.float32)
    if bad == "x_fp16":
        x = x.half()
    elif bad == "rows_257":
        x = torch.zeros((257, I), device=cuda)
    elif bad == "oh_not_4":
        w, s_lo, s_hi16 = w[:, :6].contiguous(), s_lo[:, :6].contiguous(), s_hi16[:, :6].contiguous()
    elif bad == "w_on_cpu":
        w = w.cpu()
    elif bad == "x_strided":
        x = torch.zeros((I, R), device=cuda).t()
    elif bad == "a8_i_not_4":
        x, w = x[:, :254].contiguous(), w[:254].contiguous()
    launches = (im.int4_matmul_w16.launches, im.int4_matmul_w4a8.launches)
    if bad != "a8_i_not_4":
        with pytest.raises((TypeError, ValueError)):
            im.int4_matmul_w16(x, w, s_lo, s_hi16)
    if bad != "x_fp16":
        x8, xs = im.quantize_activations_int8(x.float())
        if bad == "x_strided":
            x8 = x8.t().contiguous().t()
        with pytest.raises((TypeError, ValueError)):
            im.int4_matmul_w4a8(x8, xs, w, s_lo, s_hi16, torch.float32)
    assert (im.int4_matmul_w16.launches, im.int4_matmul_w4a8.launches) == launches


# ------------------------------------------------------ K1-q8 (int8 cache)


def _q8_inputs(dev, dtype, L=3, B=5, S=256, H=3, D=128, seed=0):
    q, k, v, mask = _inputs(dev, torch.float32, L, B, S, H, D, seed)
    parts = [quantize_kv(k[layer], v[layer]) for layer in range(L)]
    k8, ks, v8, vs = (torch.stack([p[i] for p in parts]) for i in range(4))
    return q.to(dtype), k8, ks, v8, vs, mask


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k1_q8_matches_plain_version(cuda, dtype, D):
    q, k8, ks, v8, vs, mask = _q8_inputs(cuda, dtype, D=D)
    for layer, pos in [(0, 60), (1, 127), (2, 128), (0, 200), (1, 255)]:
        q_pos = torch.tensor([pos], dtype=torch.int32, device=cuda)
        launches = da.prefix_decode_attention_q8.launches
        got = da.prefix_decode_attention_q8(q, k8, ks, v8, vs, mask, layer, q_pos)
        assert da.prefix_decode_attention_q8.launches == launches + 1
        want = da.prefix_decode_attention_q8_reference(q, k8, ks, v8, vs, mask, layer, q_pos)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOLERANCE[dtype], (layer, pos, err)


@pytest.mark.parametrize("bad", ["mask_int64", "q_pos_int", "scale_fp16", "k_fp32",
                                 "non_contiguous", "misaligned_q", "misaligned_v",
                                 "misaligned_scale"])
def test_k1_q8_wrapper_raises(cuda, bad):
    q, k8, ks, v8, vs, mask = _q8_inputs(cuda, torch.float32)
    q_pos = torch.tensor([100], dtype=torch.int32, device=cuda)
    if bad == "mask_int64":
        mask = mask.long()
    elif bad == "q_pos_int":
        q_pos = 100
    elif bad == "scale_fp16":
        ks = ks.half()
    elif bad == "k_fp32":
        k8 = k8.float()
    elif bad == "misaligned_q":
        q = _misaligned(q)
    elif bad == "misaligned_v":
        v8 = _misaligned(v8)
    elif bad == "misaligned_scale":
        ks = _misaligned(ks)
    else:
        v8 = v8.transpose(3, 4).contiguous().transpose(3, 4)
    launches = da.prefix_decode_attention_q8.launches
    with pytest.raises((TypeError, ValueError)):
        da.prefix_decode_attention_q8(q, k8, ks, v8, vs, mask, 0, q_pos)
    assert da.prefix_decode_attention_q8.launches == launches


# ------------------------------------------------- K1-a8 (s8 x s8, int8 cache)

# K1-a8 and its plain version take the same integer products and the same
# fp32 logits; a probability code may land one step apart where expf and
# the order of the fp32 softmax sum move p across a rounding boundary. A
# row whose codes agree is off by the rounding of p_s and of the output's
# dtype; a differing code moves its row by at most |v8| * p_s <= max v_scale.
A8_MAX_DIFFERING_CODES = 8
A8_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7}


def _a8_check(got, want, codes, want_codes, vs, dtype):
    diff = (codes.long() - want_codes.long()).abs()
    assert diff.max().item() <= 1 and diff.sum().item() <= A8_MAX_DIFFERING_CODES, diff.sum()
    flips = diff.sum(-1)[:, None, :, None].float()  # [B, 1, H, 1]
    err = (got.float() - want.float()).abs()
    bound = A8_RTOL[dtype] * want.float().abs() + flips * vs.max() + 1e-12
    assert (err <= bound).all(), (err - bound).max()


# q_pos of each case: 0, either side of the first tile edge (128 slots) and
# of the first split edge (A8_MAX_SPLITS splits: 128 slots at S 256, 256 at
# S 1024, 512 at S 2048, streamed as 128-slot tiles), the image loop's 677
# and S - 1
A8_POSITIONS = (0, 60, 127, 128, 200, 255, 256, 511, 512, 677, 1023, 1500)


@pytest.mark.parametrize("shape", [dict(L=3, B=5, S=256, H=3, D=128),
                                   dict(L=2, B=6, S=1024, H=4, D=64),
                                   dict(L=2, B=5, S=2048, H=2, D=128)],
                         ids=["S256_D128", "S1024_D64", "S2048_D128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k1_a8_matches_plain_version(cuda, dtype, shape):
    """K1-a8 (split over slots, one cluster per (row, head)) against its
    plain version at every q_pos of A8_POSITIONS below S and at S - 1: the
    probability codes within A8_MAX_DIFFERING_CODES steps of one, the
    output within `_a8_check`'s bound, two calls bitwise equal."""
    q, k8, ks, v8, vs, mask = _q8_inputs(cuda, dtype, **shape)
    B, S, H = shape["B"], shape["S"], shape["H"]
    positions = [p for p in A8_POSITIONS if p < S] + [S - 1]
    for i, pos in enumerate(positions):
        layer = i % shape["L"]
        q_pos = torch.tensor([pos], dtype=torch.int32, device=cuda)
        codes = torch.full((B, H, S), 99, dtype=torch.int8, device=cuda)
        launches = da.prefix_decode_attention_a8.launches
        got = da.prefix_decode_attention_a8(q, k8, ks, v8, vs, mask, layer, q_pos,
                                            codes_out=codes)
        assert da.prefix_decode_attention_a8.launches == launches + 1
        want, want_codes = da.prefix_decode_attention_a8_reference(
            q, k8, ks, v8, vs, mask, layer, q_pos, return_codes=True)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert (codes[:, :, pos + 1:] == 0).all()
        _a8_check(got, want, codes, want_codes, vs[layer], dtype)
        again = da.prefix_decode_attention_a8(q, k8, ks, v8, vs, mask, layer, q_pos)
        assert torch.equal(again, got)  # no atomics: bitwise the same


def test_k1_a8_all_pad_prefix_is_the_mean_rule(cuda):
    """A live prefix of pads only, over two splits: every live slot weighs
    alike, as the plain version (and K1-q8) give."""
    q, k8, ks, v8, vs, mask = _q8_inputs(cuda, torch.float32)
    mask[2, :150] = 0
    q_pos = torch.tensor([140], dtype=torch.int32, device=cuda)
    codes = torch.zeros((5, 3, 256), dtype=torch.int8, device=cuda)
    got = da.prefix_decode_attention_a8(q, k8, ks, v8, vs, mask, 1, q_pos, codes_out=codes)
    want, want_codes = da.prefix_decode_attention_a8_reference(
        q, k8, ks, v8, vs, mask, 1, q_pos, return_codes=True)
    _a8_check(got, want, codes, want_codes, vs[1], torch.float32)


@pytest.mark.parametrize("bad", ["mask_int64", "q_pos_int", "fp16", "head_dim_32",
                                 "scale_fp16", "k_fp32", "non_contiguous", "misaligned_q",
                                 "misaligned_v", "misaligned_scale", "codes_int32",
                                 "dtensor"])
def test_k1_a8_wrapper_raises(cuda, bad, request):
    q, k8, ks, v8, vs, mask = _q8_inputs(cuda, torch.float32)
    q_pos = torch.tensor([100], dtype=torch.int32, device=cuda)
    codes = None
    if bad == "mask_int64":
        mask = mask.long()
    elif bad == "q_pos_int":
        q_pos = 100
    elif bad == "fp16":
        q = q.half()
    elif bad == "head_dim_32":
        q, k8, v8 = (t[..., :32].contiguous() for t in (q, k8, v8))
    elif bad == "scale_fp16":
        ks = ks.half()
    elif bad == "k_fp32":
        k8 = k8.float()
    elif bad == "misaligned_q":
        q = _misaligned(q)
    elif bad == "misaligned_v":
        v8 = _misaligned(v8)
    elif bad == "misaligned_scale":
        ks = _misaligned(ks)
    elif bad == "codes_int32":
        codes = torch.zeros((5, 3, 256), dtype=torch.int32, device=cuda)
    elif bad == "dtensor":
        from torch.distributed.tensor import Replicate, distribute_tensor

        mesh = request.getfixturevalue("world1_nccl")
        q = distribute_tensor(q, mesh["model"], [Replicate()])
    else:
        v8 = v8.transpose(3, 4).contiguous().transpose(3, 4)
    launches = da.prefix_decode_attention_a8.launches
    with pytest.raises((TypeError, ValueError)):
        da.prefix_decode_attention_a8(q, k8, ks, v8, vs, mask, 0, q_pos, codes_out=codes)
    assert da.prefix_decode_attention_a8.launches == launches


# ------------------------------------- the quantizers: the card against the CPU


def _quantizer_cases():
    """(name, fn of a float32 tensor -> a tuple of tensors): each quantizer
    with the rule of the JAX call site it follows (`ops.scale_of`)."""
    from plangen_tpu_torch.ops.attention import _quantize_rows_s8
    from plangen_tpu_torch.ops.quant import quantize_weight

    def int4(eager):
        return lambda w: tuple(im.quantize_weight_int4(w, eager=eager).values())

    return {"quantize_kv": lambda x: quantize_kv(x, x.flip(-1) * 3),
            "rows_s8": _quantize_rows_s8,
            "activations_int8": im.quantize_activations_int8,
            "weight_int4_pipeline": int4(False),
            "weight_int4_convert": int4(True),
            "weight_int8": lambda w: tuple(quantize_weight(w).values())}


@pytest.mark.parametrize("name", ["quantize_kv", "rows_s8", "activations_int8",
                                  "weight_int4_pipeline", "weight_int4_convert",
                                  "weight_int8"])
def test_quantizer_on_the_card_equals_the_cpu(cuda, name):
    """Each quantizer's codes and scales on CUDA tensors equal its output on
    the CPU bit for bit: a scale is a product by fl(1/c) or a division by a
    float32 tensor on both, never PyTorch's CUDA division by a Python
    number (a product by its reciprocal there, a division on the CPU)."""
    fn = _quantizer_cases()[name]
    g = torch.Generator().manual_seed(11)
    x = torch.randn((64, 16, 256), generator=g) * torch.rand((64, 16, 1), generator=g) * 4
    x[0, 0] = 0.0  # an all-zero row (or column's worth): scale 1
    want = fn(x)
    got = fn(x.to(cuda))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name


def test_a8_graph_equals_eager_loop(cuda):
    """`generate_image_tokens(kv_a8=True)` over the int8 cache: the captured
    step replayed gives the eager loop's tokens bit for bit, and every
    decode step's attention is one K1-a8 launch a layer (none of K1-q8)."""
    cfg, model = _graph_model(cuda, "int8")
    n = 16
    embeds, mask = _graph_prompt(cuda, cfg, n)

    def run(eager):
        generator = [torch.Generator(device=cuda).manual_seed(s) for s in (5, 6)]
        before = (da.prefix_decode_attention_a8.launches,
                  da.prefix_decode_attention_q8.launches)
        tokens = generate_image_tokens(
            model, cfg, embeds, mask, generator=generator, cfg_weight=5.0, temperature=1.0,
            num_tokens=n, quantized_cache=True, eager=eager, kv_a8=True)
        torch.cuda.synchronize()
        return tokens.cpu(), (da.prefix_decode_attention_a8.launches - before[0],
                              da.prefix_decode_attention_q8.launches - before[1])

    eager_tokens, eager_counts = run(eager=True)
    graph_tokens, graph_counts = run(eager=False)
    assert torch.equal(graph_tokens, eager_tokens)
    assert graph_counts == eager_counts == (n * cfg.llama.num_layers, 0)
    assert len(set(graph_tokens.flatten().tolist())) > 1


@pytest.mark.parametrize("mode", ["int4", "int4_a8"])
def test_quantized_decode_loop_on_card_equals_cpu(cuda, mode):
    """Greedy tokens of a tiny int4 model over the int8 cache, fp32: the card
    (K2 or K4 and K1-q8 at every decode step) equals the CPU (the plain
    versions)."""
    cfg = _tiny_d64()
    cpu_model = init_params(PlanGenModel(cfg, dtype=torch.float32),
                            torch.Generator().manual_seed(0)).eval()
    gpu_model = PlanGenModel(cfg, dtype=torch.float32, device=cuda).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    quantize_model_(cpu_model, mode)
    quantize_model_(gpu_model, mode)
    rs = np.random.RandomState(0)
    embeds = torch.from_numpy(rs.randn(4, 12, cfg.llama.hidden_size).astype(np.float32))
    n = 8
    mask = torch.ones((4, 12 + n), dtype=torch.int32)
    mask[1, :3] = 0
    kw = dict(generator=None, cfg_weight=5.0, temperature=0.0, num_tokens=n,
              quantized_cache=True)
    want = generate_image_tokens(cpu_model, cfg, embeds, mask, **kw)
    wrapper = im.int4_matmul_w4a8 if mode == "int4_a8" else im.int4_matmul_w16
    launches = (wrapper.launches, da.prefix_decode_attention_q8.launches)
    got = generate_image_tokens(gpu_model, cfg, embeds.to(cuda), mask.to(cuda), **kw)
    L = cfg.llama.num_layers
    assert wrapper.launches - launches[0] == n * (4 * L + 1) + 4 * L  # prefill: 48 rows
    assert da.prefix_decode_attention_q8.launches - launches[1] == n * L
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("mode", ["dense_cache", "int8_kv", "int4", "int4_a8"])
def test_greedy_decode_text_on_card_equals_cpu(cuda, mode):
    """Greedy text tokens of the tiny fp32 model over a 40-token budget whose
    cache crosses a 128-slot chunk: the card (K1, or K1-q8 over the int8
    cache, and K2 / K4 at every int4 projection and `lm_head`) equals the
    CPU (the plain versions), the launches those of the steps it ran."""
    cfg = _tiny_d64()
    cpu_model = init_params(PlanGenModel(cfg, dtype=torch.float32),
                            torch.Generator().manual_seed(0)).eval()
    gpu_model = PlanGenModel(cfg, dtype=torch.float32, device=cuda).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    if mode.startswith("int4"):
        quantize_model_(cpu_model, mode)
        quantize_model_(gpu_model, mode)
    rs = np.random.RandomState(0)
    embeds = torch.from_numpy(rs.randn(3, 100, cfg.llama.hidden_size).astype(np.float32))
    n = 40
    mask = torch.ones((3, 100 + n), dtype=torch.int32)
    mask[1, :3] = 0
    mask[2, :70] = 0
    kw = dict(max_new_tokens=n, quantized_cache=mode != "dense_cache")
    want = greedy_decode_text(cpu_model, cfg, embeds, mask, 1, **kw)
    attention = da.prefix_decode_attention_q8 if kw["quantized_cache"] else \
        da.prefix_decode_attention
    matmul = im.int4_matmul_w4a8 if mode == "int4_a8" else im.int4_matmul_w16
    launches = (attention.launches, matmul.launches, matmul.tc_launches)
    got = greedy_decode_text(gpu_model, cfg, embeds.to(cuda), mask.to(cuda), 1, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    L = cfg.llama.num_layers
    steps = text_decode_steps(want, 1)
    assert attention.launches - launches[0] == steps * L
    if mode.startswith("int4"):  # the 300-row prefill takes the dense route
        assert matmul.launches - launches[1] == steps * (4 * L + 1)
        assert matmul.tc_launches - launches[2] == (0 if mode == "int4" else steps * (4 * L + 1))


# ------------------------------------------------ K3 (flash attention)

from plangen_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _flash_inputs(dev, dtype, B=3, S=200, H=3, D=128, left_pads=True, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
                     for _ in range(4))
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    if left_pads:
        mask[1, :7] = 0
        mask[2, :70] = 0  # more than one 64-key tile of pads
    return q, k, v, mask, dout


@pytest.mark.parametrize("left_pads", [False, True], ids=["dense", "left_pads"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k3_matches_plain_version(cuda, dtype, D, causal, left_pads):
    """Every row, those with no allowed key included (they follow the bias
    path: the mean of V over all keys, with its gradients)."""
    q, k, v, mask, dout = _flash_inputs(cuda, dtype, D=D, left_pads=left_pads)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    launches = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    got = fa.flash_attention(*leaves, mask, causal=causal)
    got.backward(dout)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    want = fa.flash_attention_reference(*plain, mask, causal=causal)
    want.backward(dout)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol_f, tol_g = (1e-4, 1e-3) if dtype == torch.float32 else (2e-2, 2e-2)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol_f, atol=tol_f)
    for name, a, b in zip("qkv", leaves, plain):
        assert bool(torch.isfinite(a.grad).all()), name
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=tol_g, atol=tol_g,
                                   msg=lambda m, n=name: f"d{n}: {m}")


def test_k3_gqa_sums_over_each_group(cuda):
    q, k, v, mask, dout = _flash_inputs(cuda, torch.float32, H=4)
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*a, mask).backward(dout)
    fa.flash_attention_reference(*b, mask).backward(dout)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_k3_fully_padded_row_follows_bias_path(cuda, causal):
    """A sequence with no unpadded key at all: every row is the mean of V,
    forward and backward as the plain version (S 130 spans three tiles)."""
    q, k, v, mask, dout = _flash_inputs(cuda, torch.float32, S=130, D=64)
    mask[0] = 0
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    got = fa.flash_attention(*a, mask, causal=causal)
    got.backward(dout)
    want = fa.flash_attention_reference(*b, mask, causal=causal)
    want.backward(dout)
    torch.testing.assert_close(got[0], v[0].mean(dim=0, keepdim=True).expand_as(got[0]),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("bad", ["fp16", "head_dim_32", "float_mask", "k_on_cpu",
                                 "fwd_strided", "fwd_mask_int64"])
def test_k3_wrappers_raise(cuda, bad):
    q, k, v, mask, _ = _flash_inputs(cuda, torch.float32)
    call = lambda: fa.flash_attention(q, k, v, mask)  # noqa: E731
    if bad == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim_32":
        q, k, v = (t[..., :32].contiguous() for t in (q, k, v))
    elif bad == "float_mask":
        mask = mask.float()
    elif bad == "k_on_cpu":
        k = k.cpu()
    elif bad == "fwd_strided":
        call = lambda: fa.flash_attention_fwd(q.transpose(1, 2), k, v, mask, True, 0.1)  # noqa: E731
    elif bad == "fwd_mask_int64":
        call = lambda: fa.flash_attention_fwd(q, k, v, mask.long(), True, 0.1)  # noqa: E731
    launches = fa.flash_attention_fwd.launches
    with pytest.raises((TypeError, ValueError)):
        call()
    assert fa.flash_attention_fwd.launches == launches


# ------------------------- K3 bf16 on the tensor cores (wgmma forward and backward)

# left pads per row: none, a few, exactly one 64-row tile (a query tile of
# pads only in the dK/dV pass), two whole tiles and more, every key
TC_PADS = (0, 5, 64, 130, None)


def _tc_inputs(dev, S, D, H=2, Hkv=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, Hkv = len(TC_PADS), Hkv or H
    q = torch.randn((B, S, H, D), generator=g, device=dev)
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=dev) for _ in range(2))
    dout = torch.randn((B, S, H, D), generator=g, device=dev)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    for r, pad in enumerate(TC_PADS):
        mask[r, :S if pad is None else pad] = 0
    return [t.to(torch.bfloat16) for t in (q, k, v, dout)], mask


def _run_k3(q, k, v, dout, mask, causal, fn=fa.flash_attention):
    """(out, dq, dk, dv) of `fn` on fresh leaves."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, mask, causal=causal)
    out.backward(dout)
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [160, 576, 736, 1000, 1024])
def test_k3_tensor_cores_match_plain_and_fp32_kernel(cuda, S, D, causal):
    """bf16 through the tensor-core route against the plain version (fp32
    softmax over bf16 inputs) and against the fp32 CUDA-core kernel on the
    same values, every row: the left-padded rows under the causal mask and
    the fully padded row take the bias path (the mean of V)."""
    (q, k, v, dout), mask = _tc_inputs(cuda, S, D)
    before = (fa.flash_attention_fwd.routes["tensor_cores"],
              fa.flash_attention_bwd.routes["tensor_cores"])
    got = _run_k3(q, k, v, dout, mask, causal)
    assert (fa.flash_attention_fwd.routes["tensor_cores"],
            fa.flash_attention_bwd.routes["tensor_cores"]) == (before[0] + 1, before[1] + 1)
    plain = _run_k3(q, k, v, dout, mask, causal, fa.flash_attention_reference)
    fp32 = _run_k3(*(t.float() for t in (q, k, v, dout)), mask, causal)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, plain, fp32):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2,
                                   msg=lambda m, n=name: f"{n} vs plain: {m}")
        torch.testing.assert_close(a.float(), c, rtol=2e-2, atol=2e-2,
                                   msg=lambda m, n=name: f"{n} vs the fp32 kernel: {m}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_k3_tensor_cores_are_deterministic(cuda, causal):
    """No atomics: two runs give the same bits, output and gradients."""
    (q, k, v, dout), mask = _tc_inputs(cuda, 736, 128)
    first = _run_k3(q, k, v, dout, mask, causal)
    second = _run_k3(q, k, v, dout, mask, causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_k3_tensor_cores_gqa_sums_over_each_group(cuda):
    (q, k, v, dout), mask = _tc_inputs(cuda, 576, 128, H=4, Hkv=2)
    got = _run_k3(q, k, v, dout, mask, True)
    want = _run_k3(q, k, v, dout, mask, True, fa.flash_attention_reference)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("bad", ["head_dim_96", "fp16", "mixed_dtypes", "fwd_strided",
                                 "fwd_misaligned", "fwd_mask_int64", "bwd_lse_bf16"])
def test_k3_tensor_core_wrappers_raise(cuda, bad):
    (q, k, v, dout), mask = _tc_inputs(cuda, 160, 64)
    call = lambda: fa.flash_attention(q, k, v, mask)  # noqa: E731
    if bad == "head_dim_96":
        q, k, v = (torch.cat([t, t[..., :32]], -1) for t in (q, k, v))
    elif bad == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtypes":
        call = lambda: fa.flash_attention_fwd(q, k.float(), v, mask, True, 0.125)  # noqa: E731
    elif bad == "fwd_strided":
        call = lambda: fa.flash_attention_fwd(q.transpose(1, 2), k, v, mask, True, 0.125)  # noqa: E731
    elif bad == "fwd_misaligned":
        shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)[1:].view(q.shape)
        shifted.copy_(q)
        call = lambda: fa.flash_attention_fwd(shifted, k, v, mask, True, 0.125)  # noqa: E731
    elif bad == "fwd_mask_int64":
        call = lambda: fa.flash_attention_fwd(q, k, v, mask.long(), True, 0.125)  # noqa: E731
    elif bad == "bwd_lse_bf16":
        out, lse = fa.flash_attention_fwd(q, k, v, mask, True, 0.125)
        call = lambda: fa.flash_attention_bwd(q, k, v, mask, out, dout,  # noqa: E731
                                              lse.to(torch.bfloat16), True, 0.125)
    launches = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    with pytest.raises((TypeError, ValueError)):
        call()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == launches


# ------------------------------------- the training step (K3 forward + backward)


def _train_config():
    tiny = PlanGenModelConfig.tiny()
    return dataclasses.replace(  # LLaMA head_dim 128 and SigLIP head_dim 64: both on K3
        tiny,
        llama=dataclasses.replace(tiny.llama, num_heads=2, num_kv_heads=1, head_dim=128,
                                  hidden_size=256, intermediate_size=256),
        vision=dataclasses.replace(tiny.vision, width=128, heads=2),
        aligner=dataclasses.replace(tiny.aligner, input_dim=128, n_embed=256),
        gen_aligner=dataclasses.replace(tiny.gen_aligner, n_embed=256),
    )


def _train_batches(cfg, dev, B=2, L=8):
    rs = np.random.RandomState(0)
    n, size = cfg.image_seq_len, cfg.vision.image_size
    ids = rs.randint(3, 100, size=(B, L))
    text_mask = np.ones((B, L), np.int32)
    text_mask[1, :3] = 0  # a left-padded row: its last pad is read by the LM loss
    ids[1, :3] = 2
    seq_mask = np.zeros((B, L), bool)
    seq_mask[:, 1:1 + n] = True
    img = rs.uniform(-1, 1, size=(B, size, size, 3)).astype(np.float32)
    b = {0: {"input_ids": ids, "images": img,
             "attn_mask": np.concatenate([text_mask, np.ones((B, n), np.int32)], 1)},
         1: {"input_ids": ids, "attn_mask": np.ones((B, L), np.int32), "images": img,
             "images_seq_mask": seq_mask},
         2: {"input_ids": ids, "attn_mask": text_mask}}
    return {f: {k: torch.from_numpy(np.array(v)).to(dev) for k, v in d.items()}
            for f, d in b.items()}


def test_tiny_train_step_on_card_equals_cpu(cuda):
    """One stage3 train step with use_flash_attention, fp32 compute: on the
    card every attention goes through K3 forward and backward; the losses,
    gradients and updated weights equal the CPU step's (plain version)."""
    from plangen_tpu_torch.config import TrainConfig
    from plangen_tpu_torch.ops import flash_attention as fa
    from plangen_tpu_torch.train.optim import make_optimizer
    from plangen_tpu_torch.train.step import init_train_state, make_train_step

    cfg = _train_config()
    tcfg = TrainConfig(use_flash_attention=True)
    flows = ((0, "uni"), (1, "mmu"), (2, "plan"))
    cpu_model = init_params(PlanGenModel(cfg, dtype=torch.float32),
                            torch.Generator().manual_seed(0))
    card_model = PlanGenModel(cfg, dtype=torch.float32, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    results = {}
    for dev, model in ((torch.device("cpu"), cpu_model), (cuda, card_model)):
        opt, mask = make_optimizer(tcfg.optim, model, "stage3")
        step = make_train_step(cfg, tcfg, 2, flows, compute_dtype=torch.float32,
                               trainable_mask=mask)
        grads = {}
        real = opt.step
        opt.step = lambda g, real=real, grads=grads: (grads.update(
            {n: t.detach().cpu().clone() for n, t in g.items() if t is not None}), real(g))
        counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
                  fa.flash_attention_reference.calls)
        state, metrics = step(init_train_state(model, opt), _train_batches(cfg, dev))
        counts = (fa.flash_attention_fwd.launches - counts[0],
                  fa.flash_attention_bwd.launches - counts[1],
                  fa.flash_attention_reference.calls - counts[2])
        results[dev.type] = ({k: float(v) for k, v in metrics.items()}, grads,
                             {k: v.detach().cpu() for k, v in model.state_dict().items()},
                             counts)
    n_attn = cfg.vision.layers + 3 * cfg.llama.num_layers
    assert results["cpu"][3] == (0, 0, n_attn)
    assert results["cuda"][3] == (n_attn, n_attn, 0)
    for k, v in results["cpu"][0].items():
        np.testing.assert_allclose(results["cuda"][0][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    assert sorted(results["cuda"][1]) == sorted(results["cpu"][1])
    for k, g in results["cpu"][1].items():
        torch.testing.assert_close(results["cuda"][1][k], g, rtol=1e-3, atol=1e-4,
                                   msg=lambda m, k=k: f"grad {k}: {m}")
    # Adam moves a weight by up to lr whatever the gradient's size, so a
    # gradient at rounding-noise level may move the two copies 2 lr apart
    lr = tcfg.optim.learning_rate
    for k, w in results["cpu"][2].items():
        torch.testing.assert_close(results["cuda"][2][k], w, rtol=0, atol=2 * lr,
                                   msg=lambda m, k=k: f"weight {k}: {m}")


# ------------------------------------- the image loop in a CUDA graph


def _graph_model(cuda, quantize=None):
    """The tiny head_dim-64 model in bf16 on the card, quantized in place."""
    cfg = _tiny_d64()
    model = init_params(PlanGenModel(cfg, dtype=torch.bfloat16, device=cuda),
                        torch.Generator(device=cuda).manual_seed(0)).eval()
    if quantize is not None:
        quantize_model_(model, quantize)
    return cfg, model


def _graph_prompt(cuda, cfg, n):
    rs = np.random.RandomState(0)
    embeds = torch.from_numpy(rs.randn(4, 12, cfg.llama.hidden_size).astype(np.float32))
    mask = torch.ones((4, 12 + n), dtype=torch.int32)
    mask[1, :3] = 0
    mask[2, :7] = 0
    return embeds.to(cuda, torch.bfloat16), mask.to(cuda)


def _loop_counts():
    return (da.prefix_decode_attention.launches, da.prefix_decode_attention_q8.launches,
            im.int4_matmul_w16.launches, im.int4_matmul_w16.tc_launches,
            im.int4_matmul_w4a8.launches)


# case: (quantize, int8 cache, temperature, generators, teacher forcing)
GRAPH_CASES = {
    "bf16_greedy": (None, False, 0.0, None, False),
    "bf16_per_row_sampled": (None, False, 1.0, "per_row", False),
    "bf16_partial_forcing": (None, False, 1.0, "one", True),
    "int8_cache": (None, True, 1.0, "per_row", False),
    "int4": ("int4", True, 1.0, "per_row", True),
    "int4_a8": ("int4_a8", True, 0.0, None, False),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_equals_eager_loop(cuda, case):
    """`generate_image_tokens` on the card (step 0 eager, then a captured
    step replayed) against its eager loop (`eager=True`): the same tokens,
    bit for bit, from generators seeded alike, and the same launch counts."""
    quantize, q8, temperature, gens, forcing = GRAPH_CASES[case]
    cfg, model = _graph_model(cuda, quantize)
    n = 16
    embeds, mask = _graph_prompt(cuda, cfg, n)
    rs = np.random.RandomState(3)
    gt = regen = None
    if forcing:
        gt = torch.from_numpy(rs.randint(0, cfg.image_token_size, (2, n))).to(cuda)
        regen = torch.from_numpy((rs.rand(2, n) < 0.5).astype(np.int32)).to(cuda)

    def run(eager):
        generator = None
        if gens == "one":
            generator = torch.Generator(device=cuda).manual_seed(5)
        elif gens == "per_row":
            generator = [torch.Generator(device=cuda).manual_seed(s) for s in (5, 6)]
        before = _loop_counts()
        tokens = generate_image_tokens(
            model, cfg, embeds, mask, generator=generator, cfg_weight=5.0,
            temperature=temperature, gt_tokens=gt, regen_mask=regen, num_tokens=n,
            quantized_cache=q8, eager=eager)
        torch.cuda.synchronize()
        return tokens.cpu(), tuple(a - b for a, b in zip(_loop_counts(), before))

    eager_tokens, eager_counts = run(eager=True)
    graph_tokens, graph_counts = run(eager=False)
    assert torch.equal(graph_tokens, eager_tokens)
    assert graph_counts == eager_counts
    L = cfg.llama.num_layers
    assert eager_counts[1 if q8 else 0] == n * L
    if quantize is not None:  # the prefill's 4 x 12 rows take the kernel too
        assert eager_counts[4 if quantize == "int4_a8" else 2] == n * (4 * L + 1) + 4 * L
    if forcing:
        keep = (regen == 0).cpu()
        assert torch.equal(graph_tokens[keep], gt.cpu()[keep])
    if temperature:
        assert len(set(graph_tokens.flatten().tolist())) > 1


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("per_row", [False, True], ids=["one_generator", "per_row"])
def test_draw_equals_multinomial_on_card(cuda, per_row, temperature):
    """The capture-safe draw against `torch.multinomial` on CUDA generators:
    the same tokens and the same generator state, step after step."""
    from plangen_tpu_torch.ops.sampling import sample_categorical

    B, V = 4, 16384
    mine = [torch.Generator(device=cuda).manual_seed(r) for r in range(B)]
    theirs = [torch.Generator(device=cuda).manual_seed(r) for r in range(B)]
    g = torch.Generator(device=cuda).manual_seed(9)
    for _ in range(5):
        logits = torch.randn((B, V), generator=g, device=cuda) * 4
        probs = torch.softmax(logits / temperature, dim=-1)
        if per_row:
            got = sample_categorical(logits, temperature, mine)
            want = torch.cat([torch.multinomial(p[None], 1, generator=r)[:, 0]
                              for p, r in zip(probs, theirs)])
        else:
            got = sample_categorical(logits, temperature, mine[0])
            want = torch.multinomial(probs, 1, generator=theirs[0])[:, 0]
        assert torch.equal(got, want)
        for a, b in zip(mine, theirs):
            assert torch.equal(a.get_state(), b.get_state())


def test_host_read_in_a_step_raises(cuda, monkeypatch):
    """A step that reads a device value on the host cannot be captured:
    `generate_image_tokens` raises instead of running the eager loop, and
    the launch counts keep only what ran (the prefill and step 0)."""
    from plangen_tpu_torch.runtime import generate as gen_mod

    cfg, model = _graph_model(cuda)
    n = 8
    embeds, mask = _graph_prompt(cuda, cfg, n)
    combine = gen_mod.cfg_combine

    def reads_on_host(logits, w):
        if float(logits.abs().max()) < 0:  # a host read of a device value
            raise AssertionError
        return combine(logits, w)

    monkeypatch.setattr(gen_mod, "cfg_combine", reads_on_host)
    before = da.prefix_decode_attention.launches
    with pytest.raises(RuntimeError):
        generate_image_tokens(model, cfg, embeds, mask, generator=None, cfg_weight=5.0,
                              temperature=0.0, num_tokens=n)
    assert da.prefix_decode_attention.launches - before == cfg.llama.num_layers
    monkeypatch.undo()
    torch.cuda.synchronize()
    tokens = generate_image_tokens(model, cfg, embeds, mask, generator=None,
                                   cfg_weight=5.0, temperature=0.0, num_tokens=n)
    assert tokens.shape == (2, n)


# -------------------------------------- the text loop in a CUDA graph

TEXT_EOS = 1  # the byte-fallback tokenizer's EOS id


def _text_prompt(cuda, cfg, n, shared=False):
    """Text embeds [3, 12, H] bf16 and mask [3, 12 + n]: left-padded rows,
    or (`shared`) three rows of one prompt behind 2 pads."""
    rs = np.random.RandomState(1)
    embeds = rs.randn(3, 12, cfg.llama.hidden_size).astype(np.float32)
    mask = np.ones((3, 12 + n), dtype=np.int32)
    if shared:
        embeds[:] = embeds[0]
        mask[:, :2] = 0
    else:
        mask[1, :3] = 0
        mask[2, :7] = 0
    return (torch.from_numpy(embeds).to(cuda, torch.bfloat16),
            torch.from_numpy(mask).to(cuda))


def _graphs_made(monkeypatch):
    """A list that gets one entry for each CUDA graph the runtime captures."""
    from plangen_tpu_torch.runtime import generate as gen_mod

    made, cls = [], gen_mod.StepGraph
    monkeypatch.setattr(gen_mod, "StepGraph", lambda *a, **kw: made.append(1) or cls(*a, **kw))
    return made


def _text_run(model, cfg, embeds, mask, eos, n, q8=False, eager=False):
    before = _loop_counts()
    tokens = greedy_decode_text(model, cfg, embeds, mask, eos, max_new_tokens=n,
                                quantized_cache=q8, eager=eager)
    torch.cuda.synchronize()
    return tokens.cpu(), tuple(a - b for a, b in zip(_loop_counts(), before))


# mode: (quantize, int8 cache)
TEXT_GRAPH_MODES = {"dense": (None, False), "int8_kv": (None, True),
                    "int4": ("int4", True), "int4_a8": ("int4_a8", True)}


@pytest.mark.parametrize("mode", sorted(TEXT_GRAPH_MODES))
def test_text_graph_equals_eager_loop(cuda, mode, monkeypatch):
    """`greedy_decode_text` on the card (step 0 eager, then one captured
    step replayed; in the int4 forms K2 or K4 at `lm_head` too) against its
    eager loop (`eager=True`): the same tokens, bit for bit, and the same
    launch counts; one graph captured, none by the eager loop."""
    quantize, q8 = TEXT_GRAPH_MODES[mode]
    cfg, model = _graph_model(cuda, quantize)
    n = 40
    embeds, mask = _text_prompt(cuda, cfg, n)
    graphs = _graphs_made(monkeypatch)
    eager_tokens, eager_counts = _text_run(model, cfg, embeds, mask, TEXT_EOS, n, q8, True)
    assert not graphs
    graph_tokens, graph_counts = _text_run(model, cfg, embeds, mask, TEXT_EOS, n, q8)
    assert len(graphs) == 1
    assert graph_tokens.dtype == torch.int32 and graph_tokens.shape == (3, n)
    assert torch.equal(graph_tokens, eager_tokens)
    assert graph_counts == eager_counts
    L = cfg.llama.num_layers
    steps = text_decode_steps(eager_tokens, TEXT_EOS)
    assert eager_counts[1 if q8 else 0] == steps * L
    if quantize is not None:  # the prefill's 3 x 12 rows take the kernel too
        assert eager_counts[4 if quantize == "int4_a8" else 2] == steps * (4 * L + 1) + 4 * L
    if quantize == "int4":
        assert eager_counts[3] == eager_counts[2]  # bf16 K2 on the tensor cores


@pytest.mark.parametrize("exit_at", ["mid_way", "step_0", "budget_1"])
def test_text_graph_stops_at_the_exit(cuda, exit_at, monkeypatch):
    """Rows of one prompt, with EOS a token their no-EOS stream emits first
    at a column from 8 on: the graph loop stops at the step the tokens
    imply, each row the stream's prefix and then EOS. With EOS the first
    token, or a budget of 1, the loop ends after step 0 and captures
    nothing."""
    cfg, model = _graph_model(cuda)
    n = 1 if exit_at == "budget_1" else 40
    embeds, mask = _text_prompt(cuda, cfg, n, shared=True)
    free, _ = _text_run(model, cfg, embeds, mask, TEXT_EOS, n, eager=True)
    free = free.numpy()
    eos, col = TEXT_EOS, n  # budget 1: the free stream, one step
    if exit_at == "step_0":
        eos, col = int(free[0, 0]), 0
    elif exit_at == "mid_way":
        row = free[0]
        col = next(c for c in range(8, n) if int(np.flatnonzero(row == row[c])[0]) == c
                   and all((r[:c] != row[c]).all() and r[c] == row[c] for r in free))
        eos = int(row[col])
    graphs = _graphs_made(monkeypatch)
    got, counts = _text_run(model, cfg, embeds, mask, eos, n)
    got = got.numpy()
    steps = min(col + 1, n)
    assert len(graphs) == (1 if exit_at == "mid_way" else 0)
    assert text_decode_steps(got, eos) == steps
    assert counts[0] == steps * cfg.llama.num_layers
    np.testing.assert_array_equal(got[:, :col], free[:, :col])
    assert (got[:, col:] == eos).all()


def test_host_read_in_a_text_step_raises(cuda, monkeypatch):
    """A text step that reads a device value on the host cannot be
    captured: `greedy_decode_text` raises instead of running the eager loop,
    and the launch counts keep only what ran (step 0)."""
    cfg, model = _graph_model(cuda)
    n = 8
    embeds, mask = _text_prompt(cuda, cfg, n)
    embed = model.embed_text

    def reads_on_host(ids):
        if int(ids.max()) < 0:  # a host read of a device value
            raise AssertionError
        return embed(ids)

    monkeypatch.setattr(model, "embed_text", reads_on_host)
    before = da.prefix_decode_attention.launches
    with pytest.raises(RuntimeError):
        greedy_decode_text(model, cfg, embeds, mask, TEXT_EOS, max_new_tokens=n)
    assert da.prefix_decode_attention.launches - before == cfg.llama.num_layers
    monkeypatch.undo()
    torch.cuda.synchronize()
    tokens = greedy_decode_text(model, cfg, embeds, mask, TEXT_EOS, max_new_tokens=n)
    assert tokens.shape == (3, n)


# ------------------------------------------------------------- serving


def _serving_cfg(**gen):
    """The tiny head_dim-64 model as a full config for `build_pipeline`."""
    from plangen_tpu_torch.config import GenerationConfig, PlanGenConfig

    model = _tiny_d64()
    model = dataclasses.replace(model, aligner=dataclasses.replace(model.aligner, n_embed=128))
    return PlanGenConfig(model=model, generation=GenerationConfig(
        max_new_text_tokens=8, output_uint8=True, **gen))


def _post(base, path, payload):
    import json
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


class _Server:
    """The port's batcher and HTTP server in-process on 127.0.0.1:0."""

    def __init__(self, pipe, **kw):
        import threading

        from plangen_tpu_torch.serve import Batcher, make_server

        pipe.defer_fetch = True
        self.batcher = Batcher(pipe, **kw)
        self.httpd = make_server(self.batcher, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()


def test_build_pipeline_runs_on_the_card_by_default(cuda):
    from plangen_tpu_torch.tasks.eval import build_pipeline

    pipe = build_pipeline(_serving_cfg())
    assert pipe.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in pipe.model.parameters())
    assert pipe.model.language_model.model.embed_tokens.weight.dtype == torch.bfloat16


def test_server_answers_generate_and_plan_on_the_card(cuda):
    import base64

    from plangen_tpu_torch.tasks.eval import build_pipeline
    from plangen_tpu_torch.utils.visualize import decode_png

    pipe = build_pipeline(_serving_cfg())
    server = _Server(pipe, max_batch=4, wait_ms=20.0)
    try:
        g = "<grounding><ref>a cat</ref><box>[100, 100, 600, 600]</box></grounding>"
        code, out = _post(server.base, "/generate", {"caption": "a cat", "grounding": g,
                                                     "seed": 3})
        assert code == 200 and len(out["tokens"]) == pipe.cfg.image_seq_len
        size = pipe.cfg.vision.image_size
        assert decode_png(base64.b64decode(out["image_b64"])).shape == (size, size, 3)
        code, plan = _post(server.base, "/plan", {"caption": "two dogs"})
        assert code == 200 and plan["grounding"] == pipe.plan(["two dogs"])[0]
    finally:
        server.close()


def test_concurrent_understand_and_generate_equal_one_by_one(cuda):
    """Requests of two modes at once: the device-owner thread runs both
    batches (each captures its graphs) while the other threads decode PNGs
    and assemble; no capture fails, and the answers equal those of the same
    requests served one at a time in the same bucket (min_batch 4)."""
    import threading

    from plangen_tpu_torch.serve import _png_b64
    from plangen_tpu_torch.tasks.eval import build_pipeline

    pipe = build_pipeline(_serving_cfg())
    rs = np.random.RandomState(0)
    size = pipe.cfg.vision.image_size
    g = "<grounding><ref>a dog</ref><box>[50, 80, 700, 900]</box></grounding>"
    requests = ([("/understand", {"image_b64": _png_b64(rs.randint(0, 256, (size, size, 3))
                                                         .astype(np.uint8))}) for _ in range(3)]
                + [("/generate", {"caption": f"scene {i}", "grounding": g, "seed": i})
                   for i in range(3)])

    def answer(out):
        return out.get("grounding") if "tokens" not in out else out["tokens"]

    server = _Server(pipe, max_batch=4, min_batch=4, wait_ms=50.0)
    try:
        together = [None] * len(requests)

        def call(i):
            together[i] = _post(server.base, *requests[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        alone = [_post(server.base, *r) for r in requests]
    finally:
        server.close()
    for (c1, o1), (c2, o2) in zip(together, alone):
        assert c1 == c2 == 200, (o1, o2)
        assert answer(o1) == answer(o2)


def test_auto_routes_launch_k2_only_up_to_64_rows(cuda):
    from plangen_tpu_torch.tasks.eval import build_pipeline

    pipe = build_pipeline(_serving_cfg(quantize="auto"))
    g = "<grounding><ref>cat</ref><box>[100, 100, 500, 500]</box></grounding>"
    dense_calls = []
    hooks = [m.register_forward_pre_hook(lambda *a: dense_calls.append(1))
             for m in pipe.model.language_model.modules() if isinstance(m, torch.nn.Linear)]
    try:
        for n, int4 in ((32, True), (33, False)):
            dense_calls.clear()
            k2 = (im.int4_matmul_w16.launches, da.prefix_decode_attention_q8.launches,
                  da.prefix_decode_attention.launches)
            out = pipe.layout_to_image([f"cat {i}" for i in range(n)], [g] * n,
                                       seeds=list(range(n)))
            torch.cuda.synchronize()
            launched = (im.int4_matmul_w16.launches - k2[0],
                        da.prefix_decode_attention_q8.launches - k2[1],
                        da.prefix_decode_attention.launches - k2[2])
            assert out.image_tokens.shape == (n, pipe.cfg.image_seq_len)
            steps, L = pipe.cfg.image_seq_len, pipe.cfg.llama.num_layers
            assert launched[1] == steps * L and launched[2] == 0  # int8 cache on both
            if int4:
                assert launched[0] == steps * (4 * L + 1) and not dense_calls
            else:
                assert launched[0] == 0 and dense_calls
    finally:
        for h in hooks:
            h.remove()


# ------------------------------------------------------------- fast_edit


# case: (model dtype, quantize)
FAST_EDIT_CASES = {"bf16": (torch.bfloat16, None), "int4": (torch.bfloat16, "int4"),
                   "fp32": (torch.float32, None)}


@pytest.mark.parametrize("case", sorted(FAST_EDIT_CASES))
def test_fast_edit_graph_equals_eager_and_the_full_loop(cuda, case):
    """`generate_image_tokens_fast_edit` on the card (the mixed steps on the
    graph, the frozen chunks eager between replays) against its eager run:
    the same tokens bit for bit, the same launches, 24 x the mixed steps
    of K1 or K1-q8; the forced tokens are the codes. Against the full graph
    loop: in fp32 every token is equal; in bf16 and int4 the chunk before
    the first frozen one is (the 16-row forward of a frozen chunk rounds
    apart from the loop's single rows, runtime/fast_edit.py)."""
    from plangen_tpu_torch.runtime.fast_edit import (
        frozen_chunk_schedule, generate_image_tokens_fast_edit,
    )

    dtype, quantize = FAST_EDIT_CASES[case]
    cfg = _tiny_d64()
    model = init_params(PlanGenModel(cfg, dtype=dtype, device=cuda),
                        torch.Generator(device=cuda).manual_seed(0)).eval()
    if quantize is not None:
        quantize_model_(model, quantize)
    n = 64
    embeds, mask = _graph_prompt(cuda, cfg, n)
    embeds = embeds.to(dtype)
    rs = np.random.RandomState(3)
    gt = torch.from_numpy(rs.randint(0, cfg.image_token_size, (2, n))).to(cuda)
    regen_np = np.zeros((2, n), np.int32)
    regen_np[0, 3:9] = 1  # chunk 0 mixed, 1 frozen, 2 mixed, 3 frozen
    regen_np[1, 36:40] = 1
    regen = torch.from_numpy(regen_np).to(cuda)
    schedule = frozen_chunk_schedule(regen_np)
    assert schedule == (False, True, False, True)
    q8 = quantize is not None

    def run(fast, eager):
        generator = [torch.Generator(device=cuda).manual_seed(s) for s in (5, 6)]
        before = _loop_counts()
        kw = dict(generator=generator, cfg_weight=5.0, temperature=1.0, gt_tokens=gt,
                  regen_mask=regen, num_tokens=n, quantized_cache=q8, eager=eager)
        if fast:
            tokens = generate_image_tokens_fast_edit(model, cfg, embeds, mask,
                                                     schedule=schedule, **kw)
        else:
            tokens = generate_image_tokens(model, cfg, embeds, mask, **kw)
        torch.cuda.synchronize()
        return tokens.cpu(), tuple(a - b for a, b in zip(_loop_counts(), before))

    graph, graph_counts = run(fast=True, eager=False)
    eager, eager_counts = run(fast=True, eager=True)
    full, _ = run(fast=False, eager=False)
    assert torch.equal(graph, eager) and graph_counts == eager_counts
    assert graph_counts[1 if q8 else 0] == 32 * cfg.llama.num_layers
    keep = regen_np == 0
    assert torch.equal(graph[torch.from_numpy(keep)], gt.cpu()[torch.from_numpy(keep)])
    if dtype == torch.float32:
        assert torch.equal(graph, full)
    else:
        assert torch.equal(graph[:, :16], full[:, :16])


def test_run_validation_on_one_coco_batch_on_the_card(cuda, tmp_path):
    """`uni` over a COCO val2017 fixture on the card: the artifact tree,
    FID / KID over SigLIP features, and K1 at every decode step."""
    import importlib.util
    import json
    import pathlib

    from plangen_tpu_torch.config import apply_overrides
    from plangen_tpu_torch.tasks.eval import run_validation

    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = _serving_cfg()
    cfg = apply_overrides(cfg, {**smoke.write_eval_fixtures(tmp_path / "data"),
                                "janus_hw": cfg.model.vision.image_size,
                                "train.val_image_metrics": True})
    before = da.prefix_decode_attention.launches
    out = run_validation(cfg, "uni", "coco", 1, str(tmp_path / "out"), 4)
    torch.cuda.synchronize()
    assert da.prefix_decode_attention.launches - before == \
        cfg.model.image_seq_len * cfg.model.llama.num_layers
    base = tmp_path / "out" / "coco_uni_1"
    assert len(list((base / "0" / "pr_image").iterdir())) == 4
    assert len(list((base / "0" / "gt_image_ids").iterdir())) == 4
    metrics = json.loads((base / "0_metrics.json").read_text())
    assert sorted(metrics) == ["fid_siglip", "kid_siglip", "kid_siglip_std", "n_gt", "n_pr"]
    assert out[0]["pr_image"].shape[0] == 4


# ---------------------------------------- training options on the card


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_k3_under_remat_matches_no_remat(cuda, policy):
    """A LLaMA layer whose attention runs on K3 (bf16, head_dim 128, left
    pads) called under `ops/remat.py` with each policy against a plain call:
    the output and every gradient (input and weights) within K3's bf16
    tolerance (2e-2); K3's forward launched twice under remat (the
    recompute runs it again), its backward once, all on the tensor cores."""
    from plangen_tpu_torch.models.llama import LlamaDecoderLayer, rope_cos_sin
    from plangen_tpu_torch.ops import flash_attention as fa
    from plangen_tpu_torch.ops.remat import remat_call

    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_layers=1,
                      num_heads=2, num_kv_heads=2, head_dim=128)
    g = torch.Generator(device=cuda).manual_seed(0)
    layer = LlamaDecoderLayer(cfg, dtype=torch.bfloat16, device=cuda)
    with torch.no_grad():
        for p in layer.parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=g, device=cuda) * p.shape[1] ** -0.5)
    B, S = 3, 200
    x = torch.randn((B, S, cfg.hidden_size), generator=g, device=cuda).to(torch.bfloat16)
    dout = torch.randn((B, S, cfg.hidden_size), generator=g, device=cuda).to(torch.bfloat16)
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
    mask[1, :17] = 0
    mask[2, :90] = 0
    pos = torch.arange(S, dtype=torch.int32, device=cuda)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)

    def run(remat):
        leaf = x.clone().requires_grad_()
        before = (fa.flash_attention_fwd.routes["tensor_cores"],
                  fa.flash_attention_bwd.routes["tensor_cores"], fa.flash_attention_reference.calls)
        out = remat_call(layer, remat, leaf, cos, sin, None, pos, mask, None, 0, mask)
        out.backward(dout)
        torch.cuda.synchronize()
        after = (fa.flash_attention_fwd.routes["tensor_cores"],
                 fa.flash_attention_bwd.routes["tensor_cores"], fa.flash_attention_reference.calls)
        grads = [leaf.grad] + [p.grad.clone() for p in layer.parameters()]
        layer.zero_grad(set_to_none=True)
        return [out.detach()] + grads, tuple(a - b for a, b in zip(after, before))

    want, plain_counts = run(False)
    got, remat_counts = run(policy)
    assert plain_counts == (1, 1, 0) and remat_counts == (2, 1, 0)
    for i, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all()), i
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("loop", ["image", "text"])
def test_lora_captured_steps_equal_eager_loops(cuda, loop, monkeypatch):
    """A bf16 model with non-zero LoRA adapters (`train/lora.py`): the image
    loop's and the text loop's captured steps give the tokens of their eager
    loops (`eager=True`), bit for bit; the adapters' delta is in the
    captured step, as the JAX layer applies it in decode."""
    from plangen_tpu_torch.train.lora import add_lora, init_lora

    cfg, model = _graph_model(cuda)
    add_lora(model, 8, 16)
    g = torch.Generator(device=cuda).manual_seed(1)
    init_lora(model, g)
    with torch.no_grad():
        for layer in model.language_model.model.layers:
            for pair in layer.self_attn.lora.values():
                pair.b.copy_(torch.randn(pair.b.shape, generator=g, device=cuda) * 0.5)
    graphs = _graphs_made(monkeypatch)
    if loop == "image":
        n = 16
        embeds, mask = _graph_prompt(cuda, cfg, n)

        def run(eager):
            return generate_image_tokens(model, cfg, embeds, mask, None, 5.0, 0.0,
                                         num_tokens=n, eager=eager)
    else:
        n = 40
        embeds, mask = _text_prompt(cuda, cfg, n)

        def run(eager):
            return greedy_decode_text(model, cfg, embeds, mask, TEXT_EOS, max_new_tokens=n,
                                      eager=eager)
    eager_tokens = run(True).cpu()
    assert not graphs
    graph_tokens = run(False).cpu()
    torch.cuda.synchronize()
    assert len(graphs) == 1
    assert torch.equal(graph_tokens, eager_tokens)


# ---------------------------------------------------------- the opt-in decoders


def _spec_prompt(cuda, cfg, n):
    """One image's CFG pair: embeds [2, 12, H] bf16, mask [2, 12 + n]."""
    embeds, mask = _graph_prompt(cuda, cfg, n)
    return embeds[:2].contiguous(), mask[:2].contiguous()


def _spec_run(model, cfg, embeds, mask, n, temperature, eager, draft_layers=1, seed=5):
    from plangen_tpu_torch.runtime.speculative import generate_image_tokens_spec

    generator = (None if temperature == 0
                 else torch.Generator(device=embeds.device).manual_seed(seed))
    before = _loop_counts()
    plain = da.prefix_decode_attention_reference.calls
    out = generate_image_tokens_spec(model, cfg, embeds, mask, generator, 5.0, temperature,
                                     num_tokens=n, draft_layers=draft_layers, draft_len=3,
                                     eager=eager)
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(_loop_counts(), before))
    return out.tokens.cpu(), out.rounds, counts, da.prefix_decode_attention_reference.calls - plain


@pytest.mark.parametrize("temperature", [1.0, 0.0], ids=["sampled", "greedy"])
def test_speculative_graph_round_equals_the_eager_round(cuda, temperature, monkeypatch):
    """`generate_image_tokens_spec` on the card (round 1 eager, then one
    captured round replayed) against its eager round loop: the same tokens
    and rounds, bit for bit, from generators seeded alike; one graph."""
    from plangen_tpu_torch.runtime import speculative as spec_mod

    cfg, model = _graph_model(cuda)
    n = 40
    embeds, mask = _spec_prompt(cuda, cfg, n)
    made, cls = [], spec_mod.StepGraph
    monkeypatch.setattr(spec_mod, "StepGraph", lambda *a, **kw: made.append(1) or cls(*a, **kw))
    eager = _spec_run(model, cfg, embeds, mask, n, temperature, eager=True)
    assert not made
    graph = _spec_run(model, cfg, embeds, mask, n, temperature, eager=False)
    assert len(made) == 1
    assert torch.equal(graph[0], eager[0]) and graph[1] == eager[1] and graph[2] == eager[2]
    assert graph[0].shape == (1, n) and int(graph[0].max()) < cfg.image_token_size


def test_speculative_call_launches_k1_and_no_plain_version(cuda):
    """Each round's 3 draft steps launch K1 in each of the draft's layers;
    the verify attends densely; the plain version never runs. In fp32 a
    full-depth greedy draft gives base greedy's tokens."""
    cfg, model = _graph_model(cuda)
    n = 40
    embeds, mask = _spec_prompt(cuda, cfg, n)
    tokens, rounds, counts, plain = _spec_run(model, cfg, embeds, mask, n, 1.0, eager=False)
    assert counts[0] == rounds * 3 * 1 and sum(counts[1:]) == 0 and plain == 0
    L = cfg.llama.num_layers
    model, embeds = model.float(), embeds.float()
    tokens, rounds, counts, plain = _spec_run(model, cfg, embeds, mask, n, 0.0, eager=False,
                                              draft_layers=L)
    base = generate_image_tokens(model, cfg, embeds, mask, None, 5.0, 0.0, num_tokens=n)
    assert counts[0] == rounds * 3 * L and plain == 0
    assert torch.equal(tokens, base.cpu())


def test_jacobi_equals_the_graph_text_loop_in_fp32(cuda):
    """Jacobi on the card in fp32 (dense attention, no kernel) gives the
    graph text loop's tokens (K1 at every step)."""
    from plangen_tpu_torch.runtime.jacobi import jacobi_decode_text

    cfg = _tiny_d64()
    model = init_params(PlanGenModel(cfg, dtype=torch.float32, device=cuda),
                        torch.Generator(device=cuda).manual_seed(0)).eval()
    n = 24
    embeds, mask = _text_prompt(cuda, cfg, n)
    embeds = embeds.float()
    seq, _ = _text_run(model, cfg, embeds, mask, TEXT_EOS, n)
    before = _loop_counts()
    jac, iters = jacobi_decode_text(model, cfg, embeds, mask, TEXT_EOS, max_new_tokens=n,
                                    return_iters=True)
    assert _loop_counts() == before
    assert torch.equal(jac.cpu(), seq) and 1 <= iters <= n


# ---------------------------- parallel/mesh.py over a world-1 NCCL group


@pytest.fixture
def world1_nccl(cuda):
    """A 1 x 1 mesh over a world-1 NCCL group on cuda:0, destroyed after."""
    import torch.distributed as dist

    from plangen_tpu_torch.parallel import mesh as pm

    mesh = pm.create_mesh({"data": 1, "model": 1})
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


# the `fsdp_min_size` of JAX's own tests: FSDP shards some of these small
# models' tensors (along dims 0 and 1) and leaves the rest whole
FSDP_MIN = 1000


def _mixed(model) -> bool:
    """Whether FSDP sharded some parameters along dim 0 and some along dim 1
    (DTensors over "data"), and left some whole (plain tensors)."""
    from torch.distributed.tensor import DTensor

    from plangen_tpu_torch.parallel import mesh as pm

    kinds = {None if not isinstance(p, DTensor) else
             pm.split_dim(p.placements[0]) if p.device_mesh.mesh_dim_names == ("data",) else "tp"
             for p in model.parameters()}
    return {0, 1, None} <= kinds


def test_fsdp_train_step_over_nccl_equals_the_plain_step(cuda, world1_nccl):
    """One stage3 step (fp32 compute, K3) under FSDP2 over the world-1 NCCL
    group (`fsdp_min_size` 1000: a mix of sharded and whole tensors) equals
    the plain step: the losses, and the weights to Adam's 2 lr (a
    rounding-level gradient may take either sign)."""
    from plangen_tpu_torch.config import TrainConfig
    from plangen_tpu_torch.ops import flash_attention as fa
    from plangen_tpu_torch.parallel import mesh as pm
    from plangen_tpu_torch.train.optim import make_optimizer, trainable_mask
    from plangen_tpu_torch.train.step import init_train_state, make_train_step

    cfg = _train_config()
    tcfg = TrainConfig(use_flash_attention=True)
    flows = ((0, "uni"), (1, "mmu"), (2, "plan"))
    results = {}
    for fsdp in (False, True):
        model = init_params(PlanGenModel(cfg, dtype=torch.float32, device=cuda),
                            torch.Generator(device=cuda).manual_seed(0))
        if fsdp:
            for name, trainable in trainable_mask(model, "stage3").items():
                model.get_parameter(name).requires_grad_(trainable)
            pm.shard_params(model, world1_nccl, tp_axis=None, fsdp_axis="data",
                            fsdp_min_size=FSDP_MIN)
            assert _mixed(model)
        opt, mask = make_optimizer(tcfg.optim, model, "stage3")
        step = make_train_step(cfg, tcfg, 2, flows, compute_dtype=torch.float32,
                               trainable_mask=mask)
        plain = fa.flash_attention_reference.calls
        _, metrics = step(init_train_state(model, opt), _train_batches(cfg, cuda))
        assert fa.flash_attention_reference.calls == plain
        with torch.no_grad():
            weights = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).cpu()
                       for n, p in model.named_parameters()}
        results[fsdp] = ({k: float(v) for k, v in metrics.items()}, weights)
    assert pm.is_sharded(model)
    for k, v in results[False][0].items():
        np.testing.assert_allclose(results[True][0][k], v, rtol=1e-6, err_msg=k)
    lr = tcfg.optim.learning_rate
    for k, w in results[False][1].items():
        torch.testing.assert_close(results[True][1][k], w, rtol=0, atol=2 * lr,
                                   msg=lambda m, k=k: f"weight {k}: {m}")


@pytest.mark.parametrize("case", ["bf16_greedy", "bf16_per_row_sampled", "int8_cache"])
def test_tp_sharded_graph_equals_eager_and_the_unsharded_model(cuda, world1_nccl, case):
    """The image loop of a model TP-sharded over the world-1 "model" axis:
    the captured step (its all-reduces and gathers included) replays the
    eager loop's tokens bit for bit, and both equal the unsharded model's."""
    import copy

    from plangen_tpu_torch.parallel import mesh as pm

    _, q8, temperature, gens, _ = GRAPH_CASES[case]
    cfg, model = _graph_model(cuda)
    tp_model = pm.shard_params(copy.deepcopy(model), world1_nccl, tp_axis="model")
    assert pm.is_sharded(tp_model)
    n = 16
    embeds, mask = _graph_prompt(cuda, cfg, n)

    def run(m, eager):
        generator = None
        if gens == "per_row":
            generator = [torch.Generator(device=cuda).manual_seed(s) for s in (5, 6)]
        before = _loop_counts()
        tokens = generate_image_tokens(m, cfg, embeds, mask, generator=generator,
                                       cfg_weight=5.0, temperature=temperature,
                                       num_tokens=n, quantized_cache=q8, eager=eager)
        torch.cuda.synchronize()
        return tokens.cpu(), tuple(a - b for a, b in zip(_loop_counts(), before))

    want, want_counts = run(model, eager=False)
    for eager in (True, False):
        tokens, counts = run(tp_model, eager)
        assert torch.equal(tokens, want), eager
        assert counts == want_counts
    assert want_counts[1 if q8 else 0] == n * cfg.llama.num_layers


@pytest.mark.parametrize("mode", ["int8", "int4", "int4_a8"])
def test_quantized_tp_graph_equals_eager_and_the_unsharded_model(cuda, world1_nccl, mode):
    """A bf16 model split over the world-1 "model" axis, then quantized on
    its shards (`quantize_model_` of a TP model): the captured image step
    replays its eager loop's tokens bit for bit, both equal the unsharded
    quantized model's with the same kernel launches (K2 on the tensor
    cores, K4, K1-q8), and the quantized model split by `shard_params`
    holds the same bytes."""
    import copy

    from plangen_tpu_torch.parallel import mesh as pm

    cfg, dense = _graph_model(cuda)
    model = quantize_model_(copy.deepcopy(dense), mode)
    tp_model = quantize_model_(pm.shard_params(copy.deepcopy(dense), world1_nccl,
                                               tp_axis="model"), mode)
    split = pm.shard_params(copy.deepcopy(model), world1_nccl, tp_axis="model")
    bufs, split_bufs = dict(tp_model.named_buffers()), dict(split.named_buffers())
    assert sorted(bufs) == sorted(split_bufs)
    assert all(torch.equal(bufs[n], split_bufs[n]) for n in bufs)
    n = 16
    embeds, mask = _graph_prompt(cuda, cfg, n)

    def run(m, eager):
        before = _loop_counts()
        tokens = generate_image_tokens(m, cfg, embeds, mask, generator=None, cfg_weight=5.0,
                                       temperature=0.0, num_tokens=n, quantized_cache=True,
                                       eager=eager)
        torch.cuda.synchronize()
        return tokens.cpu(), tuple(a - b for a, b in zip(_loop_counts(), before))

    want, want_counts = run(model, eager=False)
    for eager in (True, False):
        tokens, counts = run(tp_model, eager)
        assert torch.equal(tokens, want), eager
        assert counts == want_counts
    k2, k2_tc, k4 = want_counts[2:]
    # every decode step's projections and head; the prefill's projections
    # too (4 rows x 12 positions: the kernel's <= 256 rows)
    matmuls = n * (4 * cfg.llama.num_layers + 1) + 4 * cfg.llama.num_layers
    assert want_counts[1] == n * cfg.llama.num_layers
    assert (k2, k2_tc, k4) == {"int8": (0, 0, 0), "int4": (matmuls, matmuls, 0),
                               "int4_a8": (0, 0, matmuls)}[mode]


def test_adafactor_fsdp_steps_over_nccl_equal_the_plain_steps(cuda, world1_nccl):
    """Two stage3 Adafactor steps (fp32 masters, bf16 compute as the
    Trainer runs them, K3) under FSDP2 over the world-1 NCCL group
    (`fsdp_min_size` 1000: a mix of sharded and whole tensors) equal the
    plain steps bit for bit: the losses, every weight, and the factored
    statistics."""
    from plangen_tpu_torch.config import OptimConfig, TrainConfig
    from plangen_tpu_torch.parallel import mesh as pm
    from plangen_tpu_torch.train.optim import make_optimizer, trainable_mask
    from plangen_tpu_torch.train.step import init_train_state, make_train_step

    cfg = _train_config()
    tcfg = TrainConfig(use_flash_attention=True,
                       optim=OptimConfig(optimizer="adafactor", learning_rate=1e-3))
    flows = ((0, "uni"), (1, "mmu"), (2, "plan"))
    results = {}
    for fsdp in (False, True):
        model = init_params(PlanGenModel(cfg, dtype=torch.float32, device=cuda),
                            torch.Generator(device=cuda).manual_seed(0))
        if fsdp:
            for name, trainable in trainable_mask(model, "stage3").items():
                model.get_parameter(name).requires_grad_(trainable)
            pm.shard_params(model, world1_nccl, tp_axis=None, fsdp_axis="data",
                            param_dtype=torch.bfloat16, fsdp_min_size=FSDP_MIN)
            assert _mixed(model)
        opt, mask = make_optimizer(tcfg.optim, model, "stage3")
        step = make_train_step(cfg, tcfg, 2, flows, compute_dtype=torch.bfloat16,
                               trainable_mask=mask)
        state = init_train_state(model, opt)
        losses = []
        for _ in range(2):
            state, metrics = step(state, _train_batches(cfg, cuda))
            losses.append({k: float(v) for k, v in metrics.items()})
        with torch.no_grad():
            weights = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).cpu()
                       for n, p in model.named_parameters()}
            stats = {f"{kind}/{k}": (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu()
                     for kind in ("v_row", "v_col", "v") for k, t in getattr(opt, kind).items()}
        assert opt.v_row  # 256-wide matrices factor
        results[fsdp] = (losses, weights, stats)
    assert pm.is_sharded(model)
    assert results[True][0] == results[False][0]
    for i in (1, 2):
        for k, w in results[False][i].items():
            assert torch.equal(results[True][i][k], w), k


# ------------------------ FSDP x TP: four gloo ranks with CUDA tensors

FSDP_TP_TIMEOUT_S = 240.0
# AdamW's first moment after the step (linear in the clipped gradient), each
# tensor in L2 norm relative to the plain step's: fp32 sums over the data
# shards and TP partial sums in another order; a gradient left unsummed over
# the two data shards parts by ~0.5
FSDP_TP_MU_RTOL = 1e-5


def _fsdp_tp_config():
    """`_train_config` with LLaMA's KV heads split over tp 2 too."""
    cfg = _train_config()
    return dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, num_kv_heads=2))


def _fsdp_tp_rank(rank: int, port: int, fused_ce: bool, results) -> None:
    """One of four ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    device): one stage3 AdamW step (fp32 compute, K3, the fused lm_head CE
    when `fused_ce`) on a data 2 x model 2 mesh with FSDP over "data", this
    data shard's rows of the global batch."""
    import traceback

    import torch.distributed as dist

    try:
        from plangen_tpu_torch.config import TrainConfig
        from plangen_tpu_torch.ops import flash_attention as fa
        from plangen_tpu_torch.parallel import mesh as pm
        from plangen_tpu_torch.train.optim import make_optimizer, trainable_mask
        from plangen_tpu_torch.train.step import init_train_state, make_train_step

        dev = torch.device("cuda:0")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        pm.init_distributed(f"localhost:{port}", 4, rank, device="cpu")
        mesh = pm.create_mesh({"data": 2, "model": 2}, device="cuda")
        cfg = _fsdp_tp_config()
        tcfg = TrainConfig(use_flash_attention=True, fused_lm_ce=fused_ce)
        model = init_params(PlanGenModel(cfg, dtype=torch.float32, device=dev),
                            torch.Generator(device=dev).manual_seed(0))
        for name, trainable in trainable_mask(model, "stage3").items():
            model.get_parameter(name).requires_grad_(trainable)
        pm.shard_params(model, mesh, tp_axis="model", fsdp_axis="data", fsdp_min_size=FSDP_MIN)
        mixed = _mixed(model)
        opt, mask = make_optimizer(tcfg.optim, model, "stage3")
        step = make_train_step(cfg, tcfg, 2, ((0, "uni"), (1, "mmu"), (2, "plan")),
                               compute_dtype=torch.float32, trainable_mask=mask,
                               group=mesh["data"].get_group())
        batches = {f: {k: pm.shard_rows(v, mesh) for k, v in b.items()}
                   for f, b in _train_batches(cfg, dev, B=4).items()}
        before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
                  fa.flash_attention_reference.calls)
        _, metrics = step(init_train_state(model, opt), batches)
        calls = tuple(a - b for a, b in zip((fa.flash_attention_fwd.launches,
                                              fa.flash_attention_bwd.launches,
                                              fa.flash_attention_reference.calls), before))
        with torch.no_grad():
            # numpy: a tensor in the queue would live in this process's shared memory
            mu = {n: pm.full_tensor(m).cpu().numpy() for n, m in opt.mu.items()}
        results.put((rank, ({k: float(v) for k, v in metrics.items()}, mu, calls, mixed)))
    except BaseException:
        results.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("fused_ce", [False, True], ids=["lm_ce", "fused_lm_ce"])
def test_fsdp_tp_step_over_four_gloo_ranks_equals_the_plain_step(cuda, fused_ce):
    """One stage3 AdamW step (fp32 compute) on a data 2 x model 2 mesh with
    FSDP over "data" (`fsdp_min_size` 1000: tensors FSDP-sharded along dims
    0 and 1, TP-split and whole), four gloo ranks sharing cuda:0, equals the plain step
    on the global batch: the losses on every rank, and AdamW's first moment
    of every parameter (the clipped gradient's tenth) within FSDP_TP_MU_RTOL
    (Adam's update itself does not see a gradient's scale). Each rank runs
    K3 forward and backward at its H/tp heads, no plain call. With
    `fused_lm_ce` the chunked CE gathers the vocab-split lm_head whole over
    gloo with CUDA tensors, and the plain step takes the fused CE too."""
    import multiprocessing
    import queue
    import socket
    import time

    from plangen_tpu_torch.config import TrainConfig
    from plangen_tpu_torch.train.optim import make_optimizer
    from plangen_tpu_torch.train.step import init_train_state, make_train_step

    cfg = _fsdp_tp_config()
    tcfg = TrainConfig(use_flash_attention=True, fused_lm_ce=fused_ce)
    model = init_params(PlanGenModel(cfg, dtype=torch.float32, device=cuda),
                        torch.Generator(device=cuda).manual_seed(0))
    opt, mask = make_optimizer(tcfg.optim, model, "stage3")
    step = make_train_step(cfg, tcfg, 2, ((0, "uni"), (1, "mmu"), (2, "plan")),
                           compute_dtype=torch.float32, trainable_mask=mask)
    _, metrics = step(init_train_state(model, opt), _train_batches(cfg, cuda, B=4))
    want = {k: float(v) for k, v in metrics.items()}
    want_mu = {n: m.cpu().numpy() for n, m in opt.mu.items()}
    del model, opt
    torch.cuda.empty_cache()

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_fsdp_tp_rank, args=(r, port, fused_ce, results))
             for r in range(4)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + FSDP_TP_TIMEOUT_S
    try:
        while len(got) < len(procs):
            try:
                rank, res = results.get(timeout=5.0)
            except queue.Empty:
                # a rank killed by a signal puts nothing in the queue
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got}
                assert not dead, f"ranks died without a result (exit codes {dead})"
                if time.monotonic() > deadline:
                    pytest.fail(f"four ranks: no result within {FSDP_TP_TIMEOUT_S} s")
                continue
            assert not isinstance(res, str), f"rank {rank} failed:\n{res}"
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    attentions = cfg.vision.layers + 3 * cfg.llama.num_layers  # SigLIP and each flow's LLaMA
    for rank, (metrics, mu, calls, mixed) in got.items():
        assert mixed, f"rank {rank}: no mix of FSDP dims 0 and 1 and whole tensors"
        assert calls == (attentions, attentions, 0), f"rank {rank}: K3 calls {calls}"
        for k, v in want.items():
            np.testing.assert_allclose(metrics[k], v, rtol=1e-5, err_msg=f"rank {rank} {k}")
        assert sorted(mu) == sorted(want_mu)
        gaps = {k: float(np.linalg.norm(mu[k] - m) / (np.linalg.norm(m) or 1.0))
                for k, m in want_mu.items()}
        worst = max(gaps, key=gaps.get)
        print(f"rank {rank}: first moments within {gaps[worst]:.3e} of the plain step's "
              f"(relative L2, worst {worst})")
        assert gaps[worst] <= FSDP_TP_MU_RTOL, f"rank {rank}: first moment {worst}"
