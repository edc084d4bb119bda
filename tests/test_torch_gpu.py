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
from plangen_tpu_torch.runtime.generate import generate_image_tokens

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
    step captured in a CUDA graph would advance it."""
    q, k, v, mask = _inputs(cuda, torch.float32)
    q_pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    for pos in (70, 180):
        q_pos.fill_(pos)
        got = da.prefix_decode_attention(q, k, v, mask, 1, q_pos)
        want = da.prefix_decode_attention_reference(q, k, v, mask, 1, pos)
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("bad", ["mask_int64", "q_pos_int", "fp16", "head_dim_32",
                                 "non_contiguous", "q_pos_cpu"])
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
    launches = da.prefix_decode_attention.launches
    with pytest.raises((TypeError, ValueError)):
        da.prefix_decode_attention(q, k, v, mask, 0, q_pos)
    assert da.prefix_decode_attention.launches == launches


def test_decode_loop_on_card_equals_cpu(cuda):
    """Greedy tokens of a tiny model with the kernel's smallest head_dim
    (64), fp32: the card (every decode step through the kernel) equals the
    CPU (the plain version)."""
    tiny = PlanGenModelConfig.tiny()
    cfg = dataclasses.replace(
        tiny,
        llama=LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                          num_layers=2, num_heads=2, num_kv_heads=2, head_dim=64),
        gen_aligner=dataclasses.replace(tiny.gen_aligner, n_embed=128),
        image_token_embed=128,
    )
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


@pytest.mark.parametrize("R,I,O", INT4_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k2_matches_plain_version(cuda, dtype, R, I, O):
    x, w, s_lo, s_hi16 = _int4_inputs(cuda, R, I, O, dtype)
    launches = im.int4_matmul_w16.launches
    got = im.int4_matmul_w16(x, w, s_lo, s_hi16)
    assert im.int4_matmul_w16.launches == launches + 1
    want = im.int4_matmul_w16_reference(x, w, s_lo, s_hi16)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (R, O)
    # fp32: sums in another order (fp32 epsilon times sqrt(I)-sized values);
    # bf16: plus one rounding of the output
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("R,I,O", INT4_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k4_equals_plain_version_exactly(cuda, dtype, R, I, O):
    x, w, s_lo, s_hi16 = _int4_inputs(cuda, R, I, O, dtype, seed=1)
    x8, xs = im.quantize_activations_int8(x)
    launches = im.int4_matmul_w4a8.launches
    got = im.int4_matmul_w4a8(x8, xs, w, s_lo, s_hi16, dtype)
    assert im.int4_matmul_w4a8.launches == launches + 1
    want = im.int4_matmul_w4a8_reference(x8, xs, w, s_lo, s_hi16, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (R, O)
    assert torch.equal(got, want)


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
                                 "non_contiguous"])
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
    else:
        v8 = v8.transpose(3, 4).contiguous().transpose(3, 4)
    launches = da.prefix_decode_attention_q8.launches
    with pytest.raises((TypeError, ValueError)):
        da.prefix_decode_attention_q8(q, k8, ks, v8, vs, mask, 0, q_pos)
    assert da.prefix_decode_attention_q8.launches == launches


@pytest.mark.parametrize("mode", ["int4", "int4_a8"])
def test_quantized_decode_loop_on_card_equals_cpu(cuda, mode):
    """Greedy tokens of a tiny int4 model over the int8 cache, fp32: the card
    (K2 or K4 and K1-q8 at every decode step) equals the CPU (the plain
    versions)."""
    tiny = PlanGenModelConfig.tiny()
    cfg = dataclasses.replace(
        tiny,
        llama=LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                          num_layers=2, num_heads=2, num_kv_heads=2, head_dim=64),
        gen_aligner=dataclasses.replace(tiny.gen_aligner, n_embed=128),
        image_token_embed=128,
    )
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


# ------------------------- K3 bf16 on the tensor cores (wgmma forward, mma.sync backward)

# left pads per row: none, a few, two whole 64-row tiles and more, every key
TC_PADS = (0, 5, 130, None)


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
