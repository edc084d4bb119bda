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

from plangen_tpu.config import LlamaConfig, PlanGenModelConfig
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
