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
