"""Flash attention for training: causal or not, with a key-padding mask.

Port of `plangen_tpu/ops/pallas_attention.py` (`flash_attention`, the Pallas
forward with an XLA-recompute VJP, and `flash_attention_tpu`, the same
attention through jax's library forward and backward kernels). Both are one
function here: `flash_attention(q, k, v, pad_mask, causal=True, scale=None)`
in the model's [B, S, H, D] layout.

  * On a CUDA tensor it runs the hand-written kernels of
    `csrc/flash_attention.cu` (built at first use) through a
    `torch.autograd.Function`: `flash_attention_fwd` (output and the fp32
    log-sum-exp of every row) and `flash_attention_bwd` (Delta, then dK/dV,
    then dQ: three kernel launches per call). The route follows the dtype:
    bfloat16 runs on the tensor cores (`wgmma` forward, `mma.sync`
    backward), float32 on the CUDA cores (fp32 FMA, the check of the
    algorithm). Anything the kernels do not take raises; nothing falls
    back, and neither route falls back to the other.
  * On a CPU tensor it runs `flash_attention_reference`, the plain version:
    `make_causal_bias` (or the non-causal pad bias) plus
    `dot_product_attention`, differentiated by autograd.

A key j counts for query i iff pad_mask[b, j] > 0 and (not causal or
j <= i). Any S works: the kernels mask the ragged edge themselves. GQA
repeats the KV heads before the kernel, so autograd sums dK/dV over each
group. A query row with no allowed key (a left pad under the causal mask)
behaves as on the JAX package's default XLA path, where the -1e30 bias makes
all S scores equal: its output is the mean of V over all S keys, with that
path's gradients. (The Pallas kernel leaves such rows unspecified, but the
training loss reads one of them: the last left pad predicts the first real
token.)

`<wrapper>.launches` counts kernel-launching calls, `<wrapper>.routes`
the same calls by route (`ROUTES`), and `flash_attention_reference.calls`
counts plain-version calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from plangen_tpu_torch.ops.attention import NEG_INF, dot_product_attention, make_causal_bias

KERNEL_NAME = "flash_attention"
BACKWARD_KERNELS_PER_CALL = 3  # Delta, dK/dV, dQ
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
_HEAD_DIMS = (64, 128)


def flash_attention_reference(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    pad_mask: torch.Tensor,  # [B, S]
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's `_reference`): the causal +
    pad bias, or the pad bias alone, then `dot_product_attention`."""
    flash_attention_reference.calls += 1
    S = q.shape[1]
    if causal:
        positions = torch.arange(S, dtype=torch.int32, device=q.device)
        bias = make_causal_bias(pad_mask, positions, positions)
    else:
        allowed = pad_mask[:, None, :] > 0  # [B, 1, S]
        bias = torch.where(allowed, 0.0, NEG_INF)[:, None]  # [B, 1, 1, S]
    return dot_product_attention(q, k, v, bias=bias, scale=scale)


flash_attention_reference.calls = 0


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The two C entry points, built and loaded at first use."""
    from plangen_tpu_torch.kernels import load_library

    lib = load_library(KERNEL_NAME).lib
    fwd = lib.plangen_flash_attention_fwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fwd.restype = ctypes.c_int
    bwd = lib.plangen_flash_attention_bwd
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_cuda(tensors, like: torch.Tensor) -> None:
    """What the kernels need of their [B, S, H, D] operands."""
    if like.device.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, not {like.device}")
    if like.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {like.dtype}")
    D = like.shape[-1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {_HEAD_DIMS}, not {D}")
    for t in (like, *tensors):
        if t.dtype != like.dtype:
            raise TypeError(f"operand dtypes differ: {t.dtype} and {like.dtype}")
        if t.shape != like.shape:
            raise ValueError(f"operand shapes differ: {tuple(t.shape)} and "
                             f"{tuple(like.shape)}")
        if t.device != like.device:
            raise ValueError("all inputs must be on the same CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte aligned")
    if like.device.index != torch.cuda.current_device():
        raise ValueError(f"inputs on {like.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _check_mask(pad_mask: torch.Tensor, q: torch.Tensor) -> None:
    B, S = q.shape[:2]
    if pad_mask.dtype != torch.int32 or not pad_mask.is_contiguous():
        raise TypeError(f"pad_mask must be contiguous int32 on the card, not {pad_mask.dtype}")
    if tuple(pad_mask.shape) != (B, S) or pad_mask.device != q.device:
        raise ValueError(f"pad_mask must be [{B}, {S}] on {q.device}, got "
                         f"{tuple(pad_mask.shape)} on {pad_mask.device}")


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad_mask: torch.Tensor,
    causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (out [B, S, H, D] in q.dtype, lse fp32
    [B, H, S]). q, k, v contiguous with equal shapes (heads already
    repeated), pad_mask contiguous int32 [B, S]."""
    _check_cuda((k, v), q)
    _check_mask(pad_mask, q)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _kernel_fns()[0](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, S, H, D, float(scale), int(causal),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.routes[ROUTES[q.dtype]] += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.routes = dict.fromkeys(ROUTES.values(), 0)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad_mask: torch.Tensor,
    out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (Delta, dK/dV, dQ): (dq, dk, dv) in
    q.dtype. Inputs as `flash_attention_fwd`, plus its out and lse and the
    output gradient dout."""
    _check_cuda((k, v, out, dout), q)
    _check_mask(pad_mask, q)
    B, S, H, D = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 [{B}, {H}, {S}]")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _kernel_fns()[1](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, D, float(scale),
        int(causal), _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: cudaError {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[ROUTES[q.dtype]] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = dict.fromkeys(ROUTES.values(), 0)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad_mask, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, pad_mask, causal, scale)
        ctx.save_for_backward(q, k, v, pad_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, pad_mask, out, dout.contiguous(),
                                         lse, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    pad_mask: torch.Tensor,  # [B, S], > 0 = a real key
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of every query over the keys the mask allows; differentiable.

    Returns [B, S, H, D] in q.dtype. CUDA inputs go through the kernels
    (float32 or bfloat16, head_dim 64 or 128; strided operands are made
    contiguous, the mask becomes int32) and raise on anything else; CPU
    inputs run the plain version."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be [B, S, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != D or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if tuple(pad_mask.shape) != (B, S):
        raise ValueError(f"pad_mask must be [{B}, {S}], got {tuple(pad_mask.shape)}")
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, pad_mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    if pad_mask.is_floating_point():
        raise TypeError(f"pad_mask must be an integer or bool tensor, not {pad_mask.dtype}")
    mask = pad_mask.to(torch.int32).contiguous()
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 mask, bool(causal), float(scale))
