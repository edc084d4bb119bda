"""Prefix decode attention: one query per row over the live cache prefix.

Port of `plangen_tpu/ops/pallas_decode_attention.py` (and its `_v3`
variant, which computes the same function). `prefix_decode_attention` keeps
the Pallas signature: the cache is the runtime's stacked [L, B, S, H, D]
buffer and the layer index and query position select what is read.

  * On a CUDA tensor it launches the hand-written kernel
    `csrc/prefix_decode_attention.cu` (built at first use) or raises.
  * On a CPU tensor it runs `prefix_decode_attention_reference`, the plain
    version of the same math over the masked full buffer.

`prefix_decode_attention_q8` is the same read over the int8 cache (K1-q8):
k/v int8 [L, B, S, H, D] with fp32 scales [L, B, S, H], in the order of the
JAX package's XLA paths over that cache (`dot_product_attention_q8`,
`segmented_decode_attention`): the logits take `k_scale` and then the
softmax scale, and each chunk's probabilities take `v_scale` before they
are rounded to the query dtype.

The kernel splits the live prefix over up to `MAX_SPLITS` blocks per
(row, head), one thread-block cluster each, in a grid that `split_plan`
fixes from S alone; `q_pos` stays in device memory, so nothing of a launch
depends on its value. Slots past `q_pos` take no part in the softmax: a row
whose live prefix is all pads gets the mean of V over slots 0..q_pos.

`prefix_decode_attention_a8` (K1-a8, `csrc/prefix_decode_attention_a8.cu`)
is the JAX package's `kv_a8` decode step over the same int8 cache:
`ops/attention.py::dot_product_attention_q8(a8=True)` over the fixed buffer,
restricted to the live prefix (slots past `q_pos` and pads add exactly 0 to
its sum and to its absmax, so it is the same function). The query and the
normalized, v_scale-folded probabilities are quantized to int8 rows and
both products are s8 x s8 -> s32. One block per (row, head): the function
needs the global max, sum and absmax before any PV product, which K1's
split-KV combine does not give.

`<wrapper>.launches` counts kernel launches and `<plain>.calls` counts
plain-version calls, so a run can show which one carried it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from plangen_tpu_torch.ops import require_local
from plangen_tpu_torch.ops.attention import NEG_INF, _quantize_rows_s8, s8_dot

CHUNK = 128
MAX_SPLITS = 8  # the kernel's splits per (row, head): the portable cluster size
KERNEL_NAME = "prefix_decode_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def prefix_decode_attention_reference(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [L, B, S, H, D]
    v_cache: torch.Tensor,
    pad_mask: torch.Tensor,  # [B, S]
    layer: int,
    q_pos: Union[int, torch.Tensor],  # scalar or [1]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's math over the masked full buffer.

    q is scaled in fp32 before the dot (the TPU kernel's order), slots under
    a pad are masked with NEG_INF and slots past `q_pos` take no part, the
    softmax is fp32 and the probabilities are rounded to the cache dtype
    before the PV product. Returns [B, 1, H, D] in q.dtype."""
    prefix_decode_attention_reference.calls += 1
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    k = k_cache[layer].float()  # [B, S, H, D]
    v = v_cache[layer]
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float() * scale, k)
    p = _live_softmax_numerator(s, pad_mask, q_pos)
    l_sum = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bshd->bhd", p.to(v.dtype).float(), v.float())
    return (out / l_sum.clamp_min(1e-30)).to(q.dtype)[:, None]


def _live_softmax_numerator(s, pad_mask, q_pos):
    """exp(s - max) over the live slots [0, q_pos] of the logits s [B, H, S],
    pads at NEG_INF, 0 past q_pos: a live prefix of pads only gives every
    live slot the same weight, and no live slot at all gives zeros."""
    slots = torch.arange(s.shape[-1], device=s.device)
    live = (slots <= q_pos)[None, None, :]
    s = torch.where(pad_mask[:, None, :] > 0, s, torch.full((), NEG_INF, device=s.device))
    m = torch.where(live, s, torch.full((), float("-inf"), device=s.device))
    m = m.amax(dim=-1, keepdim=True)
    return torch.where(live, torch.exp(s - m), torch.zeros((), device=s.device))


prefix_decode_attention_reference.calls = 0


def _check_inputs(q, k_cache, v_cache, pad_mask, layer, q_pos) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError(
            "k_cache and v_cache must both be [L, B, S, H, D], got "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}"
        )
    L, B, S, H, D = k_cache.shape
    if tuple(q.shape) != (B, 1, H, D):
        raise ValueError(
            f"q {tuple(q.shape)} does not match the cache {tuple(k_cache.shape)}"
            " (the kernel assumes MHA: as many KV heads as query heads)"
        )
    if S % CHUNK:
        raise ValueError(f"prefix decode attention needs S ({S}) % {CHUNK} == 0")
    if tuple(pad_mask.shape) != (B, S):
        raise ValueError(f"pad_mask must be [{B}, {S}], got {tuple(pad_mask.shape)}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range for {L} cached layers")
    if q.dtype != k_cache.dtype or q.dtype != v_cache.dtype:
        raise TypeError(
            f"q, k_cache, v_cache dtypes differ: {q.dtype}, {k_cache.dtype}, "
            f"{v_cache.dtype}"
        )


def split_plan(S: int) -> Tuple[int, int]:
    """(splits, slots per split) of the kernel's grid for a cache of S slots.

    The S / 128 chunks are spread over at most MAX_SPLITS blocks per (row,
    head), whole chunks each, as evenly as that allows; the last split holds
    slot S - 1. It depends on S alone, never on q_pos: a split whose slots
    all lie past q_pos is launched and reads nothing."""
    if S <= 0 or S % CHUNK:
        raise ValueError(f"prefix decode attention needs S ({S}) % {CHUNK} == 0")
    chunks = S // CHUNK
    per = -(-chunks // MAX_SPLITS)
    return -(-chunks // per), per * CHUNK


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built and loaded at first use."""
    from plangen_tpu_torch.kernels import load_library

    fn = load_library(KERNEL_NAME).lib.plangen_prefix_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_common(q, pad_mask, q_pos, D, tensors) -> None:
    """What both CUDA kernels need beyond the shapes."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, not {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {_HEAD_DIMS}, not {D}")
    if pad_mask.dtype != torch.int32:
        raise TypeError(f"pad_mask must be int32 on the card, not {pad_mask.dtype}")
    if not (isinstance(q_pos, torch.Tensor) and q_pos.dtype == torch.int32
            and q_pos.numel() == 1):
        raise TypeError(
            "q_pos must be a one-element int32 CUDA tensor (the kernel reads "
            "it from device memory)"
        )
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on the same CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    # the kernel copies 16-byte vectors of every array; q_pos, one int32 read
    # as such, may be any element of a positions tensor
    if any(t.data_ptr() % 16 for t in tensors if t is not q_pos):
        raise ValueError("q, the cache, its scales and pad_mask must be 16-byte aligned")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"inputs on {q.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )


def _launch_kernel(q, k_cache, v_cache, pad_mask, layer, q_pos, scale):
    L, B, S, H, D = k_cache.shape
    _check_cuda_common(q, pad_mask, q_pos, D, (q, k_cache, v_cache, pad_mask, q_pos))
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    err = _kernel_fn()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pad_mask.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        B, S, H, D, int(layer), float(scale), _DTYPE_CODES[q.dtype],
        *split_plan(S), torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"prefix_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    prefix_decode_attention.launches += 1
    return out


def prefix_decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [L, B, S, H, D]
    v_cache: torch.Tensor,
    pad_mask: torch.Tensor,  # [B, S]
    layer: int,
    q_pos: Union[int, torch.Tensor],  # one-element int32 tensor on the card
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step decode attention over layer `layer`'s live cache prefix.

    Requires S % 128 == 0 and as many KV heads as query heads. Returns
    [B, 1, H, D] in q.dtype. CUDA inputs launch the kernel (float32 or
    bfloat16, head_dim 64 or 128, contiguous and 16-byte aligned, int32 mask
    and q_pos on the device) and raise on anything else; CPU inputs run the
    plain version."""
    require_local("prefix_decode_attention", q, k_cache, v_cache, pad_mask, q_pos)
    _check_inputs(q, k_cache, v_cache, pad_mask, layer, q_pos)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return prefix_decode_attention_reference(
            q, k_cache, v_cache, pad_mask, layer, q_pos, scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"no prefix decode attention for device {q.device}")
    return _launch_kernel(q, k_cache, v_cache, pad_mask, layer, q_pos, scale)


prefix_decode_attention.launches = 0


# ------------------------------------------------------ the int8 cache (K1-q8)


def prefix_decode_attention_q8_reference(
    q: torch.Tensor,  # [B, 1, H, D]
    k_q8: torch.Tensor,  # [L, B, S, H, D] int8
    k_scale: torch.Tensor,  # [L, B, S, H] fp32
    v_q8: torch.Tensor,
    v_scale: torch.Tensor,
    pad_mask: torch.Tensor,  # [B, S]
    layer: int,
    q_pos: Union[int, torch.Tensor],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1-q8 over the masked full buffer.

    logit = (q . k_q8) * k_scale * scale in fp32 (q not pre-scaled); pads
    get NEG_INF and slots past `q_pos` take no part; the probabilities (fp32, not normalized) are
    multiplied by v_scale and rounded to q.dtype before the PV product with
    v_q8; the output is acc / max(l, 1e-30) in q.dtype."""
    prefix_decode_attention_q8_reference.calls += 1
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), k_q8[layer].float())
    s = s * k_scale[layer].transpose(1, 2) * scale
    p = _live_softmax_numerator(s, pad_mask, q_pos)
    l_sum = p.sum(dim=-1, keepdim=True)
    pv = (p * v_scale[layer].transpose(1, 2)).to(q.dtype).float()
    out = torch.einsum("bhs,bshd->bhd", pv, v_q8[layer].float())
    return (out / l_sum.clamp_min(1e-30)).to(q.dtype)[:, None]


prefix_decode_attention_q8_reference.calls = 0


def _check_q8_inputs(q, k_q8, k_scale, v_q8, v_scale, pad_mask, layer) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    if k_q8.dim() != 5 or k_q8.shape != v_q8.shape:
        raise ValueError(
            "k_q8 and v_q8 must both be [L, B, S, H, D], got "
            f"{tuple(k_q8.shape)} and {tuple(v_q8.shape)}"
        )
    L, B, S, H, D = k_q8.shape
    if tuple(q.shape) != (B, 1, H, D):
        raise ValueError(
            f"q {tuple(q.shape)} does not match the cache {tuple(k_q8.shape)}"
            " (the kernel assumes MHA: as many KV heads as query heads)"
        )
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(sc.shape) != (L, B, S, H) or sc.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 [{L}, {B}, {S}, {H}], got "
                             f"{sc.dtype} {tuple(sc.shape)}")
    if k_q8.dtype != torch.int8 or v_q8.dtype != torch.int8:
        raise TypeError(f"k_q8 and v_q8 must be int8, got {k_q8.dtype}, {v_q8.dtype}")
    if S % CHUNK:
        raise ValueError(f"prefix decode attention needs S ({S}) % {CHUNK} == 0")
    if tuple(pad_mask.shape) != (B, S):
        raise ValueError(f"pad_mask must be [{B}, {S}], got {tuple(pad_mask.shape)}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range for {L} cached layers")


@functools.lru_cache(maxsize=None)
def _kernel_fn_q8():
    from plangen_tpu_torch.kernels import load_library

    fn = load_library(KERNEL_NAME).lib.plangen_prefix_decode_attention_q8
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def prefix_decode_attention_q8(
    q: torch.Tensor,  # [B, 1, H, D]
    k_q8: torch.Tensor,  # [L, B, S, H, D] int8
    k_scale: torch.Tensor,  # [L, B, S, H] fp32
    v_q8: torch.Tensor,
    v_scale: torch.Tensor,
    pad_mask: torch.Tensor,  # [B, S]
    layer: int,
    q_pos: Union[int, torch.Tensor],  # one-element int32 tensor on the card
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step decode attention over layer `layer`'s live int8 cache
    prefix (K1-q8). Requirements as `prefix_decode_attention`, with int8 k/v
    and fp32 scales; CPU inputs run the plain version."""
    require_local("prefix_decode_attention_q8", q, k_q8, k_scale, v_q8, v_scale, pad_mask,
                  q_pos)
    _check_q8_inputs(q, k_q8, k_scale, v_q8, v_scale, pad_mask, layer)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return prefix_decode_attention_q8_reference(
            q, k_q8, k_scale, v_q8, v_scale, pad_mask, layer, q_pos, scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"no prefix decode attention for device {q.device}")
    L, B, S, H, D = k_q8.shape
    _check_cuda_common(q, pad_mask, q_pos, D,
                       (q, k_q8, k_scale, v_q8, v_scale, pad_mask, q_pos))
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    err = _kernel_fn_q8()(
        q.data_ptr(), k_q8.data_ptr(), k_scale.data_ptr(), v_q8.data_ptr(),
        v_scale.data_ptr(), pad_mask.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        B, S, H, D, int(layer), float(scale), _DTYPE_CODES[q.dtype],
        *split_plan(S), torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"prefix_decode_attention_q8 kernel launch failed: "
                           f"cudaError {err}")
    prefix_decode_attention_q8.launches += 1
    return out


prefix_decode_attention_q8.launches = 0


# ------------------------------------------- s8 x s8 over the int8 cache (K1-a8)

KERNEL_NAME_A8 = "prefix_decode_attention_a8"
A8_MAX_SLOTS = 32768  # the logits and codes of a row fit in a block's shared memory


def prefix_decode_attention_a8_reference(
    q: torch.Tensor,  # [B, 1, H, D]
    k_q8: torch.Tensor,  # [L, B, S, Hkv, D] int8
    k_scale: torch.Tensor,  # [L, B, S, Hkv] fp32
    v_q8: torch.Tensor,
    v_scale: torch.Tensor,
    pad_mask: torch.Tensor,  # [B, S]
    layer: int,
    q_pos: Union[int, torch.Tensor],
    scale: Optional[float] = None,
    return_codes: bool = False,
):
    """Plain PyTorch version of K1-a8 over the masked full buffer.

    q8, q_s = the query quantized per (row, head) over D; logit =
    s32(q8 . k_q8) * q_s * k_scale * scale in fp32; pads get NEG_INF and
    slots past `q_pos` take no part; p = exp(logit - max) / sum, times
    v_scale, quantized per (row, head) over S to (p8, p_s); the output is
    s32(p8 . v_q8) * p_s in q.dtype. A live prefix of pads only gives every
    live slot the same weight. Fewer KV heads than query heads (GQA) are
    repeated, as `dot_product_attention_q8` does; the kernel takes MHA.
    With `return_codes`, (out, p8 [B, H, S] int8)."""
    prefix_decode_attention_a8_reference.calls += 1
    H, D = q.shape[-2:]
    if scale is None:
        scale = D ** -0.5
    rep = H // k_q8.shape[3]
    k8, ks, v8, vs = (t[layer].repeat_interleave(rep, 2) for t in (k_q8, k_scale, v_q8, v_scale))
    q8, q_s = _quantize_rows_s8(q[:, 0].float())  # q_s [B, H, 1]
    s = s8_dot("bhd,bshd->bhs", q8, k8) * q_s * ks.transpose(1, 2) * scale
    p = _live_softmax_numerator(s, pad_mask, q_pos)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p8, p_s = _quantize_rows_s8(p * vs.transpose(1, 2))  # over S; p_s [B, H, 1]
    out = (s8_dot("bhs,bshd->bhd", p8, v8) * p_s).to(q.dtype)[:, None]
    return (out, p8) if return_codes else out


prefix_decode_attention_a8_reference.calls = 0


@functools.lru_cache(maxsize=None)
def _kernel_fn_a8():
    from plangen_tpu_torch.kernels import load_library

    fn = load_library(KERNEL_NAME_A8).lib.plangen_prefix_decode_attention_a8
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def prefix_decode_attention_a8(
    q: torch.Tensor,  # [B, 1, H, D]
    k_q8: torch.Tensor,  # [L, B, S, H, D] int8
    k_scale: torch.Tensor,  # [L, B, S, H] fp32
    v_q8: torch.Tensor,
    v_scale: torch.Tensor,
    pad_mask: torch.Tensor,  # [B, S]
    layer: int,
    q_pos: Union[int, torch.Tensor],  # one-element int32 tensor on the card
    scale: Optional[float] = None,
    codes_out: Optional[torch.Tensor] = None,  # int8 [B, H, S]: the p codes
) -> torch.Tensor:
    """Single-step s8 x s8 decode attention over layer `layer`'s live int8
    cache prefix (K1-a8). Requirements as `prefix_decode_attention_q8`, and
    S <= A8_MAX_SLOTS on the card; CPU inputs run the plain version.
    `codes_out`, when given, receives the probability codes (0 past
    `q_pos`), for comparing the kernel with its plain version."""
    require_local("prefix_decode_attention_a8", q, k_q8, k_scale, v_q8, v_scale, pad_mask,
                  q_pos)
    _check_q8_inputs(q, k_q8, k_scale, v_q8, v_scale, pad_mask, layer)
    L, B, S, H, D = k_q8.shape
    if codes_out is not None and (tuple(codes_out.shape) != (B, H, S)
                                  or codes_out.dtype != torch.int8):
        raise ValueError(f"codes_out must be int8 [{B}, {H}, {S}], got "
                         f"{codes_out.dtype} {tuple(codes_out.shape)}")
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        out, codes = prefix_decode_attention_a8_reference(
            q, k_q8, k_scale, v_q8, v_scale, pad_mask, layer, q_pos, scale, return_codes=True)
        if codes_out is not None:
            codes_out.copy_(codes)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"no prefix decode attention for device {q.device}")
    if S > A8_MAX_SLOTS:
        raise ValueError(f"the a8 kernel takes S <= {A8_MAX_SLOTS}, not {S}")
    extra = () if codes_out is None else (codes_out,)
    _check_cuda_common(q, pad_mask, q_pos, D,
                       (q, k_q8, k_scale, v_q8, v_scale, pad_mask, q_pos) + extra)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    err = _kernel_fn_a8()(
        q.data_ptr(), k_q8.data_ptr(), k_scale.data_ptr(), v_q8.data_ptr(),
        v_scale.data_ptr(), pad_mask.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        None if codes_out is None else codes_out.data_ptr(),
        B, S, H, D, int(layer), float(scale), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"prefix_decode_attention_a8 kernel launch failed: "
                           f"cudaError {err}")
    prefix_decode_attention_a8.launches += 1
    return out


prefix_decode_attention_a8.launches = 0
