"""Packed-int4 weight matmul: W4A16 (K2) and W4A8 (K4).

Port of the host side of `plangen_tpu/ops/pallas_int4_matmul.py`. The packed
format is the JAX package's, byte for byte, so a JAX-packed tree loads with
no repacking:

    w_p4   int8 [..., I, O/2]  (hi << 4) | (lo + 8), hi and lo in [-8, 7];
                               packed column j holds output column j (lo)
                               and column j + O/2 (hi): "global halves"
    s_lo   fp32 [..., 1, O/2]  per-channel scale of the lo half
    s_hi16 fp32 [..., 1, O/2]  per-channel scale of the hi half, / 16
    a8     (optional)          marker: run the W4A8 form

`int4_matmul` is the dispatcher. Rows > 256 dequantize the weight and run a
dense `torch.matmul`, as the JAX package leaves prefill to XLA; rows <= 256
go to a kernel wrapper:

  * `int4_matmul_w16` (K2): x [R, I] (bf16 or fp32) @ the packed weight,
    fp32 accumulation of sum(x * lo) and sum(x * hi), scaled by `s_lo` and
    `16 * s_hi16`;
  * `int4_matmul_w4a8` (K4): per-row int8 activations (`quantize_activations_int8`,
    plain torch) times the packed weight, exact int32 dots, then
    `float(acc_lo) * s_lo * xs` and `float(16 * acc_hi) * s_hi16 * xs`.

Each wrapper launches the hand-written kernel `csrc/int4_matmul.cu` on a
CUDA tensor (or raises) and runs its plain version (`*_reference`) on a CPU
tensor. `<wrapper>.launches` counts kernel launches, `<plain>.calls` counts
plain-version calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

Int4Weight = Dict[str, torch.Tensor]

KERNEL_NAME = "int4_matmul"
MAX_KERNEL_ROWS = 256  # more rows take the dense route (JAX: int4_matmul)
ROW_TILE = 8  # rows a block of the kernel accumulates at once
COL_TILE = 128  # packed columns a block covers
K_TILE = 128  # input indices a block stages per shared-memory tile
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------- packing


def quantize_weight_int4(w: torch.Tensor, act_int8: bool = False) -> Int4Weight:
    """Symmetric per-output-channel int4 quantization of [..., in, out].

    Returns {"w_p4", "s_lo", "s_hi16"} in the JAX package's layout (see the
    module docstring); `act_int8` adds the "a8" marker of the W4A8 form.
    `out` must be even. `torch.round` rounds half to even, like `jnp.round`."""
    wf = w.float()
    O = wf.shape[-1]
    if O % 2:
        raise ValueError(f"int4 packing needs an even out dim, got {O}")
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # [..., 1, out]
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q4 = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int8)
    lo, hi = q4[..., : O // 2], q4[..., O // 2:]
    # hi << 4 stays in int8 ([-128, 112]); lo + 8 is in [0, 15]
    w_p4 = torch.bitwise_or(torch.bitwise_left_shift(hi, 4), lo + 8)
    out = {
        "w_p4": w_p4.contiguous(),
        "s_lo": scale[..., : O // 2].contiguous(),
        "s_hi16": (scale[..., O // 2:] / 16.0).contiguous(),
    }
    if act_int8:
        out["a8"] = torch.zeros((), dtype=torch.int8, device=w.device)
    return out


def _unpack(w_p4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 nibbles in [-8, 7] of packed bytes."""
    b = w_p4.to(torch.int32)
    return (b & 0xF) - 8, b >> 4  # arithmetic shift: the signed high nibble


def dequantize_weight_int4(q: Int4Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of `quantize_weight_int4`: [..., in, out] in `dtype`."""
    lo, hi = _unpack(q["w_p4"])
    w_lo = lo.float() * q["s_lo"]
    w_hi = hi.float() * (q["s_hi16"] * 16.0)
    return torch.cat([w_lo, w_hi], dim=-1).to(dtype)


def is_quantized_int4(w) -> bool:
    return isinstance(w, dict) and "w_p4" in w


def quantize_activations_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activations: (x8 int8 [..., I], xs fp32 [..., 1])."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    xs = torch.where(xs > 0, xs, 1.0)
    x8 = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
    return x8, xs


# ------------------------------------------------------------ plain versions


def int4_matmul_w16_reference(
    x: torch.Tensor, w_p4: torch.Tensor, s_lo: torch.Tensor, s_hi16: torch.Tensor
) -> torch.Tensor:
    """Plain version of K2: x [R, I] @ packed [I, O/2] -> [R, O] in x.dtype.

    fp32 products of x with the lo and hi nibbles, then the scales `s_lo`
    and `16 * s_hi16` (exact: a power-of-two multiple of the stored scale)."""
    int4_matmul_w16_reference.calls += 1
    lo, hi = _unpack(w_p4)
    xf = x.float()
    out_lo = (xf @ lo.float()) * s_lo.reshape(1, -1)
    out_hi = (xf @ hi.float()) * (s_hi16.reshape(1, -1) * 16.0)
    return torch.cat([out_lo, out_hi], dim=-1).to(x.dtype)


int4_matmul_w16_reference.calls = 0


def int4_matmul_w4a8_reference(
    x8: torch.Tensor, xs: torch.Tensor, w_p4: torch.Tensor, s_lo: torch.Tensor,
    s_hi16: torch.Tensor, out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain version of K4: exact integer dots, then fp32 scaling.

    `acc_lo = sum(x8 * lo)` and `acc16 = sum(x8 * 16 * hi)` are the integers
    `y2 - 8 * rowsum` and `y1 - y2` of the JAX kernel. They are exact in int64
    on the CPU and in float64 on the card (torch has no integer matmul
    there; |acc| <= 127 * 128 * I < 2**53)."""
    int4_matmul_w4a8_reference.calls += 1
    lo, hi = _unpack(w_p4)
    acc_dtype = torch.int64 if x8.device.type == "cpu" else torch.float64
    xa = x8.to(acc_dtype)
    acc_lo = (xa @ lo.to(acc_dtype)).to(torch.int64)
    acc16 = (xa @ (hi * 16).to(acc_dtype)).to(torch.int64)
    out_lo = acc_lo.float() * s_lo.reshape(1, -1) * xs
    out_hi = acc16.float() * s_hi16.reshape(1, -1) * xs
    return torch.cat([out_lo, out_hi], dim=-1).to(out_dtype)


int4_matmul_w4a8_reference.calls = 0


# ------------------------------------------------------------------ kernels


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The C entry points, built and loaded at first use."""
    from plangen_tpu_torch.kernels import load_library

    lib = load_library(KERNEL_NAME).lib
    fns = (lib.plangen_int4_matmul_w16, lib.plangen_int4_matmul_a8)
    # x, [xs], w_p4, s_lo, s_hi16, partial, out, R, I, OH, ksplit, dtype, stream
    fns[0].argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fns[1].argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for fn in fns:
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(R: int, I: int, OH: int, n_sm: int) -> int:
    """Blocks along the input dim, so that a skinny matmul still puts about
    two blocks on every SM: (OH / 128) x (R / 8) blocks alone leave most of
    the card idle at decode shapes. Every split gets at least one K tile."""
    blocks = -(-OH // COL_TILE) * -(-R // ROW_TILE)
    k_tiles = -(-I // K_TILE)
    want = max(1, min(k_tiles, -(-2 * n_sm // blocks)))
    per_split = -(-k_tiles // want)
    return -(-k_tiles // per_split)


def _check_packed(w_p4, s_lo, s_hi16, I: int) -> int:
    if w_p4.dim() != 2 or w_p4.dtype != torch.int8:
        raise TypeError(f"w_p4 must be int8 [I, O/2], got {w_p4.dtype} {tuple(w_p4.shape)}")
    if w_p4.shape[0] != I:
        raise ValueError(f"x has {I} input features, w_p4 {w_p4.shape[0]}")
    OH = w_p4.shape[1]
    for name, s in (("s_lo", s_lo), ("s_hi16", s_hi16)):
        if s.dtype != torch.float32 or s.numel() != OH:
            raise ValueError(f"{name} must be fp32 with {OH} values, got "
                             f"{s.dtype} {tuple(s.shape)}")
    return OH


def _check_cuda(tensors, OH: int) -> None:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must be on the same CUDA device")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"inputs on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if OH % 4:
        raise ValueError(f"the CUDA kernel needs O/2 ({OH}) % 4 == 0")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel needs 16-byte aligned inputs")


def _partials(R, I, OH, dev, dtype):
    ksplit = split_k(R, I, OH, _sm_count(dev.index))
    if ksplit == 1:
        return ksplit, None
    return ksplit, torch.empty((ksplit, R, 2 * OH), dtype=dtype, device=dev)


def int4_matmul_w16(
    x: torch.Tensor, w_p4: torch.Tensor, s_lo: torch.Tensor, s_hi16: torch.Tensor
) -> torch.Tensor:
    """K2: x [R, I] (R <= 256) @ packed int4 [I, O/2] -> [R, O] in x.dtype.

    CUDA inputs launch the kernel (float32 or bfloat16 x, contiguous) and
    raise on anything else; CPU inputs run the plain version."""
    if x.dim() != 2:
        raise ValueError(f"x must be [R, I], got {tuple(x.shape)}")
    R, I = x.shape
    OH = _check_packed(w_p4, s_lo, s_hi16, I)
    if x.device.type == "cpu":
        return int4_matmul_w16_reference(x, w_p4, s_lo, s_hi16)
    if x.device.type != "cuda":
        raise ValueError(f"no int4 matmul for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 x, not {x.dtype}")
    if not 0 < R <= MAX_KERNEL_ROWS:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_KERNEL_ROWS} rows, not {R}")
    _check_cuda((x, w_p4, s_lo, s_hi16), OH)
    ksplit, part = _partials(R, I, OH, x.device, torch.float32)
    out = torch.empty((R, 2 * OH), dtype=x.dtype, device=x.device)
    err = _kernel_fns()[0](
        x.data_ptr(), w_p4.data_ptr(), s_lo.data_ptr(), s_hi16.data_ptr(),
        0 if part is None else part.data_ptr(), out.data_ptr(),
        R, I, OH, ksplit, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int4_matmul_w16 kernel launch failed: cudaError {err}")
    int4_matmul_w16.launches += 1
    return out


int4_matmul_w16.launches = 0


def int4_matmul_w4a8(
    x8: torch.Tensor, xs: torch.Tensor, w_p4: torch.Tensor, s_lo: torch.Tensor,
    s_hi16: torch.Tensor, out_dtype: torch.dtype,
) -> torch.Tensor:
    """K4: int8 activations x8 [R, I] with row scales xs fp32 [R, 1] @ packed
    int4 [I, O/2] -> [R, O] in `out_dtype` (float32 or bfloat16).

    CUDA inputs launch the kernel and raise on anything else; CPU inputs run
    the plain version. Both give the same bits: the dots are exact."""
    if x8.dim() != 2 or x8.dtype != torch.int8:
        raise TypeError(f"x8 must be int8 [R, I], got {x8.dtype} {tuple(x8.shape)}")
    R, I = x8.shape
    if xs.dtype != torch.float32 or tuple(xs.shape) != (R, 1):
        raise ValueError(f"xs must be fp32 [{R}, 1], got {xs.dtype} {tuple(xs.shape)}")
    OH = _check_packed(w_p4, s_lo, s_hi16, I)
    if x8.device.type == "cpu":
        return int4_matmul_w4a8_reference(x8, xs, w_p4, s_lo, s_hi16, out_dtype)
    if x8.device.type != "cuda":
        raise ValueError(f"no int4 matmul for device {x8.device}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel writes float32 or bfloat16, not {out_dtype}")
    if not 0 < R <= MAX_KERNEL_ROWS:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_KERNEL_ROWS} rows, not {R}")
    if I % 4:
        raise ValueError(f"the W4A8 kernel needs I ({I}) % 4 == 0")
    _check_cuda((x8, xs, w_p4, s_lo, s_hi16), OH)
    ksplit, part = _partials(R, I, OH, x8.device, torch.int32)
    out = torch.empty((R, 2 * OH), dtype=out_dtype, device=x8.device)
    err = _kernel_fns()[1](
        x8.data_ptr(), xs.data_ptr(), w_p4.data_ptr(), s_lo.data_ptr(),
        s_hi16.data_ptr(), 0 if part is None else part.data_ptr(), out.data_ptr(),
        R, I, OH, ksplit, _DTYPE_CODES[out_dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int4_matmul_w4a8 kernel launch failed: cudaError {err}")
    int4_matmul_w4a8.launches += 1
    return out


int4_matmul_w4a8.launches = 0


# --------------------------------------------------------------- dispatcher


def _layer_slice(q: Int4Weight, layer: Optional[int]):
    wp, s_lo, s_hi16 = q["w_p4"], q["s_lo"], q["s_hi16"]
    if wp.dim() == 3:
        layer = 0 if layer is None else int(layer)
        wp, s_lo, s_hi16 = wp[layer], s_lo[layer], s_hi16[layer]
    return wp, s_lo, s_hi16


def int4_matmul_2d(
    x: torch.Tensor, w_p4: torch.Tensor, s_lo: torch.Tensor, s_hi16: torch.Tensor,
    a8: bool = False,
) -> torch.Tensor:
    """x [..., I] @ one layer's packed weight [I, O/2] -> [..., O] in x.dtype.

    More than 256 flattened rows dequantize the weight and run a dense
    matmul; otherwise K2, or K4 when `a8` (activations quantized per row
    first)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] > MAX_KERNEL_ROWS:
        w = dequantize_weight_int4({"w_p4": w_p4, "s_lo": s_lo, "s_hi16": s_hi16},
                                   dtype=x.dtype)
        out = x2 @ w
    elif a8:
        x8, xs = quantize_activations_int8(x2)
        out = int4_matmul_w4a8(x8, xs, w_p4, s_lo, s_hi16, x.dtype)
    else:
        out = int4_matmul_w16(x2.contiguous(), w_p4, s_lo, s_hi16)
    return out.reshape(*lead, out.shape[-1])


def int4_matmul(x: torch.Tensor, q: Int4Weight, layer: Optional[int] = None) -> torch.Tensor:
    """x [..., I] @ an int4-packed weight -> [..., O] in x.dtype, the JAX
    package's dispatcher: `q` leaves are [I, O/2] (`layer` ignored) or
    stacked [L, I, O/2] with `layer` the index; the "a8" marker selects
    W4A8. Routing as `int4_matmul_2d`."""
    return int4_matmul_2d(x, *_layer_slice(q, layer), a8="a8" in q)


def int4_matmul_reference(x: torch.Tensor, q: Int4Weight, layer: int = 0) -> torch.Tensor:
    """The JAX package's XLA reference: dequantize, then one matmul with
    fp32 accumulation, cast to x.dtype."""
    wp, s_lo, s_hi16 = _layer_slice(q, layer)
    w = dequantize_weight_int4({"w_p4": wp, "s_lo": s_lo, "s_hi16": s_hi16},
                               dtype=x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def int4_matmul_a8_reference(x: torch.Tensor, q: Int4Weight, layer: int = 0) -> torch.Tensor:
    """The JAX package's `int4_matmul_a8_reference`: quantize x per row,
    then the exact integer math of K4."""
    wp, s_lo, s_hi16 = _layer_slice(q, layer)
    lead = x.shape[:-1]
    x8, xs = quantize_activations_int8(x.reshape(-1, x.shape[-1]))
    out = int4_matmul_w4a8_reference(x8, xs, wp, s_lo, s_hi16, x.dtype)
    return out.reshape(*lead, out.shape[-1])
