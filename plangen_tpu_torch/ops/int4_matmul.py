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
    `16 * s_hi16`. bf16 runs on the tensor cores (`mma.sync` m16n8k16 over
    nibbles unpacked in registers), fp32 on the CUDA cores (the check
    route); `w16_plan` is the launch geometry of both;
  * `int4_matmul_w4a8` (K4): per-row int8 activations (`quantize_activations_int8`,
    plain torch) times the packed weight, exact int32 dots on the tensor
    cores (`mma.sync` m16n8k32 s8; `a8_plan` is its launch geometry), then
    `float(acc_lo) * s_lo * xs` and `float(16 * acc_hi) * s_hi16 * xs`.

Each wrapper launches the hand-written kernel `csrc/int4_matmul.cu` on a
CUDA tensor (or raises) and runs its plain version (`*_reference`) on a CPU
tensor. `<wrapper>.launches` counts kernel launches (and
`<wrapper>.tc_launches` those on the tensor-core route: every K4 launch),
`<plain>.calls` counts plain-version calls.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from plangen_tpu_torch.ops import require_local

Int4Weight = Dict[str, torch.Tensor]

KERNEL_NAME = "int4_matmul"
MAX_KERNEL_ROWS = 256  # more rows take the dense route (JAX: int4_matmul)
ROW_TILE = 8  # rows a block of the CUDA-core kernels accumulates at once
COL_TILE = 128  # packed columns a block covers (both routes)
K_TILE = 128  # input indices a CUDA-core block stages per shared-memory tile
# the tensor-core route of K2 (bf16): 4 warps of 32 packed columns each; a
# warp runs `mma.sync` m16n8k16 over 8-row n-tiles, TC_ROW_TILES[-1] at most
TC_THREADS = 128
TC_K_TILE = 64  # inputs per pipeline stage
TC_STAGES = 4  # cp.async ring depth: tiles t+1..t+3 in flight while t computes
TC_ROW_TILES = (1, 2, 4, 8)  # 8-row n-tiles per warp (template instances)
# K4 (int8 x8) on the tensor cores: the same 4 warps and n-tiles, `mma.sync`
# m16n8k32 s8; a stage holds 128 inputs, i.e. 128 bytes of every x8 row as
# K2's 64 bf16 inputs do, and a 16 KB weight tile
A8_K_TILE = 128
A8_STAGES = 4
SHARED_MEMORY_LIMIT = 232448  # bytes a block may use on the H100 (227 KB)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------- packing


def pack_int4(q4: torch.Tensor, scale: torch.Tensor) -> Int4Weight:
    """{"w_p4", "s_lo", "s_hi16"} of int4 values q4 [..., in, out] (int, in
    [-8, 7]) and their per-channel scales [..., 1, out], packed in halves."""
    O = q4.shape[-1]
    lo, hi = q4[..., : O // 2].to(torch.int8), q4[..., O // 2:].to(torch.int8)
    # hi << 4 stays in int8 ([-128, 112]); lo + 8 is in [0, 15]
    return {"w_p4": torch.bitwise_or(torch.bitwise_left_shift(hi, 4), lo + 8).contiguous(),
            "s_lo": scale[..., : O // 2].contiguous(),
            "s_hi16": (scale[..., O // 2:] / 16.0).contiguous()}


def unpack_int4(q: Int4Weight) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `pack_int4`: (int4 values int8 [..., in, out], scales fp32
    [..., 1, out]), lossless."""
    lo, hi = _unpack(q["w_p4"])
    return (torch.cat([lo, hi], dim=-1).to(torch.int8),
            torch.cat([q["s_lo"], q["s_hi16"] * 16.0], dim=-1))


def quantize_weight_int4(w: torch.Tensor, act_int8: bool = False,
                         absmax: Optional[torch.Tensor] = None) -> Int4Weight:
    """Symmetric per-output-channel int4 quantization of [..., in, out].

    Returns {"w_p4", "s_lo", "s_hi16"} in the JAX package's layout (see the
    module docstring); `act_int8` adds the "a8" marker of the W4A8 form.
    `out` must be even. `torch.round` rounds half to even, like `jnp.round`.
    `absmax` [..., 1, out] replaces the columns' absmax over `in` (a
    row-parallel shard passes the whole input dim's)."""
    wf = w.float()
    O = wf.shape[-1]
    if O % 2:
        raise ValueError(f"int4 packing needs an even out dim, got {O}")
    if absmax is None:
        absmax = wf.abs().amax(dim=-2, keepdim=True)  # [..., 1, out]
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q4 = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int8)
    out = pack_int4(q4, scale)
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


def quantize_activations_int8(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activations: (x8 int8 [..., I], xs fp32 [..., 1]).
    With a process `group` x holds this rank's columns of each row and the
    row's absmax is the maximum over the group (the whole row's)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    xs = absmax / 127.0
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
    fns = (lib.plangen_int4_matmul_w16, lib.plangen_int4_matmul_a8,
           lib.plangen_int4_matmul_w16_tc)
    # x, [xs], w_p4, s_lo, s_hi16, partial, out, R, I, OH, ksplit,
    # [row_tiles,] dtype (K2's tensor-core route: row_tiles only), stream
    fns[0].argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fns[1].argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fns[2].argtypes = fns[0].argtypes
    for fn in fns:
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(R: int, I: int, OH: int, n_sm: int, row_tile: int = ROW_TILE,
            k_tile: int = K_TILE, per_sm: int = 2) -> int:
    """Blocks along the input dim, so that a skinny matmul still puts about
    `per_sm` blocks on every SM: (OH / 128) x (R / row_tile) blocks alone
    leave most of the card idle at decode shapes. Every split gets at least
    one K tile."""
    blocks = -(-OH // COL_TILE) * -(-R // row_tile)
    k_tiles = -(-I // k_tile)
    want = max(1, min(k_tiles, -(-per_sm * n_sm // blocks)))
    per_split = -(-k_tiles // want)
    return -(-k_tiles // per_split)


def tc_blocks_per_sm(row_tiles: int) -> int:
    """Blocks per SM the tensor-core routes' split aims at (K2 and K4): two
    where a block covers 8 or 16 rows (bound by weight bytes: more blocks,
    more bytes in flight), one from 32 rows on, where the partials of the
    extra splits cost more than the SMs they would fill (measured for each
    kernel on the H100 by `kernels/profile_int4.py`)."""
    return 2 if row_tiles <= 2 else 1


@dataclass(frozen=True)
class Int4Plan:
    """Launch geometry of one K2 or K4 call (`w16_plan`, `a8_plan`); the C
    side computes the same grid from (R, I, OH, ksplit, row_tiles)."""

    route: str  # "tensor_cores" (bf16 K2, K4) or "cuda_cores" (fp32 K2)
    grid: Tuple[int, int, int]  # (column blocks, row blocks, ksplit)
    threads: int
    k_tile: int
    ksplit: int
    tiles_per_split: int
    row_tiles: int  # 8-row n-tiles per warp (tensor cores), else 1
    stages: int  # shared-memory ring depth (1: staged, not pipelined)
    smem_bytes: int

    def split_ranges(self, I: int) -> List[range]:
        """The k tiles each split accumulates, in split order."""
        n = -(-I // self.k_tile)
        return [range(z * self.tiles_per_split, min(n, (z + 1) * self.tiles_per_split))
                for z in range(self.ksplit)]


def tc_row_tiles(R: int) -> int:
    """The smallest instance of 8-row n-tiles per warp that covers R rows,
    capped at the largest (more rows take more row blocks)."""
    need = -(-R // 8)
    return next((n for n in TC_ROW_TILES if n >= need), TC_ROW_TILES[-1])


def w16_plan(R: int, I: int, OH: int, dtype, n_sm: int) -> Int4Plan:
    """Route and geometry of K2 for x [R, I] in `dtype` and O/2 = OH: bf16
    takes the tensor cores, fp32 the CUDA cores. Pure: no card needed."""
    if dtype in (torch.bfloat16, "bfloat16"):
        nt = tc_row_tiles(R)
        rows = 8 * nt
        ksplit = split_k(R, I, OH, n_sm, row_tile=rows, k_tile=TC_K_TILE,
                         per_sm=tc_blocks_per_sm(nt))
        k_tiles = -(-I // TC_K_TILE)
        # a stage: the packed weight tile [k, 128 columns] and x [rows, k] bf16
        stage = TC_K_TILE * COL_TILE + rows * TC_K_TILE * 2
        return Int4Plan("tensor_cores", (-(-OH // COL_TILE), -(-R // rows), ksplit),
                       TC_THREADS, TC_K_TILE, ksplit, -(-k_tiles // ksplit), nt,
                       TC_STAGES, TC_STAGES * stage)
    if dtype in (torch.float32, "float32"):
        ksplit = split_k(R, I, OH, n_sm)
        k_tiles = -(-I // K_TILE)
        # x_sh [8][128] fp32 and the block reduction's [8 warps][32][8] fp32
        smem = ROW_TILE * K_TILE * 4 + 8 * 32 * 8 * 4
        return Int4Plan("cuda_cores", (-(-OH // COL_TILE), -(-R // ROW_TILE), ksplit),
                       256, K_TILE, ksplit, -(-k_tiles // ksplit), 1, 1, smem)
    raise TypeError(f"K2 takes float32 or bfloat16 x, not {dtype}")


def a8_plan(R: int, I: int, OH: int, n_sm: int) -> Int4Plan:
    """Geometry of K4 for x8 [R, I] and O/2 = OH: always the tensor cores.
    Pure: no card needed. Raises on shapes the kernel does not take."""
    if not 0 < R <= MAX_KERNEL_ROWS:
        raise ValueError(f"K4 takes 1..{MAX_KERNEL_ROWS} rows, not {R}")
    if I < 4 or I % 4:
        raise ValueError(f"K4 needs I ({I}) % 4 == 0")
    if OH < 4 or OH % 4:
        raise ValueError(f"K4 needs O/2 ({OH}) % 4 == 0")
    nt = tc_row_tiles(R)
    rows = 8 * nt
    ksplit = split_k(R, I, OH, n_sm, row_tile=rows, k_tile=A8_K_TILE,
                     per_sm=tc_blocks_per_sm(nt))
    k_tiles = -(-I // A8_K_TILE)
    # a stage: the packed weight tile [k, 128 columns] and x8 [rows, k] int8
    stage = A8_K_TILE * COL_TILE + rows * A8_K_TILE
    return Int4Plan("tensor_cores", (-(-OH // COL_TILE), -(-R // rows), ksplit), TC_THREADS,
                    A8_K_TILE, ksplit, -(-k_tiles // ksplit), nt, A8_STAGES, A8_STAGES * stage)


# The tensor-core kernel's register layout, mirrored from the comments of
# csrc/int4_matmul.cu (`int4_w16_tc_kernel`) so that the CPU tests can
# compose it with the PTX fragment layout of mma.m16n8k16 and check it
# against the plain version. A warp covers 32 packed columns; lane = 4 g + t.
# Inside one k16 step, MMA k-slot 2t + h (+ 8) carries input 4t + h (+ 2), so
# that a lane reads inputs 4t..4t+3: four packed words (A) and one 8-byte
# load of x (B).


def tc_a_fragment(lane: int, tile: int, reg: int, half: int) -> Tuple[int, int, bool]:
    """(input in the k16 step, packed column in the warp's 32, is_hi) that
    half `half` of A register `reg` of m-tile `tile` (0..3) holds: byte
    `tile` of word 2 (reg >> 1) + half, where word j is word g of the warp's
    strip at input 4t + j; even registers take its lo nibble, odd its hi."""
    g, t = lane >> 2, lane & 3
    return 4 * t + 2 * (reg >> 1) + half, 4 * g + tile, bool(reg & 1)


def tc_b_fragment(lane: int, reg: int, half: int) -> Tuple[int, int]:
    """(row in the n-tile, input in the k16 step) of half `half` of B
    register `reg`: the 8-byte load of x[g][4t..4t+3]."""
    g, t = lane >> 2, lane & 3
    return g, 4 * t + 2 * reg + half


def tc_d_fragment(lane: int, tile: int, reg: int) -> Tuple[int, int, bool]:
    """(row in the n-tile, packed column in the warp's 32, is_hi) of
    accumulator `reg` of m-tile `tile`."""
    g, t = lane >> 2, lane & 3
    return 2 * t + (reg & 1), 4 * g + tile, reg >= 2


def byte_perm(x: int, y: int, selector: int) -> int:
    """CUDA's `__byte_perm` (PRMT, default mode) on 32-bit ints."""
    src = (x & 0xFFFFFFFF) | (y & 0xFFFFFFFF) << 32
    return sum(((src >> (8 * ((selector >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def tc_unpack_pair(word_a: int, word_b: int, byte: int) -> Tuple[int, int]:
    """The kernel's unpack of byte `byte` of two packed words into two bf16x2
    registers (lo, hi), as bit patterns before the subtraction of 136 (the
    kernel's `fma.rn.bf16x2` by 1 and -136): 0x4300 | n is the bf16 value
    128 + n, so lo = (0x4300 | (b & 0xF)) - 136 and
    hi = (0x4300 | ((b >> 4) ^ 8)) - 136, both exact."""
    p = byte_perm(word_a, word_b, 0x4400 + 0x1111 * byte)  # bytes a, a, b, b
    return (p & 0x000F000F) | 0x43004300, ((p >> 4) & 0x000F000F) ^ 0x43084308


# K4's register layout (`int4_a8_tc_kernel`), mirrored likewise for
# mma.m16n8k32 with s8 operands. Inside one k32 step, MMA k-slot 4t + i
# (+ 16) carries input 8t + i (+ 4), so that a lane reads inputs 8t..8t+7:
# eight packed words (A) and one 8-byte load of x8 (B).


def a8_a_fragment(lane: int, tile: int, reg: int, byte: int) -> Tuple[int, int, bool]:
    """(input in the k32 step, packed column in the warp's 32, is_hi) that
    byte `byte` of A register `reg` of m-tile `tile` (0..3) holds: byte
    `tile` of word g of the warp's strip at input 8t + 4 (reg >> 1) + byte,
    after `transpose4`; even registers take 16 x its lo nibble, odd 16 x its
    hi nibble (`a8_unpack`)."""
    g, t = lane >> 2, lane & 3
    return 8 * t + 4 * (reg >> 1) + byte, 4 * g + tile, bool(reg & 1)


def a8_b_fragment(lane: int, reg: int, byte: int) -> Tuple[int, int]:
    """(row in the n-tile, input in the k32 step) of byte `byte` of B
    register `reg`: the 8-byte load of x8[g][8t..8t+7]."""
    g, t = lane >> 2, lane & 3
    return g, 8 * t + 4 * reg + byte


def a8_d_fragment(lane: int, tile: int, reg: int) -> Tuple[int, int, bool]:
    """(row in the n-tile, packed column in the warp's 32, is_hi) of
    accumulator `reg` of m-tile `tile`: K2's places (`tc_d_fragment`); the
    lo accumulators hold 16 x acc_lo."""
    return tc_d_fragment(lane, tile, reg)


def transpose4(w0: int, w1: int, w2: int, w3: int) -> List[int]:
    """The kernel's `transpose4`: four packed words of inputs k..k+3 (byte c
    = packed column c) -> four words of one packed column each, holding its
    bytes of inputs k..k+3 in order (8 PRMTs)."""
    a01, a23 = byte_perm(w0, w1, 0x5140), byte_perm(w2, w3, 0x5140)
    b01, b23 = byte_perm(w0, w1, 0x7362), byte_perm(w2, w3, 0x7362)
    return [byte_perm(a01, a23, 0x5410), byte_perm(a01, a23, 0x7632),
            byte_perm(b01, b23, 0x5410), byte_perm(b01, b23, 0x7632)]


def a8_unpack(col: int) -> Tuple[int, int]:
    """K4's A registers from one column word: (16 lo, 16 hi) as signed
    bytes. The packed byte is 16 hi + (lo + 8), so `& 0xF0` is 16 hi, and
    the lo nibble shifted up is 16 lo + 128 (mod 256), which `^ 0x80` makes
    16 lo: one shift and two LOP3s, no per-byte subtraction."""
    return ((col << 4) & 0xF0F0F0F0) ^ 0x80808080, col & 0xF0F0F0F0


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


def int4_matmul_w16(
    x: torch.Tensor, w_p4: torch.Tensor, s_lo: torch.Tensor, s_hi16: torch.Tensor
) -> torch.Tensor:
    """K2: x [R, I] (R <= 256) @ packed int4 [I, O/2] -> [R, O] in x.dtype.

    CUDA inputs launch the kernel (contiguous float32 or bfloat16 x; bf16
    on the tensor cores, fp32 on the CUDA cores, as `w16_plan` says) and
    raise on anything else; CPU inputs run the plain version."""
    require_local("int4_matmul_w16", x, w_p4, s_lo, s_hi16)
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
    plan = w16_plan(R, I, OH, x.dtype, _sm_count(x.device.index))
    part = None if plan.ksplit == 1 else torch.empty(
        (plan.ksplit, R, 2 * OH), dtype=torch.float32, device=x.device)
    out = torch.empty((R, 2 * OH), dtype=x.dtype, device=x.device)
    fns = _kernel_fns()
    args = (x.data_ptr(), w_p4.data_ptr(), s_lo.data_ptr(), s_hi16.data_ptr(),
            0 if part is None else part.data_ptr(), out.data_ptr(), R, I, OH, plan.ksplit)
    stream = torch.cuda.current_stream().cuda_stream
    tc = plan.route == "tensor_cores"
    if tc:
        err = fns[2](*args, plan.row_tiles, stream)
    else:
        err = fns[0](*args, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul_w16 kernel launch failed ({plan.route}): "
                           f"cudaError {err}")
    int4_matmul_w16.launches += 1
    int4_matmul_w16.tc_launches += tc
    return out


int4_matmul_w16.launches = 0
int4_matmul_w16.tc_launches = 0  # of `launches`, those on the tensor cores


def int4_matmul_w4a8(
    x8: torch.Tensor, xs: torch.Tensor, w_p4: torch.Tensor, s_lo: torch.Tensor,
    s_hi16: torch.Tensor, out_dtype: torch.dtype,
) -> torch.Tensor:
    """K4: int8 activations x8 [R, I] with row scales xs fp32 [R, 1] @ packed
    int4 [I, O/2] -> [R, O] in `out_dtype` (float32 or bfloat16).

    CUDA inputs launch the kernel (on the tensor cores, as `a8_plan` says)
    and raise on anything else; CPU inputs run the plain version. Both give
    the same bits: the dots are exact."""
    require_local("int4_matmul_w4a8", x8, xs, w_p4, s_lo, s_hi16)
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
    _check_cuda((x8, xs, w_p4, s_lo, s_hi16), OH)
    plan = a8_plan(R, I, OH, _sm_count(x8.device.index))  # raises on R, I and OH it cannot take
    part = None if plan.ksplit == 1 else torch.empty(
        (plan.ksplit, R, 2 * OH), dtype=torch.int32, device=x8.device)
    out = torch.empty((R, 2 * OH), dtype=out_dtype, device=x8.device)
    err = _kernel_fns()[1](
        x8.data_ptr(), xs.data_ptr(), w_p4.data_ptr(), s_lo.data_ptr(),
        s_hi16.data_ptr(), 0 if part is None else part.data_ptr(), out.data_ptr(),
        R, I, OH, plan.ksplit, plan.row_tiles, _DTYPE_CODES[out_dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int4_matmul_w4a8 kernel launch failed: cudaError {err}")
    int4_matmul_w4a8.launches += 1
    int4_matmul_w4a8.tc_launches += 1
    return out


int4_matmul_w4a8.launches = 0
int4_matmul_w4a8.tc_launches = 0  # of `launches`, those on the tensor cores: all


# --------------------------------------------------------------- dispatcher


def _layer_slice(q: Int4Weight, layer: Optional[int]):
    wp, s_lo, s_hi16 = q["w_p4"], q["s_lo"], q["s_hi16"]
    if wp.dim() == 3:
        layer = 0 if layer is None else int(layer)
        wp, s_lo, s_hi16 = wp[layer], s_lo[layer], s_hi16[layer]
    return wp, s_lo, s_hi16


def int4_matmul_2d(
    x: torch.Tensor, w_p4: torch.Tensor, s_lo: torch.Tensor, s_hi16: torch.Tensor,
    a8: bool = False, absmax_group=None,
) -> torch.Tensor:
    """x [..., I] @ one layer's packed weight [I, O/2] -> [..., O] in x.dtype.

    More than 256 flattened rows dequantize the weight and run a dense
    matmul; otherwise K2, or K4 when `a8` (activations quantized per row
    first, each row's absmax taken over `absmax_group` when x holds a
    row-parallel shard of its columns)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] > MAX_KERNEL_ROWS:
        w = dequantize_weight_int4({"w_p4": w_p4, "s_lo": s_lo, "s_hi16": s_hi16},
                                   dtype=x.dtype)
        out = x2 @ w
    elif a8:
        x8, xs = quantize_activations_int8(x2, absmax_group)
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
