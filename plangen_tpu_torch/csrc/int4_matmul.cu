// Packed-int4 weight matmul for Hopper (sm_90a): W4A16 (K2) and W4A8 (K4).
//
// Replaces the TPU kernels plangen_tpu/ops/pallas_int4_matmul.py::_kernel
// (wrapper _int4_matmul_2d, W4A16) and ::_kernel_a8 (wrapper
// _int4_matmul_2d_a8, W4A8). The packed format is theirs, byte for byte:
// w_p4 int8 [I, OH] holds (hi << 4) | (lo + 8), packed column j carrying
// output column j (lo) and column j + OH (hi); s_lo and s_hi16 are fp32 [OH]
// with the hi scale pre-divided by 16. The TPU kernels index a stacked
// [L, I, OH] weight by layer; the port's modules are per layer, so these take
// the 2-D weight of one layer and need no layer index.
//
// What they compute:
//   K2: out[r, j]      = (sum_k x[r, k] * lo[k, j]) * s_lo[j]
//       out[r, j + OH] = (sum_k x[r, k] * hi[k, j]) * (16 * s_hi16[j])
//       with x bf16 or fp32 and fp32 accumulation. The TPU kernel's two
//       matmuls over the same packed tile (its "lincomb identity") were a
//       way to avoid unpacking on the TPU; here the nibbles are unpacked in
//       registers: lo = (b & 0xF) - 8, hi = b >> 4 (arithmetic, signed byte).
//   K4: with x8 int8 [R, I] and per-row scales xs [R] (quantized outside):
//       acc_lo = sum_k x8 * lo and acc16 = sum_k x8 * (16 * hi) in exact
//       int32 on the tensor cores, then out = float(acc_lo) * s_lo * xs and
//       float(acc16) * s_hi16 * xs, in that order. acc_lo and acc16 are the
//       integers y2 - 8 * rowsum and y1 - y2 of the TPU kernel, so with the
//       same multiply order the output is bit-equal to the plain version.
//
// What bounds them: weight bytes at decode. At Janus-Pro-1B decode (R = 8
// CFG rows) a call reads I * OH bytes (2.1 to 16.8 MB) and does 2 * R * 2
// operations per weight byte, far below the card's ~295 flops/byte balance
// point. At R = 256 (a prefill or a batch of 128 requests) the same call
// does 1,024 operations per weight byte: the tensor cores bound it.
//
// K2 in bf16 (`int4_w16_tc_kernel`, the tensor-core route). A block of 4
// warps covers 128 packed columns (256 outputs) and 8 * NT rows of x
// (NT = 1, 2, 4 or 8 n-tiles, the smallest that covers R, more rows over
// blockIdx.y). Each pipeline stage holds the packed weight tile [64 inputs x
// 128 bytes] and the x tile [8 NT rows x 64 inputs] in shared memory; a ring
// of 4 stages is filled by 16-byte `cp.async.cg`, so the copies of tiles
// t+1..t+3 are in flight while tile t computes. The product is
// `mma.sync.m16n8k16` bf16 with fp32 accumulation, A and B swapped: the
// weight is A (16 output columns x 16 inputs), x transposed is B (16 inputs
// x 8 rows), so the 8 CFG rows of a 4-request decode step fill N = 8. The
// nibbles are unpacked in registers straight into A fragments, and each
// warp reuses them over its NT n-tiles: that is where the tensor cores pay
// at R = 64-256. Layout (lane = 4 g + t; mirrored in ops/int4_matmul.py,
// `tc_a_fragment` / `tc_b_fragment` / `tc_d_fragment`):
//   - A warp covers 32 packed columns, i.e. 4 m-tiles: m-tile c holds the lo
//     outputs of packed columns 4 g' + c in rows g' and their hi outputs in
//     rows g' + 8. Inside a k16 step, k-slot 2t + h (+ 8) carries input
//     4t + h (+ 2) in A and B alike, so lane (g, t) reads word g of the
//     warp's strip at inputs 4t..4t+3: four 32-bit words whose byte c feeds
//     m-tile c, lo nibble to A registers 0 and 2, hi to 1 and 3. One byte
//     thus feeds two MMA rows, and a word four m-tiles.
//   - Unpacking: PRMT gathers byte c of two words into the two halves of a
//     register; (n | 0x4300) is the bf16 value 128 + n, so one LOP3 gives
//     128 + lo + 8 (and a shift and one LOP3 128 + hi + 8, the hi nibble
//     XOR 8), and one `fma.rn.bf16x2` subtracts 136: exact. The LOP3s are
//     written as `lop3.b32` with the constants in registers (the compiler
//     splits (p & m) | c into two: a LOP3 takes one immediate).
//   - B is one 8-byte shared-memory load of x[g][4t..4t+3] per n-tile.
//   - Software pipeline over the four k16 steps of a stage: the A words of
//     step s + 1 and all NT B fragments of step s are loaded into registers
//     of their own before step s's MMAs, so no group of MMAs waits on a
//     shared-memory load (241 registers at NT = 8, no spill).
//   - Accumulator c of m-tile c holds rows 2t, 2t + 1 of packed column
//     4g + c: lane (g, t) writes four contiguous lo and four hi outputs per
//     row (16-byte partial stores, 8-byte bf16 stores).
//   - Shared-memory tiles are XOR-swizzled in 16-byte chunks (weight row r:
//     chunk ^ 2 ((r >> 2) & 3); x row n: chunk ^ 2 (n & 3)), so the A word
//     loads hit 32 distinct banks and the B loads take the 2 wavefronts that
//     256 bytes need.
//   - Ragged edges are masked in the kernel: zero-filled copies (src-size 0)
//     past I, R and OH; I % 8 != 0 stages x with plain loads and OH % 16 != 0
//     copies the weight by 4-byte `cp.async.ca`.
// Not `wgmma`: it needs a 64-row operand in shared memory or in its fixed
// register layout, i.e. an unpacked bf16 round trip through shared memory,
// and at R = 8 a 64-row tile would be 7/8 padding. The split over the input
// dimension and the fixed-order second pass stay as below.
//
// K4 (`int4_a8_tc_kernel`, every call): K2's tensor-core structure with
// `mma.sync.m16n8k32` s8 x s8 -> s32: the same 4 warps of 32 packed
// columns, 8-row n-tiles of x8 (1, 2, 4 or 8 a warp), weight as A and x8
// transposed as B, a 4-stage `cp.async` ring and the same zero-filled
// ragged edges (4-byte copies of the weight where OH % 16 != 0 and of x8
// where I % 16 != 0). A stage holds 128 inputs: 128 bytes of every x8 row,
// as K2's 64 bf16 inputs, and a 16 KB weight tile. Layout (mirrored in
// ops/int4_matmul.py, `a8_a_fragment` / `a8_b_fragment` / `a8_d_fragment`):
//   - Inside a k32 step, k-slot 4t + i (+ 16) carries input 8t + i (+ 4) in
//     A and B alike, so lane (g, t) reads word g of the warp's strip at
//     inputs 8t..8t+7 (eight 32-bit words) and B as one 8-byte load of
//     x8[g][8t..8t+7] per n-tile.
//   - `transpose4` (8 PRMTs) turns four words of inputs 8t..8t+3 into one
//     column word per m-tile c (packed column 4g + c); its A registers are
//     16 lo (row g: ((col << 4) & 0xF0F0F0F0) ^ 0x80808080, since the
//     byte is 16 hi + lo + 8) and 16 hi (row g + 8: col & 0xF0F0F0F0), as
//     signed bytes: a shift and two LOP3s a word, no per-byte subtraction
//     and no row sums. The lo accumulators hold 16 acc_lo, exactly (|acc|
//     <= 2^14 I < 2^31 for I < 131072), and the epilogue shifts them back.
//   - Accumulators land where K2's do: rows 2t, 2t + 1 of packed columns
//     4g + c, lo in c0/c1, hi in c2/c3.
//   - Weight rows are swizzled by 2 ((r >> 3) & 3) (the rows 8t + j that
//     lanes t = 0..3 read at once hit 32 distinct banks), x8 rows as K2's.
//
// K2 in fp32 (`int4_w16_kernel<float>`, the check route, CUDA cores): a
// block of 8 warps covers 128 packed columns (each lane one 32-bit word = 4
// packed columns, so a warp reads 128 contiguous bytes per input row) and
// 8 rows of x. x is staged in shared memory 128 inputs at a time; the 8
// warps take interleaved input rows of the tile, each thread accumulating 8
// rows x 8 outputs in registers, and a shared-memory reduction over the
// warps ends the block.
//
// Every route splits the input dimension over grid.z where (OH / 128) x
// (row blocks) alone would leave most of the 132 SMs idle (about two blocks
// per SM; one from 32 rows a block on, ops/int4_matmul.py::tc_blocks_per_sm,
// measured for K2 and K4 alike): each split writes unscaled fp32 (K2) or int32
// (K4) partial sums, and a second kernel adds the splits in a fixed order
// and applies the scales. No atomics: the result is deterministic, and K4
// stays exact.
//
// Left for later work: one launch per call (the split-K combine in a
// cluster), K4's activation quantization inside the kernel, `wgmma`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // rows of x per block
constexpr int kColWords = 32;   // 32-bit words of packed columns per block
constexpr int kKTile = 128;     // inputs staged per shared-memory tile
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 32-bit word `word` of packed row k (rows clamped to the last one: the x
// values staged for k >= I are zero, so what is loaded there never counts)
__device__ __forceinline__ uint32_t load_word(const int8_t* __restrict__ w,
                                              int k, int I, int OHW, int word) {
  const int kc = k < I ? k : I - 1;
  return __ldg(reinterpret_cast<const uint32_t*>(w) + (size_t)kc * OHW + word);
}

// Block reduction of each thread's kRows x 8 accumulators over the warps,
// row by row. Thread t then owns value (t & 7) of lane (t >> 3): packed
// column 4 * word + (t & 3), lo half for (t & 7) < 4, hi half otherwise.
// `emit(row_in_tile, packed_col, is_hi, sum)` writes one output.
template <typename Acc, typename Emit>
__device__ __forceinline__ void reduce_and_emit(Acc (&acc)[kRows][8],
                                                Acc* red, int rows_here,
                                                Emit emit) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows_here) break;  // uniform over the block
    Acc* mine = red + warp * (32 * 8) + lane * 8;
#pragma unroll
    for (int v = 0; v < 8; ++v) mine[v] = acc[r][v];
    __syncthreads();
    Acc s = 0;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) s += red[ww * (32 * 8) + tid];
    const int v = tid & 7;
    emit(r, (blockIdx.x * kColWords + (tid >> 3)) * 4 + (v & 3), v >= 4, s);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- K2 (W4A16)

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int4_w16_kernel(const T* __restrict__ x,        // [R, I]
                    const int8_t* __restrict__ w,   // [I, OH]
                    const float* __restrict__ s_lo,     // [OH]
                    const float* __restrict__ s_hi16,   // [OH]
                    float* __restrict__ partial,  // [ksplit, R, 2 OH] or null
                    T* __restrict__ out,          // [R, 2 OH]
                    int R, int I, int OH, int tiles_per_split) {
  __shared__ float x_sh[kRows][kKTile];
  __shared__ float red[kWarps * 32 * 8];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int OHW = OH / 4;
  const int word = blockIdx.x * kColWords + lane;
  const bool col_ok = word < OHW;
  const int r0 = blockIdx.y * kRows;
  const int k_tiles = (I + kKTile - 1) / kKTile;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(k_tiles, t0 + tiles_per_split);

  float acc[kRows][8];  // [row][lo 0..3 | hi 4..7]
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[r][v] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kKTile;
    for (int i = tid; i < kRows * kKTile; i += kThreads) {
      const int r = i / kKTile, kk = i % kKTile;
      const int row = r0 + r, k = k0 + kk;
      x_sh[r][kk] = (row < R && k < I) ? to_float(x[(size_t)row * I + k]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 8
      for (int j = 0; j < kKTile / kWarps; ++j) {
        const int kk = warp + j * kWarps;
        const uint32_t b4 = load_word(w, k0 + kk, I, OHW, word);
        float lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = (int)(int8_t)(b4 >> (8 * c));  // the signed byte
          lo[c] = (float)((b & 0xF) - 8);
          hi[c] = (float)(b >> 4);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = x_sh[r][kk];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(xv, lo[c], acc[r][c]);
            acc[r][4 + c] = fmaf(xv, hi[c], acc[r][4 + c]);
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t ld = 2 * (size_t)OH;
  reduce_and_emit<float>(acc, red, min(kRows, R - r0),
      [&](int r, int j, bool is_hi, float s) {
        if (j >= OH) return;
        const int row = r0 + r;
        const int col = is_hi ? j + OH : j;
        if (partial) {
          partial[((size_t)blockIdx.z * R + row) * ld + col] = s;
        } else {
          const float scale = is_hi ? 16.f * s_hi16[j] : s_lo[j];
          out[(size_t)row * ld + col] = from_float<T>(s * scale);
        }
      });
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    int4_w16_reduce(const float* __restrict__ partial,
                    const float* __restrict__ s_lo,
                    const float* __restrict__ s_hi16, T* __restrict__ out,
                    int R, int OH, int ksplit) {
  const size_t n = (size_t)R * 2 * OH;
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < ksplit; ++z) s += partial[(size_t)z * n + i];
  const int col = (int)(i % (2 * (size_t)OH));
  const float scale = col >= OH ? 16.f * s_hi16[col - OH] : s_lo[col];
  out[i] = from_float<T>(s * scale);
}

// --------------------------------------------- K2 (W4A16) on the tensor cores

namespace tc {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kWarpCols = 32;                 // packed columns a warp covers
constexpr int kCols = 4 * kWarpCols;          // packed columns a block covers
constexpr int kKTile = 64;                    // inputs a stage
constexpr int kStages = 4;                    // cp.async ring depth
constexpr int kWBytes = kKTile * kCols;       // packed weight bytes a stage
constexpr int kXRowBytes = kKTile * 2;        // bf16 x bytes a row a stage

template <int NT>
__host__ __device__ constexpr int stage_bytes() { return kWBytes + 8 * NT * kXRowBytes; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` of 16 (or 4) copied from global, the rest of the 16 (4) zeroed
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte offset of byte `b` of weight row r (rows of 128 bytes, 16-byte chunks
// XOR-swizzled by 2 ((r >> 2) & 3): the four rows 4t + j that lanes t = 0..3
// read at once land on distinct banks)
__device__ __forceinline__ int w_off(int r, int b) {
  return r * kCols + (((b >> 4) ^ (((r >> 2) & 3) << 1)) << 4) + (b & 15);
}
// byte offset of byte `b` of x row n (rows of 128 bytes, chunks ^ 2 (n & 3))
__device__ __forceinline__ int x_off(int n, int b) {
  return n * kXRowBytes + (((b >> 4) ^ ((n & 3) << 1)) << 4) + (b & 15);
}

// Issues the copies of one k tile [k0, k0 + 64) into a stage: the packed
// weight [64, 128 columns from col0] and x [8 NT rows from r0, 64 inputs].
// The common case (OH % 16 == 0 and I % 8 == 0: 16-byte chunks that lie all
// inside or all outside the arrays) has its per-thread addresses computed
// once: thread tid copies chunk tid & 7 of rows (tid >> 3) + 16 q, and both
// swizzles depend on a row only through (row & 15) >> 2 or row & 3, which
// 16 q leaves unchanged. Other shapes take the general loops.
template <int NT>
struct TileCopier {
  static constexpr int kXChunks = 8 * NT * 8;  // 16-byte chunks of x a stage
  const __nv_bfloat16* x;
  const int8_t* w;
  int R, I, OH, r0, col0;
  bool fast;
  int row, chunk, w_dst, x_dst;  // this thread's first row, chunk, offsets

  __device__ TileCopier(const __nv_bfloat16* x_, const int8_t* w_, int R_, int I_, int OH_,
                        int r0_, int col0_)
      : x(x_), w(w_), R(R_), I(I_), OH(OH_), r0(r0_), col0(col0_),
        fast((OH_ & 15) == 0 && (I_ & 7) == 0) {
    row = threadIdx.x >> 3;
    chunk = threadIdx.x & 7;
    w_dst = w_off(row, 16 * chunk);
    x_dst = kWBytes + x_off(row, 16 * chunk);
  }

  __device__ __forceinline__ void copy(uint8_t* st, int k0) const {
    if (fast) {
      const int col = col0 + 16 * chunk;
#pragma unroll
      for (int q = 0; q < kKTile / 16; ++q) {
        const int k = k0 + row + 16 * q;
        const bool ok = k < I && col < OH;
        cp_async16(smem_u32(st + w_dst + q * 16 * kCols), ok ? w + (size_t)k * OH + col : w,
                   ok ? 16 : 0);
      }
#pragma unroll
      for (int q = 0; q < (kXChunks + kThreads - 1) / kThreads; ++q) {
        if (kXChunks < kThreads && threadIdx.x >= kXChunks) break;
        const int r = r0 + row + 16 * q, k = k0 + 8 * chunk;
        const bool ok = r < R && k < I;
        cp_async16(smem_u32(st + x_dst + q * 16 * kXRowBytes),
                   ok ? x + (size_t)r * I + k : x, ok ? 16 : 0);
      }
      return;
    }
    uint8_t* wsh = st;
    uint8_t* xsh = st + kWBytes;
    if ((OH & 15) == 0) {  // a 16-byte chunk is all inside OH or all past it
      for (int i = threadIdx.x; i < kKTile * 8; i += kThreads) {
        const int r = i >> 3, c = i & 7, k = k0 + r, col = col0 + 16 * c;
        const bool ok = k < I && col < OH;
        cp_async16(smem_u32(wsh + w_off(r, 16 * c)), ok ? w + (size_t)k * OH + col : w,
                   ok ? 16 : 0);
      }
    } else {  // OH % 4 == 0 only: word by word
      for (int i = threadIdx.x; i < kKTile * 32; i += kThreads) {
        const int r = i >> 5, wd = i & 31, k = k0 + r, col = col0 + 4 * wd;
        const bool ok = k < I && col < OH;
        cp_async4(smem_u32(wsh + w_off(r, 4 * wd)), ok ? w + (size_t)k * OH + col : w,
                  ok ? 4 : 0);
      }
    }
    if ((I & 7) == 0) {  // a chunk of 8 inputs is all inside I or all past it
      for (int i = threadIdx.x; i < kXChunks; i += kThreads) {
        const int n = i >> 3, c = i & 7, r = r0 + n, k = k0 + 8 * c;
        const bool ok = r < R && k < I;
        cp_async16(smem_u32(xsh + x_off(n, 16 * c)), ok ? x + (size_t)r * I + k : x,
                   ok ? 16 : 0);
      }
    } else {  // rows of x are not 16-byte aligned: plain loads, zeros outside
      for (int i = threadIdx.x; i < 8 * NT * kKTile; i += kThreads) {
        const int n = i / kKTile, kk = i % kKTile, r = r0 + n, k = k0 + kk;
        *reinterpret_cast<__nv_bfloat16*>(xsh + x_off(n, 2 * kk)) =
            (r < R && k < I) ? x[(size_t)r * I + k] : __float2bfloat16(0.f);
      }
    }
  }
};

__device__ __forceinline__ uint32_t lop3_and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;  // (a & b) | c in one LOP3 (the compiler splits it: one immediate a LOP3)
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t lop3_and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;  // (a & b) ^ c
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Byte `sel`'s two sources of words wa, wb -> the bf16x2 A registers
// (lo(wa), lo(wb)) and (hi(wa), hi(wb)): 0x4300 | n is bf16 128 + n, and
// 128 + (lo + 8) - 136 = lo, 128 + (hi ^ 8 as a nibble) - 136 = hi, exact.
__device__ __forceinline__ void unpack(uint32_t wa, uint32_t wb, uint32_t sel, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t mask = 0x000F000Fu, lo_magic = 0x43004300u, hi_magic = 0x43084308u;
  const uint32_t p = __byte_perm(wa, wb, sel);  // bytes: wa.c, wa.c, wb.c, wb.c
  const uint32_t l = lop3_and_or(p, mask, lo_magic);
  const uint32_t h = lop3_and_xor(p >> 4, mask, hi_magic);
  const uint32_t one = 0x3F803F80u, minus136 = 0xC308C308u;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(lo) : "r"(l), "r"(one), "r"(minus136));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(hi) : "r"(h), "r"(one), "r"(minus136));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
    int4_w16_tc_kernel(const __nv_bfloat16* __restrict__ x,  // [R, I]
                       const int8_t* __restrict__ w,         // [I, OH]
                       const float* __restrict__ s_lo,       // [OH]
                       const float* __restrict__ s_hi16,     // [OH]
                       float* __restrict__ partial,  // [ksplit, R, 2 OH] or null
                       __nv_bfloat16* __restrict__ out,  // [R, 2 OH]
                       int R, int I, int OH, int tiles_per_split) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * 8 * NT;
  const int k_tiles = (I + kKTile - 1) / kKTile;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(k_tiles, t0 + tiles_per_split);
  const int n_live = min(NT, (R - r0 + 7) / 8);  // n-tiles with a row < R
  constexpr int kStage = stage_bytes<NT>();
  const TileCopier<NT> copier(x, w, R, I, OH, r0, col0);
  // this lane's A words: word g of the warp's strip at rows 16 s + 4 t + j,
  // a_off + (16 s + j) * 128 (the row swizzle depends on t only); its B
  // fragment of n-tile n in step s: b_off[s] + n * 8 rows
  const int a_off = w_off(4 * t, kWarpCols * warp + 4 * g);
  int b_off[kKTile / 16];
#pragma unroll
  for (int s = 0; s < kKTile / 16; ++s) b_off[s] = kWBytes + x_off(g, 32 * s + 8 * t);

  float acc[NT][4][4];  // [n-tile][m-tile][accumulator]
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[n][c][v] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < t1) copier.copy(smem + s * kStage, (t0 + s) * kKTile);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = t0; kt < t1; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and stage (kt - 1) is free to refill
    const int next = kt + kStages - 1;
    if (next < t1) copier.copy(smem + ((next - t0) % kStages) * kStage, next * kKTile);
    cp_async_commit();
    const uint8_t* st = smem + ((kt - t0) % kStages) * kStage;
    // software pipeline over the k16 steps: the A words of step s + 1 and all
    // B fragments of step s are loaded before step s's MMAs, each into its
    // own registers, so no MMA waits on a shared-memory load
    uint32_t wd[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wd[0][j] = *reinterpret_cast<const uint32_t*>(st + a_off + j * kCols);
#pragma unroll
    for (int s = 0; s < kKTile / 16; ++s) {
      if (s + 1 < kKTile / 16) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wd[(s + 1) & 1][j] =
              *reinterpret_cast<const uint32_t*>(st + a_off + (16 * (s + 1) + j) * kCols);
      }
      uint2 b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        b[n] = *reinterpret_cast<const uint2*>(st + b_off[s] + n * 8 * kXRowBytes);
      uint32_t a[4][4];  // [m-tile c][A register]
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t sel = 0x4400u + 0x1111u * c;  // byte c of wa, wa, wb, wb
        unpack(wd[s & 1][0], wd[s & 1][1], sel, a[c][0], a[c][1]);
        unpack(wd[s & 1][2], wd[s & 1][3], sel, a[c][2], a[c][3]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < n_live) {  // uniform over the block
#pragma unroll
          for (int c = 0; c < 4; ++c) mma_bf16(acc[n][c], a[c], b[n].x, b[n].y);
        }
      }
    }
  }

  const int p0 = col0 + kWarpCols * warp + 4 * g;  // packed columns p0..p0+3
  if (p0 >= OH) return;  // OH % 4 == 0: all four in or all out
  const size_t ld = 2 * (size_t)OH;
  float4 slo = make_float4(0.f, 0.f, 0.f, 0.f), shi = slo;
  if (!partial) {
    slo = *reinterpret_cast<const float4*>(s_lo + p0);
    shi = *reinterpret_cast<const float4*>(s_hi16 + p0);
    shi = make_float4(16.f * shi.x, 16.f * shi.y, 16.f * shi.z, 16.f * shi.w);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= n_live) continue;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * n + 2 * t + rr;
      if (row >= R) continue;
      const float4 lo = make_float4(acc[n][0][rr], acc[n][1][rr], acc[n][2][rr], acc[n][3][rr]);
      const float4 hi =
          make_float4(acc[n][0][2 + rr], acc[n][1][2 + rr], acc[n][2][2 + rr], acc[n][3][2 + rr]);
      if (partial) {
        float* dst = partial + ((size_t)blockIdx.z * R + row) * ld;
        *reinterpret_cast<float4*>(dst + p0) = lo;
        *reinterpret_cast<float4*>(dst + OH + p0) = hi;
      } else {
        __nv_bfloat16* dst = out + (size_t)row * ld;
        const __nv_bfloat162 l01 = __floats2bfloat162_rn(lo.x * slo.x, lo.y * slo.y);
        const __nv_bfloat162 l23 = __floats2bfloat162_rn(lo.z * slo.z, lo.w * slo.w);
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(hi.x * shi.x, hi.y * shi.y);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(hi.z * shi.z, hi.w * shi.w);
        uint2 vl, vh;
        vl.x = *reinterpret_cast<const uint32_t*>(&l01);
        vl.y = *reinterpret_cast<const uint32_t*>(&l23);
        vh.x = *reinterpret_cast<const uint32_t*>(&h01);
        vh.y = *reinterpret_cast<const uint32_t*>(&h23);
        *reinterpret_cast<uint2*>(dst + p0) = vl;
        *reinterpret_cast<uint2*>(dst + OH + p0) = vh;
      }
    }
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* w, const float* s_lo, const float* s_hi16,
                   void* partial, void* out, int R, int I, int OH, int ksplit,
                   cudaStream_t st) {
  constexpr int smem = kStages * stage_bytes<NT>();
  static bool smem_set = false;  // once per instance (the process drives one card)
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_w16_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int k_tiles = (I + kKTile - 1) / kKTile;
  const dim3 grid((OH + kCols - 1) / kCols, (R + 8 * NT - 1) / (8 * NT), ksplit);
  float* part = ksplit > 1 ? static_cast<float*>(partial) : nullptr;
  auto* o = static_cast<__nv_bfloat16*>(out);
  int4_w16_tc_kernel<NT><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), s_lo, s_hi16, part,
      o, R, I, OH, (k_tiles + ksplit - 1) / ksplit);
  if (part) {
    const size_t n = (size_t)R * 2 * OH;
    int4_w16_reduce<__nv_bfloat16><<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads),
                                     kReduceThreads, 0, st>>>(part, s_lo, s_hi16, o, R, OH,
                                                              ksplit);
  }
  return cudaSuccess;
}

}  // namespace tc

// ----------------------------------------------- K4 (W4A8) on the tensor cores

// Four packed words of input rows k..k+3 (4 columns each) -> four words of
// one column each, holding the bytes of rows k..k+3 in order (8 PRMTs).
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t (&col)[4]) {
  const uint32_t a01 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t a23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t b01 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t b23 = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(a01, a23, 0x5410);
  col[1] = __byte_perm(a01, a23, 0x7632);
  col[2] = __byte_perm(b01, b23, 0x5410);
  col[3] = __byte_perm(b01, b23, 0x7632);
}

// out = float(acc) * s * xs: two roundings in this order, as the plain version
template <typename T>
__device__ __forceinline__ T a8_scale(int acc, float s, float xs) {
  return from_float<T>(__fmul_rn(__fmul_rn(__int2float_rn(acc), s), xs));
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    int4_a8_reduce(const int* __restrict__ partial,
                   const float* __restrict__ xs,
                   const float* __restrict__ s_lo,
                   const float* __restrict__ s_hi16, T* __restrict__ out,
                   int R, int OH, int ksplit) {
  const size_t n = (size_t)R * 2 * OH;
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  int s = 0;
  for (int z = 0; z < ksplit; ++z) s += partial[(size_t)z * n + i];
  const int row = (int)(i / (2 * (size_t)OH));
  const int col = (int)(i % (2 * (size_t)OH));
  out[i] = a8_scale<T>(s, col >= OH ? s_hi16[col - OH] : s_lo[col], xs[row]);
}

namespace a8 {

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::kCols;
using tc::kThreads;
using tc::kWarpCols;
using tc::lop3_and_xor;
using tc::smem_u32;
using tc::x_off;  // x8 rows are 128 bytes a stage, as K2's bf16 rows

constexpr int kKTile = 128;                   // inputs a stage
constexpr int kStages = 4;                    // cp.async ring depth
constexpr int kWBytes = kKTile * kCols;       // packed weight bytes a stage (16 KB)
constexpr int kXRowBytes = kKTile;            // x8 bytes a row a stage
static_assert(kXRowBytes == tc::kXRowBytes, "x_off assumes rows of 128 bytes");

template <int NT>
__host__ __device__ constexpr int stage_bytes() { return kWBytes + 8 * NT * kXRowBytes; }

// byte offset of byte `b` of weight row r (rows of 128 bytes, 16-byte chunks
// XOR-swizzled by 2 ((r >> 3) & 3): the rows 8t + j that lanes t = 0..3
// read at once land on distinct banks)
__device__ __forceinline__ int w_off(int r, int b) {
  return r * kCols + (((b >> 4) ^ (((r >> 3) & 3) << 1)) << 4) + (b & 15);
}

// Issues the copies of one k tile [k0, k0 + 128) into a stage: the packed
// weight [128, 128 columns from col0] and x8 [8 NT rows from r0, 128
// inputs]. The common case (OH % 16 == 0 and I % 16 == 0: 16-byte chunks
// that lie all inside or all outside the arrays) has its per-thread
// addresses computed once: thread tid copies chunk tid & 7 of rows
// (tid >> 3) + 16 q; the x8 swizzle depends on a row through row & 3 only,
// the weight swizzle through (row >> 3) & 3, which 16 q flips by 2 for odd
// q. Other shapes take the general loops: 4-byte copies of the weight where
// OH % 16 != 0 and of x8 where I % 16 != 0 (x8 rows are then not 16-byte
// aligned; I % 4 == 0 keeps every 4-byte group inside or outside I).
template <int NT>
struct TileCopier {
  static constexpr int kXChunks = 8 * NT * 8;  // 16-byte chunks of x8 a stage
  const int8_t* x8;
  const int8_t* w;
  int R, I, OH, r0, col0;
  bool fast;
  int row, chunk, w_dst[2], x_dst;  // this thread's first row, chunk, offsets

  __device__ TileCopier(const int8_t* x8_, const int8_t* w_, int R_, int I_, int OH_, int r0_,
                        int col0_)
      : x8(x8_), w(w_), R(R_), I(I_), OH(OH_), r0(r0_), col0(col0_),
        fast((OH_ & 15) == 0 && (I_ & 15) == 0) {
    row = threadIdx.x >> 3;
    chunk = threadIdx.x & 7;
    w_dst[0] = w_off(row, 16 * chunk);                // even q
    w_dst[1] = w_off(row + 16, 16 * chunk) - 16 * kCols;  // odd q
    x_dst = kWBytes + x_off(row, 16 * chunk);
  }

  __device__ __forceinline__ void copy(uint8_t* st, int k0) const {
    if (fast) {
      const int col = col0 + 16 * chunk;
#pragma unroll
      for (int q = 0; q < kKTile / 16; ++q) {
        const int k = k0 + row + 16 * q;
        const bool ok = k < I && col < OH;
        cp_async16(smem_u32(st + w_dst[q & 1] + q * 16 * kCols),
                   ok ? w + (size_t)k * OH + col : w, ok ? 16 : 0);
      }
#pragma unroll
      for (int q = 0; q < (kXChunks + kThreads - 1) / kThreads; ++q) {
        if (kXChunks < kThreads && threadIdx.x >= kXChunks) break;
        const int r = r0 + row + 16 * q, k = k0 + 16 * chunk;
        const bool ok = r < R && k < I;
        cp_async16(smem_u32(st + x_dst + q * 16 * kXRowBytes),
                   ok ? x8 + (size_t)r * I + k : x8, ok ? 16 : 0);
      }
      return;
    }
    uint8_t* wsh = st;
    uint8_t* xsh = st + kWBytes;
    if ((OH & 15) == 0) {  // a 16-byte chunk is all inside OH or all past it
      for (int i = threadIdx.x; i < kKTile * 8; i += kThreads) {
        const int r = i >> 3, c = i & 7, k = k0 + r, col = col0 + 16 * c;
        const bool ok = k < I && col < OH;
        cp_async16(smem_u32(wsh + w_off(r, 16 * c)), ok ? w + (size_t)k * OH + col : w,
                   ok ? 16 : 0);
      }
    } else {  // OH % 4 == 0 only: word by word
      for (int i = threadIdx.x; i < kKTile * 32; i += kThreads) {
        const int r = i >> 5, wd = i & 31, k = k0 + r, col = col0 + 4 * wd;
        const bool ok = k < I && col < OH;
        cp_async4(smem_u32(wsh + w_off(r, 4 * wd)), ok ? w + (size_t)k * OH + col : w,
                  ok ? 4 : 0);
      }
    }
    if ((I & 15) == 0) {  // a chunk of 16 inputs is all inside I or all past it
      for (int i = threadIdx.x; i < kXChunks; i += kThreads) {
        const int n = i >> 3, c = i & 7, r = r0 + n, k = k0 + 16 * c;
        const bool ok = r < R && k < I;
        cp_async16(smem_u32(xsh + x_off(n, 16 * c)), ok ? x8 + (size_t)r * I + k : x8,
                   ok ? 16 : 0);
      }
    } else {  // I % 4 == 0 only: 4 inputs at a time
      for (int i = threadIdx.x; i < 8 * NT * (kKTile / 4); i += kThreads) {
        const int n = i >> 5, c = i & 31, r = r0 + n, k = k0 + 4 * c;
        const bool ok = r < R && k < I;
        cp_async4(smem_u32(xsh + x_off(n, 4 * c)), ok ? x8 + (size_t)r * I + k : x8,
                  ok ? 4 : 0);
      }
    }
  }
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A registers of the four m-tiles from four packed words of inputs k..k+3:
// byte c of each word is packed column 4g + c; after `transpose4`, column
// word c gives 16 lo (register `reg` of m-tile c: the packed byte is
// 16 hi + lo + 8, so (byte << 4) & 0xF0 is 16 lo + 128 mod 256, and ^ 0x80
// makes it 16 lo) and 16 hi (register reg + 1: byte & 0xF0), as signed bytes.
__device__ __forceinline__ void unpack4(const uint32_t* wd, int reg, uint32_t (&a)[4][4]) {
  const uint32_t hi_mask = 0xF0F0F0F0u, sign = 0x80808080u;
  uint32_t col[4];
  transpose4(wd[0], wd[1], wd[2], wd[3], col);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c][reg] = lop3_and_xor(col[c] << 4, hi_mask, sign);
    a[c][reg + 1] = col[c] & hi_mask;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c, float d);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, float a, float b,
                                                      float c, float d) {
  const __nv_bfloat162 ab = __floats2bfloat162_rn(a, b), cd = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&ab);
  v.y = *reinterpret_cast<const uint32_t*>(&cd);
  *reinterpret_cast<uint2*>(dst) = v;
}

template <int NT, typename T>
__global__ void __launch_bounds__(kThreads)
    int4_a8_tc_kernel(const int8_t* __restrict__ x8,   // [R, I]
                      const float* __restrict__ xs,    // [R]
                      const int8_t* __restrict__ w,    // [I, OH]
                      const float* __restrict__ s_lo,  // [OH]
                      const float* __restrict__ s_hi16,  // [OH]
                      int* __restrict__ partial,  // [ksplit, R, 2 OH] or null
                      T* __restrict__ out,        // [R, 2 OH]
                      int R, int I, int OH, int tiles_per_split) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * 8 * NT;
  const int k_tiles = (I + kKTile - 1) / kKTile;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(k_tiles, t0 + tiles_per_split);
  const int n_live = min(NT, (R - r0 + 7) / 8);  // n-tiles with a row < R
  constexpr int kStage = stage_bytes<NT>();
  const TileCopier<NT> copier(x8, w, R, I, OH, r0, col0);
  // this lane's A words: word g of the warp's strip at rows 32 s + 8 t + j,
  // a_off + (32 s + j) * 128 (the row swizzle depends on t only); its B
  // fragment of n-tile n in step s: the 8 bytes at b_off[s] + n * 8 rows
  const int a_off = w_off(8 * t, kWarpCols * warp + 4 * g);
  int b_off[kKTile / 32];
#pragma unroll
  for (int s = 0; s < kKTile / 32; ++s) b_off[s] = kWBytes + x_off(g, 32 * s + 8 * t);

  int acc[NT][4][4];  // [n-tile][m-tile][accumulator]; lo ones hold 16 acc_lo
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[n][c][v] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < t1) copier.copy(smem + s * kStage, (t0 + s) * kKTile);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = t0; kt < t1; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and stage (kt - 1) is free to refill
    const int next = kt + kStages - 1;
    if (next < t1) copier.copy(smem + ((next - t0) % kStages) * kStage, next * kKTile);
    cp_async_commit();
    const uint8_t* st = smem + ((kt - t0) % kStages) * kStage;
    // software pipeline over the k32 steps, as K2's: the A words of step
    // s + 1 and all B fragments of step s are in registers before step s's
    // MMAs
    uint32_t wd[2][8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wd[0][j] = *reinterpret_cast<const uint32_t*>(st + a_off + j * kCols);
#pragma unroll
    for (int s = 0; s < kKTile / 32; ++s) {
      if (s + 1 < kKTile / 32) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wd[(s + 1) & 1][j] =
              *reinterpret_cast<const uint32_t*>(st + a_off + (32 * (s + 1) + j) * kCols);
      }
      uint2 b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        b[n] = *reinterpret_cast<const uint2*>(st + b_off[s] + n * 8 * kXRowBytes);
      uint32_t a[4][4];  // [m-tile c][A register]
      unpack4(wd[s & 1], 0, a);      // inputs 8t..8t+3: registers 0 (lo), 1 (hi)
      unpack4(wd[s & 1] + 4, 2, a);  // inputs 8t+4..8t+7: registers 2, 3
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < n_live) {  // uniform over the block
#pragma unroll
          for (int c = 0; c < 4; ++c) mma_s8(acc[n][c], a[c], b[n].x, b[n].y);
        }
      }
    }
  }

  const int p0 = col0 + kWarpCols * warp + 4 * g;  // packed columns p0..p0+3
  if (p0 >= OH) return;  // OH % 4 == 0: all four in or all out
  const size_t ld = 2 * (size_t)OH;
  float4 slo = make_float4(0.f, 0.f, 0.f, 0.f), shi = slo;
  if (!partial) {
    slo = *reinterpret_cast<const float4*>(s_lo + p0);
    shi = *reinterpret_cast<const float4*>(s_hi16 + p0);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= n_live) continue;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * n + 2 * t + rr;
      if (row >= R) continue;
      // acc_lo: the lo sums are of multiples of 16, so >> 4 is exact
      const int4 lo = make_int4(acc[n][0][rr] >> 4, acc[n][1][rr] >> 4, acc[n][2][rr] >> 4,
                                acc[n][3][rr] >> 4);
      const int4 hi = make_int4(acc[n][0][2 + rr], acc[n][1][2 + rr], acc[n][2][2 + rr],
                                acc[n][3][2 + rr]);
      if (partial) {
        int* dst = partial + ((size_t)blockIdx.z * R + row) * ld;
        *reinterpret_cast<int4*>(dst + p0) = lo;
        *reinterpret_cast<int4*>(dst + OH + p0) = hi;
      } else {
        const float x = xs[row];
        T* dst = out + (size_t)row * ld;
        store4<T>(dst + p0, a8_scale<float>(lo.x, slo.x, x), a8_scale<float>(lo.y, slo.y, x),
                  a8_scale<float>(lo.z, slo.z, x), a8_scale<float>(lo.w, slo.w, x));
        store4<T>(dst + OH + p0, a8_scale<float>(hi.x, shi.x, x),
                  a8_scale<float>(hi.y, shi.y, x), a8_scale<float>(hi.z, shi.z, x),
                  a8_scale<float>(hi.w, shi.w, x));
      }
    }
  }
}

template <int NT, typename T>
cudaError_t launch(const void* x8, const float* xs, const void* w, const float* s_lo,
                   const float* s_hi16, void* partial, void* out, int R, int I, int OH,
                   int ksplit, cudaStream_t st) {
  constexpr int smem = kStages * stage_bytes<NT>();
  static bool smem_set = false;  // once per instance (the process drives one card)
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_a8_tc_kernel<NT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int k_tiles = (I + kKTile - 1) / kKTile;
  const dim3 grid((OH + kCols - 1) / kCols, (R + 8 * NT - 1) / (8 * NT), ksplit);
  int* part = ksplit > 1 ? static_cast<int*>(partial) : nullptr;
  T* o = static_cast<T*>(out);
  int4_a8_tc_kernel<NT, T><<<grid, kThreads, smem, st>>>(
      static_cast<const int8_t*>(x8), xs, static_cast<const int8_t*>(w), s_lo, s_hi16, part, o,
      R, I, OH, (k_tiles + ksplit - 1) / ksplit);
  if (part) {
    const size_t n = (size_t)R * 2 * OH;
    int4_a8_reduce<T><<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads), kReduceThreads,
                        0, st>>>(part, xs, s_lo, s_hi16, o, R, OH, ksplit);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_rows(int row_tiles, const void* x8, const float* xs, const void* w,
                        const float* s_lo, const float* s_hi16, void* partial, void* out, int R,
                        int I, int OH, int ksplit, cudaStream_t st) {
  switch (row_tiles) {
    case 1: return launch<1, T>(x8, xs, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st);
    case 2: return launch<2, T>(x8, xs, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st);
    case 4: return launch<4, T>(x8, xs, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st);
    case 8: return launch<8, T>(x8, xs, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace a8

// ------------------------------------------------------------------ launches

struct Grid {
  dim3 main;
  dim3 reduce;
  int tiles_per_split;
};

Grid make_grid(int R, int I, int OH, int ksplit) {
  const int col_tiles = (OH / 4 + kColWords - 1) / kColWords;
  const int row_tiles = (R + kRows - 1) / kRows;
  const int k_tiles = (I + kKTile - 1) / kKTile;
  const size_t n = (size_t)R * 2 * OH;
  return Grid{dim3(col_tiles, row_tiles, ksplit),
              dim3((unsigned)((n + kReduceThreads - 1) / kReduceThreads)),
              (k_tiles + ksplit - 1) / ksplit};
}

bool bad_args(int R, int I, int OH, int ksplit, const void* partial) {
  return R < 1 || I < 1 || OH < 4 || OH % 4 || ksplit < 1 ||
         ksplit > (I + kKTile - 1) / kKTile || (ksplit > 1 && !partial);
}

template <typename T>
void launch_w16(const void* x, const void* w, const float* s_lo,
                const float* s_hi16, void* partial, void* out, int R, int I,
                int OH, int ksplit, cudaStream_t st) {
  const Grid g = make_grid(R, I, OH, ksplit);
  float* part = ksplit > 1 ? static_cast<float*>(partial) : nullptr;
  int4_w16_kernel<T><<<g.main, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), s_lo, s_hi16,
      part, static_cast<T*>(out), R, I, OH, g.tiles_per_split);
  if (part)
    int4_w16_reduce<T><<<g.reduce, kReduceThreads, 0, st>>>(
        part, s_lo, s_hi16, static_cast<T*>(out), R, OH, ksplit);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is device memory
// and every array contiguous: x [R, I] (float32 or bfloat16), x8 [R, I] int8
// with xs [R] fp32, w [I, OH] int8, s_lo / s_hi16 [OH] fp32, out [R, 2 OH]
// in `dtype` (0 = float32 only for W4A16, whose bf16 route is
// plangen_int4_matmul_w16_tc; 0 = float32 or 1 = bfloat16 for W4A8), and,
// when ksplit > 1, partial
// [ksplit, R, 2 OH] scratch (fp32 for W4A16, int32 for W4A8). OH % 4 == 0;
// W4A8 also needs I % 4 == 0. Returns cudaGetLastError() after the launches.
extern "C" int plangen_int4_matmul_w16(const void* x, const void* w,
                                       const float* s_lo, const float* s_hi16,
                                       void* partial, void* out, int R, int I,
                                       int OH, int ksplit, int dtype,
                                       void* stream) {
  if (bad_args(R, I, OH, ksplit, partial))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0)  // bf16 takes plangen_int4_matmul_w16_tc
    return static_cast<int>(cudaErrorInvalidValue);
  launch_w16<float>(x, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st);
  return static_cast<int>(cudaGetLastError());
}

// K2 in bf16 on the tensor cores: x and out bfloat16, `row_tiles` (1, 2, 4
// or 8) the 8-row n-tiles a warp covers, partial fp32 as above.
extern "C" int plangen_int4_matmul_w16_tc(const void* x, const void* w,
                                          const float* s_lo, const float* s_hi16,
                                          void* partial, void* out, int R, int I,
                                          int OH, int ksplit, int row_tiles,
                                          void* stream) {
  if (R < 1 || I < 1 || OH < 4 || OH % 4 || ksplit < 1 ||
      ksplit > (I + tc::kKTile - 1) / tc::kKTile || (ksplit > 1 && !partial))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (row_tiles) {
    case 1: e = tc::launch<1>(x, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st); break;
    case 2: e = tc::launch<2>(x, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st); break;
    case 4: e = tc::launch<4>(x, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st); break;
    case 8: e = tc::launch<8>(x, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K4 on the tensor cores: x8 int8 with xs fp32, `row_tiles` (1, 2, 4 or 8)
// the 8-row n-tiles a warp covers, out in `dtype`, partial int32 as above.
extern "C" int plangen_int4_matmul_a8(const void* x8, const float* xs,
                                      const void* w, const float* s_lo,
                                      const float* s_hi16, void* partial,
                                      void* out, int R, int I, int OH,
                                      int ksplit, int row_tiles, int dtype,
                                      void* stream) {
  if (R < 1 || I < 4 || I % 4 || OH < 4 || OH % 4 || ksplit < 1 ||
      ksplit > (I + a8::kKTile - 1) / a8::kKTile || (ksplit > 1 && !partial))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1)
    e = a8::launch_rows<__nv_bfloat16>(row_tiles, x8, xs, w, s_lo, s_hi16, partial, out, R, I,
                                       OH, ksplit, st);
  else if (dtype == 0)
    e = a8::launch_rows<float>(row_tiles, x8, xs, w, s_lo, s_hi16, partial, out, R, I, OH,
                               ksplit, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
