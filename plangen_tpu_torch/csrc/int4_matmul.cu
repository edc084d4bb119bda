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
//       int32 (__dp4a on four k at a time: the lo bytes are
//       (b & 0x0F) - 8, the hi bytes (b & 0xF0), i.e. 16 * hi as a signed
//       byte), then out = float(acc_lo) * s_lo * xs and
//       float(acc16) * s_hi16 * xs, in that order. acc_lo and acc16 are the
//       integers y2 - 8 * rowsum and y1 - y2 of the TPU kernel, so with the
//       same multiply order the output is bit-equal to the plain version.
//
// What bounds them: weight bytes. At Janus-Pro-1B decode (R = 8 CFG rows)
// a call reads I * OH bytes (2.1 to 16.8 MB) and does 2 * R * 2 operations
// per weight byte, far below the card's ~295 flops/byte balance point.
//
// Design: a block of 8 warps covers 128 packed columns (each lane one
// 32-bit word = 4 packed columns, so a warp reads 128 contiguous bytes per
// input row) and 8 rows of x. x is staged in shared memory 128 inputs at a
// time; the 8 warps take interleaved input rows of the tile, each thread
// accumulating 8 rows x 8 outputs in registers, and a shared-memory
// reduction over the warps ends the block. At decode shapes (OH / 128)
// blocks alone would leave most of the 132 SMs idle, so the wrapper splits
// the input dimension over grid.z (about two blocks per SM): each split
// writes unscaled fp32 (K2) or int32 (K4) partial sums, and a second kernel
// adds the splits in a fixed order and applies the scales. No atomics: the
// result is deterministic, and K4 stays exact.
//
// Left for later work: cp.async/TMA staging of the weight tiles, tensor-core
// MMA (int8 mma.sync for K4, bf16 after an unpack for K2) at larger R, and
// fusing the activation quantization of K4 into the kernel.

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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// ----------------------------------------------------------------- K4 (W4A8)

// Four packed words of input rows k..k+3 (4 columns each) -> four words of
// one column each, holding the bytes of rows k..k+3 in order (for __dp4a).
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
__global__ void __launch_bounds__(kThreads)
    int4_a8_kernel(const int8_t* __restrict__ x8,   // [R, I]
                   const float* __restrict__ xs,    // [R]
                   const int8_t* __restrict__ w,    // [I, OH]
                   const float* __restrict__ s_lo,
                   const float* __restrict__ s_hi16,
                   int* __restrict__ partial,  // [ksplit, R, 2 OH] or null
                   T* __restrict__ out,        // [R, 2 OH]
                   int R, int I, int OH, int tiles_per_split) {
  constexpr int kGroups = kKTile / 4;  // four inputs per int32 word of x8
  __shared__ int x_sh[kRows][kGroups];
  __shared__ int red[kWarps * 32 * 8];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int OHW = OH / 4;
  const int word = blockIdx.x * kColWords + lane;
  const bool col_ok = word < OHW;
  const int r0 = blockIdx.y * kRows;
  const int k_tiles = (I + kKTile - 1) / kKTile;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(k_tiles, t0 + tiles_per_split);

  int acc[kRows][8];  // [row][acc_lo 0..3 | acc16 4..7]
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[r][v] = 0;

  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kKTile;
    for (int i = tid; i < kRows * kGroups; i += kThreads) {
      const int r = i / kGroups, g = i % kGroups;
      const int row = r0 + r, k = k0 + 4 * g;  // I % 4 == 0: whole groups
      x_sh[r][g] = (row < R && k < I)
                       ? *reinterpret_cast<const int*>(x8 + (size_t)row * I + k)
                       : 0;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll
      for (int j = 0; j < kGroups / kWarps; ++j) {
        const int g = warp + j * kWarps;
        const int k = k0 + 4 * g;
        uint32_t col[4];
        transpose4(load_word(w, k, I, OHW, word), load_word(w, k + 1, I, OHW, word),
                   load_word(w, k + 2, I, OHW, word), load_word(w, k + 3, I, OHW, word),
                   col);
        int lo[4], hi16[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = (int)__vsub4(col[c] & 0x0F0F0F0Fu, 0x08080808u);  // lo bytes
          hi16[c] = (int)(col[c] & 0xF0F0F0F0u);  // 16 * hi as signed bytes
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int xw = x_sh[r][g];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = __dp4a(lo[c], xw, acc[r][c]);
            acc[r][4 + c] = __dp4a(hi16[c], xw, acc[r][4 + c]);
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t ld = 2 * (size_t)OH;
  reduce_and_emit<int>(acc, red, min(kRows, R - r0),
      [&](int r, int j, bool is_hi, int s) {
        if (j >= OH) return;
        const int row = r0 + r;
        const int col = is_hi ? j + OH : j;
        if (partial) {
          partial[((size_t)blockIdx.z * R + row) * ld + col] = s;
        } else {
          out[(size_t)row * ld + col] =
              a8_scale<T>(s, is_hi ? s_hi16[j] : s_lo[j], xs[row]);
        }
      });
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

template <typename T>
void launch_a8(const void* x8, const float* xs, const void* w,
               const float* s_lo, const float* s_hi16, void* partial,
               void* out, int R, int I, int OH, int ksplit, cudaStream_t st) {
  const Grid g = make_grid(R, I, OH, ksplit);
  int* part = ksplit > 1 ? static_cast<int*>(partial) : nullptr;
  int4_a8_kernel<T><<<g.main, kThreads, 0, st>>>(
      static_cast<const int8_t*>(x8), xs, static_cast<const int8_t*>(w), s_lo,
      s_hi16, part, static_cast<T*>(out), R, I, OH, g.tiles_per_split);
  if (part)
    int4_a8_reduce<T><<<g.reduce, kReduceThreads, 0, st>>>(
        part, xs, s_lo, s_hi16, static_cast<T*>(out), R, OH, ksplit);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is device memory
// and every array contiguous: x [R, I] (float32 or bfloat16), x8 [R, I] int8
// with xs [R] fp32, w [I, OH] int8, s_lo / s_hi16 [OH] fp32, out [R, 2 OH]
// in `dtype` (0 = float32, 1 = bfloat16), and, when ksplit > 1, partial
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
  if (dtype == 1)
    launch_w16<__nv_bfloat16>(x, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st);
  else if (dtype == 0)
    launch_w16<float>(x, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plangen_int4_matmul_a8(const void* x8, const float* xs,
                                      const void* w, const float* s_lo,
                                      const float* s_hi16, void* partial,
                                      void* out, int R, int I, int OH,
                                      int ksplit, int dtype, void* stream) {
  if (bad_args(R, I, OH, ksplit, partial) || I % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_a8<__nv_bfloat16>(x8, xs, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st);
  else if (dtype == 0)
    launch_a8<float>(x8, xs, w, s_lo, s_hi16, partial, out, R, I, OH, ksplit, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
