// Flash attention forward and backward for Hopper (sm_90a), in the model's
// [B, S, H, D] layout, with the causal and key-padding masks of training.
//
// Replaces the TPU kernel plangen_tpu/ops/pallas_attention.py::_flash_fwd_kernel
// (wrapper flash_attention, whose custom_vjp recomputes the backward through
// XLA) and the library kernels behind flash_attention_tpu (forward plus real
// dq / dkv backward kernels). One forward and one backward here stand for both.
//
// What the forward computes, exactly as the TPU kernel does:
//   s = (q . k) in fp32, times `scale`; a key j counts for query i iff
//   pad_mask[b, j] > 0 and (not causal or j <= i); other entries get
//   -0.7 * FLT_MAX; an fp32 online softmax runs over 64-key tiles (running
//   max m from -inf, alpha = exp(m_prev - m_next)); each tile's probabilities
//   are rounded to the V dtype before the PV product (fp32 accumulator); the
//   output is acc * (l == 0 ? 1 : 1 / l) in the query dtype. The forward
//   also writes the fp32 log-sum-exp m + log(l) of every row.
//
// A query row with no allowed key (a left pad under the causal mask, or every
// row of a fully padded sequence) has no defined output on the TPU, whose
// kernel averages V over the keys of the tiles it happened to visit. The
// training loss does read one such row: the last left pad predicts the first
// real token. So here such a row takes the semantics of the JAX package's
// default (XLA, additive -1e30 bias) path, where all S scores round to the
// same value: every key j < S is visited with score 0, P = 1 / S, the output
// is the mean of V over all S keys, and the gradients are that path's own
// (dS below with P = 1 / S). `first` is the first unpadded key of the batch
// row, found by each block; row i has no allowed key iff i < first (causal)
// or first == S (not causal).
//
// The backward (FlashAttention-2): Delta = rowsum(dO * O) first; then P is
// recomputed from the saved log-sum-exp, with P = 0 wherever the mask
// forbids the pair, and
//   dV = P^T dO (P rounded to the V dtype, as in the forward),
//   dS = P * (dO V^T - Delta), dQ = scale * dS K, dK = scale * dS^T Q.
// One pass per output side and no atomics, so the result is deterministic:
// a dK/dV kernel whose block owns a key tile and loops over query tiles, and
// a dQ kernel whose block owns a query tile and loops over key tiles.
//
// What bounds it: arithmetic. At the training shapes (S = 160..1024, D = 64
// or 128) every tile of q, k and v is reused 64 times from shared memory, so
// the kernel does ~64 FMAs per byte it reads from HBM; it is far above the
// card's balance point. This first version computes on the CUDA cores
// (fp32 FMA, 67 TFLOP/s peak), not the tensor cores (989 TFLOP/s bf16).
//
// Design: 256 threads as a 16 x 16 grid; 64-row tiles of q, k, v and dO are
// staged in shared memory in their own dtype, one row per tile row with a
// row stride of D + 1 (fp32) or D + 2 (bf16) elements, so the threads of a
// half-warp, which read 16 different rows at one column, hit 16 different
// banks. Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j of the
// 64 x 64 score tile; the online softmax stays in registers, with row
// reductions over the 16 lanes of a half-warp by shuffles. Probabilities
// and dS pass through shared memory to the second product. Causal tiles
// wholly above the diagonal are skipped, as the TPU kernel skips them; the
// ragged edge (S not a multiple of 64) is masked in the kernel, nothing is
// padded. The next steps are mma.sync / wgmma products and TMA staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kPer = kTile / 16;  // tile rows (or columns) per thread
constexpr int kLdP = kTile + 1;   // row stride of the fp32 P / dS tiles
constexpr float kMaskValue = -0.7f * FLT_MAX;

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
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// x rounded to T and back (the TPU kernel's p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// row stride (elements) of a staged [64, D] tile: consecutive rows start in
// consecutive banks
template <typename T, int D>
__host__ __device__ constexpr int tile_ld() {
  return D + (sizeof(T) == 2 ? 2 : 1);
}

template <typename T, int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(T) * kTile * tile_ld<T, D>();
}

// max / sum over the 16 lanes of a half-warp (the threads sharing ty)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows [row0, row0 + 64) of head h of batch b of a [B, S, H, D] tensor
// in shared memory; rows at or past S are zero. 16-byte global loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int b, int h, int row0, int S,
                                          int H) {
  constexpr int LD = tile_ld<T, D>();
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    const int s = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      u = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * S + s) * H + h) * D + c);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * LD + c + i] = e[i];
  }
}

// The first unpadded key of batch row b (S if none); every thread gets it
__device__ __forceinline__ int first_key(const int* __restrict__ mask, int b, int S) {
  __shared__ int s_first;
  if (threadIdx.x == 0) s_first = S;
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += kThreads)
    if (mask[static_cast<size_t>(b) * S + j] > 0) {
      atomicMin(&s_first, j);
      break;
    }
  __syncthreads();
  return s_first;
}

// Query row i has no allowed key (see the note at the top)
template <bool kCausal>
__device__ __forceinline__ bool no_key(int i, int first, int S) {
  return kCausal ? i < first : first == S;
}

// Whether key j counts for query i, and for a row with no allowed key every
// key j < S does
template <bool kCausal>
__device__ __forceinline__ bool key_ok(int i, int j, bool row_no_key, int mask_j, int S) {
  return j < S && (row_no_key || (mask_j > 0 && (!kCausal || j <= i)));
}

// pad_mask[b, j0 .. j0 + 63] into shared memory; keys at or past S are masked
__device__ __forceinline__ void load_mask(int* dst, const int* __restrict__ mask,
                                          int b, int j0, int S) {
  if (threadIdx.x < kTile) {
    const int j = j0 + threadIdx.x;
    dst[threadIdx.x] = (j < S) ? mask[static_cast<size_t>(b) * S + j] : 0;
  }
}

// acc[i][j] += sum_d A[ra + 16 i][d] * B[rb + 16 j][d] over two staged tiles
template <typename T, int D>
__device__ __forceinline__ void tile_dot(float (&acc)[kPer][kPer], const T* A,
                                         const T* B, int ra, int rb) {
  constexpr int LD = tile_ld<T, D>();
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = to_float(A[(ra + 16 * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) bv[j] = to_float(B[(rb + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// out[i][c] += sum_j P[r + 16 i][j] * V[j][tx + 16 c]: P an fp32 [64, 65]
// tile in shared memory, V a staged [64, D] tile
template <typename T, int D>
__device__ __forceinline__ void tile_pv(float (&out)[kPer][D / 16],
                                        const float* P, const T* V, int r,
                                        int tx) {
  constexpr int LD = tile_ld<T, D>();
  constexpr int kCols = D / 16;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float p[kPer], v[kCols];
#pragma unroll
    for (int i = 0; i < kPer; ++i) p[i] = P[(r + 16 * i) * kLdP + j];
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = to_float(V[j * LD + tx + 16 * c]);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[i][c] = fmaf(p[i], v[c], out[i][c]);
  }
}

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return 3 * tile_bytes<T, D>() + sizeof(float) * kTile * kLdP +
         sizeof(int) * kTile;
}

// grid (ceil(S / 64), B * H); block 256
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int S, int H,
                     float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + tile_bytes<T, D>());
  T* sV = reinterpret_cast<T*>(smem + 2 * tile_bytes<T, D>());
  float* sP = reinterpret_cast<float*>(smem + 3 * tile_bytes<T, D>());
  int* sMask = reinterpret_cast<int*>(sP + kTile * kLdP);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;

  const int first = first_key(mask, b, S);
  load_tile<T, D>(sQ, q, b, h, q0, S, H);
  float acc[kPer][kCols];
  float m[kPer], l[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles wholly above the diagonal are skipped, unless a row of
  // this tile has no allowed key and so visits every key
  int n_kv = (S + kTile - 1) / kTile;
  if (kCausal && !no_key<kCausal>(q0, first, S))
    n_kv = min(n_kv, (q0 + kTile - 1) / kTile + 1);
  for (int t = 0; t < n_kv; ++t) {
    const int kv0 = t * kTile;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    load_tile<T, D>(sK, k, b, h, kv0, S, H);
    load_tile<T, D>(sV, v, b, h, kv0, S, H);
    load_mask(sMask, mask, b, kv0, S);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    tile_dot<T, D>(s, sQ, sK, ty, tx);

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qi = q0 + ty + 16 * i;
      const bool row_no_key = no_key<kCausal>(qi, first, S);
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kj = kv0 + tx + 16 * j;
        const bool ok = key_ok<kCausal>(qi, kj, row_no_key, sMask[tx + 16 * j], S);
        s[i][j] = ok ? (row_no_key ? 0.f : s[i][j] * scale) : kMaskValue;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_next = fmaxf(m[i], half_warp_max(row_max));
      const float alpha = expf(m[i] - m_next);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_next);
        row_sum += p;
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + half_warp_sum(row_sum);
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pv<T, D>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float l_inv = (l[i] == 0.f) ? 1.f : 1.f / l[i];
    T* row = out + ((static_cast<size_t>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      row[tx + 16 * c] = from_float<T>(acc[i][c] * l_inv);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * S + qi] = m[i] + logf(l[i]);  // l >= 1
  }
}

// Delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in fp32; one warp per
// (b, i, h) row, grid ceil(B * S * H / 8), block 256
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int rows, int S, int H) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const T* a = o + static_cast<size_t>(row) * D;
  const T* g = dout + static_cast<size_t>(row) * D;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) sum = fmaf(to_float(a[d]), to_float(g[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = row % H, bi = row / H, i = bi % S, b = bi / S;
    delta[(static_cast<size_t>(b) * H + h) * S + i] = sum;
  }
}

// The recomputed probabilities and dS of one 64 x 64 tile, for the thread's
// (row group ra, column group rb). `rows_are_queries` says whether the A side
// (ra) indexes queries (dQ kernel) or keys (dK/dV kernel).
template <typename T, int D, bool kCausal, bool kRowsAreQueries>
__device__ __forceinline__ void recompute_p_ds(
    float (&p)[kPer][kPer], float (&ds)[kPer][kPer], const T* sA, const T* sB,
    const T* sGA, const T* sGB, const float* sLse, const float* sDelta,
    const int* sMask, int ra, int rb, int q0, int kv0, int S, int first,
    float scale) {
  float dp[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      p[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  tile_dot<T, D>(p, sA, sB, ra, rb);    // q . k
  tile_dot<T, D>(dp, sGA, sGB, ra, rb);  // dO . v
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int qr = kRowsAreQueries ? ra + 16 * i : rb + 16 * j;  // in tile
      const int kr = kRowsAreQueries ? rb + 16 * j : ra + 16 * i;
      const int qi = q0 + qr, kj = kv0 + kr;
      const bool row_no_key = no_key<kCausal>(qi, first, S);
      const bool ok = qi < S && key_ok<kCausal>(qi, kj, row_no_key, sMask[kr], S);
      const float sij = row_no_key ? 0.f : p[i][j] * scale;
      const float pij = ok ? expf(sij - sLse[qr]) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - sDelta[qr]);
    }
}

template <typename T, int D>
constexpr size_t bwd_smem_bytes() {
  return 4 * tile_bytes<T, D>() + 2 * sizeof(float) * kTile * kLdP +
         2 * sizeof(float) * kTile + sizeof(int) * kTile;
}

// Stage a query tile's lse and Delta; rows at or past S get 0 (their P is 0)
__device__ __forceinline__ void load_row_stats(float* sLse, float* sDelta,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int bh, int q0, int S) {
  if (threadIdx.x < kTile) {
    const int i = q0 + threadIdx.x;
    const size_t at = static_cast<size_t>(bh) * S + i;
    sLse[threadIdx.x] = (i < S) ? lse[at] : 0.f;
    sDelta[threadIdx.x] = (i < S) ? delta[at] : 0.f;
  }
}

// dK and dV of one key tile; grid (ceil(S / 64), B * H), block 256
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ mask,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int S, int H, float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + tile_bytes<T, D>());
  T* sQ = reinterpret_cast<T*>(smem + 2 * tile_bytes<T, D>());
  T* sdO = reinterpret_cast<T*>(smem + 3 * tile_bytes<T, D>());
  float* sP = reinterpret_cast<float*>(smem + 4 * tile_bytes<T, D>());  // [key][query]
  float* sdS = sP + kTile * kLdP;                                        // [key][query]
  float* sLse = sdS + kTile * kLdP;
  float* sDelta = sLse + kTile;
  int* sMask = reinterpret_cast<int*>(sDelta + kTile);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kv0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  constexpr int LD = tile_ld<T, D>();

  const int first = first_key(mask, b, S);
  load_tile<T, D>(sK, k, b, h, kv0, S, H);
  load_tile<T, D>(sV, v, b, h, kv0, S, H);
  load_mask(sMask, mask, b, kv0, S);
  float acc_dk[kPer][kCols], acc_dv[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc_dk[i][c] = 0.f;
      acc_dv[i][c] = 0.f;
    }

  const int n_q = (S + kTile - 1) / kTile;
  for (int t = 0; t < n_q; ++t) {
    const int q0 = t * kTile;
    // causal: query tiles wholly above this key tile see none of its keys,
    // unless one of their rows has no allowed key and so sees every key
    if (kCausal && t < static_cast<int>(blockIdx.x) && !no_key<kCausal>(q0, first, S))
      continue;
    __syncthreads();
    load_tile<T, D>(sQ, q, b, h, q0, S, H);
    load_tile<T, D>(sdO, dout, b, h, q0, S, H);
    load_row_stats(sLse, sDelta, lse, delta, bh, q0, S);
    __syncthreads();

    // rows: keys ty + 16 i; columns: queries tx + 16 j
    float p[kPer][kPer], ds[kPer][kPer];
    recompute_p_ds<T, D, kCausal, false>(p, ds, sK, sQ, sV, sdO, sLse, sDelta,
                                         sMask, ty, tx, q0, kv0, S, first, scale);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = round_to<T>(p[i][j]);
        sdS[(ty + 16 * i) * kLdP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dV[key][c] += P^T[key][query] dO[query][c]; dK likewise with dS and Q
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float pv[kPer], dsv[kPer], g[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = sP[(ty + 16 * i) * kLdP + j];
        dsv[i] = sdS[(ty + 16 * i) * kLdP + j];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        g[c] = to_float(sdO[j * LD + tx + 16 * c]);
        qv[c] = to_float(sQ[j * LD + tx + 16 * c]);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_dv[i][c] = fmaf(pv[i], g[c], acc_dv[i][c]);
          acc_dk[i][c] = fmaf(dsv[i], qv[c], acc_dk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kj = kv0 + ty + 16 * i;
    if (kj >= S) continue;
    const size_t at = ((static_cast<size_t>(b) * S + kj) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[at + tx + 16 * c] = from_float<T>(acc_dk[i][c] * scale);
      dv[at + tx + 16 * c] = from_float<T>(acc_dv[i][c]);
    }
  }
}

// dQ of one query tile; grid (ceil(S / 64), B * H), block 256
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ mask,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int H, float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = reinterpret_cast<T*>(smem + tile_bytes<T, D>());
  T* sK = reinterpret_cast<T*>(smem + 2 * tile_bytes<T, D>());
  T* sV = reinterpret_cast<T*>(smem + 3 * tile_bytes<T, D>());
  float* sdS = reinterpret_cast<float*>(smem + 4 * tile_bytes<T, D>());  // [query][key]
  float* sLse = sdS + 2 * kTile * kLdP;  // (the second fp32 tile is unused)
  float* sDelta = sLse + kTile;
  int* sMask = reinterpret_cast<int*>(sDelta + kTile);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  constexpr int LD = tile_ld<T, D>();

  const int first = first_key(mask, b, S);
  load_tile<T, D>(sQ, q, b, h, q0, S, H);
  load_tile<T, D>(sdO, dout, b, h, q0, S, H);
  load_row_stats(sLse, sDelta, lse, delta, bh, q0, S);
  float acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  int n_kv = (S + kTile - 1) / kTile;
  if (kCausal && !no_key<kCausal>(q0, first, S))
    n_kv = min(n_kv, (q0 + kTile - 1) / kTile + 1);
  for (int t = 0; t < n_kv; ++t) {
    const int kv0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k, b, h, kv0, S, H);
    load_tile<T, D>(sV, v, b, h, kv0, S, H);
    load_mask(sMask, mask, b, kv0, S);
    __syncthreads();

    // rows: queries ty + 16 i; columns: keys tx + 16 j
    float p[kPer][kPer], ds[kPer][kPer];
    recompute_p_ds<T, D, kCausal, true>(p, ds, sQ, sK, sdO, sV, sLse, sDelta,
                                        sMask, ty, tx, q0, kv0, S, first, scale);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        sdS[(ty + 16 * i) * kLdP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_pv<T, D>(acc, sdS, sK, ty, tx);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    T* row = dq + ((static_cast<size_t>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[tx + 16 * c] = from_float<T>(acc[i][c] * scale);
  }
}

// Raise a kernel's dynamic shared memory limit once per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, bool kCausal>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* mask, void* out, float* lse, int B, int S,
                       int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, D>();
  static const cudaError_t attr = allow_smem(flash_fwd_kernel<T, D, kCausal>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<T, D, kCausal><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, S, H, scale);
  return cudaGetLastError();
}

template <typename T, int D, bool kCausal>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const int* mask, const void* out, const void* dout,
                       const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int S, int H, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<T, D>();
  static const cudaError_t attr_kv =
      allow_smem(flash_bwd_dkdv_kernel<T, D, kCausal>, smem);
  static const cudaError_t attr_q = allow_smem(flash_bwd_dq_kernel<T, D, kCausal>, smem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int rows = B * S * H;
  const int rows_per_block = kThreads / 32;
  flash_bwd_delta_kernel<T, D><<<(rows + rows_per_block - 1) / rows_per_block,
                                 kThreads, 0, stream>>>(
      static_cast<const T*>(out), tdo, delta, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_bwd_dkdv_kernel<T, D, kCausal><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, mask, tdo, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D, kCausal><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, mask, tdo, lse, delta, static_cast<T*>(dq), S, H, scale);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128 (checked by the wrapper)
#define PLANGEN_DISPATCH(FN, ...)                                          \
  do {                                                                     \
    if (dtype == 0 && D == 64)                                             \
      return causal ? FN<float, 64, true>(__VA_ARGS__)                     \
                    : FN<float, 64, false>(__VA_ARGS__);                   \
    if (dtype == 0 && D == 128)                                            \
      return causal ? FN<float, 128, true>(__VA_ARGS__)                    \
                    : FN<float, 128, false>(__VA_ARGS__);                  \
    if (dtype == 1 && D == 64)                                             \
      return causal ? FN<__nv_bfloat16, 64, true>(__VA_ARGS__)             \
                    : FN<__nv_bfloat16, 64, false>(__VA_ARGS__);           \
    if (dtype == 1 && D == 128)                                            \
      return causal ? FN<__nv_bfloat16, 128, true>(__VA_ARGS__)            \
                    : FN<__nv_bfloat16, 128, false>(__VA_ARGS__);          \
    return cudaErrorInvalidValue;                                          \
  } while (0)

cudaError_t fwd_dispatch(const void* q, const void* k, const void* v,
                         const int* mask, void* out, float* lse, int B, int S,
                         int H, int D, float scale, int causal, int dtype,
                         cudaStream_t stream) {
  PLANGEN_DISPATCH(launch_fwd, q, k, v, mask, out, lse, B, S, H, scale, stream);
}

cudaError_t bwd_dispatch(const void* q, const void* k, const void* v,
                         const int* mask, const void* out, const void* dout,
                         const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int B, int S, int H, int D, float scale,
                         int causal, int dtype, cudaStream_t stream) {
  PLANGEN_DISPATCH(launch_bwd, q, k, v, mask, out, dout, lse, delta, dq, dk, dv,
                   B, S, H, scale, stream);
}

}  // namespace

// q, k, v, out: [B, S, H, D] contiguous, one dtype; mask: int32 [B, S];
// lse: fp32 [B, H, S]. Returns the CUDA error code (0 = success).
extern "C" int plangen_flash_attention_fwd(const void* q, const void* k,
                                           const void* v, const int* mask,
                                           void* out, float* lse, int B, int S,
                                           int H, int D, float scale,
                                           int causal, int dtype, void* stream) {
  return static_cast<int>(fwd_dispatch(q, k, v, mask, out, lse, B, S, H, D,
                                       scale, causal, dtype,
                                       static_cast<cudaStream_t>(stream)));
}

// dout, dq, dk, dv: [B, S, H, D] like q; delta: fp32 [B, H, S] scratch.
// Launches three kernels in order: Delta, dK/dV, dQ.
extern "C" int plangen_flash_attention_bwd(
    const void* q, const void* k, const void* v, const int* mask,
    const void* out, const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, int B, int S, int H, int D, float scale,
    int causal, int dtype, void* stream) {
  return static_cast<int>(bwd_dispatch(q, k, v, mask, out, dout, lse, delta, dq,
                                       dk, dv, B, S, H, D, scale, causal, dtype,
                                       static_cast<cudaStream_t>(stream)));
}
