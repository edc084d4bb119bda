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
// or first == S (not causal). The block that owns such rows visits every
// key tile (they all take the masked path), so the online softmax itself
// sums V over all S keys for them.
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
// Two routes, chosen by dtype, each raising on failure (no fallback):
//
// * bfloat16, the training path: the tensor cores (namespace `tc` below).
//   What bounds it: arithmetic. Every 64-row tile of q, k, v and dO is reused
//   by up to S / 64 tiles from shared memory, ~64 FLOP per HBM byte at the
//   training shapes, far above the card's balance point (~295), so the aim
//   is the 989 TFLOP/s of the bf16 tensor cores. The forward runs on one
//   warpgroup per 64-query tile with `wgmma` (S = Q K^T from shared memory,
//   O += P V with P in registers), and so does the backward, on one
//   warpgroup per 64-row tile. The backward rounds dS to bf16 before its two
//   products (the rounding point every bf16 flash backward has), besides P
//   before dV.
// * float32: the CUDA cores (fp32 FMA, 67 TFLOP/s peak), the first version
//   kept as the 1e-4 check of the algorithm on the card. 256 threads as a
//   16 x 16 grid; 64-row tiles of q, k, v and dO are staged in shared memory,
//   one row per tile row with a row stride of D + 1 elements, so the threads
//   of a half-warp, which read 16 different rows at one column, hit 16
//   different banks. Thread (ty, tx) owns rows ty + 16 i and columns
//   tx + 16 j of the 64 x 64 score tile; the online softmax stays in
//   registers, with row reductions over the 16 lanes of a half-warp by
//   shuffles. Probabilities and dS pass through shared memory to the second
//   product.
//
// Both routes skip causal tiles wholly above the diagonal, as the TPU kernel
// does, and mask the ragged edge (S not a multiple of 64) in the kernel;
// nothing is padded.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kPer = kTile / 16;  // tile rows (or columns) per thread
constexpr int kLdP = kTile + 1;   // row stride of the fp32 P / dS tiles
constexpr float kMaskValue = -0.7f * FLT_MAX;

// The fp32 route (CUDA cores): every tensor is float, so the TPU kernel's
// rounding of p to the V dtype is the identity here.

// row stride (floats) of a staged [64, D] tile: consecutive rows start in
// consecutive banks
template <int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 1;
}

template <int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(float) * kTile * tile_ld<D>();
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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int b, int h, int row0, int S,
                                          int H) {
  constexpr int LD = tile_ld<D>();
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    const int s = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      u = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * S + s) * H + h) * D + c);
    const float* e = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * LD + c + i] = e[i];
  }
}

// The first unpadded key of batch row b (S if none); every thread of the
// block (kN threads) gets it
template <int kN>
__device__ __forceinline__ int first_key(const int* __restrict__ mask, int b, int S) {
  __shared__ int s_first;
  if (threadIdx.x == 0) s_first = S;
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += kN)
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
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[kPer][kPer], const float* A,
                                         const float* B, int ra, int rb) {
  constexpr int LD = tile_ld<D>();
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = A[(ra + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) bv[j] = B[(rb + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// out[i][c] += sum_j P[r + 16 i][j] * V[j][tx + 16 c]: P an fp32 [64, 65]
// tile in shared memory, V a staged [64, D] tile
template <int D>
__device__ __forceinline__ void tile_pv(float (&out)[kPer][D / 16],
                                        const float* P, const float* V, int r,
                                        int tx) {
  constexpr int LD = tile_ld<D>();
  constexpr int kCols = D / 16;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float p[kPer], v[kCols];
#pragma unroll
    for (int i = 0; i < kPer; ++i) p[i] = P[(r + 16 * i) * kLdP + j];
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = V[j * LD + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[i][c] = fmaf(p[i], v[c], out[i][c]);
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return 3 * tile_bytes<D>() + sizeof(float) * kTile * kLdP +
         sizeof(int) * kTile;
}

// grid (ceil(S / 64), B * H); block 256
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ lse, int S, int H,
                     float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + tile_bytes<D>());
  float* sV = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>());
  float* sP = reinterpret_cast<float*>(smem + 3 * tile_bytes<D>());
  int* sMask = reinterpret_cast<int*>(sP + kTile * kLdP);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;

  const int first = first_key<kThreads>(mask, b, S);
  load_tile<D>(sQ, q, b, h, q0, S, H);
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
    load_tile<D>(sK, k, b, h, kv0, S, H);
    load_tile<D>(sV, v, b, h, kv0, S, H);
    load_mask(sMask, mask, b, kv0, S);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    tile_dot<D>(s, sQ, sK, ty, tx);

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
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + half_warp_sum(row_sum);
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pv<D>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float l_inv = (l[i] == 0.f) ? 1.f : 1.f / l[i];
    float* row = out + ((static_cast<size_t>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      row[tx + 16 * c] = acc[i][c] * l_inv;
    if (tx == 0)
      lse[static_cast<size_t>(bh) * S + qi] = m[i] + logf(l[i]);  // l >= 1
  }
}

// Delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in fp32; one warp per
// (b, i, h) row, grid ceil(B * S * H / 8), block 256
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                           float* __restrict__ delta, int rows, int S, int H) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const float* a = o + static_cast<size_t>(row) * D;
  const float* g = dout + static_cast<size_t>(row) * D;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) sum = fmaf(a[d], g[d], sum);
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
template <int D, bool kCausal, bool kRowsAreQueries>
__device__ __forceinline__ void recompute_p_ds(
    float (&p)[kPer][kPer], float (&ds)[kPer][kPer], const float* sA, const float* sB,
    const float* sGA, const float* sGB, const float* sLse, const float* sDelta,
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
  tile_dot<D>(p, sA, sB, ra, rb);    // q . k
  tile_dot<D>(dp, sGA, sGB, ra, rb);  // dO . v
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

template <int D>
constexpr size_t bwd_smem_bytes() {
  return 4 * tile_bytes<D>() + 2 * sizeof(float) * kTile * kLdP +
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
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ mask,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int S, int H, float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = reinterpret_cast<float*>(smem + tile_bytes<D>());
  float* sQ = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>());
  float* sdO = reinterpret_cast<float*>(smem + 3 * tile_bytes<D>());
  float* sP = reinterpret_cast<float*>(smem + 4 * tile_bytes<D>());  // [key][query]
  float* sdS = sP + kTile * kLdP;                                        // [key][query]
  float* sLse = sdS + kTile * kLdP;
  float* sDelta = sLse + kTile;
  int* sMask = reinterpret_cast<int*>(sDelta + kTile);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kv0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  constexpr int LD = tile_ld<D>();

  const int first = first_key<kThreads>(mask, b, S);
  load_tile<D>(sK, k, b, h, kv0, S, H);
  load_tile<D>(sV, v, b, h, kv0, S, H);
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
    load_tile<D>(sQ, q, b, h, q0, S, H);
    load_tile<D>(sdO, dout, b, h, q0, S, H);
    load_row_stats(sLse, sDelta, lse, delta, bh, q0, S);
    __syncthreads();

    // rows: keys ty + 16 i; columns: queries tx + 16 j
    float p[kPer][kPer], ds[kPer][kPer];
    recompute_p_ds<D, kCausal, false>(p, ds, sK, sQ, sV, sdO, sLse, sDelta,
                                         sMask, ty, tx, q0, kv0, S, first, scale);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p[i][j];
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
        g[c] = sdO[j * LD + tx + 16 * c];
        qv[c] = sQ[j * LD + tx + 16 * c];
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
      dk[at + tx + 16 * c] = acc_dk[i][c] * scale;
      dv[at + tx + 16 * c] = acc_dv[i][c];
    }
  }
}

// dQ of one query tile; grid (ceil(S / 64), B * H), block 256
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ mask,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int S, int H, float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = reinterpret_cast<float*>(smem + tile_bytes<D>());
  float* sK = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>());
  float* sV = reinterpret_cast<float*>(smem + 3 * tile_bytes<D>());
  float* sdS = reinterpret_cast<float*>(smem + 4 * tile_bytes<D>());  // [query][key]
  float* sLse = sdS + 2 * kTile * kLdP;  // (the second fp32 tile is unused)
  float* sDelta = sLse + kTile;
  int* sMask = reinterpret_cast<int*>(sDelta + kTile);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  constexpr int LD = tile_ld<D>();

  const int first = first_key<kThreads>(mask, b, S);
  load_tile<D>(sQ, q, b, h, q0, S, H);
  load_tile<D>(sdO, dout, b, h, q0, S, H);
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
    load_tile<D>(sK, k, b, h, kv0, S, H);
    load_tile<D>(sV, v, b, h, kv0, S, H);
    load_mask(sMask, mask, b, kv0, S);
    __syncthreads();

    // rows: queries ty + 16 i; columns: keys tx + 16 j
    float p[kPer][kPer], ds[kPer][kPer];
    recompute_p_ds<D, kCausal, true>(p, ds, sQ, sK, sdO, sV, sLse, sDelta,
                                        sMask, ty, tx, q0, kv0, S, first, scale);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        sdS[(ty + 16 * i) * kLdP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_pv<D>(acc, sdS, sK, ty, tx);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    float* row = dq + ((static_cast<size_t>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[tx + 16 * c] = acc[i][c] * scale;
  }
}

// Raise a kernel's dynamic shared memory limit once per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, bool kCausal>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* mask, void* out, float* lse, int B, int S,
                       int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  static const cudaError_t attr = allow_smem(flash_fwd_kernel<D, kCausal>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<D, kCausal><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), lse, S, H, scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const int* mask, const void* out, const void* dout,
                       const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int S, int H, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D>();
  static const cudaError_t attr_kv =
      allow_smem(flash_bwd_dkdv_kernel<D, kCausal>, smem);
  static const cudaError_t attr_q = allow_smem(flash_bwd_dq_kernel<D, kCausal>, smem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const int rows = B * S * H;
  const int rows_per_block = kThreads / 32;
  flash_bwd_delta_kernel<D><<<(rows + rows_per_block - 1) / rows_per_block,
                                 kThreads, 0, stream>>>(
      static_cast<const float*>(out), tdo, delta, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_bwd_dkdv_kernel<D, kCausal><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, mask, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, kCausal><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, mask, tdo, lse, delta, static_cast<float*>(dq), S, H, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 route on the tensor cores.
//
// Shared-memory tiles. A [64, D] bf16 tile is D / 64 sub-tiles of 64 rows x
// 128 bytes (64 columns); the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8) of its row: the 128-byte swizzle that `wgmma`'s shared-memory
// descriptors name, which also lets `ldmatrix` read 8 rows at one logical
// chunk from 8 different bank groups. Every tile starts on a 1024-byte
// boundary. Rows are copied from HBM at stride H * D of the [B, S, H, D]
// layout by 16-byte `cp.async` (rows at or past S are zero-filled); nothing
// is transposed in HBM.
//
// Forward (flash_fwd_tc_kernel): one warpgroup (128 threads) per 64-query
// tile. Q is staged once; K and V tiles stream through a two-stage ring, the
// next tile's copies in flight while the current one computes. S = Q K^T is
// `wgmma` m64n64k16 with both operands K-major in shared memory; the fp32
// scores stay in registers (the wgmma accumulator layout: thread t of warp w
// holds rows 16 w + t / 4 and + 8, 16 columns each), the online softmax runs
// there with row reductions over the 4 lanes that share a row; P goes to
// bf16 in registers and is the register-A operand of O += P V (`wgmma`
// m64n{D}k16, V MN-major through the descriptor's transpose bit). P never
// touches shared memory. Masks are evaluated only on tiles that need them:
// the diagonal tile, tiles with a key that is padded or at or past S, and
// every tile of a block with a row that has no allowed key. The epilogue stages O / l in bf16 through the Q
// tile's shared memory for 16-byte stores.
//
// Backward: flash_bwd_dq_tc_kernel (block: a 64-query tile, loops over key
// tiles; it also computes Delta = rowsum(dO * O) of its rows, 16-byte
// loads, and writes it), then flash_bwd_dkdv_tc_kernel (block: a 64-key
// tile, loops over query tiles, reads Delta), each one warpgroup running
// `wgmma` (bf16 in, fp32 accumulate), no atomics (deterministic). The fixed
// tiles are copied once by `cp.async`; the streamed ones (K and V, or Q and
// dO) come by TMA into a two-stage ring, one thread arming a stage's
// mbarrier, the next tile's copies in flight while this one computes; all
// in the swizzled layout above. dK, dV and dQ stay in fp32 registers. P is
// recomputed from the saved log-sum-exp, and P and dS go to bf16 in
// registers as the register-A operand of the next product, as P does in
// the forward. 7
// products a tile pair, with their operands:
//   dK/dV  S^T = K Q^T    A: K, K-major      B: Q, K-major      (m64n64)
//          dP^T = V dO^T  A: V, K-major      B: dO, K-major     (m64n64)
//          dV += P^T dO   A: P^T, registers  B: dO, MN-major    (m64n{D})
//          dK += dS^T Q   A: dS^T, registers B: Q, MN-major     (m64n{D})
//   dQ     S = Q K^T      A: Q, K-major      B: K, K-major      (m64n64)
//          dP = dO V^T    A: dO, K-major     B: V, K-major      (m64n64)
//          dQ += dS K     A: dS, registers   B: K, MN-major     (m64n{D})
// At D 128 the dK/dV kernel holds S^T and dP^T (32 fp32 registers each)
// beside dK and dV (64 each) in about 240 registers; with the streamed
// tiles' copy addresses gone to TMA nothing spills.

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup / 4 warps
constexpr int kTile = 64;
constexpr int kSub = kTile * 128;  // bytes of a 64-row x 64-column sub-tile

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return (D / 64) * kSub;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0 .. D / 8 - 1) of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * kSub + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// the dynamic shared memory, rounded up to a 1024-byte boundary (the
// swizzle's period); launches ask for 1024 bytes more than they use
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// 4 bytes from src, or zeros when !ok (src is then not read)
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
constexpr float kLog2e = 1.4426950408889634f;
// 2^x (MUFU.EX2, as __expf uses it); the backward's exp(s * scale - lse) is
// 2^(s * scale * log2 e - lse * log2 e), one FFMA and one EX2
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- TMA into the swizzled tiles (the backward's streamed tiles)
//
// A tensor map over a bf16 [B, S, H, D] tensor with a box of 64 rows x 64
// columns and the 128-byte swizzle writes exactly one sub-tile of the
// layout above (chunk c of row r at c ^ (r % 8)); rows at or past S are
// zero-filled. One thread starts the copies of a stage and arms its
// mbarrier with the byte count; every thread waits on the barrier's phase.

// the descriptor into the TMA unit's cache ahead of its first use
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for phase `parity` of the barrier to complete. A copy that never
// lands traps (a launch error) after some seconds instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries > (1u << 24)) __trap();
  }
}
// rows [row0, row0 + 64) of head h of batch b into the [64, D] tile at dst:
// D / 64 boxes, one per 64-column sub-tile
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, int b, int h,
                                              int row0, uint32_t bar) {
#pragma unroll
  for (int j = 0; j < D / 64; ++j)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst + j * kSub),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(64 * j), "r"(h), "r"(row0), "r"(b), "r"(bar)
        : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes (cp.async) made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of head h of batch b of a [B, S, H, D] tensor into
// the swizzled tile at shared address dst, by cp.async; rows >= S are zeros
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ src,
                                                int b, int h, int row0, int S, int H) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int s = row0 + r;
    const bool ok = s < S;
    const bf16* g = src + ((static_cast<size_t>(b) * S + (ok ? s : 0)) * H + h) * D + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + swz(r, c)),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// pad_mask[b, j0 .. j0 + 63] into dst (keys >= S read as 0) and full[0..1]:
// whether each half of the tile holds only real keys. Threads 0-63 (warps 0
// and 1) load; the block's next barrier publishes it.
__device__ __forceinline__ void load_mask_tile(int* dst, int* full, const int* __restrict__ mask,
                                               int b, int j0, int S) {
  if (threadIdx.x < kTile) {
    const int j = j0 + threadIdx.x;
    const int m = (j < S) ? mask[static_cast<size_t>(b) * S + j] : 0;
    dst[threadIdx.x] = m;
    const bool all = __all_sync(0xffffffffu, m > 0);
    if ((threadIdx.x & 31) == 0) full[threadIdx.x >> 5] = all;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- wgmma (forward and backward)

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: between 64-wide atoms along M/N, here the next 64
// columns of the head dim, one sub-tile on; unused K-major), stride byte
// offset (between 8-row groups: along M/N for K-major, along K for MN-major)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// after the wait: the compiler may not move reads of the accumulators
// above it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define PLANGEN_WG_D32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
      "+f"(d[30]), "+f"(d[31])
#define PLANGEN_WG_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PLANGEN_WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PLANGEN_WG_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define PLANGEN_WG_D64(d) \
  PLANGEN_WG_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),             \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PLANGEN_WG_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63}"

// d[64 x N] += A[64 x 16] B[16 x N], N = 64 or 128 (the head dim); A in
// registers (the m16n8k16 A fragment of each warp's 16 rows), B MN-major in
// shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PLANGEN_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PLANGEN_WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PLANGEN_WG_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : PLANGEN_WG_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q, two stages of K and V, two stages of mask + 2 full flags
  return 5 * tile_bytes<D>() + 2 * (kTile + 2) * sizeof(int) + 1024;
}

// grid (ceil(S / 64), B * H); block 128 (one warpgroup)
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ mask,
                        bf16* __restrict__ out, float* __restrict__ lse, int S, int H,
                        float scale) {
  constexpr int kTB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  auto sK = [&](int st) { return sQ + (1 + 2 * st) * kTB; };
  auto sV = [&](int st) { return sQ + (2 + 2 * st) * kTB; };
  int* sMask = reinterpret_cast<int*>(smem + 5 * kTB);  // [2][64]
  int* sFull = sMask + 2 * kTile;                      // [2][2]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int q0 = q_tile * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int first = first_key<kThreads>(mask, b, S);
  const bool block_no_key = no_key<kCausal>(q0, first, S);
  int n_kv = (S + kTile - 1) / kTile;
  if (kCausal && !block_no_key) n_kv = min(n_kv, q_tile + 1);

  load_tile_async<D>(sQ, q, b, h, q0, S, H);
  load_tile_async<D>(sK(0), k, b, h, 0, S, H);
  load_tile_async<D>(sV(0), v, b, h, 0, S, H);
  cp_async_commit();
  load_mask_tile(sMask, sFull, mask, b, 0, S);

  float acc[D / 2];  // O, the m64n{D} accumulator (same layout as s below)
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);        // and columns c0, c0 + 1 of each 8

  for (int t = 0; t < n_kv; ++t) {
    const int st = t & 1, kv0 = t * kTile;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile t landed; every read of the other stage is done
    if (t + 1 < n_kv) {
      load_tile_async<D>(sK(st ^ 1), k, b, h, kv0 + kTile, S, H);
      load_tile_async<D>(sV(st ^ 1), v, b, h, kv0 + kTile, S, H);
      load_mask_tile(sMask + (st ^ 1) * kTile, sFull + 2 * (st ^ 1), mask, b, kv0 + kTile, S);
    }
    cp_async_commit();

    // S = Q K^T: D / 16 steps of k16, 4 per 64-column sub-tile (32 bytes each)
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSub + (kk & 3) * 32;
      wgmma_ss(s, gmma_desc(sQ + off, 16, 1024), gmma_desc(sK(st) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s[e]: row r0 + 8 * ((e >> 1) & 1), column 8 * (e >> 2) + c0 + (e & 1)
    const bool masked = block_no_key || !(sFull[2 * st] && sFull[2 * st + 1]) ||
                        (kCausal && kv0 + kTile - 1 > q0);
    float rmax[2] = {-INFINITY, -INFINITY};
    if (masked) {
      const int* m = sMask + st * kTile;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hr = (e >> 1) & 1;
        const int qi = q0 + r0 + 8 * hr;
        const int kc = 8 * (e >> 2) + c0 + (e & 1);
        const bool row_no_key = no_key<kCausal>(qi, first, S);
        const bool ok = key_ok<kCausal>(qi, kv0 + kc, row_no_key, m[kc], S);
        s[e] = ok ? (row_no_key ? 0.f : s[e] * scale) : kMaskValue;
        rmax[hr] = fmaxf(rmax[hr], s[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] *= scale;
        rmax[(e >> 1) & 1] = fmaxf(rmax[(e >> 1) & 1], s[e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = rmax[hr];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m_r[hr], mx);
      alpha[hr] = __expf(m_r[hr] - m_next);
      m_r[hr] = m_next;
    }
    // P in bf16: pf[4 kk .. 4 kk + 3] is the A fragment of keys 16 kk .. + 15
    uint32_t pf[16];
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int hr = (e >> 1) & 1;
      const float p0 = __expf(s[e] - m_r[hr]), p1 = __expf(s[e + 1] - m_r[hr]);
      rsum[hr] += p0 + p1;
      pf[e / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float x = rsum[hr];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      l_r[hr] = alpha[hr] * l_r[hr] + x;
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];

    // O += P V, m64n{D}k16: V MN-major, k16 step kk = key rows 16 kk .. + 15
    // (2048 bytes on), the second 64 columns of the head dim a sub-tile on
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, pf + 4 * kk, gmma_desc(sV(st) + kk * 2048, kSub, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  // epilogue: O / l in bf16 through the Q tile's shared memory
  __syncthreads();  // every wgmma read of the Q tile is done
  float l_inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) l_inv[hr] = (l_r[hr] == 0.f) ? 1.f : 1.f / l_r[hr];
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int hr = (e >> 1) & 1;
    const int row = r0 + 8 * hr, col = 8 * (e >> 2) + c0;
    *reinterpret_cast<uint32_t*>(smem + swz(row, col >> 3) + (col & 7) * 2) =
        pack_bf16(acc[e] * l_inv[hr], acc[e + 1] * l_inv[hr]);
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + r0 + 8 * hr;
      if (qi < S) lse[static_cast<size_t>(bh) * S + qi] = m_r[hr] + logf(l_r[hr]);  // l >= 1
    }
  }
  __syncthreads();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * S + q0 + r) * H + h) * D +
                                c * 8) = *reinterpret_cast<const uint4*>(smem + swz(r, c));
  }
}

// ---- wgmma (backward)

// Store acc[64 x D] * mul, the m64n{D} accumulator of the warpgroup (rows
// row0 + 16 warp + lane / 4 and + 8), into a [B, S, H, D] tensor; rows >= S
// are dropped
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 2],
                                           float mul, int b, int h, int row0, int S, int H) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = row0 + 16 * warp + lane / 4 + 8 * hr;
    if (s >= S) continue;
    bf16* row = dst + ((static_cast<size_t>(b) * S + s) * H + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) =
          pack_bf16(acc[4 * n + 2 * hr] * mul, acc[4 * n + 2 * hr + 1] * mul);
  }
}

// After the six tiles: dK/dV: two stages of lse and Delta, the key tile's
// mask and 2 full flags; dQ: two stages of masks, 2 x 2 full flags and the
// tile's Delta; then, at kBwdBars, the two stages' mbarriers
constexpr int kBwdBars = (4 * kTile + kTile + 4) * sizeof(int);


template <int D>
constexpr size_t bwd_smem_bytes() {
  return 6 * tile_bytes<D>() + kBwdBars + 2 * sizeof(uint64_t) + 1024;
}

// dK and dV of one key tile; grid (ceil(S / 64), B * H), block 128 (one
// warpgroup). (Two key tiles a block, one per warpgroup sharing each
// streamed query tile, halve the L2 traffic but were slower on the card:
// the two warpgroups then meet at every tile's barrier, where two blocks
// of one warpgroup each drift apart and overlap their products.)
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_dout,
                             const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const int* __restrict__ mask, const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int S, int H, float scale) {
  constexpr int kTB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + kTB;
  auto sQ = [&](int st) { return sK + (2 + 2 * st) * kTB; };
  auto sdO = [&](int st) { return sK + (3 + 2 * st) * kTB; };
  float* sLse = reinterpret_cast<float*>(smem + 6 * kTB);  // [2][64]
  float* sDelta = sLse + 2 * kTile;                        // [2][64]
  int* sMask = reinterpret_cast<int*>(sDelta + 2 * kTile);  // [64] (the key tile)
  int* sFull = sMask + kTile;                                // [2]
  const uint32_t bar0 = sK + 6 * kTB + kBwdBars;  // the stages' mbarriers: bar0 + 8 st

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_tile = blockIdx.x, kv0 = kv_tile * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int first = first_key<kThreads>(mask, b, S);
  const int n_q = (S + kTile - 1) / kTile;
  // the query tiles visited: under the causal mask those from the diagonal
  // on, and before it only those with a row that has no allowed key (rows
  // < first, which see every key): tiles [0, n_pre) then [t_diag, n_q)
  int n_pre = 0, t_diag = 0;
  if (kCausal) {
    t_diag = kv_tile;
    n_pre = min((first + kTile - 1) / kTile, kv_tile);
  }
  const int count = n_pre + n_q - t_diag;
  auto tile_of = [&](int i) { return i < n_pre ? i : t_diag + (i - n_pre); };
  // a query tile's Q and dO by TMA (one thread), its lse and Delta by
  // cp.async (rows >= S get 0: their P is 0)
  auto prefetch = [&](int i, int st) {
    const int r0 = tile_of(i) * kTile;
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar0 + 8 * st, 2 * kTB);
      tma_load_tile<D>(sQ(st), &tm_q, b, h, r0, bar0 + 8 * st);
      tma_load_tile<D>(sdO(st), &tm_dout, b, h, r0, bar0 + 8 * st);
    }
    if (threadIdx.x < kTile) {
      const int i_row = r0 + threadIdx.x;
      const size_t at = static_cast<size_t>(bh) * S + min(i_row, S - 1);
      cp_async4_zfill(smem_u32(sLse + st * kTile + threadIdx.x), lse + at, i_row < S);
      cp_async4_zfill(smem_u32(sDelta + st * kTile + threadIdx.x), delta + at, i_row < S);
    }
  };

  if (threadIdx.x == 0) {
    prefetch_map(&tm_q);
    prefetch_map(&tm_dout);
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    mbar_init_fence();
  }
  __syncthreads();  // the barriers are set up before any thread waits on them
  load_tile_async<D>(sK, k, b, h, kv0, S, H);
  load_tile_async<D>(sV, v, b, h, kv0, S, H);
  load_mask_tile(sMask, sFull, mask, b, kv0, S);
  if (count > 0) prefetch(0, 0);
  cp_async_commit();

  float acc_dk[D / 2], acc_dv[D / 2];  // m64n{D} accumulators: rows are this tile's keys
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    acc_dk[e] = 0.f;
    acc_dv[e] = 0.f;
  }
  const int kr0 = 16 * warp + lane / 4;  // this thread's keys: kr0 and kr0 + 8
  const int c0 = 2 * (lane % 4);         // its queries c0, c0 + 1 of each 8
  const float scale_log2 = scale * kLog2e;

  for (int i = 0; i < count; ++i) {
    const int st = i & 1, q0 = tile_of(i) * kTile;
    cp_async_wait_all();
    mbar_wait(bar0 + 8 * st, (i >> 1) & 1);
    fence_proxy_async();
    __syncthreads();  // tile i landed; every read of the other stage is done

    const float* l_st = sLse + st * kTile;
    const float* d_st = sDelta + st * kTile;
    // query rows at or past S need no mask here: their Q and dO rows are
    // zeros, so they add nothing to dK or dV
    const bool masked = no_key<kCausal>(q0, first, S) || !(sFull[0] && sFull[1]) ||
                        (kCausal && kv0 + kTile - 1 > q0);

    // S^T = K Q^T and dP^T = V dO^T over the head dim, m64n64k16, both
    // operands K-major in shared memory
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = 0.f;
      dp[e] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSub + (kk & 3) * 32;
      wgmma_ss(s, gmma_desc(sK + off, 16, 1024), gmma_desc(sQ(st) + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSub + (kk & 3) * 32;
      wgmma_ss(dp, gmma_desc(sV + off, 16, 1024), gmma_desc(sdO(st) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    // the next tile's copies go out while the products run
    if (i + 1 < count) prefetch(i + 1, st ^ 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // s[e]: key kr0 + 8 * ((e >> 1) & 1), query 8 * (e >> 2) + c0 + (e & 1);
    // P^T and dS^T in bf16 as the A fragments of the next products:
    // pf[4 kk .. 4 kk + 3] holds queries 16 kk .. + 15
    uint32_t pf[16], dsf[16];
    // one straight-line body per case: the mask is uniform over the tile
    auto p_and_ds = [&](auto with_mask) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int kr = kr0 + 8 * ((e >> 1) & 1);
        float p[2], ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int qc = 8 * (e >> 2) + c0 + x;
          const float l2 = l_st[qc] * kLog2e;
          if constexpr (decltype(with_mask)::value) {
            const int qi = q0 + qc;
            const bool row_no_key = no_key<kCausal>(qi, first, S);
            const bool ok = qi < S && key_ok<kCausal>(qi, kv0 + kr, row_no_key, sMask[kr], S);
            p[x] = ok ? exp2_approx((row_no_key ? 0.f : s[e + x] * scale_log2) - l2) : 0.f;
          } else {
            p[x] = exp2_approx(fmaf(s[e + x], scale_log2, -l2));
          }
          ds[x] = p[x] * (dp[e + x] - d_st[qc]);
        }
        pf[e / 2] = pack_bf16(p[0], p[1]);
        dsf[e / 2] = pack_bf16(ds[0], ds[1]);
      }
    };
    if (masked)
      p_and_ds(std::true_type{});
    else
      p_and_ds(std::false_type{});

    // dV += P^T dO and dK += dS^T Q, m64n{D}k16: dO and Q MN-major through
    // the transpose bit, k16 step kk = query rows 16 kk .. + 15
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(acc_dv, pf + 4 * kk, gmma_desc(sdO(st) + kk * 2048, kSub, 1024));
      wgmma_rs<D>(acc_dk, dsf + 4 * kk, gmma_desc(sQ(st) + kk * 2048, kSub, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
  }
  store_rows<D>(dk, acc_dk, scale, b, h, kv0, S, H);
  store_rows<D>(dv, acc_dv, 1.f, b, h, kv0, S, H);
}

// Delta = rowsum(dO * O) in fp32 of the 64 rows of two staged tiles (rows
// past S are zeros), two threads a row with 16-byte shared-memory loads;
// both threads of the pair get the row's value
template <int D>
__device__ __forceinline__ float tile_delta(const unsigned char* o, const unsigned char* dout) {
  const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
  float sum = 0.f;
#pragma unroll
  for (int cc = 0; cc < D / 16; ++cc) {
    const int c = part * (D / 16) + cc;
    const uint4 a = *reinterpret_cast<const uint4*>(o + swz(r, c));
    const uint4 g = *reinterpret_cast<const uint4*>(dout + swz(r, c));
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 af = __bfloat1622float2(a2[i]), gf = __bfloat1622float2(g2[i]);
      sum = fmaf(af.x, gf.x, sum);
      sum = fmaf(af.y, gf.y, sum);
    }
  }
  return sum + __shfl_xor_sync(0xffffffffu, sum, 1);
}

// dQ of one query tile, and Delta of its rows (written for the dK/dV kernel,
// which runs after it); grid (ceil(S / 64), B * H), block 128 (one warpgroup)
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const bf16* __restrict__ q, const int* __restrict__ mask,
                           const bf16* __restrict__ out, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, float* __restrict__ delta,
                           bf16* __restrict__ dq, int S, int H, float scale) {
  constexpr int kTB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem), sdO = sQ + kTB;
  auto sK = [&](int st) { return sQ + (2 + 2 * st) * kTB; };
  auto sV = [&](int st) { return sQ + (3 + 2 * st) * kTB; };
  int* sMask = reinterpret_cast<int*>(smem + 6 * kTB);  // [2][64]
  int* sFull = sMask + 2 * kTile;                      // [2][2]
  float* sDelta = reinterpret_cast<float*>(sFull + 4);  // [64] this tile's rows
  const uint32_t bar0 = sQ + 6 * kTB + kBwdBars;  // the stages' mbarriers: bar0 + 8 st

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int q0 = q_tile * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int first = first_key<kThreads>(mask, b, S);
  const bool block_no_key = no_key<kCausal>(q0, first, S);
  int n_kv = (S + kTile - 1) / kTile;
  if (kCausal && !block_no_key) n_kv = min(n_kv, q_tile + 1);
  // a key tile's K and V by TMA (one thread)
  auto prefetch = [&](int t, int st) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar0 + 8 * st, 2 * kTB);
      tma_load_tile<D>(sK(st), &tm_k, b, h, t * kTile, bar0 + 8 * st);
      tma_load_tile<D>(sV(st), &tm_v, b, h, t * kTile, bar0 + 8 * st);
    }
  };

  if (threadIdx.x == 0) {
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    mbar_init_fence();
  }
  __syncthreads();  // the barriers are set up before any thread waits on them
  load_tile_async<D>(sQ, q, b, h, q0, S, H);
  load_tile_async<D>(sdO, dout, b, h, q0, S, H);
  load_tile_async<D>(sK(1), out, b, h, q0, S, H);  // O, in stage 1 until tile 1 comes
  cp_async_commit();
  prefetch(0, 0);
  load_mask_tile(sMask, sFull, mask, b, 0, S);
  cp_async_wait_all();
  __syncthreads();  // dO and O are in shared memory
  {
    const float d = tile_delta<D>(smem + 4 * kTB, smem + kTB);  // O at sK(1), dO
    const int r = threadIdx.x >> 1;
    if ((threadIdx.x & 1) == 0) {
      sDelta[r] = d;
      if (q0 + r < S) delta[static_cast<size_t>(bh) * S + q0 + r] = d;
    }
  }
  fence_proxy_async();  // the reads of O come before tile 1's TMA writes there
  __syncthreads();      // sDelta is complete

  const int qr0 = 16 * warp + lane / 4;  // this thread's queries: qr0 and qr0 + 8
  const int c0 = 2 * (lane % 4);         // its keys c0, c0 + 1 of each 8
  const float scale_log2 = scale * kLog2e;
  float row_lse2[2], row_delta[2];  // lse in base 2
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + qr0 + 8 * hr;
    row_lse2[hr] = (qi < S) ? lse[static_cast<size_t>(bh) * S + qi] * kLog2e : 0.f;
    row_delta[hr] = sDelta[qr0 + 8 * hr];
  }
  float acc[D / 2];  // dQ, the m64n{D} accumulator
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int st = t & 1, kv0 = t * kTile;
    cp_async_wait_all();
    mbar_wait(bar0 + 8 * st, (t >> 1) & 1);
    fence_proxy_async();
    __syncthreads();  // tile t landed; every read of the other stage is done

    // S = Q K^T and dP = dO V^T, m64n64k16, both operands K-major
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = 0.f;
      dp[e] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSub + (kk & 3) * 32;
      wgmma_ss(s, gmma_desc(sQ + off, 16, 1024), gmma_desc(sK(st) + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSub + (kk & 3) * 32;
      wgmma_ss(dp, gmma_desc(sdO + off, 16, 1024), gmma_desc(sV(st) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    // the next tile's copies go out while the products run
    if (t + 1 < n_kv) {
      prefetch(t + 1, st ^ 1);
      load_mask_tile(sMask + (st ^ 1) * kTile, sFull + 2 * (st ^ 1), mask, b, kv0 + kTile, S);
    }
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // s[e]: query qr0 + 8 * ((e >> 1) & 1), key 8 * (e >> 2) + c0 + (e & 1);
    // dS in bf16 as the A fragments of dQ += dS K
    const int* m = sMask + st * kTile;
    const bool masked = block_no_key || !(sFull[2 * st] && sFull[2 * st + 1]) ||
                        (kCausal && kv0 + kTile - 1 > q0);
    uint32_t dsf[16];
    // one straight-line body per case: the mask is uniform over the tile
    auto ds_of = [&](auto with_mask) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hr = (e >> 1) & 1;
        float ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int kc = 8 * (e >> 2) + c0 + x;
          float p;
          if constexpr (decltype(with_mask)::value) {
            const int qi = q0 + qr0 + 8 * hr;
            const bool row_no_key = no_key<kCausal>(qi, first, S);
            const bool ok = key_ok<kCausal>(qi, kv0 + kc, row_no_key, m[kc], S);
            p = ok ? exp2_approx((row_no_key ? 0.f : s[e + x] * scale_log2) - row_lse2[hr])
                   : 0.f;
          } else {
            p = exp2_approx(fmaf(s[e + x], scale_log2, -row_lse2[hr]));
          }
          ds[x] = p * (dp[e + x] - row_delta[hr]);
        }
        dsf[e / 2] = pack_bf16(ds[0], ds[1]);
      }
    };
    if (masked)
      ds_of(std::true_type{});
    else
      ds_of(std::false_type{});

    // dQ += dS K, m64n{D}k16: K MN-major through the transpose bit
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, dsf + 4 * kk, gmma_desc(sK(st) + kk * 2048, kSub, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  store_rows<D>(dq, acc, scale, b, h, q0, S, H);
}

// The TMA descriptor of a bf16 [B, S, H, D] tensor for tma_load_tile: dims
// innermost first (D, H, S, B), a box of 64 columns x 1 head x 64 rows x 1
// batch, the 128-byte swizzle, zeros past the edge. cuTensorMapEncodeTiled
// is looked up at run time by cudaGetDriverEntryPoint (no -lcuda).
CUresult tile_map(CUtensorMap* map, const void* base, int B, int S, int H, int D) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};  // bytes, dims 1-3
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D, bool kCausal>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* mask, void* out,
                       float* lse, int B, int S, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  static const cudaError_t attr = allow_smem(flash_fwd_tc_kernel<D, kCausal>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_fwd_tc_kernel<D, kCausal><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, static_cast<bf16*>(out), lse, S, H, scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const int* mask,
                       const void* out, const void* dout, const float* lse, float* delta,
                       void* dq, void* dk, void* dv, int B, int S, int H, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D>();
  static const cudaError_t attr_kv = allow_smem(flash_bwd_dkdv_tc_kernel<D, kCausal>, smem);
  static const cudaError_t attr_q = allow_smem(flash_bwd_dq_tc_kernel<D, kCausal>, smem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const void* streamed[4] = {q, k, v, dout};
  CUtensorMap maps[4];  // q, k, v, dout
  for (int j = 0; j < 4; ++j)
    if (tile_map(&maps[j], streamed[j], B, S, H, D) != CUDA_SUCCESS) return cudaErrorInvalidValue;
  // dQ first: it writes the Delta that the dK/dV kernel reads
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_bwd_dq_tc_kernel<D, kCausal><<<grid, kThreads, smem, stream>>>(
      maps[1], maps[2], tq, mask, static_cast<const bf16*>(out), tdo, lse, delta,
      static_cast<bf16*>(dq), S, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc_kernel<D, kCausal><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[3], tk, tv, mask, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, scale);
  return cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); D: 64 or 128
// (checked by the wrapper)
#define PLANGEN_DISPATCH(FN, ...)                                                  \
  do {                                                                             \
    if (dtype == 0 && D == 64)                                                     \
      return causal ? FN<64, true>(__VA_ARGS__) : FN<64, false>(__VA_ARGS__);       \
    if (dtype == 0 && D == 128)                                                    \
      return causal ? FN<128, true>(__VA_ARGS__) : FN<128, false>(__VA_ARGS__);     \
    if (dtype == 1 && D == 64)                                                     \
      return causal ? tc::FN<64, true>(__VA_ARGS__) : tc::FN<64, false>(__VA_ARGS__); \
    if (dtype == 1 && D == 128)                                                    \
      return causal ? tc::FN<128, true>(__VA_ARGS__) : tc::FN<128, false>(__VA_ARGS__); \
    return cudaErrorInvalidValue;                                                  \
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
