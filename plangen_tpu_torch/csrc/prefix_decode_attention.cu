// Prefix decode attention for Hopper (sm_90a): one decode query per batch row
// against layer `layer` of the stacked KV cache, reading only the live prefix.
//
// Replaces the TPU kernels plangen_tpu/ops/pallas_decode_attention.py::_kernel
// (wrapper prefix_decode_attention) and its row-batched variant
// plangen_tpu/ops/pallas_decode_attention_v3.py::_kernel: both compute this
// function, and the v3 variant's batching of DMAs over four rows is a TPU
// trick with no counterpart here.
//
// What it computes, exactly as the TPU kernel does:
//   q is scaled by D^-0.5 in fp32; the slots [0, q_pos] are scored, a slot
//   counts when pad_mask[b, slot] > 0 (others get the finite -1e30); an fp32
//   online softmax runs over 128-slot chunks; each chunk's probabilities are
//   rounded to the cache dtype before the PV product (fp32 accumulation); the
//   output is acc / max(l, 1e-30) in the query dtype.
//
// What bounds it: HBM bytes. Each call reads 2 * B * (q_pos + 1) * H * D *
// sizeof(dtype) bytes of cache (K and V of one layer up to the live
// position) and does 4 flops per element read, far below the card's ~295
// flops/byte balance point.
//
// Design: one thread block per (row, head), 128 threads, a loop over the
// live 128-slot chunks; the slots after q_pos are never read. In each chunk,
// warp w scores slots w*32..w*32+31: the warp reads one K row at a time with
// neighbouring lanes on neighbouring addresses and reduces the dot product
// with shuffles, and lane j keeps the score of slot j, so thread t holds
// slot t's score. Block reductions give the chunk max and sum; the PV
// product gives each thread one output dimension (two slot groups per
// dimension when D = 64). No atomics: the result is deterministic.
// q_pos is read from device memory so that a decode step captured in a CUDA
// graph can advance it without rebuilding the launch.
//
// Left for later work: split-KV across SMs (B * H = 128 blocks leave the card
// under-filled at batch 8), cp.async/TMA staging of the chunks, and tuning for
// B = 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;  // slots per chunk == threads per block
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;

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

// N consecutive elements loaded as one vector access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide reductions; `red` is kWarps floats of shared scratch.
__device__ __forceinline__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_max(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    prefix_decode_attention_kernel(const T* __restrict__ q,  // [B, H, D]
                                   const T* __restrict__ k,  // [L, B, S, H, D]
                                   const T* __restrict__ v,  // [L, B, S, H, D]
                                   const int* __restrict__ mask,   // [B, S]
                                   const int* __restrict__ q_pos,  // [1]
                                   T* __restrict__ out,            // [B, H, D]
                                   int B, int S, int H, int layer,
                                   float scale) {
  static_assert(D % 32 == 0 && kThreads % D == 0, "unsupported head dim");
  constexpr int kPerLane = D / 32;       // elements of a K row per lane
  constexpr int kGroups = kThreads / D;  // PV: slot groups per output dim

  __shared__ float p_sh[kChunk];
  __shared__ float red[kWarps];
  __shared__ float acc_sh[kThreads];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = tid % D;
  const int g = tid / D;

  const int last = min(*q_pos, S - 1);  // the last live slot
  const int n_chunks = last >= 0 ? last / kChunk + 1 : 0;

  const size_t slot_stride = (size_t)H * D;
  const size_t base = (((size_t)layer * B + b) * S * H + h) * D;
  const T* kb = k + base;
  const T* vb = v + base;
  const int* mb = mask + (size_t)b * S;

  // this lane's slice of the scaled query, in fp32
  float qr[kPerLane];
  {
    const Vec<T, kPerLane> qv = *reinterpret_cast<const Vec<T, kPerLane>*>(
        q + ((size_t)b * H + h) * D + lane * kPerLane);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) qr[e] = to_float(qv.v[e]) * scale;
  }

  float m_run = -INFINITY;  // running max (uniform over the block)
  float l_run = 0.f;        // running sum of unrounded probabilities
  float acc = 0.f;          // output dim d over slot group g

  for (int c = 0; c < n_chunks; ++c) {
    const int start = c * kChunk;

    // scores: warp w handles slots start + w*32 + j; lane j keeps slot j's
    float score = 0.f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int t = start + warp * 32 + j;
      float dot = 0.f;
      if (t <= last) {  // uniform over the warp
        const Vec<T, kPerLane> kv = *reinterpret_cast<const Vec<T, kPerLane>*>(
            kb + (size_t)t * slot_stride + lane * kPerLane);
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) dot += qr[e] * to_float(kv.v[e]);
      }
      dot = warp_sum(dot);
      if (lane == j) score = dot;
    }

    const int t = start + tid;
    const bool ok = t <= last && mb[t] > 0;
    const float s = ok ? score : kMasked;

    const float m_new = fmaxf(m_run, block_max(s, red));
    const float alpha = expf(m_run - m_new);  // 0 on the first chunk
    const float p = expf(s - m_new);
    l_run = l_run * alpha + block_sum(p, red);
    m_run = m_new;
    p_sh[tid] = to_float(from_float<T>(p));  // rounded like p.astype(v.dtype)
    __syncthreads();

    const int n_live = min(kChunk, last - start + 1);
    float pv = 0.f;
#pragma unroll 8
    for (int i = g; i < n_live; i += kGroups)
      pv += p_sh[i] * to_float(vb[(size_t)(start + i) * slot_stride + d]);
    acc = acc * alpha + pv;
    __syncthreads();  // p_sh is rewritten by the next chunk
  }

  if (kGroups > 1) {
    acc_sh[tid] = acc;
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int gg = 1; gg < kGroups; ++gg) acc += acc_sh[gg * D + d];
    }
  }
  if (g == 0)
    out[((size_t)b * H + h) * D + d] = from_float<T>(acc / fmaxf(l_run, 1e-30f));
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* mask,
            const int* q_pos, void* out, int B, int S, int H, int layer,
            float scale, cudaStream_t stream) {
  prefix_decode_attention_kernel<T, D><<<B * H, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, q_pos, static_cast<T*>(out), B, S, H,
      layer, scale);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is device memory;
// the arrays are contiguous: q/out [B, H, D], k/v [L, B, S, H, D], mask
// [B, S] int32, q_pos one int32. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int plangen_prefix_decode_attention(const void* q, const void* k,
                                               const void* v, const int* mask,
                                               const int* q_pos, void* out,
                                               int B, int S, int H, int D,
                                               int layer, float scale,
                                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    launch<__nv_bfloat16, 128>(q, k, v, mask, q_pos, out, B, S, H, layer, scale, st);
  else if (dtype == 1 && D == 64)
    launch<__nv_bfloat16, 64>(q, k, v, mask, q_pos, out, B, S, H, layer, scale, st);
  else if (dtype == 0 && D == 128)
    launch<float, 128>(q, k, v, mask, q_pos, out, B, S, H, layer, scale, st);
  else if (dtype == 0 && D == 64)
    launch<float, 64>(q, k, v, mask, q_pos, out, B, S, H, layer, scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
