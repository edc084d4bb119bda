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
// The int8 cache (K1-q8): the same kernel reads k/v int8 [L, B, S, H, D] with
// fp32 scales k_scale/v_scale [L, B, S, H] (one per slot and head). It is
// the port's counterpart of the XLA paths the JAX package takes over that
// cache (plangen_tpu/ops/attention.py::segmented_decode_attention with int8
// segments and ::dot_product_attention_q8), in their order: q is NOT
// pre-scaled; logit = (q . k_q8) * k_scale * D^-0.5; each chunk's
// probabilities are multiplied by v_scale and rounded to the query dtype
// before the PV product with v_q8 in fp32. A slot then costs 2 * D + 8 bytes
// against 4 * D in bf16, so a call reads about half of K1's bytes.
//
// Left for later work: split-KV across SMs (B * H = 128 blocks leave the card
// under-filled at batch 8), cp.async/TMA staging of the chunks, and tuning for
// B = 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;  // slots per chunk == threads per block
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// int8 -> float without I2F (a quarter-rate conversion): the byte, offset
// to unsigned, becomes the low mantissa bits of 2^23, and one exact FADD
// removes 2^23 + 128. `word` holds 4 bytes; `i` picks one.
__device__ __forceinline__ float s8_to_float(uint32_t word, int i) {
  const uint32_t u = __byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7540 + i);
  return __int_as_float(u) - 8388736.f;
}
__device__ __forceinline__ float to_float(int8_t x) {
  return s8_to_float((uint32_t)(uint8_t)x, 0);
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

// T: query / output dtype; C: cache dtype, T itself or int8_t (K1-q8, which
// also reads the per-slot scales k_scale / v_scale [L, B, S, H]).
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kThreads)
    prefix_decode_attention_kernel(const T* __restrict__ q,  // [B, H, D]
                                   const C* __restrict__ k,  // [L, B, S, H, D]
                                   const C* __restrict__ v,  // [L, B, S, H, D]
                                   const float* __restrict__ k_scale,  // q8
                                   const float* __restrict__ v_scale,  // q8
                                   const int* __restrict__ mask,   // [B, S]
                                   const int* __restrict__ q_pos,  // [1]
                                   T* __restrict__ out,            // [B, H, D]
                                   int B, int S, int H, int layer,
                                   float scale) {
  static_assert(D % 32 == 0 && kThreads % D == 0, "unsupported head dim");
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
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
  const C* kb = k + base;
  const C* vb = v + base;
  const int* mb = mask + (size_t)b * S;
  // q8 scales: slot t of this (layer, row, head) sits at sb + t * H
  const size_t sb = ((size_t)layer * B + b) * S * H + h;

  // this lane's slice of the query in fp32; the dense cache pre-scales it
  // (the TPU kernel's order), the int8 cache scales the logit instead
  float qr[kPerLane];
  {
    const Vec<T, kPerLane> qv = *reinterpret_cast<const Vec<T, kPerLane>*>(
        q + ((size_t)b * H + h) * D + lane * kPerLane);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      qr[e] = kQ8 ? to_float(qv.v[e]) : to_float(qv.v[e]) * scale;
  }

  float m_run = -INFINITY;  // running max (uniform over the block)
  float l_run = 0.f;        // running sum of unrounded probabilities
  float acc = 0.f;          // output dim d over slot group g

  for (int c = 0; c < n_chunks; ++c) {
    const int start = c * kChunk;
    const int t = start + tid;  // this thread's slot; t < S always

    // the int8 cache's scales of slot t, loaded before the score loop so
    // their latency hides behind it
    float ks = 0.f, vs = 0.f;
    if (kQ8) {
      ks = k_scale[sb + (size_t)t * H];
      vs = v_scale[sb + (size_t)t * H];
    }

    // scores: warp w handles slots start + w*32 + j; lane j keeps slot j's
    float score = 0.f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int tj = start + warp * 32 + j;
      float dot = 0.f;
      if (tj <= last) {  // uniform over the warp
        const C* row = kb + (size_t)tj * slot_stride + lane * kPerLane;
        if constexpr (kQ8 && kPerLane == 4) {  // 4 int8 as one 32-bit word
          const uint32_t w4 = *reinterpret_cast<const uint32_t*>(row);
#pragma unroll
          for (int e = 0; e < 4; ++e) dot += qr[e] * s8_to_float(w4, e);
        } else {
          const Vec<C, kPerLane> kv = *reinterpret_cast<const Vec<C, kPerLane>*>(row);
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) dot += qr[e] * to_float(kv.v[e]);
        }
      }
      dot = warp_sum(dot);
      if (lane == j) score = dot;
    }

    const bool ok = t <= last && mb[t] > 0;
    if (kQ8) score = score * ks * scale;
    const float s = ok ? score : kMasked;

    const float m_new = fmaxf(m_run, block_max(s, red));
    const float alpha = expf(m_run - m_new);  // 0 on the first chunk
    const float p = expf(s - m_new);
    l_run = l_run * alpha + block_sum(p, red);
    m_run = m_new;
    if (kQ8) {
      // p * v_scale rounded like (p * v_scale).astype(q.dtype); p is 0 at
      // the dead slots after `last`
      p_sh[tid] = to_float(from_float<T>(p * vs));
    } else {
      p_sh[tid] = to_float(from_float<T>(p));  // rounded like p.astype(v.dtype)
    }
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

template <typename T, typename C, int D>
void launch(const void* q, const void* k, const void* v, const float* k_scale,
            const float* v_scale, const int* mask, const int* q_pos, void* out,
            int B, int S, int H, int layer, float scale, cudaStream_t stream) {
  prefix_decode_attention_kernel<T, C, D><<<B * H, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), k_scale, v_scale, mask, q_pos,
      static_cast<T*>(out), B, S, H, layer, scale);
}

// cache dtype C = T (dense) or int8_t (K1-q8); T by `dtype`, D by `D`
template <bool kQ8>
int dispatch(const void* q, const void* k, const void* v, const float* k_scale,
             const float* v_scale, const int* mask, const int* q_pos, void* out,
             int B, int S, int H, int D, int layer, float scale, int dtype,
             void* stream) {
  using Bf = __nv_bfloat16;
  using CBf = typename std::conditional<kQ8, int8_t, Bf>::type;
  using CF = typename std::conditional<kQ8, int8_t, float>::type;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    launch<Bf, CBf, 128>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H, layer, scale, st);
  else if (dtype == 1 && D == 64)
    launch<Bf, CBf, 64>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H, layer, scale, st);
  else if (dtype == 0 && D == 128)
    launch<float, CF, 128>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H, layer, scale, st);
  else if (dtype == 0 && D == 64)
    launch<float, CF, 64>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H, layer, scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is device memory;
// the arrays are contiguous: q/out [B, H, D], k/v [L, B, S, H, D], mask
// [B, S] int32, q_pos one int32. dtype (of q, out and the dense cache):
// 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int plangen_prefix_decode_attention(const void* q, const void* k,
                                               const void* v, const int* mask,
                                               const int* q_pos, void* out,
                                               int B, int S, int H, int D,
                                               int layer, float scale,
                                               int dtype, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, mask, q_pos, out, B, S, H,
                         D, layer, scale, dtype, stream);
}

// K1-q8: k/v int8 [L, B, S, H, D], k_scale/v_scale fp32 [L, B, S, H].
extern "C" int plangen_prefix_decode_attention_q8(
    const void* q, const void* k, const float* k_scale, const void* v,
    const float* v_scale, const int* mask, const int* q_pos, void* out, int B,
    int S, int H, int D, int layer, float scale, int dtype, void* stream) {
  return dispatch<true>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H,
                        D, layer, scale, dtype, stream);
}
