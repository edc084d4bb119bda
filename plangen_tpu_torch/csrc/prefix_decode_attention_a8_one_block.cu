// K1-a8's earlier design, one block per (row, head), kept beside the split
// design of prefix_decode_attention_a8.cu as the yardstick chip_smoke.py
// times it against (phase 16, in turns). No path of the port launches it;
// it computes the same function, with the same scale rule.
//
// Design: one block of 256 threads per (row, head), grid B * H, q_pos read
// from device memory. Four passes over shared memory:
//   1. D/16 threads a slot, each one 16-byte chunk of the K row: four
//      __dp4a against its chunk of q8, a shuffle sum over the slot's threads;
//      the logits go to shared memory (S floats); a thread loads its next
//      kUnroll slots' rows before it uses any, to keep bytes in flight.
//   2. the block max; exp(logit - max) in place; the block sum.
//   3. p * v_scale in place; the block max of it (all >= 0); the codes into
//      shared memory (S bytes), and into `codes` when the caller asks.
//   4. PV: each thread owns a 16-byte chunk of D and a slot group, loads its
//      next kUnroll V rows together as 16-byte vectors, skipping the slots
//      whose code is 0; the groups' s32 sums are added in group order.
// A block is the only one on its SM (128 blocks at the image call), so the
// rows in flight set its rate, and it streams its (row, head) alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;
constexpr int kMaxDynamicSmem = 232448;  // 227 KB, the opt-in limit of a block
constexpr int kUnroll = 8;  // K or V rows a thread has in flight

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// signed byte i of a 4-byte word
__device__ __forceinline__ int sbyte(uint32_t word, int i) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * i)) & 0xFFu));
}

constexpr float kInv127 = 1.f / 127.f;  // fl(1/127): a scale is absmax * this

// clip(rint(x / s), -127, 127): a true division, rounded half to even
__device__ __forceinline__ int quantize(float x, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(x, s))));
}

// Block-wide reductions over kThreads; `red` is kWarps floats of shared
// scratch. The warps' values are combined in warp order.
__device__ __forceinline__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
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
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = __fadd_rn(r, red[w]);
  __syncthreads();
  return r;
}

// Dynamic shared memory of one instantiation for a cache of S slots, in
// bytes: the PV partials, the logits (then probabilities), the codes, the
// quantized query and the reduction scratch.
template <int D>
struct Layout {
  static constexpr int kTps = D / 16;               // threads a slot (pass 1)
  static constexpr int kSlotsPass = kThreads / kTps;  // slots a pass of the block
  static constexpr int kGroups = kThreads / kTps;     // PV slot groups
  static constexpr int kAcc = 0;                      // s32 [kGroups][D]
  static constexpr int kQ8 = kAcc + kGroups * D * 4;  // int8 [D]
  static constexpr int kRed = kQ8 + D;                // float [kWarps]
  static constexpr int kLogits = kRed + kWarps * 4;   // float [S]
  static_assert(kThreads % kTps == 0 && kLogits % 16 == 0, "unsupported head dim");
  static __host__ __device__ constexpr int codes_at(int S) { return kLogits + 4 * S; }
  static __host__ __device__ constexpr int bytes(int S) { return codes_at(S) + S; }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    a8_decode_kernel(const T* __restrict__ q,             // [B, H, D]
                     const int8_t* __restrict__ k,        // [L, B, S, H, D]
                     const float* __restrict__ k_scale,   // [L, B, S, H]
                     const int8_t* __restrict__ v,        // [L, B, S, H, D]
                     const float* __restrict__ v_scale,   // [L, B, S, H]
                     const int* __restrict__ mask,        // [B, S]
                     const int* __restrict__ q_pos,       // [1]
                     T* __restrict__ out,                 // [B, H, D]
                     int8_t* __restrict__ codes,          // [B, H, S] or null
                     int B, int S, int H, int layer, float scale) {
  using Lay = Layout<D>;
  constexpr int kTps = Lay::kTps;
  extern __shared__ __align__(16) unsigned char smem[];
  int* acc_sh = reinterpret_cast<int*>(smem + Lay::kAcc);
  int8_t* q8_sh = reinterpret_cast<int8_t*>(smem + Lay::kQ8);
  float* red = reinterpret_cast<float*>(smem + Lay::kRed);
  float* s_sh = reinterpret_cast<float*>(smem + Lay::kLogits);
  int8_t* p8_sh = reinterpret_cast<int8_t*>(smem + Lay::codes_at(S));

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int n = min(*q_pos, S - 1) + 1;  // live slots [0, n)
  int8_t* codes_bh = codes ? codes + static_cast<size_t>(bh) * S : nullptr;
  if (n <= 0) {  // no live slot: zeros, as the plain version gives
    for (int d = tid; d < D; d += kThreads) out[static_cast<size_t>(bh) * D + d] = from_float<T>(0.f);
    if (codes_bh)
      for (int t = tid; t < S; t += kThreads) codes_bh[t] = 0;
    return;
  }
  const size_t row0 = (static_cast<size_t>(layer) * B + b) * S;  // slot 0 of (layer, b)
  const size_t slot_stride = static_cast<size_t>(H) * D;
  const int8_t* kb = k + row0 * slot_stride + static_cast<size_t>(h) * D;
  const int8_t* vb = v + row0 * slot_stride + static_cast<size_t>(h) * D;
  const float* ksb = k_scale + row0 * H + h;
  const float* vsb = v_scale + row0 * H + h;
  const int* mb = mask + static_cast<size_t>(b) * S;

  // the query, quantized per (row, head) over D
  const float x = tid < D ? to_float(q[static_cast<size_t>(bh) * D + tid]) : 0.f;
  const float q_amax = block_max(fabsf(x), red);
  const float q_s = q_amax > 0.f ? __fmul_rn(q_amax, kInv127) : 1.f;
  if (tid < D) q8_sh[tid] = static_cast<int8_t>(quantize(x, q_s));
  __syncthreads();

  // 1. logits: kTps threads a slot, one 16-byte chunk of the row each
  const int chunk = tid % kTps, sub = tid / kTps;
  const int4 qw = reinterpret_cast<const int4*>(q8_sh)[chunk];
  float m_loc = -INFINITY;
  for (int base = 0; base < n; base += kUnroll * Lay::kSlotsPass) {  // uniform bound
    int4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * Lay::kSlotsPass + sub;
      w[u] = t < n ? __ldg(reinterpret_cast<const int4*>(kb + t * slot_stride) + chunk)
                   : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * Lay::kSlotsPass + sub;
      int dot = __dp4a(w[u].x, qw.x, 0);
      dot = __dp4a(w[u].y, qw.y, dot);
      dot = __dp4a(w[u].z, qw.z, dot);
      dot = __dp4a(w[u].w, qw.w, dot);
#pragma unroll
      for (int o = 1; o < kTps; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (chunk == 0 && t < n) {
        const float logit = __fmul_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(dot), q_s), __ldg(ksb + t * H)), scale);
        const float s = __ldg(mb + t) > 0 ? logit : kMasked;
        s_sh[t] = s;
        m_loc = fmaxf(m_loc, s);
      }
    }
  }
  const float m = block_max(m_loc, red);  // finite: a slot is live

  // 2. exp(logit - max) in place, and its sum
  float l_loc = 0.f;
  for (int t = tid; t < n; t += kThreads) {
    const float e = expf(s_sh[t] - m);
    s_sh[t] = e;
    l_loc = __fadd_rn(l_loc, e);
  }
  const float l = block_sum(l_loc, red);  // >= 1: the max slot gives exp(0)

  // 3. p * v_scale in place, its absmax, the codes
  float a_loc = 0.f;
  for (int t = tid; t < n; t += kThreads) {
    const float pv = __fmul_rn(__fdiv_rn(s_sh[t], l), __ldg(vsb + t * H));
    s_sh[t] = pv;
    a_loc = fmaxf(a_loc, pv);
  }
  const float p_amax = block_max(a_loc, red);
  const float p_s = p_amax > 0.f ? __fmul_rn(p_amax, kInv127) : 1.f;
  for (int t = tid; t < S; t += kThreads) {
    const int8_t c = t < n ? static_cast<int8_t>(quantize(s_sh[t], p_s)) : 0;
    if (t < n) p8_sh[t] = c;
    if (codes_bh) codes_bh[t] = c;
  }
  __syncthreads();

  // 4. PV in s32: this thread's 16 bytes of D over its slot group, kUnroll
  // slots at a time, their V rows loaded together and only where the code
  // is not 0
  int acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0;
  for (int base = sub; base < n; base += kUnroll * Lay::kGroups) {
    int c[kUnroll];
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * Lay::kGroups;
      c[u] = t < n ? p8_sh[t] : 0;
      w[u] = c[u] != 0 ? __ldg(reinterpret_cast<const uint4*>(vb + t * slot_stride) + chunk)
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t words[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] += c[u] * sbyte(words[e / 4], e % 4);
    }
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) acc_sh[sub * D + chunk * 16 + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    int sum = 0;
    for (int g = 0; g < Lay::kGroups; ++g) sum += acc_sh[g * D + d];
    out[static_cast<size_t>(bh) * D + d] = from_float<T>(__fmul_rn(__int2float_rn(sum), p_s));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const float* k_scale, const void* v,
                   const float* v_scale, const int* mask, const int* q_pos, void* out,
                   void* codes, int B, int S, int H, int layer, float scale,
                   cudaStream_t stream) {
  using Lay = Layout<D>;
  auto kernel = a8_decode_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<B * H, kThreads, Lay::bytes(S), stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k), k_scale,
      static_cast<const int8_t*>(v), v_scale, mask, q_pos, static_cast<T*>(out),
      static_cast<int8_t*>(codes), B, S, H, layer, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is device memory,
// 16-byte aligned, the arrays contiguous: q/out [B, H, D] (dtype 0 = float32,
// 1 = bfloat16), k/v int8 [L, B, S, H, D], k_scale/v_scale fp32 [L, B, S, H],
// mask [B, S] int32, q_pos one int32, codes int8 [B, H, S] or null (the
// probability codes, 0 past q_pos). Returns the CUDA error of the launch.
extern "C" int plangen_prefix_decode_attention_a8_one_block(
    const void* q, const void* k, const float* k_scale, const void* v,
    const float* v_scale, const int* mask, const int* q_pos, void* out, void* codes,
    int B, int S, int H, int D, int layer, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % 128 ||
      (D == 128 ? Layout<128>::bytes(S) : Layout<64>::bytes(S)) > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Bf = __nv_bfloat16;
  cudaError_t err;
  if (dtype == 1 && D == 128)
    err = launch<Bf, 128>(q, k, k_scale, v, v_scale, mask, q_pos, out, codes, B, S, H, layer,
                          scale, st);
  else if (dtype == 1 && D == 64)
    err = launch<Bf, 64>(q, k, k_scale, v, v_scale, mask, q_pos, out, codes, B, S, H, layer,
                         scale, st);
  else if (dtype == 0 && D == 128)
    err = launch<float, 128>(q, k, k_scale, v, v_scale, mask, q_pos, out, codes, B, S, H,
                             layer, scale, st);
  else if (dtype == 0 && D == 64)
    err = launch<float, 64>(q, k, k_scale, v, v_scale, mask, q_pos, out, codes, B, S, H, layer,
                            scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
