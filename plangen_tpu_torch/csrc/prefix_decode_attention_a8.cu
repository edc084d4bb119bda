// K1-a8: s8 x s8 decode attention over the int8 KV cache for Hopper (sm_90a),
// split over the KV slots: one decode query per batch row against layer
// `layer` of the stacked int8 cache, reading only the live prefix, with both
// products in integers.
//
// Replaces no Pallas kernel. It is the port's counterpart of the JAX
// package's `kv_a8` decode step, which XLA computes from einsums:
// plangen_tpu/ops/attention.py::dot_product_attention_q8(a8=True) over the
// fixed cache, and ::segmented_decode_attention(a8=True) over the growing one
// (plangen_tpu/models/llama.py takes it at decode steps only, Q == 1).
//
// What it computes, in the order of dot_product_attention_q8(a8=True) as the
// jitted JAX decode runs it:
//   q is quantized per (row, head) over D: q_s = absmax * fl(1/127) (1 for a
//   zero row; XLA turns the division by the constant 127 into a product by
//   its float32 reciprocal), q8 = clip(rint(q / q_s), -127, 127);
//   logit = ((float(s32(q8 . k8)) * q_s) * k_scale) * D^-0.5 over the slots
//   [0, q_pos]; a pad slot gets -1e30 (the JAX bias: logit + -1e30 rounds to
//   -1e30); slots past q_pos take no part;
//   p = exp(logit - max) / sum (fp32, normalized), then p * v_scale, then
//   quantized per (row, head) over all the slots: p_s = absmax * fl(1/127),
//   p8 = clip(rint(p / p_s), -127, 127) (0 past q_pos);
//   out = float(s32(p8 . v8)) * p_s in the query dtype, with no division by
//   the softmax sum afterwards.
//   Every multiply and divide is written __fmul_rn / __fdiv_rn, so nvcc
//   cannot contract it into an FMA and the logits equal the plain version's
//   bit for bit; only expf and the order of the fp32 sum can differ, so a
//   probability code may land one apart at a rounding boundary. The integer
//   sums are exact and independent of order: 127^2 * S stays far below 2^31
//   for every S the wrapper takes.
//
// What bounds it: HBM bytes, the same as K1-q8: a call reads 2 * B * H *
// (q_pos + 1) * (D + 4) bytes of cache and scales. The function needs three
// global values before any PV product (the max, the sum and the absmax of
// p * v_scale), so K1's combine after the PV products does not carry over,
// and the time goes to the chain of dependent steps as much as to bytes.
//
// Design (split over slots, one thread-block cluster per (row, head)):
// * Grid (n_split, B * H) from the wrapper's split_plan(S, A8_MAX_SPLITS):
//   n_split <= 4 splits of whole 128-slot chunks (256 slots at S 1024),
//   one cluster of n_split blocks per (row, head), launched with
//   cudaLaunchKernelEx and the load-balancing cluster scheduling policy. It
//   depends on S alone; q_pos stays in device memory, so a captured decode
//   step advances it. The live splits are a prefix (split < n_live, from
//   q_pos); a dead split writes zero codes and leaves at once.
// * 128 threads a block, at most 64 registers (8 blocks an SM). A live
//   block streams its split's K rows as 128-slot tiles through a ring of
//   two shared-memory stages (16-byte cp.async), each tile with its
//   k_scale, v_scale and mask entries; once the logits are done the same
//   stages take the V tiles, whose copies run under the exchanges. The
//   scales are read at a stride of H floats: the cache keeps its
//   [L, B, S, H] scale layout.
// * Each global value is one exchange over distributed shared memory: every
//   live block sends its local value into slot `split` of every live
//   block's array by st.async, which completes 4 bytes on that block's
//   mbarrier; a block waits on its own mbarrier until all n_live values
//   have landed, then combines them in split order, so all blocks hold the
//   same bits:
//     1. logits into shared memory (the __dp4a chain, one 16-byte chunk of
//        the K row a thread), the local max -> the global max m;
//     2. e = expf(logit - m) in place (no local rescaling, which would
//        change p's bits), the local sum -> the global sum l;
//     3. p * v_scale = (e / l) * v_scale in place, its local absmax -> the
//        global p_s; the split's codes into shared memory and `codes`;
//     4. PV: each thread owns a 16-byte chunk of D and a slot group; the
//        groups' s32 sums go into the first block's [D] int sum by
//        red.async adds (exact, so their order does not matter), each
//        completing on its mbarrier; every block but the first leaves, and
//        the first, once all n_live * D sums are in, writes
//        out = float(sum) * p_s.
//   The mbarriers are set up (expecting their bytes) before one cluster
//   barrier that every live block passes before its first remote write; a
//   block waits for every write into it, so none leaves while another may
//   still write into it. Measured against a cluster barrier per exchange,
//   8 splits of 128 slots and V staged beside K (PERF.md): each was slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;  // blocks an SM: at most 64 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;  // the portable thread-block cluster size (the plan takes 4)
constexpr int kTile = 128;     // slots a stage holds: one a thread for the scales
constexpr float kMasked = -1e30f;
constexpr float kInv127 = 1.f / 127.f;  // fl(1/127): a scale is absmax * this
constexpr int kMaxDynamicSmem = 232448;  // 227 KB, the opt-in limit of a block
static_assert(kThreads == kTile, "one thread a slot stages a tile's scales");

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// An mbarrier of one arrival (this block's) that completes when `bytes`
// have landed through st.async / red.async from the cluster
__device__ __forceinline__ void mbar_init_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
}
// 4 bytes into another block's shared memory, completing 4 bytes of its mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void red_async_add(uint32_t addr, int v, uint32_t bar) {
  asm volatile(
      "red.async.relaxed.cluster.shared::cluster.mbarrier::complete_tx::bytes.add.s32 [%0], %1, [%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

// The cluster barrier in its two halves. A thread that has exited counts as
// arrived, so a block may leave after any arrive.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Shared-memory layout of one instantiation, in bytes from the start of the
// dynamic shared memory: fixed parts, the split's arrays (n = split_slots,
// a multiple of 128), then one stage (a K tile, later a V tile) when the
// split is one tile, else a ring of two.
template <int D>
struct Layout {
  static constexpr int kChunks = D / 16;                 // 16-byte chunks a row
  static constexpr int kSlotsPass = kThreads / kChunks;  // logits: slots a pass
  static constexpr int kGroups = kThreads / kChunks;     // PV: slot groups
  static constexpr int kRows = kTile * D;                // a K or V tile
  static constexpr int kStage = kRows;                   // a K tile, then a V tile
  static constexpr int kQ8 = 0;                          // int8 [D]
  static constexpr int kRed = kQ8 + D;                   // float [kWarps]
  static constexpr int kBars = kRed + 16;                // uint64 [4]: 3 exchanges, the PV sum
  static constexpr int kXch = kBars + 32;                // float [3][kMaxSplits]
  static constexpr int kSum = kXch + 3 * kMaxSplits * 4;  // int [D]: the first block's PV
  static constexpr int kSplit = kSum + D * 4;            // the split's arrays
  static_assert(kWarps * 4 <= 16 && kSplit % 16 == 0, "unsupported head dim");
  static_assert(kGroups * D * 4 <= kStage, "the PV partials fit over a stage");
  // logits (then probabilities) float, k_scale float, v_scale float, mask
  // int, codes int8: 17 bytes a slot; the stages start on a 128-byte
  // boundary (16 bytes off it, the kernel ran slower on the card)
  static __host__ __device__ constexpr int stages_at(int n) {
    return (kSplit + 17 * n + 127) / 128 * 128;
  }
  static __host__ __device__ constexpr int stages_of(int n) { return n > kTile ? 2 : 1; }
  static __host__ __device__ constexpr int bytes(int n) {
    return stages_at(n) + stages_of(n) * kStage;
  }
};

// Grid (n_split, B * H), clusters of (n_split, 1, 1): block x of a cluster
// is split x of one (row, head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    a8_split_kernel(const T* __restrict__ q,             // [B, H, D]
                    const int8_t* __restrict__ k,        // [L, B, S, H, D]
                    const float* __restrict__ k_scale,   // [L, B, S, H]
                    const int8_t* __restrict__ v,        // [L, B, S, H, D]
                    const float* __restrict__ v_scale,   // [L, B, S, H]
                    const int* __restrict__ mask,        // [B, S]
                    const int* __restrict__ q_pos,       // [1]
                    T* __restrict__ out,                 // [B, H, D]
                    int8_t* __restrict__ codes,          // [B, H, S] or null
                    int B, int S, int H, int layer, float scale, int split_slots) {
  using Lay = Layout<D>;
  constexpr int kChunks = Lay::kChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* q8_sh = reinterpret_cast<int8_t*>(smem + Lay::kQ8);
  float* red = reinterpret_cast<float*>(smem + Lay::kRed);
  float* xch = reinterpret_cast<float*>(smem + Lay::kXch);  // max, sum, absmax by split
  const uint32_t bars = smem_u32(smem + Lay::kBars);
  int* sum_sh = reinterpret_cast<int*>(smem + Lay::kSum);
  float* s_sh = reinterpret_cast<float*>(smem + Lay::kSplit);
  float* ks_sh = s_sh + split_slots;
  float* vs_sh = ks_sh + split_slots;
  int* m_sh = reinterpret_cast<int*>(vs_sh + split_slots);
  int8_t* p8_sh = reinterpret_cast<int8_t*>(m_sh + split_slots);
  unsigned char* stages = smem + Lay::stages_at(split_slots);

  const int split = blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int s0 = split * split_slots;
  const int s_top = min(s0 + split_slots, S);  // this split's slots [s0, s_top)
  int8_t* codes_bh = codes ? codes + static_cast<size_t>(bh) * S : nullptr;

  const int n = min(*q_pos, S - 1) + 1;  // live slots [0, n)
  const int n_live = n > 0 ? (n - 1) / split_slots + 1 : 0;  // live splits
  if (split >= n_live) {  // past q_pos: zero codes, and leave
    if (codes_bh)
      for (int t = s0 + tid; t < s_top; t += kThreads) codes_bh[t] = 0;
    if (split == 0)  // no live slot at all: zeros, as the plain version gives
      for (int d = tid; d < D; d += kThreads) out[static_cast<size_t>(bh) * D + d] = from_float<T>(0.f);
    return;
  }
  if (split == 0)
    for (int d = tid; d < D; d += kThreads) sum_sh[d] = 0;
  if (tid == 0) {
    for (int x = 0; x < 3; ++x) mbar_init_expect(bars + 8 * x, 4 * n_live);
    if (split == 0) mbar_init_expect(bars + 24, 4 * D * n_live);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive_release();  // the mbarriers (and the first block's sum) are ready

  const int len = min(s0 + split_slots, n) - s0;  // live slots of this split (>= 1)
  const int n_tiles = (len + kTile - 1) / kTile;
  const size_t row0 = (static_cast<size_t>(layer) * B + b) * S;  // slot 0 of (layer, b)
  const size_t slot_stride = static_cast<size_t>(H) * D;
  const int8_t* kb = k + row0 * slot_stride + static_cast<size_t>(h) * D;
  const int8_t* vb = v + row0 * slot_stride + static_cast<size_t>(h) * D;
  const float* ksb = k_scale + row0 * H + h;
  const float* vsb = v_scale + row0 * H + h;
  const int* mb = mask + static_cast<size_t>(b) * S + s0;

  // The live rows of tile `tile` of the split from `src` into stage `st`
  // at `off` (0: K, kRows: V)
  auto load_rows = [&](const int8_t* src, int tile, int st, int off) {
    const uint32_t base = smem_u32(stages + st * Lay::kStage + off);
    const int t0 = tile * kTile, nt = min(kTile, len - t0);
    for (int idx = tid; idx < nt * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      cp_async16(base + (r * D + c * 16),
                 src + static_cast<size_t>(s0 + t0 + r) * slot_stride + c * 16);
    }
  };
  // the tile's scales (one slot a thread, a stride of H floats) and its mask
  // (t0 + 128 <= S: S is a multiple of 128)
  auto load_meta = [&](int tile) {
    const int t = tile * kTile + tid;
    if (t < len) {
      cp_async4(smem_u32(ks_sh + t), ksb + static_cast<size_t>(s0 + t) * H);
      cp_async4(smem_u32(vs_sh + t), vsb + static_cast<size_t>(s0 + t) * H);
    }
    if (tid < kTile / 4) cp_async16(smem_u32(m_sh + tile * kTile + 4 * tid),
                                     mb + tile * kTile + 4 * tid);
  };

  // the first K tile with its scales and mask
  load_meta(0);
  load_rows(kb, 0, 0, 0);
  cp_async_commit();

  // the query, quantized per (row, head) over D
  const float x = tid < D ? to_float(q[static_cast<size_t>(bh) * D + tid]) : 0.f;
  const float q_amax = block_max(fabsf(x), red);
  const float q_s = q_amax > 0.f ? __fmul_rn(q_amax, kInv127) : 1.f;
  if (tid < D) q8_sh[tid] = static_cast<int8_t>(quantize(x, q_s));

  // 1. logits: kChunks threads a slot, one 16-byte chunk of the row each
  const int chunk = tid % kChunks, sub = tid / kChunks;
  float m_loc = -INFINITY;
  for (int i = 0; i < n_tiles; ++i) {
    // the next K tile into the other stage, which tile i - 1 freed (or an
    // empty group, so that the counts below hold)
    if (i + 1 < n_tiles) {
      load_meta(i + 1);
      load_rows(kb, i + 1, (i + 1) & 1, 0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile i has landed (tile i + 1 may be in flight)
    __syncthreads();     // and, with q8_sh, is visible to every thread
    const int4 qw = reinterpret_cast<const int4*>(q8_sh)[chunk];
    const unsigned char* kt = stages + (i & 1) * Lay::kStage;
    const int t0 = i * kTile, nt = min(kTile, len - t0);
    for (int base = 0; base < nt; base += Lay::kSlotsPass) {  // uniform bound
      const int r = base + sub;
      const int4 w = r < nt ? *reinterpret_cast<const int4*>(kt + r * D + chunk * 16)
                            : make_int4(0, 0, 0, 0);
      int dot = __dp4a(w.x, qw.x, 0);
      dot = __dp4a(w.y, qw.y, dot);
      dot = __dp4a(w.z, qw.z, dot);
      dot = __dp4a(w.w, qw.w, dot);
#pragma unroll
      for (int o = 1; o < kChunks; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (chunk == 0 && r < nt) {
        const int t = t0 + r;
        const float logit =
            __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(dot), q_s), ks_sh[t]), scale);
        const float s = m_sh[t] > 0 ? logit : kMasked;
        s_sh[t] = s;
        m_loc = fmaxf(m_loc, s);
      }
    }
    __syncthreads();  // the stage's K tile is rewritten by tile i + 2
  }

  // the V rows into the freed stages: their copies run under the exchanges
  load_rows(vb, 0, 0, 0);
  if (n_tiles > 1) load_rows(vb, 1, 1, 0);
  cp_async_commit();

  // Exchange `val` with every live block: into slot `split` of array
  // `which` in each, completing on its mbarrier `which`; returns this
  // block's array once the live splits' values are in
  auto exchange = [&](int which, float val) -> const float* {
    float* mine = xch + which * kMaxSplits;
    const uint32_t bar = bars + 8 * which;
    if (tid < n_live) st_async(map_rank(smem_u32(mine + split), tid), val, map_rank(bar, tid));
    mbar_wait(bar);
    return mine;
  };

  const float m_blk = block_max(m_loc, red);  // finite: a slot is live
  cluster_wait_acquire();  // every live block's mbarriers are ready
  const float* ms = exchange(0, m_blk);
  float m = ms[0];
  for (int sp = 1; sp < n_live; ++sp) m = fmaxf(m, ms[sp]);

  // 2. exp(logit - max) in place, and its sum
  float l_loc = 0.f;
  for (int t = tid; t < len; t += kThreads) {
    const float e = expf(s_sh[t] - m);
    s_sh[t] = e;
    l_loc = __fadd_rn(l_loc, e);
  }
  const float* ls = exchange(1, block_sum(l_loc, red));
  float l = ls[0];  // >= 1: the max slot gives exp(0)
  for (int sp = 1; sp < n_live; ++sp) l = __fadd_rn(l, ls[sp]);

  // 3. p * v_scale in place, its absmax, the codes
  float a_loc = 0.f;
  for (int t = tid; t < len; t += kThreads) {
    const float pv = __fmul_rn(__fdiv_rn(s_sh[t], l), vs_sh[t]);
    s_sh[t] = pv;
    a_loc = fmaxf(a_loc, pv);
  }
  const float* as = exchange(2, block_max(a_loc, red));
  float p_amax = as[0];
  for (int sp = 1; sp < n_live; ++sp) p_amax = fmaxf(p_amax, as[sp]);
  const float p_s = p_amax > 0.f ? __fmul_rn(p_amax, kInv127) : 1.f;
  for (int t = tid; t < s_top - s0; t += kThreads) {
    const int8_t c = t < len ? static_cast<int8_t>(quantize(s_sh[t], p_s)) : 0;
    if (t < len) p8_sh[t] = c;
    if (codes_bh) codes_bh[s0 + t] = c;
  }
  cp_async_wait<0>();  // this thread's V copies have landed
  __syncthreads();     // and, with the codes, are visible to every thread

  // 4. PV in s32: this thread's 16 bytes of D over its slot group
  const int grp = tid / kChunks;
  int acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0;
  for (int i = 0; i < n_tiles; ++i) {
    if (i > 0) {
      cp_async_wait<1>();  // tile i's V rows (tile i + 1's may be in flight)
      __syncthreads();
    }
    const unsigned char* vt = stages + (i & 1) * Lay::kStage + chunk * 16;
    const int t0 = i * kTile, nt = min(kTile, len - t0);
#pragma unroll 4
    for (int j = grp; j < nt; j += Lay::kGroups) {
      const int c = p8_sh[t0 + j];
      const uint4 w = *reinterpret_cast<const uint4*>(vt + j * D);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] += c * sbyte(words[e / 4], e % 4);
    }
    __syncthreads();  // the stage is rewritten by tile i + 2, or below
    if (i + 2 < n_tiles) load_rows(vb, i + 2, i & 1, 0);
    cp_async_commit();
  }

  // the slot groups' sums over the first stage (no copy is in flight: the
  // last groups committed are empty), then into the first block's sum
  int* acc_sh = reinterpret_cast<int*>(stages);  // [kGroups][D]
#pragma unroll
  for (int e = 0; e < 16; ++e) acc_sh[grp * D + chunk * 16 + e] = acc[e];
  __syncthreads();
  const uint32_t sum0 = map_rank(smem_u32(sum_sh), 0), bar0 = map_rank(bars + 24, 0);
  for (int d = tid; d < D; d += kThreads) {
    int sum = 0;
    for (int g = 0; g < Lay::kGroups; ++g) sum += acc_sh[g * D + d];
    red_async_add(sum0 + 4 * d, sum, bar0);
  }
  if (split != 0) return;
  mbar_wait(bars + 24);  // every live split's partial is in
  for (int d = tid; d < D; d += kThreads)
    out[static_cast<size_t>(bh) * D + d] =
        from_float<T>(__fmul_rn(__int2float_rn(sum_sh[d]), p_s));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const float* k_scale, const void* v,
                   const float* v_scale, const int* mask, const int* q_pos, void* out,
                   void* codes, int B, int S, int H, int layer, float scale, int n_split,
                   int split_slots, cudaStream_t stream) {
  using Lay = Layout<D>;
  auto kernel = a8_split_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (attr != cudaSuccess) return attr;
  static const cudaError_t sched = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeClusterSchedulingPolicyPreference,
      cudaClusterSchedulingPolicyLoadBalancing);
  if (sched != cudaSuccess) return sched;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * H, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Lay::bytes(split_slots);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = n_split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const int8_t*>(k), k_scale,
      static_cast<const int8_t*>(v), v_scale, mask, q_pos, static_cast<T*>(out),
      static_cast<int8_t*>(codes), B, S, H, layer, scale, split_slots);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is device memory,
// 16-byte aligned, the arrays contiguous: q/out [B, H, D] (dtype 0 = float32,
// 1 = bfloat16), k/v int8 [L, B, S, H, D], k_scale/v_scale fp32 [L, B, S, H],
// mask [B, S] int32, q_pos one int32, codes int8 [B, H, S] or null (the
// probability codes, 0 past q_pos). n_split and split_slots come from the
// wrapper's split_plan(S): n_split <= 8 splits of split_slots (a multiple of
// 128) slots, the last one holding slot S - 1. Returns the CUDA error of the
// launch (0 = success).
extern "C" int plangen_prefix_decode_attention_a8(
    const void* q, const void* k, const float* k_scale, const void* v,
    const float* v_scale, const int* mask, const int* q_pos, void* out, void* codes,
    int B, int S, int H, int D, int layer, float scale, int dtype, int n_split,
    int split_slots, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % kTile || n_split < 1 || n_split > kMaxSplits ||
      split_slots <= 0 || split_slots % kTile ||
      static_cast<long long>(n_split) * split_slots < S ||
      static_cast<long long>(n_split - 1) * split_slots >= S ||
      (D == 128 ? Layout<128>::bytes(split_slots) : Layout<64>::bytes(split_slots)) >
          kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Bf = __nv_bfloat16;
  cudaError_t err;
  if (dtype == 1 && D == 128)
    err = launch<Bf, 128>(q, k, k_scale, v, v_scale, mask, q_pos, out, codes, B, S, H, layer,
                          scale, n_split, split_slots, st);
  else if (dtype == 1 && D == 64)
    err = launch<Bf, 64>(q, k, k_scale, v, v_scale, mask, q_pos, out, codes, B, S, H, layer,
                         scale, n_split, split_slots, st);
  else if (dtype == 0 && D == 128)
    err = launch<float, 128>(q, k, k_scale, v, v_scale, mask, q_pos, out, codes, B, S, H,
                             layer, scale, n_split, split_slots, st);
  else if (dtype == 0 && D == 64)
    err = launch<float, 64>(q, k, k_scale, v, v_scale, mask, q_pos, out, codes, B, S, H,
                            layer, scale, n_split, split_slots, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
