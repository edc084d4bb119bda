// Prefix decode attention for Hopper (sm_90a), split over the KV slots: one
// decode query per batch row against layer `layer` of the stacked KV cache,
// reading only the live prefix.
//
// Replaces the TPU kernels plangen_tpu/ops/pallas_decode_attention.py::_kernel
// (wrapper prefix_decode_attention) and its row-batched variant
// plangen_tpu/ops/pallas_decode_attention_v3.py::_kernel: both compute this
// function, and the v3 variant's batching of DMAs over four rows is a TPU
// trick with no counterpart here.
//
// What it computes, as the TPU kernel does:
//   q is scaled by D^-0.5 in fp32; the slots [0, q_pos] are scored, a slot
//   counts when pad_mask[b, slot] > 0 (others get the finite -1e30); the
//   softmax is fp32, online over 64-slot tiles; each tile's probabilities
//   are rounded to the cache dtype before the PV product (fp32
//   accumulation); the output is acc / max(l, 1e-30) in the query dtype.
//   Slots past q_pos take no part at all, so a row whose live prefix is all
//   pads gets the mean of V over slots 0..q_pos (the plain version's rule).
//   Probabilities are rounded relative to the running max of their own
//   split (the TPU kernel: of the whole prefix so far; the plain version:
//   the global max); all three agree within the bf16 rounding of p.
//
// What bounds it: HBM bytes. Each call reads 2 * B * (q_pos + 1) * H * D *
// sizeof(dtype) bytes of cache (K and V of one layer up to the live
// position) and does 4 flops per element read, far below the card's ~295
// flops/byte balance point. So the design keeps as many bytes in flight on
// as many SMs as the live prefix allows.
//
// Design (split-KV):
// * Grid (n_split, B * H), fixed by S alone: the wrapper's `split_plan`
//   gives n_split <= 8 splits of `split_slots` slots each (whole 128-slot
//   chunks). At batch 8, 16 heads and S 1024 that is 8 x 128 = 1024 blocks
//   of 128 slots: 7.8 blocks per SM in all, 5.8 live at q_pos 677. q_pos
//   stays in device memory and only decides what each block does, so a
//   decode step captured in a CUDA graph can advance it without rebuilding
//   the launch. A block whose split starts after q_pos reads nothing and
//   leaves at once, freeing its SM slot.
// * 256 threads a block. A live block stages its split by 16-byte
//   `cp.async`, K rows, V rows and the tile's mask (and, for the int8
//   cache, its scales): a 128-slot split (bf16, int8) is one tile with all
//   its bytes in flight at once; a longer split (S > 1024) streams 128-slot
//   tiles (64 for fp32 at D 128) through a ring of two stages. Rows are
//   padded by 16 bytes, so eight threads reading the same 16-byte chunk of
//   eight consecutive rows hit eight different bank groups. Scores: two
//   threads per slot (four for fp32 at D 128), each over its part of the row
//   in 16-byte loads against the fp32 query in shared memory, shuffles to
//   add the parts. PV: each thread owns one 16-byte chunk of the head dim
//   and a slot group, reading V in 16-byte vectors; the groups are summed in
//   a fixed order at the end.
// * Combine: the splits of one (row, head) are one thread-block cluster
//   (launched with cudaLaunchKernelEx, cluster size n_split <= 8, the
//   portable size). Each live block writes its partial (m, l, acc[D])
//   through distributed shared memory into row `split` of the first
//   block's shared memory and leaves; after the cluster barrier the first
//   block combines the live rows in split order and writes the output. A
//   block that has exited counts as arrived, so dead splits never hold the
//   barrier. Chosen over a global workspace with a last-arriving-block
//   counter because it needs no scratch buffer, no atomics and no counter
//   that concurrent launches would share; the fixed order makes two calls
//   bitwise equal. The combine reads live splits only, so it never forms
//   -inf - -inf; a live split whose slots are all pads has the finite local
//   max -1e30 and is weighted by exp(-1e30 - m) = 0 unless every live split
//   is all pads.
// * Measured against variants on the card (PERF.md): 128 threads with
//   64-slot tiles, and 4 splits of 256 slots, were slower at the decode
//   loop's q_pos; so was copying K and V as two cp.async groups.
//
// The int8 cache (K1-q8): the same kernel reads k/v int8 [L, B, S, H, D] with
// fp32 scales k_scale/v_scale [L, B, S, H] (one per slot and head). It is
// the port's counterpart of the XLA paths the JAX package takes over that
// cache (plangen_tpu/ops/attention.py::segmented_decode_attention with int8
// segments and ::dot_product_attention_q8), in their order: q is NOT
// pre-scaled; logit = (q . k_q8) * k_scale * D^-0.5; each tile's
// probabilities are multiplied by v_scale and rounded to the query dtype
// before the PV product with v_q8 in fp32. A slot then costs 2 * D + 8 bytes
// against 4 * D in bf16, so a call reads about half of K1's bytes.
//
// Left for later work: the int8 cache's scales are read per slot at a stride
// of H floats (a layout with the scales of a slot range contiguous would
// stage them with the rows); TMA in place of cp.async; overlap of one
// block's compute with the next block's copies (a block stages its whole
// split, then computes).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;  // the portable thread-block cluster size
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

// element e of a 16-byte chunk of cache dtype C, in fp32
template <typename C>
__device__ __forceinline__ float chunk_elem(const uint4& w, int e) {
  const uint32_t word = (&w.x)[e * (int)sizeof(C) / 4];
  if constexpr (std::is_same<C, float>::value) {
    return __uint_as_float(word);
  } else if constexpr (std::is_same<C, __nv_bfloat16>::value) {
    return __uint_as_float((e & 1) ? (word & 0xFFFF0000u) : (word << 16));
  } else {
    return s8_to_float(word, e & 3);
  }
}

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
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The cluster barrier in its two halves. A thread that has exited counts as
// arrived, so a block may leave after any arrive.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Shared-memory layout of one instantiation (cache dtype C, head dim D), in
// bytes from the start of the dynamic shared memory: fixed parts, then one
// stage when a split is one tile, else a ring of two.
template <typename C, int D>
struct Layout {
  static constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(C));
  static constexpr int kChunks = kRowBytes / 16;                  // 16-byte chunks a row
  static constexpr int kElems = 16 / static_cast<int>(sizeof(C));  // elements a chunk
  // scoring threads a slot (each over kChunks / kTps chunks) and slots a tile:
  // four for the 512-byte fp32 rows, so that two stages still fit
  static constexpr int kTps = kChunks > 16 ? 4 : 2;
  static constexpr int kTile = kThreads / kTps;
  static constexpr int kLd = kRowBytes + 16;  // padded row stride: an odd number of chunks
  static constexpr int kKV = kTile * kLd;     // a K (or V) tile
  static constexpr int kMask = 2 * kKV;       // in a stage: the tile's mask, then scales
  static constexpr int kStage = kMask + kTile * 4 + (kQ8 ? 2 * kTile * 4 : 0);
  static constexpr int kGroups = kThreads / kChunks;  // PV: slot groups a chunk
  static constexpr int kQ = 0;                        // q in fp32 [D]
  static constexpr int kP = kQ + D * 4;               // the tile's rounded p [kTile]
  static constexpr int kRed = kP + kTile * 4;         // block reductions [kWarps]
  static constexpr int kParts = kRed + kWarps * 4;    // the first block's: every split's
  static constexpr int kPartLd = D + 2;               //   m, l, acc[D]
  static constexpr int kStages = (kParts + kMaxSplits * kPartLd * 4 + 15) / 16 * 16;
  static_assert(kChunks % 2 == 0 && kThreads % kChunks == 0, "unsupported head dim");
  static_assert(kStage % 16 == 0, "16-byte cp.async destinations");
  static_assert(kGroups * D * 4 <= kStage, "the PV partials fit over a stage");
  static_assert(kStages + 2 * kStage <= 227 * 1024, "two stages fit in shared memory");
  // the stages of a split of `split_slots` slots: the whole split at once,
  // or a ring of two tiles
  static __host__ __device__ constexpr int stages_of(int split_slots) {
    return split_slots > kTile ? 2 : 1;
  }
};

// T: query / output dtype; C: cache dtype, T itself or int8_t (K1-q8, which
// also reads the per-slot scales k_scale / v_scale [L, B, S, H]).
// Grid (n_split, B * H), clusters of (n_split, 1, 1): block x of a cluster
// is split x of one (row, head).
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kThreads)
    split_kv_decode_kernel(const T* __restrict__ q,  // [B, H, D]
                           const C* __restrict__ k,  // [L, B, S, H, D]
                           const C* __restrict__ v,  // [L, B, S, H, D]
                           const float* __restrict__ k_scale,  // q8
                           const float* __restrict__ v_scale,  // q8
                           const int* __restrict__ mask,       // [B, S]
                           const int* __restrict__ q_pos,      // [1]
                           T* __restrict__ out,                // [B, H, D]
                           int B, int S, int H, int layer, float scale,
                           int split_slots) {
  using Lay = Layout<C, D>;
  constexpr bool kQ8 = Lay::kQ8;
  constexpr int kElems = Lay::kElems;
  constexpr int kTile = Lay::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_sh = reinterpret_cast<float*>(smem + Lay::kQ);
  float* p_sh = reinterpret_cast<float*>(smem + Lay::kP);
  float* red = reinterpret_cast<float*>(smem + Lay::kRed);
  float* parts = reinterpret_cast<float*>(smem + Lay::kParts);
  unsigned char* stages = smem + Lay::kStages;

  const int split = blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  cluster_arrive_relaxed();  // this block has started (the first block is written to)
  const int last = min(*q_pos, S - 1);  // the last live slot
  const int n_live = last >= 0 ? last / split_slots + 1 : 0;  // live splits
  if (split >= n_live) {  // past q_pos: read nothing, leave at once
    if (split == 0)  // no live slot at all: zeros, as acc / max(l, 1e-30) gives
      for (int d = tid; d < D; d += kThreads)
        out[static_cast<size_t>(bh) * D + d] = from_float<T>(0.f);
    return;
  }

  const int s0 = split * split_slots;
  const int s_end = min(s0 + split_slots, last + 1);
  const size_t row0 = (static_cast<size_t>(layer) * B + b) * S;  // slot 0 of (layer, b)
  const size_t slot_stride = static_cast<size_t>(H) * D;
  const C* kb = k + row0 * slot_stride + static_cast<size_t>(h) * D;
  const C* vb = v + row0 * slot_stride + static_cast<size_t>(h) * D;
  const int* mb = mask + static_cast<size_t>(b) * S;

  // The K and V rows of slots t0 .. t0 + kTile - 1 that are <= last into
  // stage st, with the mask of all kTile (and the int8 cache's scales), as
  // one cp.async group
  auto load = [&](int t0, int st) {
    const uint32_t base = smem_u32(stages + st * Lay::kStage);
    const int n = min(kTile, s_end - t0);
#pragma unroll
    for (int i = 0; i < kTile * Lay::kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / Lay::kChunks, c = idx % Lay::kChunks;
      if (r < n) {
        const size_t g = static_cast<size_t>(t0 + r) * slot_stride + c * kElems;
        cp_async16(base + r * Lay::kLd + c * 16, kb + g);
        cp_async16(base + Lay::kKV + r * Lay::kLd + c * 16, vb + g);
      }
    }
    if (tid < kTile / 4) cp_async16(base + Lay::kMask + tid * 16, mb + t0 + 4 * tid);
    if constexpr (kQ8) {
      if (tid < n) {
        const size_t at = (row0 + t0 + tid) * H + h;
        cp_async4(base + Lay::kMask + kTile * 4 + tid * 4, k_scale + at);
        cp_async4(base + Lay::kMask + 2 * kTile * 4 + tid * 4, v_scale + at);
      }
    }
    cp_async_commit();
  };

  const int n_tiles = (s_end - s0 + kTile - 1) / kTile;
  const int n_stages = Lay::stages_of(split_slots);
  load(s0, 0);

  // the query in fp32: pre-scaled for the dense cache (the TPU kernel's
  // order); the int8 cache scales the logit instead
  for (int d = tid; d < D; d += kThreads) {
    const float x = to_float(q[static_cast<size_t>(bh) * D + d]);
    q_sh[d] = kQ8 ? x : x * scale;
  }

  constexpr int kSlotsWarp = 32 / Lay::kTps;             // scoring: slots a warp
  const int slot = warp * kSlotsWarp + lane % kSlotsWarp;  // this thread's slot
  const int part = lane / kSlotsWarp;                      // and its part of the row
  const int chunk = tid % Lay::kChunks;      // PV: this thread's chunk of D
  const int grp = tid / Lay::kChunks;        // and its slot group
  float m_run = -INFINITY;  // running max of the split (uniform over the block)
  float l_run = 0.f;        // running sum of unrounded probabilities
  float acc[kElems];        // PV over this thread's slots, its chunk of D
#pragma unroll
  for (int e = 0; e < kElems; ++e) acc[e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = s0 + i * kTile, st = i % n_stages;
    // the next tile into the other stage, which tile i - 1 freed (or an
    // empty group, so that the count below holds)
    if (i + 1 < n_tiles)
      load(t0 + kTile, (i + 1) % n_stages);
    else
      cp_async_commit();
    cp_async_wait_but_one();  // tile i has landed
    __syncthreads();     // and, with q_sh, is visible to every thread
    const unsigned char* sg = stages + st * Lay::kStage;
    const int n = min(kTile, s_end - t0);  // live slots of this tile (>= 1)
    const bool live = slot < n;

    // score: this thread's part of slot `slot`'s K row against q
    float dot = 0.f;
    if (live) {
      constexpr int kPart = Lay::kChunks / Lay::kTps;
      const unsigned char* row = sg + slot * Lay::kLd;
#pragma unroll
      for (int cc = 0; cc < kPart; ++cc) {
        const int c = part * kPart + cc;
        const uint4 w = *reinterpret_cast<const uint4*>(row + c * 16);
        const float4* qc = reinterpret_cast<const float4*>(q_sh + c * kElems);
#pragma unroll
        for (int e4 = 0; e4 < kElems / 4; ++e4) {
          const float4 qq = qc[e4];
          dot += qq.x * chunk_elem<C>(w, 4 * e4) + qq.y * chunk_elem<C>(w, 4 * e4 + 1) +
                 qq.z * chunk_elem<C>(w, 4 * e4 + 2) + qq.w * chunk_elem<C>(w, 4 * e4 + 3);
        }
      }
    }
#pragma unroll
    for (int o = kSlotsWarp; o < 32; o <<= 1)  // the other parts of the row
      dot += __shfl_xor_sync(0xffffffffu, dot, o);

    const float* ks = reinterpret_cast<const float*>(sg + Lay::kMask + kTile * 4);
    const float* vs = ks + kTile;
    const bool ok = reinterpret_cast<const int*>(sg + Lay::kMask)[slot] > 0;
    if (kQ8 && live) dot = dot * ks[slot] * scale;
    // slots past q_pos take no part; live pads get the finite -1e30
    const float s = live ? (ok ? dot : kMasked) : -INFINITY;
    const float m_new = fmaxf(m_run, block_max(s, red));  // finite: a slot is live
    const float alpha = expf(m_run - m_new);                // 0 on the first tile
    const float p = live ? expf(s - m_new) : 0.f;
    l_run = l_run * alpha + block_sum(part == 0 ? p : 0.f, red);
    m_run = m_new;
    if (part == 0) {
      // rounded like p.astype(v.dtype); the int8 cache: like
      // (p * v_scale).astype(q.dtype)
      p_sh[slot] = kQ8 ? (live ? to_float(from_float<T>(p * vs[slot])) : 0.f)
                       : to_float(from_float<T>(p));
    }
    __syncthreads();

    // PV: 16-byte V vectors of this thread's chunk, over its slot group
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] *= alpha;
    const unsigned char* vt = sg + Lay::kKV + chunk * 16;
#pragma unroll 4
    for (int j = grp; j < n; j += Lay::kGroups) {
      const uint4 w = *reinterpret_cast<const uint4*>(vt + j * Lay::kLd);
      const float pj = p_sh[j];
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[e] = fmaf(pj, chunk_elem<C>(w, e), acc[e]);
    }
    __syncthreads();  // the stage and p_sh are rewritten by the next tiles
  }

  // the slot groups' sums, in group order, over the first stage (no copy is
  // in flight: the last group committed is empty)
  float* red_acc = reinterpret_cast<float*>(stages);  // [kGroups][D]
#pragma unroll
  for (int e = 0; e < kElems; ++e) red_acc[grp * D + chunk * kElems + e] = acc[e];
  __syncthreads();
  cluster_wait_acquire();  // every block of the cluster has started
  // this split's partial (m, l, acc[D]) into row `split` of the first
  // block's `parts`, through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  float* dst = cluster.map_shared_rank(parts, 0) + split * Lay::kPartLd;
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < Lay::kGroups; ++g) a += red_acc[g * D + d];
    dst[2 + d] = a;
  }
  if (tid == 0) {
    dst[0] = m_run;
    dst[1] = l_run;
  }
  cluster_arrive_release();  // publishes the partial; a block other than the first leaves
  if (split != 0) return;
  cluster_wait_acquire();  // every live split's partial has landed

  // combine the live splits in split order: deterministic. Every m is
  // finite (a live split has a live slot), so no -inf - -inf.
  for (int d = tid; d < D; d += kThreads) {
    float m_all = -INFINITY;
    for (int sp = 0; sp < n_live; ++sp) m_all = fmaxf(m_all, parts[sp * Lay::kPartLd]);
    float l_all = 0.f, a_all = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float* ps = parts + sp * Lay::kPartLd;
      const float w = expf(ps[0] - m_all);
      l_all = fmaf(w, ps[1], l_all);
      a_all = fmaf(w, ps[2 + d], a_all);
    }
    out[static_cast<size_t>(bh) * D + d] = from_float<T>(a_all / fmaxf(l_all, 1e-30f));
  }
}

template <typename T, typename C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* mask, const int* q_pos, void* out,
                   int B, int S, int H, int layer, float scale, int n_split,
                   int split_slots, cudaStream_t stream) {
  using Lay = Layout<C, D>;
  auto kernel = split_kv_decode_kernel<T, C, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kStages + 2 * Lay::kStage);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * H, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Lay::kStages + Lay::stages_of(split_slots) * Lay::kStage;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = n_split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const C*>(k),
                            static_cast<const C*>(v), k_scale, v_scale, mask, q_pos,
                            static_cast<T*>(out), B, S, H, layer, scale, split_slots);
}

// cache dtype C = T (dense) or int8_t (K1-q8); T by `dtype`, D by `D`
template <bool kQ8>
int dispatch(const void* q, const void* k, const void* v, const float* k_scale,
             const float* v_scale, const int* mask, const int* q_pos, void* out,
             int B, int S, int H, int D, int layer, float scale, int dtype,
             int n_split, int split_slots, void* stream) {
  using Bf = __nv_bfloat16;
  using CBf = typename std::conditional<kQ8, int8_t, Bf>::type;
  using CF = typename std::conditional<kQ8, int8_t, float>::type;
  if (n_split < 1 || n_split > kMaxSplits || split_slots % 128 ||
      static_cast<long long>(n_split) * split_slots < S ||
      static_cast<long long>(n_split - 1) * split_slots >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && D == 128)
    err = launch<Bf, CBf, 128>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H, layer,
                               scale, n_split, split_slots, st);
  else if (dtype == 1 && D == 64)
    err = launch<Bf, CBf, 64>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H, layer,
                              scale, n_split, split_slots, st);
  else if (dtype == 0 && D == 128)
    err = launch<float, CF, 128>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H, layer,
                                 scale, n_split, split_slots, st);
  else if (dtype == 0 && D == 64)
    err = launch<float, CF, 64>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H, layer,
                                scale, n_split, split_slots, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is device memory,
// 16-byte aligned; the arrays are contiguous: q/out [B, H, D], k/v
// [L, B, S, H, D], mask [B, S] int32, q_pos one int32. dtype (of q, out and
// the dense cache): 0 = float32, 1 = bfloat16. n_split and split_slots come
// from the wrapper's split_plan(S): n_split <= 8 splits of split_slots
// (a multiple of 64) slots, the last one holding slot S - 1. Returns the
// CUDA error of the launch (0 = success).
extern "C" int plangen_prefix_decode_attention(const void* q, const void* k,
                                               const void* v, const int* mask,
                                               const int* q_pos, void* out,
                                               int B, int S, int H, int D,
                                               int layer, float scale,
                                               int dtype, int n_split,
                                               int split_slots, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, mask, q_pos, out, B, S, H,
                         D, layer, scale, dtype, n_split, split_slots, stream);
}

// K1-q8: k/v int8 [L, B, S, H, D], k_scale/v_scale fp32 [L, B, S, H].
extern "C" int plangen_prefix_decode_attention_q8(
    const void* q, const void* k, const float* k_scale, const void* v,
    const float* v_scale, const int* mask, const int* q_pos, void* out, int B,
    int S, int H, int D, int layer, float scale, int dtype, int n_split,
    int split_slots, void* stream) {
  return dispatch<true>(q, k, v, k_scale, v_scale, mask, q_pos, out, B, S, H,
                        D, layer, scale, dtype, n_split, split_slots, stream);
}
