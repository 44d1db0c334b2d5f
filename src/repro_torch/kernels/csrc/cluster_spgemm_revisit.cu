// Cluster-wise sparse x sparse SpGEMM over a revisit-ordered live-pair
// stream, hand-written for Hopper (sm_90a), IEEE fp32 on the CUDA cores.
//
// Replaces the TPU kernels of src/repro/kernels/cluster_spgemm.py:
//   cluster_spgemm_pairs_window        -> segment_kernel, one CTA per
//                                         (window, j) segment (K7)
//   cluster_spgemm_pairs_sharded with  -> the same kernel over every
//   window_blocks set                     shard's segments in one launch
//                                         (K8)
// The revisit order (core/formats.py::revisit_pair_stream) sorts the pairs
// of each window of `window_blocks` consecutive row blocks by
// (j, slot, block), so a B tile's uses across the window's blocks are
// adjacent. For every live pair p of window W and column strip j,
//   C[blk*8 : +8, j*bn : +bn] += A_slab[a_idx[p]] @ B_tile[slot[p]]
// with blk = the segment's first block + rows[p]. Per C element the pairs
// come slot ascending, which is A-stream ascending, so each element's sum
// has the order of the window kernel (csrc/cluster_spgemm.cu): identical
// output, bit for bit, NaN where B's non-finite values meet a slab's dead
// columns included (the same census, nonfinite.cuh).
//
// Design:
//  * One CTA per segment: the pairs of one window and one column strip j,
//    or, where the window is wider than the accumulator below holds, of
//    one sub-range of its blocks (kernels/cluster_spgemm.py::
//    segments_from_shards splits it at pack time, keeping the stream order
//    within each part). The CTA owns that strip of C: no other CTA writes
//    it, so no atomics. The caller zero-fills C; the CTA writes its strip
//    once. A sharded launch runs every shard's segments as one grid; the
//    launch order (order) is shard-major and column strip by column strip
//    within a shard, so the CTAs in flight share B's strip in L2.
//  * The pairs are walked over A's live columns (live_columns.cuh, the
//    window kernel's walk): each live column k of slab a_idx[p] reads row
//    k of B tile slots[p] and applies it to the block's 8 rows; the padded
//    slab is never read. A CTA runs up to 8 consecutive pairs at a time,
//    one unit group (a warp at bn = 128) each: as many groups as a (block,
//    j) tile's pairs call for, while the segments leave the card's thread
//    slots unfilled. Pairs of one slot run come together, so a B tile's
//    rows are read close in time (L1 hits); on an H100 the same segments
//    run block-major were only a few per cent slower on kron-14 A^2, the B
//    rows being L2 hits either way (PERF.md).
//  * Each pair's part (k ascending) is added to its block's accumulator in
//    pair order by group 0, which owns the whole strip in shared memory
//    (segment blocks x 8 x bn fp32; the host's segment_blocks in
//    kernels/cluster_spgemm.py bounds it at 16 KiB, 4 blocks at bn = 128);
//    each thread owns the same V columns of every row, so the adds need no
//    synchronisation.
//
// What bounds it: the window kernel's live-column walk (kron-14 A^2: ~41M
// live-column visits, 2 * 8 * bn flops each, ~1.25 ms at 67 TFLOP/s fp32)
// and the dense C written once (1 GiB, ~0.32 ms at 3.35 TB/s); like that
// kernel it is held by the load latency of each pair's metadata, columns
// and B rows. PERF.md has the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "live_columns.cuh"
#include "nonfinite.cuh"

namespace {

constexpr int kBNMax = 128;     // widest column strip (bn)

using live_columns::PairUnits;

template <int V>
__device__ __forceinline__ void add_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    float4 a = *reinterpret_cast<float4*>(p);
    a.x += x[0]; a.y += x[1]; a.z += x[2]; a.w += x[3];
    *reinterpret_cast<float4*>(p) = a;
  } else if constexpr (V == 2) {
    float2 a = *reinterpret_cast<float2*>(p);
    a.x += x[0]; a.y += x[1];
    *reinterpret_cast<float2*>(p) = a;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] += x[v];
  }
}

// CTA x runs segment order[x]; the accumulator, the segment's strip of
// nblk x 8 rows of bn floats, starts acc_off floats into shared memory,
// past the walk's own buffers.
template <typename TB, int V>
__global__ void __launch_bounds__(live_columns::kMaxThreads,
                                  live_columns::kMinBlocks)
segment_kernel(const int32_t* __restrict__ order,
               const int32_t* __restrict__ seg_ptr,
               const int64_t* __restrict__ seg_out,
               const int32_t* __restrict__ seg_nblk,
               const int32_t* __restrict__ rows, PairUnits units,
               const int32_t* __restrict__ col_k,
               const float* __restrict__ col_vals,
               const TB* __restrict__ b_tiles, float* __restrict__ out,
               const int32_t* __restrict__ counts,
               const int32_t* __restrict__ flag, int block_k, int bn,
               int64_t ldc, int groups_q, int acc_off) {
  using namespace live_columns;
  extern __shared__ float4 smem4[];
  const Geometry g(groups_q, smem4);
  float* acc = reinterpret_cast<float*>(smem4) + acc_off;
  const int s = order[blockIdx.x];
  const int nblk = seg_nblk[s];
  for (int i = threadIdx.x; i < nblk * kRows * bn; i += blockDim.x) {
    acc[i] = 0.f;
  }
  // (walk_parts' first __syncthreads orders the zero-fill before any add)
  const int c = g.q * V;
  const bool active = g.lane_used && c < bn;
  const TB* cols = b_tiles + (active ? c : 0);
  const int64_t tile_elems = static_cast<int64_t>(block_k) * bn;
  const auto band_of = [&](const Meta& m) {
    return Band<TB>{cols + m.band * tile_elems, block_k};
  };
  walk_parts<TB, V>(seg_ptr[s], seg_ptr[s + 1], units, band_of, col_k,
                    col_vals, bn, active, g, groups_q,
                    [&](int p, const float (&part)[kRows][V]) {
                      if (!active) return;
                      float* a = acc + __ldg(rows + p) * kRows * bn + c;
#pragma unroll
                      for (int r = 0; r < kRows; ++r) {
                        add_vec<V>(a + r * bn, part[r]);
                      }
                    });
  if (g.grp == 0 && active && *flag != 0) {
    // B holds a non-finite value in a tile some slab with a dead column
    // meets (nonfinite.cuh): NaN in the blocks whose dead columns meet one.
    // This thread owns its V columns of every row, as in the adds above.
    for (int p = seg_ptr[s]; p < seg_ptr[s + 1]; ++p) {
      const Meta m = units.meta(p);
      if (m.c1 - m.c0 >= block_k) continue;
      bool hit[V];
#pragma unroll
      for (int v = 0; v < V; ++v) hit[v] = false;
      nonfinite::dead_hits<TB, V>(
          m.c0, m.c1, col_k, counts + static_cast<int64_t>(m.band) * bn + c,
          cols + m.band * tile_elems, bn, block_k, hit);
      float* a = acc + __ldg(rows + p) * kRows * bn + c;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!hit[v]) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          a[r * bn + v] += nonfinite::nan_value();
        }
      }
    }
  }
  __syncthreads();
  // the strip, nblk * 8 rows of bn columns, V at a time
  const int vecs = bn / V;
  float* o = out + seg_out[s];
  for (int i = threadIdx.x; i < nblk * kRows * vecs; i += blockDim.x) {
    const int row = i / vecs;
    const int cv = (i - row * vecs) * V;
    float x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = acc[row * bn + cv + v];
    store_vec<V>(o + static_cast<int64_t>(row) * ldc + cv, x);
  }
}

template <typename TB>
int launch(const void* order, const void* seg_ptr, const void* seg_out,
           const void* seg_nblk, const void* rows, const void* slots,
           const void* a_idx, const void* col_ptr, const void* col_k,
           const void* col_vals, const void* b_tiles, void* out,
           const void* census, int ncensus, void* scratch, int cap, int nseg,
           int npairs, int ntiles, int max_nblk, int block_k, int bn,
           long long ldc, void* stream) {
  if (nseg <= 0 || order == nullptr || block_k <= 0 || bn <= 0 ||
      bn > kBNMax || max_nblk <= 0 || ntiles <= 0 || cap <= 0 ||
      ncensus < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // V-wide loads, adds and stores need V-aligned strips: bn, ldc and every
  // segment origin (a multiple of bn) divisible by V, aligned bases
  const auto aligned = [&](int v) {
    return bn % v == 0 && ldc % v == 0 &&
           reinterpret_cast<uintptr_t>(b_tiles) % (v * sizeof(TB)) == 0 &&
           reinterpret_cast<uintptr_t>(out) % (4 * v) == 0;
  };
  const int vec = aligned(4) ? 4 : aligned(2) ? 2 : 1;
  const int v = live_columns::vec_for(bn, vec);
  // unit groups by the pairs per live (block, j) tile, as the window
  // kernel sizes them per window, but no more than the segments need to
  // fill the card's thread slots: group 0 adds every part of a round, so a
  // group more costs a barrier per round (on an H100 kron-14 A^2 ran
  // faster with one group than with two, while a narrow B's 1024 segments
  // want four; PERF.md)
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto shape = live_columns::shape_for(
      bn, v, npairs, ntiles, nseg, static_cast<long long>(sms) * per_sm);
  // (cudaFuncSetAttribute refuses an accumulator past the card's shared
  // memory; segment_blocks keeps it at 16 KiB)
  const int acc_off = static_cast<int>((shape.smem_bytes + 15) / 16 * 4);
  const long long smem =
      acc_off * 4LL + static_cast<long long>(max_nblk) *
                          live_columns::kRows * bn * sizeof(float);
  if (smem > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  // the non-finite census of the listed tiles (nonfinite.cuh): scratch is
  // the flag, then the counts (cap x bn)
  auto* flag = static_cast<int32_t*>(scratch);
  auto* counts = flag + 1;
  const int rc = nonfinite::count_tile_store<TB>(
      static_cast<const TB*>(b_tiles), cap, block_k, bn,
      static_cast<const int32_t*>(census), ncensus, flag, counts, s);
  if (rc != 0) return rc;
  const PairUnits units{static_cast<const int32_t*>(a_idx),
                        static_cast<const int32_t*>(slots),
                        static_cast<const int32_t*>(col_ptr)};
  const auto go = [&](auto vec_c) {
    constexpr int V = decltype(vec_c)::value;
    const auto kernel = segment_kernel<TB, V>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return;
    kernel<<<nseg, shape.threads, static_cast<size_t>(smem), s>>>(
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(seg_ptr),
        static_cast<const int64_t*>(seg_out),
        static_cast<const int32_t*>(seg_nblk),
        static_cast<const int32_t*>(rows), units,
        static_cast<const int32_t*>(col_k),
        static_cast<const float*>(col_vals), static_cast<const TB*>(b_tiles),
        static_cast<float*>(out), counts, flag, block_k, bn, ldc,
        shape.groups_q, acc_off);
  };
  if (v == 4) {
    go(std::integral_constant<int, 4>());
  } else if (v == 2) {
    go(std::integral_constant<int, 2>());
  } else {
    go(std::integral_constant<int, 1>());
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SEGMENTS_ENTRY(NAME, TB)                                             \
  extern "C" int NAME(const void* order, const void* seg_ptr,                \
                      const void* seg_out,                                   \
                      const void* seg_nblk, const void* rows,                \
                      const void* slots, const void* a_idx,                  \
                      const void* col_ptr, const void* col_k,                \
                      const void* col_vals, const void* b_tiles, void* out,  \
                      const void* census, int ncensus, void* scratch,        \
                      int cap, int nseg, int npairs, int ntiles,             \
                      int max_nblk, int block_k, int bn, long long ldc,      \
                      void* stream) {                                        \
    return launch<TB>(order, seg_ptr, seg_out, seg_nblk, rows, slots, a_idx, \
                      col_ptr, col_k, col_vals, b_tiles, out, census,        \
                      ncensus, scratch, cap, nseg, npairs, ntiles, max_nblk, \
                      block_k, bn, ldc, stream);                             \
  }

SEGMENTS_ENTRY(cluster_spgemm_revisit_f32, float)
SEGMENTS_ENTRY(cluster_spgemm_revisit_bf16, __nv_bfloat16)

extern "C" const char* cluster_spgemm_revisit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
