// Cluster-wise sparse x sparse SpGEMM over a window-major live-pair stream,
// hand-written for Hopper (sm_90a), IEEE fp32 on the CUDA cores.
//
// Replaces the TPU kernels of src/repro/kernels/cluster_spgemm.py:
//   cluster_spgemm_pairs, cluster_spgemm_pairs_resident,
//   cluster_spgemm_pairs_db            -> dense C row-strip output
//   cluster_spgemm_pairs_sparse,
//   cluster_spgemm_pairs_sparse_db     -> CompactedC slab output
//   cluster_spgemm_pairs_sharded       -> the same kernel over every
//                                         shard's windows in one launch
//                                         (K8)
// All five compute, for every live (blk, j) window of C,
//   C[blk*8 : +8, j*bn : +bn] = sum over the window's pairs p, s ascending,
//                               of A_slab[a_idx[p]] @ B_tile[slot[p]]
// and differ only in where the TPU kept B (a VMEM placement) and in how the
// output is addressed. Here one kernel serves all of them: the host hands
// each window its output origin (win_out, in elements) and the output row
// stride (ldc), so a strip of a dense C and a CompactedC slab are the same
// store. Dead windows are never visited; the caller zero-fills the output.
//
// Design:
//  * One CTA per live window, found through win_ptr offsets into the
//    window-major (blk, j, s) stream. The TPU kernels ran a serial grid and
//    relied on Pallas writing an output block back when its index changed;
//    a GPU grid has no order, so each window is owned by exactly one CTA:
//    no atomics, and every element keeps the s-ascending order of the sum.
//  * The window's pairs are walked over A's live columns (live_columns.cuh):
//    for pair p, each live column k of slab a_idx[p] reads row k of B tile
//    slots[p] (bn values; at bn = 128 a warp of 16-byte loads, bf16 tiles
//    upcast on load from 8-byte loads) and applies it to the 8 rows of the
//    window, 8 FMAs per B element. The padded slab is never read, and the
//    64 KB B tile is read only where A has a column.
//  * Each pair is summed in its own part (k ascending) and added to the
//    window's accumulator in pair order -- the reference's `o += dot(a, b)`
//    -- so the result equals the tile-padded kernel's bit for bit on finite
//    data. Before the walk, the launch runs nonfinite.cuh's census: the
//    per-column non-finite counts of the tile slots that some pair meets
//    through a slab with a dead column (listed once per pack); a window
//    whose dead columns meet a non-finite value gets the padded sum's NaN
//    there. On finite B the census costs one read of the listed tiles and
//    changes no bit.
//  * Where windows hold many pairs (kron-14: 31.7 on average), a CTA runs
//    up to 4 pairs at a time (a warp each at bn = 128) and adds their
//    parts in order through shared memory, which shortens the chain of a
//    hub window; at about one pair per window (caveman) it is one warp.
//  * Windows launch column strip by column strip (Windows.order), so the
//    CTAs in flight read one strip of B's tiles, which stays in L2. A
//    sharded stream is one launch too: its order is shard-major, then
//    strip by strip within each shard. Shards own disjoint row ranges, so
//    the windows (and the sums) are the unsharded stream's.
//
// What bounds it: kron-14 A^2 (16,384 rows, 8.2M live pairs in 258,210
// windows) visits ~41M live columns, one 512-byte B row each: ~21 GB of
// B rows, most of them L2 hits, against ~540 GB of tile traffic for the
// padded design (a 4 KB slab and a 64 KB B tile per pair). Its least bytes
// are the 1 GiB dense C written once (~0.32 ms at 3.35 TB/s), the bound a
// kernel of this product is held to; the flops the walk does, 2 * 8 * bn
// per visit (~84 GFLOP, ~1.3 ms at 67 TFLOP/s fp32), bound the walk
// itself. It runs far from both: each pair waits on dependent loads (its
// metadata, its columns, then its B rows) with a few columns each, so the
// kernel is held by load latency at the occupancy its registers allow.
// PERF.md has the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "live_columns.cuh"
#include "nonfinite.cuh"

namespace {

constexpr int kBNMax = 128;     // widest window (bn)

using live_columns::PairUnits;

// One CTA per window, the sum of its pairs over their live columns,
// written once; `order` (optional) is the launch order of the windows, so
// that CTAs running together share B's column strip.
template <typename TB, int V>
__global__ void __launch_bounds__(live_columns::kMaxThreads,
                                  live_columns::kMinBlocks)
window_kernel(const int32_t* __restrict__ order,
              const int32_t* __restrict__ win_ptr,
              const int64_t* __restrict__ win_out, PairUnits units,
              const int32_t* __restrict__ col_k,
              const float* __restrict__ col_vals,
              const TB* __restrict__ b_tiles, float* __restrict__ out,
              const int32_t* __restrict__ counts,
              const int32_t* __restrict__ flag, int block_k, int bn,
              int64_t ldc, int groups_q) {
  using namespace live_columns;
  extern __shared__ float4 smem4[];
  const Geometry g(groups_q, smem4);
  const int w = order ? order[blockIdx.x] : static_cast<int>(blockIdx.x);
  const int c = g.q * V;
  const bool active = g.lane_used && c < bn;
  const TB* cols = b_tiles + (active ? c : 0);
  const int64_t tile_elems = static_cast<int64_t>(block_k) * bn;
  float acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  const auto band_of = [&](const Meta& m) {
    return Band<TB>{cols + m.band * tile_elems, block_k};
  };
  walk<TB, V>(win_ptr[w], win_ptr[w + 1], units, band_of, col_k, col_vals,
              bn, active, g, groups_q, acc);
  if (g.grp == 0 && active && *flag != 0) {
    // B holds a non-finite value in a tile some slab with a dead column
    // meets (nonfinite.cuh): NaN where this window's dead columns meet one
    bool hit[V];
#pragma unroll
    for (int v = 0; v < V; ++v) hit[v] = false;
    for (int p = win_ptr[w]; p < win_ptr[w + 1]; ++p) {
      const Meta m = units.meta(p);
      if (m.c1 - m.c0 >= block_k) continue;
      nonfinite::dead_hits<TB, V>(
          m.c0, m.c1, col_k, counts + static_cast<int64_t>(m.band) * bn + c,
          cols + m.band * tile_elems, bn, block_k, hit);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (hit[v]) acc[r][v] += nonfinite::nan_value();
  }
  if (g.grp == 0 && active) {
    store_rows<V>(out + win_out[w] + c, ldc, acc);
  }
}

template <typename TB>
int launch(const void* order, const void* win_ptr, const void* win_out,
           const void* slots, const void* a_idx, const void* col_ptr,
           const void* col_k, const void* col_vals, const void* b_tiles,
           void* out, const void* census, int ncensus, void* scratch,
           int cap, int nwin, int npairs, int block_k, int bn,
           long long ldc, void* stream) {
  if (nwin <= 0 || block_k <= 0 || bn <= 0 || bn > kBNMax || cap <= 0 ||
      ncensus < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // V-wide loads and stores need V-aligned strips: bn, ldc and every
  // window origin (a multiple of bn) divisible by V, aligned bases
  const auto aligned = [&](int v) {
    return bn % v == 0 && ldc % v == 0 &&
           reinterpret_cast<uintptr_t>(b_tiles) % (v * sizeof(TB)) == 0 &&
           reinterpret_cast<uintptr_t>(out) % (4 * v) == 0;
  };
  const int vec = live_columns::vec_for(bn, aligned(4) ? 4
                                            : aligned(2) ? 2 : 1);
  const auto shape = live_columns::shape_for(bn, vec, npairs, nwin);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto bt = static_cast<const TB*>(b_tiles);
  // the non-finite census of the listed tiles (nonfinite.cuh): scratch is
  // the flag, then the counts (cap x bn)
  auto* flag = static_cast<int32_t*>(scratch);
  auto* counts = flag + 1;
  const int rc = nonfinite::count_tile_store<TB>(
      bt, cap, block_k, bn, static_cast<const int32_t*>(census), ncensus,
      flag, counts, s);
  if (rc != 0) return rc;
  const auto wp = static_cast<const int32_t*>(win_ptr);
  const auto wo = static_cast<const int64_t*>(win_out);
  const PairUnits units{static_cast<const int32_t*>(a_idx),
                        static_cast<const int32_t*>(slots),
                        static_cast<const int32_t*>(col_ptr)};
  const auto ck = static_cast<const int32_t*>(col_k);
  const auto cv = static_cast<const float*>(col_vals);
  const auto o = static_cast<float*>(out);
  const auto go = [&](auto vec) {
    constexpr int V = decltype(vec)::value;
    window_kernel<TB, V><<<nwin, shape.threads, shape.smem_bytes, s>>>(
        static_cast<const int32_t*>(order), wp, wo, units, ck, cv, bt, o,
        counts, flag, block_k, bn, ldc, shape.groups_q);
  };
  if (vec == 4) {
    go(std::integral_constant<int, 4>());
  } else if (vec == 2) {
    go(std::integral_constant<int, 2>());
  } else {
    go(std::integral_constant<int, 1>());
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define WINDOWS_ENTRY(NAME, TB)                                              \
  extern "C" int NAME(const void* order, const void* win_ptr,                \
                      const void* win_out, const void* slots,                \
                      const void* a_idx, const void* col_ptr,                \
                      const void* col_k, const void* col_vals,               \
                      const void* b_tiles, void* out, const void* census,    \
                      int ncensus, void* scratch, int cap, int nwin,         \
                      int npairs, int block_k, int bn, long long ldc,        \
                      void* stream) {                                        \
    return launch<TB>(order, win_ptr, win_out, slots, a_idx, col_ptr, col_k, \
                      col_vals, b_tiles, out, census, ncensus, scratch, cap, \
                      nwin, npairs, block_k, bn, ldc, stream);               \
  }

WINDOWS_ENTRY(cluster_spgemm_windows_f32, float)
WINDOWS_ENTRY(cluster_spgemm_windows_bf16, __nv_bfloat16)

extern "C" const char* cluster_spgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
