// The non-finite census of the live-column kernels: cluster_spmm.cu's
// compact SpMM (K4), cluster_spgemm.cu's window kernel (K1/K5, and K8's
// window variant), cluster_spgemm_revisit.cu's segment kernel (K7, and
// K8's revisit variant) and cluster_spgemm_padded.cu's padded grid (K6).
//
// The TPU kernels multiply whole (8, block_k) slabs, so a dead column k of
// a slab (all 8 values zero) still meets row k of the B tile the slab is
// paired with: 0 * inf and 0 * NaN are NaN, and the slab's part, hence
// its output rows, is NaN in every column where that B row is not finite.
// The live-column walk skips dead columns -- exact on finite B, where
// fmaf(0, b, x) == x -- so each launch finds the NaN the skip loses by
// counting:
//  1. the B tiles that some unit (a compact-stream step, a live pair, a
//     live (step, j) of the padded grid) meets through a slab with fewer
//     than block_k live columns are the only tiles a dead column sits in.
//     They depend on A's pattern and B's tile table, not on B's values:
//     the Sp x Sp packs list them once (kernels/cluster_spgemm.py::
//     census_tiles); the compact SpMM marks them per launch
//     (mark_tiles_kernel, after a memset of the flag and the marks);
//  2. per launch, on the stream before the kernel's own, count_kernel
//     counts for each listed or marked tile and each of its columns
//     the non-finite values among the tile's rows, and raises the flag
//     where a count is not zero. A "tile" is block_k consecutive rows of
//     a row-major (rows, width) array: for K4, B's k-tiles of N columns;
//     for the Sp x Sp kernels, the tile store's (block_k, bn) slots,
//     which are the same thing with width = bn;
//  3. each CTA of the kernel reads the flag once, after its walk. When it
//     is raised, the CTA walks its units again: for a unit whose slab has
//     dead columns, dead_hits counts the non-finite values the live
//     columns meet; where that falls short of the tile's count, a dead
//     column met one, and the kernel adds NaN to that column of the
//     unit's 8 output rows.
// Live columns multiply all 8 values, zeros included, as the TPU kernel
// does; so the kernels give the TPU kernels' NaN positions, inf signs and
// finite values. On finite B the flag stays down and the output is the
// walk's alone, bit for bit; what the census costs there is one read of
// the listed tiles (PERF.md has the measured times).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "live_columns.cuh"

namespace nonfinite {

__device__ __forceinline__ bool is_bad(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

template <typename TB>
__device__ __forceinline__ bool is_bad(TB x) {
  return is_bad(dtypes::to_float(x));
}

// Marks tile tiles[s] (below ntiles) of every step s < n whose slab has
// fewer than block_k live columns.
__global__ void mark_tiles_kernel(const int32_t* __restrict__ tiles,
                                  const int32_t* __restrict__ col_ptr,
                                  int n, int block_k, int ntiles,
                                  int32_t* __restrict__ marked) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int tile = tiles[s];
  if (tile < ntiles && col_ptr[s + 1] - col_ptr[s] < block_k) {
    marked[tile] = 1;
  }
}

constexpr int kCountLanes = 32;
constexpr int kCountRows = 8;

// counts[tile * width + n] = the non-finite values in column n among rows
// tile * block_k .. + block_k (below nrows) of the row-major (nrows, width)
// array b, for tile = tiles[blockIdx.x] (a list) or blockIdx.x where
// marked[tile] is set; raises *flag where one is not zero. Lane x of a row
// group reads columns (blockIdx.y * 32 + x) * V .. + V of every 8th row
// (one 16-byte load a row at V = 4 in fp32). Other tiles are left
// unwritten (no slab with a dead column meets them).
template <typename TB, int V>
__global__ void __launch_bounds__(kCountLanes * kCountRows)
count_kernel(const TB* __restrict__ b, int64_t nrows, int width,
             int block_k, const int32_t* __restrict__ tiles,
             const int32_t* __restrict__ marked,
             int32_t* __restrict__ counts, int32_t* __restrict__ flag) {
  __shared__ int part[kCountRows][kCountLanes * V];
  const int tile = tiles ? tiles[blockIdx.x] : static_cast<int>(blockIdx.x);
  if (marked && marked[tile] == 0) return;
  const int n0 = (blockIdx.y * kCountLanes + threadIdx.x) * V;
  const int64_t row0 = static_cast<int64_t>(tile) * block_k;
  const int64_t left = nrows - row0;
  const int rows = left < block_k ? static_cast<int>(left) : block_k;
  int c[V];
#pragma unroll
  for (int v = 0; v < V; ++v) c[v] = 0;
  if (n0 < width) {
#pragma unroll 4
    for (int r = threadIdx.y; r < rows; r += kCountRows) {
      float x[V];
      live_columns::load_b<V>(b + (row0 + r) * width + n0, x);
#pragma unroll
      for (int v = 0; v < V; ++v) c[v] += is_bad(x[v]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) part[threadIdx.y][threadIdx.x * V + v] = c[v];
  __syncthreads();
  if (threadIdx.y == 0 && n0 < width) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int total = 0;
#pragma unroll
      for (int y = 0; y < kCountRows; ++y) {
        total += part[y][threadIdx.x * V + v];
      }
      counts[static_cast<int64_t>(tile) * width + n0 + v] = total;
      if (total != 0) *flag = 1;
    }
  }
}

// The count over n tiles of b: the list tiles[0 .. n), or tiles 0 .. n
// where marked (tiles null). Four columns a load where the rows allow it
// (width a multiple of 4, b 4-value aligned).
template <typename TB>
int count_tiles(const TB* b, int64_t nrows, int width, int block_k,
                const int32_t* tiles, const int32_t* marked, int n,
                int32_t* counts, int32_t* flag, cudaStream_t s) {
  if (n <= 0) return 0;
  const dim3 block(kCountLanes, kCountRows);
  if (width % 4 == 0 &&
      reinterpret_cast<uintptr_t>(b) % (4 * sizeof(TB)) == 0) {
    const dim3 grid(n, (width / 4 + kCountLanes - 1) / kCountLanes);
    count_kernel<TB, 4><<<grid, block, 0, s>>>(b, nrows, width, block_k,
                                                tiles, marked, counts, flag);
  } else {
    const dim3 grid(n, (width + kCountLanes - 1) / kCountLanes);
    count_kernel<TB, 1><<<grid, block, 0, s>>>(b, nrows, width, block_k,
                                                tiles, marked, counts, flag);
  }
  return static_cast<int>(cudaGetLastError());
}

// The Sp x Sp kernels' census of a tile store (cap, block_k, bn): clear
// the flag, then count the listed tiles (the pack's census list) into
// counts (cap x bn).
template <typename TB>
int count_tile_store(const TB* tiles_store, int cap, int block_k, int bn,
                     const int32_t* list, int nlist, int32_t* flag,
                     int32_t* counts, cudaStream_t s) {
  const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return count_tiles<TB>(tiles_store, static_cast<int64_t>(cap) * block_k,
                         bn, block_k, list, nullptr, nlist, counts, flag, s);
}

// hit[v] |= a dead column of a slab with live columns c0 .. c1 (slab-local
// ids col_k[l], ascending) meets a non-finite value in column v of a tile
// whose counts are cnt[v]: the live columns' rows band[k * stride + v]
// (k below krem; rows past it read as zero) hold fewer of them than the
// whole tile. The caller skips slabs with every column live.
template <typename TB, int V>
__device__ __forceinline__ void dead_hits(int c0, int c1,
                                          const int32_t* __restrict__ col_k,
                                          const int32_t* __restrict__ cnt,
                                          const TB* __restrict__ band,
                                          int64_t stride, int64_t krem,
                                          bool (&hit)[V]) {
  int missing[V];
  bool any = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    missing[v] = cnt[v];
    any |= missing[v] > 0;
  }
  if (!any) return;
  for (int l = c0; l < c1; ++l) {
    const int64_t k = col_k[l];
    if (k >= krem) break;  // columns ascend
#pragma unroll
    for (int v = 0; v < V; ++v) missing[v] -= is_bad(band[k * stride + v]);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) hit[v] |= missing[v] > 0;
}

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fffffff);
}

}  // namespace nonfinite
