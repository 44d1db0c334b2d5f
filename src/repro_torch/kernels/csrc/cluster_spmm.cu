// Cluster-wise SpMM C = A_bcc @ B (B dense, tall-skinny), hand-written for
// Hopper (sm_90a), IEEE fp32 on the CUDA cores. Two kernels:
//
//  * spmm_columns_kernel (entry point cluster_spmm_columns) replaces the
//    TPU kernel src/repro/kernels/cluster_spmm.py::cluster_spmm_compact,
//    whose grid (N / bn, S) added A_slab[s] @ B[tile_ids[s] * block_k :
//    +block_k, j * bn : +bn] into C[blk] over the compact (block, tile)
//    stream and zeroed the accumulator when the block id changed along the
//    serial S axis;
//  * spmm_kernel (entry point cluster_spmm_padded) replaces
//    src/repro/kernels/cluster_spmm.py::cluster_spmm, the padded grid
//    (N / bn, nblocks, tiles_per_block): every block visits all of its
//    tiles_per_block slabs, and the pad slabs (zero, pointing at tile 0) are
//    summed like the others, as on the TPU.
//
// Both give one CTA to a (row block, column strip of bn <= 128), walk the
// block's slabs in order (the TPU's serial axis becomes a loop inside the
// block) and write the 8 x bn strip of C once. A compact stream built for
// the kernel has every block (empty blocks carry one zero slab); the
// compact wrapper zero-fills C all the same, for a block a stream leaves
// out. Rows of B past K and columns past N are masked, so ragged shapes
// need no padded copy of B.
//
// spmm_columns_kernel walks each slab's live columns (live_columns.cuh):
// for every live column k of step s it reads B's row tile_ids[s] * block_k
// + k, strip col0 .. col0 + bn, once and does 8 FMAs per B element, the
// column's 8 values broadcast. Threads map to the strip width, not to a
// fixed 128: a group of bn / V threads per step (V = 2 at bn = 64, 4 at
// bn = 128: one full warp, 8- or 16-byte loads), and as many step groups
// per CTA as the mean steps per block keep busy (kron-14: 8). Each step is summed in its own part and added to
// the block's accumulator in step order, so the result equals the
// tile-padded kernel's bit for bit on finite data.
//
// What bounds it: the work the product needs, not the padding. At the SpMM
// request of the smoke run (kron-14 A: 73,432 slabs of 8 x 128 holding
// 346,348 live columns; B 16384 x 64) it reads ~12 MB of live columns, one
// 256-byte B row per live column (89 MB, from the 4 MB B that stays in the
// 50 MB L2) and writes C (4 MB): a few microseconds of HBM traffic. What
// holds it is the chain of a block: the steps of a block run in order
// (8 at a time), each a few dependent loads long, and the longest block (a
// power-law hub: 127 steps, 5,316 live columns) decides the kernel's end.
// The tile-padded design did ~9.6 GFLOP for the product's ~5.7e7.
// spmm_kernel on SparseLinear's padded path (a 2560 x 10240 weight at
// density 0.1, 4096 tokens, dense slabs) is bounded by the product's own
// 21.5 GFLOP, ~0.32 ms at 67 TFLOP/s. PERF.md has the measured times.
//
// Non-finite B values. The TPU kernel multiplies whole (8, block_k) slabs,
// so a dead column k of a slab (all 8 values zero) still meets B's row k:
// 0 * inf and 0 * NaN are NaN, and the slab's part, hence the block's
// output, is NaN in every column of the strip where B's row k is not
// finite. The walk skips dead columns, so cluster_spmm_columns finds
// them by counting, in four launches on the stream:
//  1. a memset of the flag and of the per-tile marks;
//  2. mark_tiles_kernel marks every k-tile that some slab covers with
//     fewer than block_k live columns (the only tiles a dead column sits
//     in; SparseLinear's layer has one such tile of 80);
//  3. nonfinite_count_kernel counts, for each marked tile and each column
//     n, the non-finite values among B's rows of the tile (rows < K), and
//     raises the flag where a count is not zero;
//  4. spmm_columns_kernel reads the flag once per CTA after its walk (the
//     finite path is otherwise the walk above) and, when it is raised,
//     walks its block's slabs again, counting the non-finite values its
//     live columns meet: where a slab's count falls short of its tile's,
//     a dead column met one, and NaN is added to that column of the
//     block's output. Live columns multiply all 8 values, zeros included,
//     as the TPU kernel does; so the kernel gives the TPU kernel's NaN
//     positions and inf signs, and its finite values.
//
// 16-bit B. With B in bf16 or fp16 the TPU kernels give C in B's dtype and
// add each step's fp32 product to it rounded, o += dot(...).astype(o.dtype).
// Both kernels take such a B (entry points' dtype 1 = bf16, 2 = fp16) and
// do the same: B is loaded in 16 bits (half the bytes) and widened, each
// step's part is summed in fp32 as before, rounded to B's dtype and added
// to the running C, which is rounded again after every add, in step order
// (live_columns.cuh's acc_add); C is stored in B's dtype. Rounding after
// every step is not associative, so the order is that of the fp32 path:
// spmm_kernel walks its slabs in order; the live-column walk keeps each
// step's fp32 part apart and group 0 adds the parts in step order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "live_columns.cuh"

namespace {

constexpr int kBR = 8;
constexpr int kBNMax = 128;
constexpr int kKT = 64;
constexpr int kThreads = 256;

// The padded lattice: block blk's slabs are blk * tiles_per_block .. +
// tiles_per_block, dense slabs staged through shared memory. B and C are
// TB (fp32, bf16 or fp16).
template <typename TB>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const int32_t* __restrict__ tile_ids,
            const float* __restrict__ a_values, const TB* __restrict__ b,
            TB* __restrict__ out, int tiles_per_block, int block_k, int K,
            int N, int bn) {
  using dtypes::from_float;
  using dtypes::to_float;
  using live_columns::acc_add;
  __shared__ __align__(16) float a_s[kKT][kBR];
  __shared__ float b_s[kKT][kBNMax];
  const int t = threadIdx.x;
  const int col = t & (kBNMax - 1);
  const int row0 = (t >> 7) * 4;
  const int blk = blockIdx.x;
  const int col0 = blockIdx.y * bn;
  const int width = min(bn, N - col0);
  const int s0 = blk * tiles_per_block;
  const int s1 = s0 + tiles_per_block;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = s0; s < s1; ++s) {
    const float* a = a_values + static_cast<int64_t>(s) * kBR * block_k;
    const int64_t krow = static_cast<int64_t>(tile_ids[s]) * block_k;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < block_k; k0 += kKT) {
      const int kt = min(kKT, block_k - k0);
      __syncthreads();  // every thread is done with the previous sub-tile
      for (int i = t; i < kBR * kt; i += kThreads) {
        const int r = i / kt;
        const int k = i - r * kt;
        a_s[k][r] = a[r * block_k + k0 + k];
      }
      for (int i = t; i < kt * kBNMax; i += kThreads) {
        const int k = i >> 7;
        const int c = i & (kBNMax - 1);
        const int64_t row = krow + k0 + k;
        b_s[k][c] =
            (c < width && row < K) ? to_float(b[row * N + col0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kt; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[k][row0]);
        const float bv = b_s[k][col];
        part[0] = fmaf(av.x, bv, part[0]);
        part[1] = fmaf(av.y, bv, part[1]);
        part[2] = fmaf(av.z, bv, part[2]);
        part[3] = fmaf(av.w, bv, part[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = acc_add<TB>(acc[q], part[q]);
  }
  if (col < width) {
    TB* o = out + static_cast<int64_t>(blk) * kBR * N + col0 + col;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[static_cast<int64_t>(row0 + q) * N] = from_float<TB>(acc[q]);
    }
  }
}

__device__ __forceinline__ bool nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

template <typename TB>
__device__ __forceinline__ bool nonfinite(TB x) {
  return nonfinite(dtypes::to_float(x));
}

// Marks every k-tile below ntiles that a slab with a dead column covers.
__global__ void mark_tiles_kernel(const int32_t* __restrict__ tile_ids,
                                  const int32_t* __restrict__ col_ptr,
                                  int nsteps, int block_k, int ntiles,
                                  int32_t* __restrict__ marked) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nsteps) return;
  const int tile = tile_ids[s];
  if (tile < ntiles && col_ptr[s + 1] - col_ptr[s] < block_k) {
    marked[tile] = 1;
  }
}

constexpr int kCountCols = 32;
constexpr int kCountRows = 8;

// counts[tile * N + n] = the non-finite values among B's rows of a marked
// tile in column n; raises *flag where one is not zero. Unmarked tiles are
// left unwritten (no slab with a dead column reads them).
template <typename TB>
__global__ void __launch_bounds__(kCountCols * kCountRows)
nonfinite_count_kernel(const TB* __restrict__ b, int K, int N,
                       int block_k, const int32_t* __restrict__ marked,
                       int32_t* __restrict__ counts,
                       int32_t* __restrict__ flag) {
  __shared__ int part[kCountRows][kCountCols];
  const int tile = blockIdx.x;
  if (marked[tile] == 0) return;
  const int n = blockIdx.y * kCountCols + threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * block_k;
  const int64_t left = K - row0;
  const int rows = left < block_k ? static_cast<int>(left) : block_k;
  int c = 0;
  if (n < N) {
    for (int r = threadIdx.y; r < rows; r += kCountRows) {
      c += nonfinite(__ldg(b + (row0 + r) * N + n));
    }
  }
  part[threadIdx.y][threadIdx.x] = c;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    int total = 0;
#pragma unroll
    for (int y = 0; y < kCountRows; ++y) total += part[y][threadIdx.x];
    counts[static_cast<int64_t>(tile) * N + n] = total;
    if (total != 0) *flag = 1;
  }
}

// The compact stream's live columns: one CTA per (block, column strip),
// the block's steps blk_ptr[blk] .. blk_ptr[blk + 1] walked in order.
struct StepUnits {
  const int32_t* tile_ids;
  const int32_t* col_ptr;
  __device__ live_columns::Meta meta(int s) const {
    return {col_ptr[s], col_ptr[s + 1], tile_ids[s]};
  }
};

template <typename TB, int V>
__global__ void __launch_bounds__(live_columns::kMaxThreads,
                                  live_columns::kMinBlocks)
spmm_columns_kernel(const int32_t* __restrict__ blk_ptr,
                    const int32_t* __restrict__ tile_ids,
                    const int32_t* __restrict__ col_ptr,
                    const int32_t* __restrict__ col_k,
                    const float* __restrict__ col_vals,
                    const TB* __restrict__ b, TB* __restrict__ out,
                    const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ flag, int ntiles,
                    int block_k, int K, int N, int bn, int groups_q) {
  using namespace live_columns;
  extern __shared__ float4 smem4[];
  const Geometry g(groups_q, smem4);
  const int blk = blockIdx.x;
  const int col0 = blockIdx.y * bn;
  const int width = min(bn, N - col0);
  const int c = g.q * V;
  const bool active = g.lane_used && c < width;
  const TB* strip = b + col0 + (active ? c : 0);
  float acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  const auto band_of = [&](const Meta& m) {
    const int64_t row0 = static_cast<int64_t>(m.band) * block_k;
    return Band<TB>{strip + row0 * N, K - row0};
  };
  walk<TB, V, TB>(blk_ptr[blk], blk_ptr[blk + 1],
                  StepUnits{tile_ids, col_ptr}, band_of, col_k, col_vals, N,
                  active, g, groups_q, acc);
  if (g.grp == 0 && active && *flag != 0) {
    // B holds a non-finite value in a tile with a dead slab column: find
    // this block's slabs whose dead columns meet one (see the note above)
    bool hit[V];
#pragma unroll
    for (int v = 0; v < V; ++v) hit[v] = false;
    for (int s = blk_ptr[blk]; s < blk_ptr[blk + 1]; ++s) {
      const int c0 = col_ptr[s], c1 = col_ptr[s + 1];
      const int tile = tile_ids[s];
      if (c1 - c0 >= block_k || tile >= ntiles) continue;
      const int32_t* cnt = counts + static_cast<int64_t>(tile) * N + col0 + c;
      int missing[V];
      bool any = false;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        missing[v] = cnt[v];
        any |= missing[v] > 0;
      }
      if (!any) continue;
      const int64_t row0 = static_cast<int64_t>(tile) * block_k;
      for (int l = c0; l < c1; ++l) {
        const int64_t row = row0 + col_k[l];
        if (row >= K) break;  // columns ascend; rows past K read as zero
#pragma unroll
        for (int v = 0; v < V; ++v) missing[v] -= nonfinite(strip[row * N + v]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) hit[v] |= missing[v] > 0;
    }
    const float nan = __int_as_float(0x7fffffff);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (hit[v]) acc[r][v] += nan;
  }
  if (g.grp == 0 && active) {
    store_rows<V>(out + static_cast<int64_t>(blk) * kRows * N + col0 + c, N,
                  acc);
  }
}

template <typename TB>
int launch_columns(const void* blk_ptr, const void* tile_ids,
                   const void* col_ptr, const void* col_k,
                   const void* col_vals, const void* b, void* out,
                   void* counts, int32_t* flag, int nblocks, int nsteps,
                   int block_k, int K, int N, int bn, cudaStream_t s) {
  const int ntiles = (K + block_k - 1) / block_k;
  const TB* bt = static_cast<const TB*>(b);
  if (ntiles > 0 && nsteps > 0) {
    mark_tiles_kernel<<<(nsteps + 255) / 256, 256, 0, s>>>(
        static_cast<const int32_t*>(tile_ids),
        static_cast<const int32_t*>(col_ptr), nsteps, block_k, ntiles,
        flag + 1);
    const dim3 count_grid(ntiles, (N + kCountCols - 1) / kCountCols);
    nonfinite_count_kernel<TB><<<count_grid, dim3(kCountCols, kCountRows), 0,
                                 s>>>(bt, K, N, block_k, flag + 1,
                                      static_cast<int32_t*>(counts), flag);
  }
  // V-wide loads and stores need every strip to start V-aligned
  const auto aligned = [&](int v) {
    const uintptr_t bytes = sizeof(TB) * v;
    return N % v == 0 && bn % v == 0 &&
           reinterpret_cast<uintptr_t>(b) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(out) % bytes == 0;
  };
  const int vec = live_columns::vec_for(bn, aligned(4) ? 4
                                            : aligned(2) ? 2 : 1);
  const auto shape = live_columns::shape_for(bn, vec, nsteps, nblocks);
  const dim3 grid(nblocks, (N + bn - 1) / bn);
  const auto args = [&](auto kernel) {
    kernel<<<grid, shape.threads, shape.smem_bytes, s>>>(
        static_cast<const int32_t*>(blk_ptr),
        static_cast<const int32_t*>(tile_ids),
        static_cast<const int32_t*>(col_ptr),
        static_cast<const int32_t*>(col_k),
        static_cast<const float*>(col_vals), bt, static_cast<TB*>(out),
        static_cast<const int32_t*>(counts), flag, ntiles, block_k, K, N, bn,
        shape.groups_q);
  };
  if (vec == 4) {
    args(spmm_columns_kernel<TB, 4>);
  } else if (vec == 2) {
    args(spmm_columns_kernel<TB, 2>);
  } else {
    args(spmm_columns_kernel<TB, 1>);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B's dtype: 0 fp32, 1 bf16, 2 fp16 (C in the same dtype).
extern "C" int cluster_spmm_columns(const void* blk_ptr, const void* tile_ids,
                                    const void* col_ptr, const void* col_k,
                                    const void* col_vals, const void* b,
                                    void* out, void* counts, void* scratch,
                                    int nblocks, int nsteps, int block_k,
                                    int K, int N, int bn, int dtype,
                                    void* stream) {
  if (nblocks <= 0 || nsteps < 0 || block_k <= 0 || K < 0 || N <= 0 ||
      bn <= 0 || bn > kBNMax || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  // scratch: the flag, then one mark per k-tile of B
  const int ntiles = (K + block_k - 1) / block_k;
  auto* flag = static_cast<int32_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int32_t) * (1 + ntiles), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 1) {
    return launch_columns<__nv_bfloat16>(blk_ptr, tile_ids, col_ptr, col_k,
                                         col_vals, b, out, counts, flag,
                                         nblocks, nsteps, block_k, K, N, bn,
                                         s);
  }
  if (dtype == 2) {
    return launch_columns<__half>(blk_ptr, tile_ids, col_ptr, col_k,
                                  col_vals, b, out, counts, flag, nblocks,
                                  nsteps, block_k, K, N, bn, s);
  }
  return launch_columns<float>(blk_ptr, tile_ids, col_ptr, col_k, col_vals,
                               b, out, counts, flag, nblocks, nsteps,
                               block_k, K, N, bn, s);
}

extern "C" int cluster_spmm_padded(const void* tile_ids,
                                   const void* a_values, const void* b,
                                   void* out, int nblocks,
                                   int tiles_per_block, int block_k, int K,
                                   int N, int bn, int dtype, void* stream) {
  if (nblocks <= 0 || tiles_per_block <= 0 || block_k <= 0 || N <= 0 ||
      bn <= 0 || bn > kBNMax || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nblocks, (N + bn - 1) / bn);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ids = static_cast<const int32_t*>(tile_ids);
  const auto* av = static_cast<const float*>(a_values);
  if (dtype == 1) {
    spmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        ids, av, static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), tiles_per_block, block_k, K, N, bn);
  } else if (dtype == 2) {
    spmm_kernel<__half><<<grid, kThreads, 0, s>>>(
        ids, av, static_cast<const __half*>(b), static_cast<__half*>(out),
        tiles_per_block, block_k, K, N, bn);
  } else {
    spmm_kernel<float><<<grid, kThreads, 0, s>>>(
        ids, av, static_cast<const float*>(b), static_cast<float*>(out),
        tiles_per_block, block_k, K, N, bn);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cluster_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
