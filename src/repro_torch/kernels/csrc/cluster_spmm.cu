// Cluster-wise SpMM C = A_bcc @ B (B dense, tall-skinny), hand-written for
// Hopper (sm_90a), IEEE fp32 on the CUDA cores. Two entry points share one
// kernel:
//
//  * cluster_spmm_compact_f32 replaces the TPU kernel
//    src/repro/kernels/cluster_spmm.py::cluster_spmm_compact, whose grid
//    (N / bn, S) added A_slab[s] @ B[tile_ids[s] * block_k : +block_k,
//    j * bn : +bn] into C[blk] over the compact (block, tile) stream and
//    zeroed the accumulator when the block id changed along the serial S
//    axis;
//  * cluster_spmm_padded_f32 replaces src/repro/kernels/cluster_spmm.py::
//    cluster_spmm, the padded grid (N / bn, nblocks, tiles_per_block): every
//    block visits all of its tiles_per_block slabs, and the pad slabs (zero,
//    pointing at tile 0) are summed like the others, as on the TPU.
//
// Design:
//  * One CTA per (row block, column strip of bn <= 128). On the compact
//    stream block_ids is non-decreasing, so the host hands each block its
//    segment of the stream as blk_ptr offsets; on the padded lattice a
//    block's slabs are blk * tiles_per_block .. + tiles_per_block. The CTA
//    walks its segment in order (the TPU's serial axis becomes a loop inside
//    the block) and writes its 8 x bn strip of C once. A compact stream
//    built for this kernel has every block (empty blocks carry one zero
//    slab), so every element of C is written exactly once; the compact
//    wrapper zero-fills C all the same, for a block a stream leaves out.
//  * 256 threads; the 8 x bn fp32 accumulator lives in registers, 4 values
//    per thread (column t % 128, rows 4 * (t / 128) .. + 3).
//  * A slabs and B row bands are staged through shared memory in K
//    sub-tiles of at most 64 rows. B rows past K and columns past N are
//    masked to zero, so ragged shapes need no padded copy of B. Tail-pad
//    steps carry zero slabs, as in the reference.
//
// What bounds it: the kernel does 2 * 8 * block_k * N_strip multiply-adds
// per stream step (tile-padded) and reads A's slabs, the B rows they select
// and C. At the spmm request of the smoke run (kron-14 A, B 16384 x 64) that
// padded work is ~9.6 GFLOP against the product's 2 * nnz * N ~ 5.7e7
// flops, whose least bytes (CSR A, B and C once) take ~4 us; on SparseLinear's
// padded path (a 2560 x 10240 weight at density 0.1, 4096 tokens) the
// product's own 21.5 GFLOP bound it by operations at ~0.32 ms. The kernel is
// held by load latency and the load/store units, as the Sp x Sp kernel is.
// PERF.md has its measured times. Tensor-core (wgmma) versions are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBR = 8;
constexpr int kBNMax = 128;
constexpr int kKT = 64;
constexpr int kThreads = 256;

// blk_ptr: per-block stream offsets (compact), or null for the padded
// lattice of tiles_per_block slabs per block
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const int32_t* __restrict__ blk_ptr,
            const int32_t* __restrict__ tile_ids,
            const float* __restrict__ a_values, const float* __restrict__ b,
            float* __restrict__ out, int tiles_per_block, int block_k, int K,
            int N, int bn) {
  __shared__ __align__(16) float a_s[kKT][kBR];
  __shared__ float b_s[kKT][kBNMax];
  const int t = threadIdx.x;
  const int col = t & (kBNMax - 1);
  const int row0 = (t >> 7) * 4;
  const int blk = blockIdx.x;
  const int col0 = blockIdx.y * bn;
  const int width = min(bn, N - col0);
  const int s0 = blk_ptr ? blk_ptr[blk] : blk * tiles_per_block;
  const int s1 = blk_ptr ? blk_ptr[blk + 1] : s0 + tiles_per_block;
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
        b_s[k][c] = (c < width && row < K) ? b[row * N + col0 + c] : 0.f;
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
    for (int q = 0; q < 4; ++q) acc[q] += part[q];
  }
  if (col < width) {
    float* o = out + static_cast<int64_t>(blk) * kBR * N + col0 + col;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[static_cast<int64_t>(row0 + q) * N] = acc[q];
  }
}

}  // namespace

extern "C" int cluster_spmm_compact_f32(const void* blk_ptr,
                                        const void* tile_ids,
                                        const void* a_values, const void* b,
                                        void* out, int nblocks, int block_k,
                                        int K, int N, int bn, void* stream) {
  if (nblocks <= 0 || block_k <= 0 || N <= 0 || bn <= 0 || bn > kBNMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nblocks, (N + bn - 1) / bn);
  spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blk_ptr),
      static_cast<const int32_t*>(tile_ids),
      static_cast<const float*>(a_values), static_cast<const float*>(b),
      static_cast<float*>(out), 0, block_k, K, N, bn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cluster_spmm_padded_f32(const void* tile_ids,
                                       const void* a_values, const void* b,
                                       void* out, int nblocks,
                                       int tiles_per_block, int block_k, int K,
                                       int N, int bn, void* stream) {
  if (nblocks <= 0 || tiles_per_block <= 0 || block_k <= 0 || N <= 0 ||
      bn <= 0 || bn > kBNMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nblocks, (N + bn - 1) / bn);
  spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr, static_cast<const int32_t*>(tile_ids),
      static_cast<const float*>(a_values), static_cast<const float*>(b),
      static_cast<float*>(out), tiles_per_block, block_k, K, N, bn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cluster_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
