// Cluster-wise sparse x sparse SpGEMM over a window-major live-pair stream,
// hand-written for Hopper (sm_90a), IEEE fp32 on the CUDA cores.
//
// Replaces the TPU kernels of src/repro/kernels/cluster_spgemm.py:
//   cluster_spgemm_pairs, cluster_spgemm_pairs_resident,
//   cluster_spgemm_pairs_db            -> dense C row-strip output
//   cluster_spgemm_pairs_sparse,
//   cluster_spgemm_pairs_sparse_db     -> CompactedC slab output
//   cluster_spgemm_pairs_sharded       -> window_sharded_kernel: one
//                                         persistent CTA per shard (K8)
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
//  * 256 threads. The 8 x bn (bn <= 128) fp32 accumulator lives in
//    registers, 4 values per thread: thread t owns column t % 128 and rows
//    4 * (t / 128) .. + 3.
//  * A slabs and B tiles are staged through shared memory in K sub-tiles of
//    at most 64 rows: block_k reaches 512, and one 512 x 128 fp32 B tile is
//    256 KB, more than the 227 KB a block can have.
//  * bf16 B tiles are upcast on load. Each pair's product is summed in
//    registers and then added to the window's accumulator, the reference's
//    `o += dot(a, b)`.
//
// What bounds it: the kernel does tile-padded fp32 multiply-adds, 2 * 8 *
// block_k * bn per live pair. At kron-14 (16,384 rows, 8.2M live pairs) that
// is ~2.1 TFLOP, ~31 ms at the 67 TFLOP/s fp32 rate of the H100 SXM data
// sheet, while its bytes (A 287 MB + B 763 MB + C 1 GiB) move in ~0.6 ms at
// 3.35 TB/s: compute-bound on padded work. That is the tile design's own
// floor, not the product's: A^2 at kron-14 needs only ~3.2e8 flops, and its
// least bytes (the CSR operand read once, the 1 GiB dense C written once)
// take ~0.3 ms, the bound a kernel of this product is held to. This first
// version is held further by the load/store units (two shared-memory loads
// per four FMAs, scalar global loads) and by no overlap of loads with
// compute. wgmma and TMA pipelines (tensor cores need TF32 or bf16 inputs
// and 64-row tiles) are later work; PERF.md has its measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBR = 8;          // rows of a BCC block (block_r)
constexpr int kBNMax = 128;     // widest window (bn)
constexpr int kKT = 64;         // K sub-tile staged per step
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One window: the sum of its pairs, written once. Shared memory is passed in
// so that the one-window-per-CTA kernel and the persistent sharded kernel
// run the same body.
template <typename TB>
__device__ __forceinline__ void window_body(
    int w, const int32_t* __restrict__ win_ptr,
    const int64_t* __restrict__ win_out, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ a_idx, const float* __restrict__ a_values,
    const TB* __restrict__ b_tiles, float* __restrict__ out, int block_k,
    int bn, int64_t ldc, float (*a_s)[kBR], float (*b_s)[kBNMax]) {
  const int t = threadIdx.x;
  const int col = t & (kBNMax - 1);
  const int row0 = (t >> 7) * 4;
  const int p0 = win_ptr[w];
  const int p1 = win_ptr[w + 1];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p = p0; p < p1; ++p) {
    const float* a = a_values + static_cast<int64_t>(a_idx[p]) * kBR * block_k;
    const TB* b = b_tiles + static_cast<int64_t>(slots[p]) * block_k * bn;
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
        b_s[k][c] = c < bn ? to_f32(b[static_cast<int64_t>(k0 + k) * bn + c])
                           : 0.f;
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
  if (col < bn) {
    float* o = out + win_out[w] + col;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[static_cast<int64_t>(row0 + q) * ldc] = acc[q];
  }
}

template <typename TB>
__global__ void __launch_bounds__(kThreads)
window_kernel(const int32_t* __restrict__ win_ptr,
              const int64_t* __restrict__ win_out,
              const int32_t* __restrict__ slots,
              const int32_t* __restrict__ a_idx,
              const float* __restrict__ a_values,
              const TB* __restrict__ b_tiles, float* __restrict__ out,
              int block_k, int bn, int64_t ldc) {
  __shared__ __align__(16) float a_s[kKT][kBR];  // A sub-tile, k-major
  __shared__ float b_s[kKT][kBNMax];             // B sub-tile
  window_body<TB>(blockIdx.x, win_ptr, win_out, slots, a_idx, a_values,
                  b_tiles, out, block_k, bn, ldc, a_s, b_s);
}

// K8, the sharded pair stream: one persistent CTA per shard walks the
// windows shard_ptr[shard] .. shard_ptr[shard + 1] in order. A shard is a
// contiguous range of row blocks, so its windows are a contiguous range of
// the window-major stream and no two CTAs write the same C rows.
template <typename TB>
__global__ void __launch_bounds__(kThreads)
window_sharded_kernel(const int32_t* __restrict__ shard_ptr,
                      const int32_t* __restrict__ win_ptr,
                      const int64_t* __restrict__ win_out,
                      const int32_t* __restrict__ slots,
                      const int32_t* __restrict__ a_idx,
                      const float* __restrict__ a_values,
                      const TB* __restrict__ b_tiles, float* __restrict__ out,
                      int block_k, int bn, int64_t ldc) {
  __shared__ __align__(16) float a_s[kKT][kBR];
  __shared__ float b_s[kKT][kBNMax];
  const int w1 = shard_ptr[blockIdx.x + 1];
  for (int w = shard_ptr[blockIdx.x]; w < w1; ++w) {
    window_body<TB>(w, win_ptr, win_out, slots, a_idx, a_values, b_tiles,
                    out, block_k, bn, ldc, a_s, b_s);
  }
}

template <typename TB>
int launch(const void* shard_ptr, int nshards, const void* win_ptr,
           const void* win_out, const void* slots, const void* a_idx,
           const void* a_values, const void* b_tiles, void* out, int nwin,
           int block_k, int bn, long long ldc, void* stream) {
  if (nwin <= 0 || block_k <= 0 || bn <= 0 || bn > kBNMax ||
      (shard_ptr != nullptr && nshards <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto wp = static_cast<const int32_t*>(win_ptr);
  const auto wo = static_cast<const int64_t*>(win_out);
  const auto sl = static_cast<const int32_t*>(slots);
  const auto ai = static_cast<const int32_t*>(a_idx);
  const auto av = static_cast<const float*>(a_values);
  const auto bt = static_cast<const TB*>(b_tiles);
  const auto o = static_cast<float*>(out);
  if (shard_ptr == nullptr) {
    window_kernel<TB><<<nwin, kThreads, 0, s>>>(wp, wo, sl, ai, av, bt, o,
                                                block_k, bn, ldc);
  } else {
    window_sharded_kernel<TB><<<nshards, kThreads, 0, s>>>(
        static_cast<const int32_t*>(shard_ptr), wp, wo, sl, ai, av, bt, o,
        block_k, bn, ldc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cluster_spgemm_windows_f32(
    const void* win_ptr, const void* win_out, const void* slots,
    const void* a_idx, const void* a_values, const void* b_tiles, void* out,
    int nwin, int block_k, int bn, long long ldc, void* stream) {
  return launch<float>(nullptr, 0, win_ptr, win_out, slots, a_idx, a_values,
                       b_tiles, out, nwin, block_k, bn, ldc, stream);
}

extern "C" int cluster_spgemm_windows_bf16(
    const void* win_ptr, const void* win_out, const void* slots,
    const void* a_idx, const void* a_values, const void* b_tiles, void* out,
    int nwin, int block_k, int bn, long long ldc, void* stream) {
  return launch<__nv_bfloat16>(nullptr, 0, win_ptr, win_out, slots, a_idx,
                               a_values, b_tiles, out, nwin, block_k, bn, ldc,
                               stream);
}

extern "C" int cluster_spgemm_windows_sharded_f32(
    const void* shard_ptr, int nshards, const void* win_ptr,
    const void* win_out, const void* slots, const void* a_idx,
    const void* a_values, const void* b_tiles, void* out, int nwin,
    int block_k, int bn, long long ldc, void* stream) {
  return launch<float>(shard_ptr, nshards, win_ptr, win_out, slots, a_idx,
                       a_values, b_tiles, out, nwin, block_k, bn, ldc, stream);
}

extern "C" int cluster_spgemm_windows_sharded_bf16(
    const void* shard_ptr, int nshards, const void* win_ptr,
    const void* win_out, const void* slots, const void* a_idx,
    const void* a_values, const void* b_tiles, void* out, int nwin,
    int block_k, int bn, long long ldc, void* stream) {
  return launch<__nv_bfloat16>(shard_ptr, nshards, win_ptr, win_out, slots,
                               a_idx, a_values, b_tiles, out, nwin, block_k,
                               bn, ldc, stream);
}

extern "C" const char* cluster_spgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
