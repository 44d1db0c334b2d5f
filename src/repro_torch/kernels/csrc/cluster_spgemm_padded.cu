// Cluster-wise sparse x sparse SpGEMM on the padded per-tile grid,
// hand-written for Hopper (sm_90a), IEEE fp32 on the CUDA cores.
//
// Replaces the TPU kernels of src/repro/kernels/cluster_spgemm.py:
//   cluster_spgemm_tiled     (K6a, B tiles streamed per grid step)
//   cluster_spgemm_resident  (K6b, B's tile store pinned in VMEM)
// which differ only in where the TPU kept B, so one kernel serves both. It
// is the route for B too wide for the live-pair grid's C row strip. For
// every output tile (blk, j) of C,
//   C[blk*8 : +8, j*bn : +bn] = sum over A's stream steps s of block blk,
//                               s ascending, with slot = table[tile_ids[s] *
//                               nnb + j] > 0, of A_slab[s] @ B_tile[slot]
// with no live-pair stream: the table lookup happens in the kernel.
//
// Design:
//  * One CTA per output tile (blk, j): a 1-D grid of nblocks * nnb CTAs,
//    j fastest, so neighbouring CTAs read the same A slabs. The TPU grid
//    (nnb, S) zeroed a tile at its block's first step and ran in order; here
//    each CTA owns its tile, walks its block's steps (block_ptr offsets into
//    the compact stream, which covers every block) and stores the tile once,
//    zeros when no step of the block has a live slot. No atomics.
//  * Dead slots skip the step (uniform across the CTA).
//  * The 8 x bn accumulator is fp32 in registers (4 values a thread, as in
//    the window kernel); A slabs and B tiles are staged in K sub-tiles of 64
//    rows, because block_k reaches 512.
//  * The output has B's dtype, as the TPU kernel's does: with bf16 B tiles
//    the tile is accumulated in fp32 and rounded to bf16 once at the store
//    (the TPU kernel rounded after every step, so the two agree within the
//    documented 2e-2 bound, not bit for bit).
//
// What bounds it: writing the dense C once (nblocks * 8 * nnb * bn values)
// and the tile-padded multiply-adds of the live (step, j) pairs, 2 * 8 *
// block_k * bn each, at 67 TFLOP/s fp32 (H100 SXM data sheet). On the wide
// operands this route serves, almost every CTA only zero-fills, so the C
// write dominates; PERF.md has the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBR = 8;          // rows of a BCC block (block_r)
constexpr int kBNMax = 128;     // widest tile (bn)
constexpr int kKT = 64;         // K sub-tile staged per step
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

template <typename TB>
__global__ void __launch_bounds__(kThreads)
padded_kernel(const int32_t* __restrict__ block_ptr,
              const int32_t* __restrict__ tile_ids,
              const int32_t* __restrict__ table,
              const float* __restrict__ a_values,
              const TB* __restrict__ b_tiles, TB* __restrict__ out, int nnb,
              int block_k, int bn, int64_t ldc) {
  __shared__ __align__(16) float a_s[kKT][kBR];  // A sub-tile, k-major
  __shared__ float b_s[kKT][kBNMax];             // B sub-tile
  const int t = threadIdx.x;
  const int col = t & (kBNMax - 1);
  const int row0 = (t >> 7) * 4;
  const int64_t tile = blockIdx.x;
  const int64_t blk = tile / nnb;
  const int j = static_cast<int>(tile - blk * nnb);
  const int s0 = block_ptr[blk];
  const int s1 = block_ptr[blk + 1];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = s0; s < s1; ++s) {
    const int slot = table[static_cast<int64_t>(tile_ids[s]) * nnb + j];
    if (slot <= 0) continue;  // dead B tile: nothing to add
    const float* a = a_values + static_cast<int64_t>(s) * kBR * block_k;
    const TB* b = b_tiles + static_cast<int64_t>(slot) * block_k * bn;
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
    TB* o = out + blk * kBR * ldc + static_cast<int64_t>(j) * bn + col;
#pragma unroll
    for (int q = 0; q < 4; ++q) store(o + (row0 + q) * ldc, acc[q]);
  }
}

template <typename TB>
int launch(const void* block_ptr, const void* tile_ids, const void* table,
           const void* a_values, const void* b_tiles, void* out, int nblocks,
           int nnb, int block_k, int bn, long long ldc, void* stream) {
  const long long ntiles = static_cast<long long>(nblocks) * nnb;
  if (nblocks <= 0 || nnb <= 0 || ntiles > 0x7fffffffLL || block_k <= 0 ||
      bn <= 0 || bn > kBNMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  padded_kernel<TB><<<static_cast<unsigned>(ntiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(block_ptr),
      static_cast<const int32_t*>(tile_ids),
      static_cast<const int32_t*>(table), static_cast<const float*>(a_values),
      static_cast<const TB*>(b_tiles), static_cast<TB*>(out), nnb, block_k,
      bn, static_cast<int64_t>(ldc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cluster_spgemm_padded_f32(
    const void* block_ptr, const void* tile_ids, const void* table,
    const void* a_values, const void* b_tiles, void* out, int nblocks,
    int nnb, int block_k, int bn, long long ldc, void* stream) {
  return launch<float>(block_ptr, tile_ids, table, a_values, b_tiles, out,
                       nblocks, nnb, block_k, bn, ldc, stream);
}

extern "C" int cluster_spgemm_padded_bf16(
    const void* block_ptr, const void* tile_ids, const void* table,
    const void* a_values, const void* b_tiles, void* out, int nblocks,
    int nnb, int block_k, int bn, long long ldc, void* stream) {
  return launch<__nv_bfloat16>(block_ptr, tile_ids, table, a_values, b_tiles,
                               out, nblocks, nnb, block_k, bn, ldc, stream);
}

extern "C" const char* cluster_spgemm_padded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
