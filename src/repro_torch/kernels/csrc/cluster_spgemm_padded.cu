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
//  * C is written by two launches on the stream, one wrapper call. First
//    zero_fill_kernel zeroes all of C with 16-byte stores: a persistent
//    grid (kFillCtasPerSm CTAs per SM) strides over C's bytes, and the
//    bytes before the first and after the last 16-byte boundary are
//    stored one by one, so any span works. Then padded_kernel runs one
//    CTA per live output tile (blk, j) -- those with at least one step of
//    block blk whose B tile is live, listed once per packed operand by the
//    host (PaddedGrid.live_tiles, blk-major) -- and overwrites it: a live
//    tile is written twice, zero then its value, in stream order. The
//    TPU grid (nnb, S) zeroed every tile at its block's first step and
//    ran in order; here a tile no step reaches is the fill's zero.
//  * A live tile's CTA walks its block's steps (block_ptr offsets into
//    the compact stream, which covers every block) s ascending, looks the
//    step's slot up in B's table and skips dead slots (uniform across the
//    CTA). No atomics.
//  * A step multiplies only its slab's live columns (the columns with a
//    nonzero in any of the 8 rows; kernels/columns.py): their 8 values and
//    the B tile rows they select are staged in shared memory up to 64 at
//    a time, and the 8 x bn accumulator is fp32 in registers (4 values a
//    thread). Skipping an all-zero column is exact (fmaf(0, b, x) == x for
//    finite b), and the columns ascend, so a step's sum is the whole
//    slab's, k ascending. Where B is not finite the whole slab's 0 * inf
//    is NaN: between the fill and the tile launch, nonfinite.cuh's census
//    counts the non-finite values of the tile slots that a live (step, j)
//    meets through a slab with a dead column (listed once per pack), and
//    a tile whose dead columns meet one gets the NaN. On the
//    wide operands below a slab has about 10
//    live columns of 128, so a step reads that many 512-byte B rows, not
//    the 64 KiB tile.
//  * The output has B's dtype, as the TPU kernel's does, and is rounded
//    where the TPU kernel rounded it: the TPU kernel's tile was a bf16
//    block updated as o = bf16(o + bf16(dot)) at every live step, s
//    ascending, so with bf16 B tiles each step's fp32 product is rounded
//    to bf16 and added to the running tile, which is rounded to bf16 again
//    (kept in an fp32 register, where every bf16 value is exact). With
//    fp32 tiles both roundings are the identity.
//
// What bounds it: writing the dense C once (nblocks * 8 * nnb * bn values)
// and the tile-padded multiply-adds of the live (step, j) pairs, 2 * 8 *
// block_k * bn each, at 67 TFLOP/s fp32 (H100 SXM data sheet). On the wide
// operands this route serves (the first 8,192 rows of a 288 x 288 mesh
// times the mesh: 663,552 tiles of C, about 2 % of them live) the C write
// dominates, so the fill runs at the memory's rate and the tile products
// cost a few thousand CTAs. The design before this one gave every tile of
// C its own CTA, which walked its block's steps and table lookups to store
// zeros: the CTA count, not the bytes, set its time; and a live step
// staged its whole 8 x 128 slab and 128 x 128 B tile. PERF.md has the
// measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nonfinite.cuh"

namespace {

constexpr int kBR = 8;          // rows of a BCC block (block_r)
constexpr int kBNMax = 128;     // widest tile (bn)
constexpr int kKT = 64;         // K sub-tile staged per step
constexpr int kThreads = 256;
constexpr int kFillThreads = 256;
constexpr int kFillCtasPerSm = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float, float x) { return x; }
__device__ __forceinline__ float round_to(__nv_bfloat16, float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// Zeroes nbytes from p: 16-byte stores over the aligned body, grid-stride;
// the unaligned head and the tail byte by byte.
__global__ void __launch_bounds__(kFillThreads)
zero_fill_kernel(unsigned char* __restrict__ p, int64_t nbytes) {
  const int64_t lead =
      (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  const int64_t head = lead < nbytes ? lead : nbytes;
  const int64_t nvec = (nbytes - head) >> 4;
  const int64_t tail = head + (nvec << 4);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (tid < head) p[tid] = 0;
  if (tid < nbytes - tail) p[tail + tid] = 0;
  uint4* body = reinterpret_cast<uint4*>(p + head);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = tid;
  for (; i + 3 * stride < nvec; i += 4 * stride) {
    body[i] = zero;
    body[i + stride] = zero;
    body[i + 2 * stride] = zero;
    body[i + 3 * stride] = zero;
  }
  for (; i < nvec; i += stride) body[i] = zero;
}

int fill_zero(void* p, long long nbytes, cudaStream_t stream) {
  if (nbytes <= 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long want = (nbytes / 16 + kFillThreads - 1) / kFillThreads + 1;
  const long long most = 1LL * sms * kFillCtasPerSm;
  const long long ctas = want < most ? want : most;
  zero_fill_kernel<<<static_cast<unsigned>(ctas), kFillThreads, 0, stream>>>(
      static_cast<unsigned char*>(p), static_cast<int64_t>(nbytes));
  return static_cast<int>(cudaGetLastError());
}

// One CTA per live tile live_tiles[blockIdx.x] = blk * nnb + j.
template <typename TB>
__global__ void __launch_bounds__(kThreads)
padded_kernel(const int32_t* __restrict__ block_ptr,
              const int32_t* __restrict__ tile_ids,
              const int32_t* __restrict__ table,
              const int32_t* __restrict__ live_tiles,
              const int32_t* __restrict__ col_ptr,
              const int32_t* __restrict__ col_k,
              const float* __restrict__ col_vals,
              const TB* __restrict__ b_tiles, TB* __restrict__ out,
              const int32_t* __restrict__ counts,
              const int32_t* __restrict__ flag, int nnb, int block_k, int bn,
              int64_t ldc) {
  __shared__ __align__(16) float a_s[kKT][kBR];  // live columns' values
  __shared__ float b_s[kKT][kBNMax];             // the B rows they select
  const int t = threadIdx.x;
  const int col = t & (kBNMax - 1);
  const int row0 = (t >> 7) * 4;
  const int64_t tile = live_tiles[blockIdx.x];
  const int64_t blk = tile / nnb;
  const int j = static_cast<int>(tile - blk * nnb);
  const int s0 = block_ptr[blk];
  const int s1 = block_ptr[blk + 1];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = s0; s < s1; ++s) {
    const int slot = table[static_cast<int64_t>(tile_ids[s]) * nnb + j];
    if (slot <= 0) continue;  // dead B tile: nothing to add
    const TB* b = b_tiles + static_cast<int64_t>(slot) * block_k * bn;
    const int c0 = col_ptr[s];
    const int c1 = col_ptr[s + 1];
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int l0 = c0; l0 < c1; l0 += kKT) {
      const int n = min(kKT, c1 - l0);
      __syncthreads();  // every thread is done with the previous batch
      for (int i = t; i < kBR * n; i += kThreads) {
        a_s[i / kBR][i % kBR] = col_vals[static_cast<int64_t>(l0) * kBR + i];
      }
      for (int i = t; i < n * kBNMax; i += kThreads) {
        const int l = i >> 7;
        const int c = i & (kBNMax - 1);
        const int64_t k = __ldg(col_k + l0 + l);
        b_s[l][c] = c < bn ? to_f32(b[k * bn + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int l = 0; l < n; ++l) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[l][row0]);
        const float bv = b_s[l][col];
        part[0] = fmaf(av.x, bv, part[0]);
        part[1] = fmaf(av.y, bv, part[1]);
        part[2] = fmaf(av.z, bv, part[2]);
        part[3] = fmaf(av.w, bv, part[3]);
      }
    }
    // the TPU kernel's per-step rounding of its output tile
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[q] = round_to(TB(), acc[q] + round_to(TB(), part[q]));
    }
  }
  if (col < bn && *flag != 0) {
    // B holds a non-finite value in a tile some slab with a dead column
    // meets (nonfinite.cuh): NaN where this block's dead columns meet one
    bool hit[1] = {false};
    for (int s = s0; s < s1; ++s) {
      const int slot = table[static_cast<int64_t>(tile_ids[s]) * nnb + j];
      const int c0 = col_ptr[s];
      const int c1 = col_ptr[s + 1];
      if (slot <= 0 || c1 - c0 >= block_k) continue;
      nonfinite::dead_hits<TB, 1>(
          c0, c1, col_k, counts + static_cast<int64_t>(slot) * bn + col,
          b_tiles + static_cast<int64_t>(slot) * block_k * bn + col, bn,
          block_k, hit);
    }
    if (hit[0]) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += nonfinite::nan_value();
    }
  }
  if (col < bn) {
    TB* o = out + blk * kBR * ldc + static_cast<int64_t>(j) * bn + col;
#pragma unroll
    for (int q = 0; q < 4; ++q) store(o + (row0 + q) * ldc, acc[q]);
  }
}

template <typename TB>
int launch(const void* block_ptr, const void* tile_ids, const void* table,
           const void* live_tiles, int nlive, const void* col_ptr,
           const void* col_k, const void* col_vals, const void* b_tiles,
           void* out, const void* census, int ncensus, void* scratch,
           int cap, int nblocks, int nnb, int block_k, int bn, long long ldc,
           void* stream) {
  const long long ntiles = static_cast<long long>(nblocks) * nnb;
  if (nblocks <= 0 || nnb <= 0 || ntiles > 0x7fffffffLL || nlive < 0 ||
      nlive > ntiles || block_k <= 0 || bn <= 0 || bn > kBNMax ||
      ldc < static_cast<long long>(nnb) * bn || cap <= 0 || ncensus < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  int rc = fill_zero(out, nblocks * kBR * ldc * sizeof(TB), s);
  if (rc != 0 || nlive == 0) return rc;
  // the non-finite census of the listed tiles (nonfinite.cuh): scratch is
  // the flag, then the counts (cap x bn)
  auto* flag = static_cast<int32_t*>(scratch);
  auto* counts = flag + 1;
  rc = nonfinite::count_tile_store<TB>(
      static_cast<const TB*>(b_tiles), cap, block_k, bn,
      static_cast<const int32_t*>(census), ncensus, flag, counts, s);
  if (rc != 0) return rc;
  padded_kernel<TB><<<static_cast<unsigned>(nlive), kThreads, 0, s>>>(
      static_cast<const int32_t*>(block_ptr),
      static_cast<const int32_t*>(tile_ids),
      static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(live_tiles),
      static_cast<const int32_t*>(col_ptr), static_cast<const int32_t*>(col_k),
      static_cast<const float*>(col_vals), static_cast<const TB*>(b_tiles),
      static_cast<TB*>(out), counts, flag, nnb, block_k, bn,
      static_cast<int64_t>(ldc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PADDED_ENTRY(NAME, TB)                                               \
  extern "C" int NAME(const void* block_ptr, const void* tile_ids,           \
                      const void* table, const void* live_tiles, int nlive,  \
                      const void* col_ptr, const void* col_k,                \
                      const void* col_vals, const void* b_tiles, void* out,  \
                      const void* census, int ncensus, void* scratch,        \
                      int cap, int nblocks, int nnb, int block_k, int bn,    \
                      long long ldc, void* stream) {                         \
    return launch<TB>(block_ptr, tile_ids, table, live_tiles, nlive,         \
                      col_ptr, col_k, col_vals, b_tiles, out, census,        \
                      ncensus, scratch, cap, nblocks, nnb, block_k, bn, ldc, \
                      stream);                                               \
  }

PADDED_ENTRY(cluster_spgemm_padded_f32, float)
PADDED_ENTRY(cluster_spgemm_padded_bf16, __nv_bfloat16)

// The zero-fill alone, over any byte span (the padded wrappers' first
// launch).
extern "C" int cluster_spgemm_padded_zero(void* p, long long nbytes,
                                          void* stream) {
  if (nbytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  return fill_zero(p, nbytes, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cluster_spgemm_padded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
