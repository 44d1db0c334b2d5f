// Cluster-wise sparse x sparse SpGEMM over a revisit-ordered live-pair
// stream, hand-written for Hopper (sm_90a), IEEE fp32 on the CUDA cores.
//
// Replaces the TPU kernels of src/repro/kernels/cluster_spgemm.py:
//   cluster_spgemm_pairs_window        -> segment_kernel: one CTA per
//                                         (window, j) segment (K7)
//   cluster_spgemm_pairs_sharded with  -> segment_sharded_kernel: one
//   window_blocks set                     persistent CTA per shard (K8)
// The revisit order (core/formats.py::revisit_pair_stream) sorts the pairs
// of each window of `window_blocks` consecutive row blocks by
// (j, slot, block), so a B tile's uses across the window's blocks are
// adjacent. For every live pair p of window W and column strip j,
//   C[blk*8 : +8, j*bn : +bn] += A_slab[a_idx[p]] @ B_tile[slot[p]]
// with blk = window origin + rows[p]. Per C element the pairs come slot
// ascending, which is A-stream ascending, so each element's sum has the
// order of the window kernel (csrc/cluster_spgemm.cu): bit-identical output.
//
// Design:
//  * One CTA per (window, j) segment of the stream (seg_ptr offsets). The
//    CTA owns that window's column strip of C: no other CTA writes it, so
//    no atomics. The TPU kernel zeroed the whole window on entry; here the
//    caller zero-fills C, and the CTA writes its strip once.
//  * The point of the order is the B fetch dedup: the CTA stages a B tile's
//    K sub-tile in shared memory once per run of equal slot (up to kRun
//    blocks at a time) and applies it to every block of the run. Each
//    block's pair product is summed in registers (part) over the whole of
//    block_k before it is added to the block's accumulator, as the window
//    kernel does.
//  * The accumulator for the window strip (window_blocks x 8 x 128 fp32) is
//    kept in shared memory while it fits (kAccMaxBytes); revisit_window_
//    blocks sizes windows for a 2 MiB TPU budget, so at nnb <= 2 a window is
//    256 blocks (1 MiB) and the CTA then adds into its own C strip in
//    global memory instead. Each thread owns the same 4 elements of every
//    block (column t % 128, rows 4 * (t / 128) .. + 3), so the accumulator
//    needs no synchronisation.
//  * 256 threads; A slabs and B tiles are staged in K sub-tiles of 64 rows
//    (block_k reaches 512).
//
// What bounds it: the same tile-padded fp32 multiply-adds as the window
// kernel (2 * 8 * block_k * bn per live pair, ~31 ms at kron-14 at the
// 67 TFLOP/s fp32 rate of the H100 SXM data sheet); what the order saves is
// B bytes (one fetch per tile per window run instead of per block), which
// on a card whose L2 holds 50 MB may already be served from cache. PERF.md
// has the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBR = 8;          // rows of a BCC block (block_r)
constexpr int kBNMax = 128;     // widest column strip (bn)
constexpr int kKT = 64;         // K sub-tile staged per step
constexpr int kRun = 8;         // blocks of one slot run staged together
constexpr int kThreads = 256;
constexpr int kStageFloats = kKT * kBNMax + kRun * kKT * kBR;
constexpr int kAccMaxBytes = 160 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TB, bool kSmemAcc>
__device__ __forceinline__ void segment_body(
    int g, const int32_t* __restrict__ seg_ptr,
    const int64_t* __restrict__ seg_out, const int32_t* __restrict__ seg_nblk,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ a_idx, const float* __restrict__ a_values,
    const TB* __restrict__ b_tiles, float* __restrict__ out, int block_k,
    int bn, int64_t ldc, float* smem) {
  float* b_s = smem;                      // [kKT][kBNMax]
  float* a_s = b_s + kKT * kBNMax;        // [kRun][kKT][kBR]
  float* acc = a_s + kRun * kKT * kBR;    // [nblk * kBR][kBNMax]
  const int t = threadIdx.x;
  const int col = t & (kBNMax - 1);
  const int row0 = (t >> 7) * 4;
  const int p0 = seg_ptr[g];
  const int p1 = seg_ptr[g + 1];
  const int nblk = seg_nblk[g];
  float* o = out + seg_out[g];
  if (kSmemAcc) {
    for (int rb = 0; rb < nblk; ++rb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[(rb * kBR + row0 + q) * kBNMax + col] = 0.f;
    }
  }
  for (int p = p0; p < p1;) {
    const int slot = slots[p];
    int n = 1;
    while (p + n < p1 && n < kRun && slots[p + n] == slot) ++n;
    const TB* b = b_tiles + static_cast<int64_t>(slot) * block_k * bn;
    float part[kRun][4];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) part[r][q] = 0.f;
    }
    for (int k0 = 0; k0 < block_k; k0 += kKT) {
      const int kt = min(kKT, block_k - k0);
      __syncthreads();  // every thread is done with the previous sub-tile
      for (int i = t; i < kt * kBNMax; i += kThreads) {
        const int k = i >> 7;
        const int c = i & (kBNMax - 1);
        b_s[k * kBNMax + c] =
            c < bn ? to_f32(b[static_cast<int64_t>(k0 + k) * bn + c]) : 0.f;
      }
      for (int i = t; i < n * kBR * kt; i += kThreads) {
        const int r = i / (kBR * kt);
        const int rem = i - r * kBR * kt;
        const int row = rem / kt;
        const int k = rem - row * kt;
        a_s[(r * kKT + k) * kBR + row] =
            a_values[static_cast<int64_t>(a_idx[p + r]) * kBR * block_k +
                     row * block_k + k0 + k];
      }
      __syncthreads();
      for (int k = 0; k < kt; ++k) {
        const float bv = b_s[k * kBNMax + col];
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          if (r < n) {
            const float4 av =
                *reinterpret_cast<const float4*>(&a_s[(r * kKT + k) * kBR + row0]);
            part[r][0] = fmaf(av.x, bv, part[r][0]);
            part[r][1] = fmaf(av.y, bv, part[r][1]);
            part[r][2] = fmaf(av.z, bv, part[r][2]);
            part[r][3] = fmaf(av.w, bv, part[r][3]);
          }
        }
      }
    }
    if (col < bn) {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (r < n) {
          const int base = rows[p + r] * kBR + row0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (kSmemAcc) {
              acc[(base + q) * kBNMax + col] += part[r][q];
            } else {
              o[static_cast<int64_t>(base + q) * ldc + col] += part[r][q];
            }
          }
        }
      }
    }
    p += n;
  }
  if (kSmemAcc && col < bn) {
    for (int rb = 0; rb < nblk; ++rb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = rb * kBR + row0 + q;
        o[static_cast<int64_t>(row) * ldc + col] = acc[row * kBNMax + col];
      }
    }
  }
}

template <typename TB, bool kSmemAcc>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const int32_t* __restrict__ seg_ptr,
               const int64_t* __restrict__ seg_out,
               const int32_t* __restrict__ seg_nblk,
               const int32_t* __restrict__ rows,
               const int32_t* __restrict__ slots,
               const int32_t* __restrict__ a_idx,
               const float* __restrict__ a_values,
               const TB* __restrict__ b_tiles, float* __restrict__ out,
               int block_k, int bn, int64_t ldc) {
  extern __shared__ __align__(16) float smem[];
  segment_body<TB, kSmemAcc>(blockIdx.x, seg_ptr, seg_out, seg_nblk, rows,
                             slots, a_idx, a_values, b_tiles, out, block_k, bn,
                             ldc, smem);
}

// K8 over a revisit-ordered stream: one persistent CTA per shard walks its
// segments shard_ptr[shard] .. shard_ptr[shard + 1] in order. Shards own
// disjoint row-block ranges, so their C strips never meet.
template <typename TB, bool kSmemAcc>
__global__ void __launch_bounds__(kThreads)
segment_sharded_kernel(const int32_t* __restrict__ shard_ptr,
                       const int32_t* __restrict__ seg_ptr,
                       const int64_t* __restrict__ seg_out,
                       const int32_t* __restrict__ seg_nblk,
                       const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ slots,
                       const int32_t* __restrict__ a_idx,
                       const float* __restrict__ a_values,
                       const TB* __restrict__ b_tiles, float* __restrict__ out,
                       int block_k, int bn, int64_t ldc) {
  extern __shared__ __align__(16) float smem[];
  const int g1 = shard_ptr[blockIdx.x + 1];
  for (int g = shard_ptr[blockIdx.x]; g < g1; ++g) {
    segment_body<TB, kSmemAcc>(g, seg_ptr, seg_out, seg_nblk, rows, slots,
                               a_idx, a_values, b_tiles, out, block_k, bn, ldc,
                               smem);
  }
}

template <typename TB, bool kSmemAcc>
int launch_as(const void* shard_ptr, int nshards, const void* seg_ptr,
              const void* seg_out, const void* seg_nblk, const void* rows,
              const void* slots, const void* a_idx, const void* a_values,
              const void* b_tiles, void* out, int nseg, int block_k, int bn,
              long long ldc, int smem_bytes, cudaStream_t s) {
  const auto sp = static_cast<const int32_t*>(seg_ptr);
  const auto so = static_cast<const int64_t*>(seg_out);
  const auto sn = static_cast<const int32_t*>(seg_nblk);
  const auto rw = static_cast<const int32_t*>(rows);
  const auto sl = static_cast<const int32_t*>(slots);
  const auto ai = static_cast<const int32_t*>(a_idx);
  const auto av = static_cast<const float*>(a_values);
  const auto bt = static_cast<const TB*>(b_tiles);
  const auto o = static_cast<float*>(out);
  cudaError_t err;
  if (shard_ptr == nullptr) {
    err = cudaFuncSetAttribute(segment_kernel<TB, kSmemAcc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    segment_kernel<TB, kSmemAcc><<<nseg, kThreads, smem_bytes, s>>>(
        sp, so, sn, rw, sl, ai, av, bt, o, block_k, bn, ldc);
  } else {
    err = cudaFuncSetAttribute(segment_sharded_kernel<TB, kSmemAcc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    segment_sharded_kernel<TB, kSmemAcc><<<nshards, kThreads, smem_bytes, s>>>(
        static_cast<const int32_t*>(shard_ptr), sp, so, sn, rw, sl, ai, av, bt,
        o, block_k, bn, ldc);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TB>
int launch(const void* shard_ptr, int nshards, const void* seg_ptr,
           const void* seg_out, const void* seg_nblk, const void* rows,
           const void* slots, const void* a_idx, const void* a_values,
           const void* b_tiles, void* out, int nseg, int block_k, int bn,
           long long ldc, int window_blocks, void* stream) {
  if (nseg <= 0 || block_k <= 0 || bn <= 0 || bn > kBNMax ||
      window_blocks <= 0 || (shard_ptr != nullptr && nshards <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const long long acc_bytes =
      static_cast<long long>(window_blocks) * kBR * kBNMax * 4;
  if (acc_bytes <= kAccMaxBytes) {
    const int smem = kStageFloats * 4 + static_cast<int>(acc_bytes);
    return launch_as<TB, true>(shard_ptr, nshards, seg_ptr, seg_out, seg_nblk,
                               rows, slots, a_idx, a_values, b_tiles, out,
                               nseg, block_k, bn, ldc, smem, s);
  }
  return launch_as<TB, false>(shard_ptr, nshards, seg_ptr, seg_out, seg_nblk,
                              rows, slots, a_idx, a_values, b_tiles, out, nseg,
                              block_k, bn, ldc, kStageFloats * 4, s);
}

}  // namespace

extern "C" int cluster_spgemm_revisit_f32(
    const void* shard_ptr, int nshards, const void* seg_ptr,
    const void* seg_out, const void* seg_nblk, const void* rows,
    const void* slots, const void* a_idx, const void* a_values,
    const void* b_tiles, void* out, int nseg, int block_k, int bn,
    long long ldc, int window_blocks, void* stream) {
  return launch<float>(shard_ptr, nshards, seg_ptr, seg_out, seg_nblk, rows,
                       slots, a_idx, a_values, b_tiles, out, nseg, block_k, bn,
                       ldc, window_blocks, stream);
}

extern "C" int cluster_spgemm_revisit_bf16(
    const void* shard_ptr, int nshards, const void* seg_ptr,
    const void* seg_out, const void* seg_nblk, const void* rows,
    const void* slots, const void* a_idx, const void* a_values,
    const void* b_tiles, void* out, int nseg, int block_k, int bn,
    long long ldc, int window_blocks, void* stream) {
  return launch<__nv_bfloat16>(shard_ptr, nshards, seg_ptr, seg_out, seg_nblk,
                               rows, slots, a_idx, a_values, b_tiles, out,
                               nseg, block_k, bn, ldc, window_blocks, stream);
}

extern "C" const char* cluster_spgemm_revisit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
