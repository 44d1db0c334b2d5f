// Online-softmax (flash) attention, hand-written for Hopper (sm_90a), IEEE
// fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention: (BH, Sq, D) x (BH, Sk, D) -> (BH, Sq, D),
// softmax(Q K^T / sqrt(D)) V with fp32 running max m, sum l and accumulator,
// the causal mask q_pos >= k_pos aligned at the top left, masked scores set
// to -1e30 (not -inf), KV blocks above the diagonal skipped, KV blocks in
// ascending order (block 0 holds key 0, unmasked for every row, so m is a
// real score after it) and the final division by max(l, 1e-30).
//
// What bounds it: on the zamba2-2.7b prefill (BH = 128, S = 1024, D = 80,
// causal) the work is ~21.5 GFLOP against ~0.17 GB of Q, K, V and O, so the
// card's bound is operations (~0.32 ms at 67 TFLOP/s fp32). The kernel is
// written so that the FMA pipe, not shared memory, is its limit:
//
//  * Register blocking. One CTA per (64 query rows, b*h), 256 threads in
//    16 row groups x 16 key groups. Thread (rg, kg) owns a 4 x 4 micro-tile
//    of the 64 x 64 score block -- rows rg*4 .. rg*4+3, keys kg + 16 j --
//    and reads Q and K from shared memory as float4s along d: 8 loads feed
//    64 FMAs. Q and K rows are padded to 16 * ceil(D / 16) + 4 floats, so
//    the 8 keys a quarter-warp reads fall in distinct banks.
//  * P V. The same thread owns rows rg*4 .. +3 of O and ceil(D / 16)
//    columns: float4 chunks at c * 64 + kg * 4 and single columns
//    64 * (DQ / 4) + 16 r + kg, so one float4 of P (its 4 rows, from P^T in
//    shared memory) and DQ / 4 + DQ % 4 loads of V feed 4 * DQ FMAs. The
//    column count DQ is a template parameter: the inner loops are fully
//    unrolled with no test of d against D; Q's columns past D are zero
//    (and K's finite), so padded columns add exact zeros to the scores,
//    and O's are never stored.
//  * Row statistics. A row's 64 keys sit in the 16 lanes of one row group,
//    within one warp: row max and row sum combine with __shfl_xor_sync.
//  * Asynchronous loads. K and V blocks are double-buffered with cp.async
//    (16-byte copies where D % 4 == 0 and the rows are aligned, 4-byte ones
//    otherwise; rows past Sk are zero-filled by the copy), so block j + 1
//    loads while block j computes. P^T of block j overwrites block j's K
//    buffer, which the scores no longer need, which keeps shared memory at
//    103 KiB at D = 80: two CTAs of 256 threads fit on an SM.
//  * Load balance. Query tiles are issued heaviest first (blockIdx.y
//    reversed, b*h on x), so under the causal mask the tiles with the most
//    KV blocks start in the first wave; only a block that reaches past a
//    row's last key (the diagonal block, the ragged last block) applies
//    the mask.
//
// The query and key tails are masked, so any Sq and Sk work (the TPU
// kernel needed multiples of 128). D up to 128 runs as above; D from 129 to
// 256 runs a second instantiation with 32-key blocks (a thread owns 4 x 2
// scores), so that Q, K and V still fit 227 KB (199 KB at D = 256, one CTA
// per SM).
//
// 16-bit q, k, v (bf16 or fp16, the TPU kernel's q.dtype): tiles are read
// in 16 bits and widened into the same fp32 shared buffers (half the bytes
// from device memory; the copies are synchronous, so only fp32 keeps
// cp.async), m, l and the accumulator stay fp32, P is rounded to v's dtype
// before P V (p.astype(v.dtype) in the TPU kernel) while l sums it
// unrounded, and O is written in q's dtype. PERF.md has the measured times.
//
// This header holds the kernel; flash_attention.cu, flash_attention_bf16.cu
// and flash_attention_fp16.cu each instantiate it for one dtype, so that
// nvcc builds the three in parallel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"

namespace flash {

using dtypes::from_float;
using dtypes::round_to;
using dtypes::to_float;

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kThreads = 256;   // 16 row groups x 16 key groups
constexpr int kPS = kBQ + 4;    // P^T row stride (floats)
constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;


__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in, bool vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows row0 .. row0 + n - 1 of a (rows, D) matrix into shared rows `ld`
// floats apart, columns 0 .. D-1; rows at or past `rows` are zero. fp32 by
// cp.async; 16-bit loaded, widened and stored (4 values at a time when
// vec).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int row0, int n, int rows, int D,
                                          bool vec) {
  const int step = vec ? 4 : 1;
  const int per_row = D / step;
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * step;
    const bool in = row0 + r < rows;
    const T* g = src + static_cast<int64_t>(in ? row0 + r : 0) * D + c;
    if constexpr (std::is_same_v<T, float>) {
      cp_async(dst + r * ld + c, g, in, vec);
    } else if (vec) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) {
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(g));
        const T* h = reinterpret_cast<const T*>(&raw);
        f = make_float4(to_float(h[0]), to_float(h[1]), to_float(h[2]),
                        to_float(h[3]));
      }
      *reinterpret_cast<float4*>(dst + r * ld + c) = f;
    } else {
      dst[r * ld + c] = in ? to_float(g[0]) : 0.f;
    }
  }
}

// DQ: output columns per thread, ceil(D / 16) (or more); KT: keys per
// thread in a score block, which holds 16 * KT keys.
template <int DQ, int KT>
struct Layout {
  static constexpr int kBK = 16 * KT;                 // keys per KV block
  static constexpr int kDp = 16 * DQ;                 // D padded to 16
  static constexpr int kRS = kDp + 4;                 // Q / K row stride
  static constexpr int kKB = kBK * (kRS > kPS ? kRS : kPS);  // K (or P^T)
  static constexpr int kVB = kBK * kDp;
  static constexpr size_t kBytes =
      sizeof(float) * (static_cast<size_t>(kBQ) * kRS + 2 * kKB + 2 * kVB);
};

template <typename T, int DQ, int KT>
__global__ void __launch_bounds__(kThreads, KT == 4 ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
             int D, float scale, int causal, int vec) {
  using L = Layout<DQ, KT>;
  constexpr int kBK = L::kBK;
  constexpr int kNV = DQ / 4;   // float4 column chunks of O
  constexpr int kNS = DQ % 4;   // single columns of O
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // (kBQ, kRS)
  float* k_s = q_s + kBQ * L::kRS;      // 2 x (kBK, kRS), P^T aliased
  float* v_s = k_s + 2 * L::kKB;        // 2 x (kBK, kDp)
  const int tid = threadIdx.x;
  const int kg = tid & 15;
  const int rg = tid >> 4;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const T* qb = q + bh * Sq * static_cast<int64_t>(D);
  const T* kb = k + bh * Sk * static_cast<int64_t>(D);
  const T* vb = v + bh * Sk * static_cast<int64_t>(D);

  // Q's padded columns must be zero and K's finite: zero both before the
  // copies land
  for (int i = tid; i < kBQ * L::kRS + 2 * L::kKB; i += kThreads) {
    smem[i] = 0.f;
  }
  __syncthreads();

  // causal: KV blocks with k0 <= the tile's last query row
  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int nkv = (kv_end + kBK - 1) / kBK;
  load_rows(q_s, L::kRS, qb, q0, kBQ, Sq, D, vec);
  load_rows(k_s, L::kRS, kb, 0, kBK, Sk, D, vec);
  load_rows(v_s, L::kDp, vb, 0, kBK, Sk, D, vec);
  cp_async_commit();

  float m[4], l[4], acc[4][DQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DQ; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * kBK;
    float* kc = k_s + (j & 1) * L::kKB;
    const float* vc = v_s + (j & 1) * L::kVB;
    cp_async_wait_all();
    __syncthreads();  // block j is visible; block j - 1's readers are done
    if (j + 1 < nkv) {
      load_rows(k_s + ((j + 1) & 1) * L::kKB, L::kRS, kb, k0 + kBK, kBK, Sk,
                D, vec);
      load_rows(v_s + ((j + 1) & 1) * L::kVB, L::kDp, vb, k0 + kBK, kBK, Sk,
                D, vec);
    }
    cp_async_commit();

    // S = Q K^T on this thread's 4 x KT micro-tile
    float s[4][KT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < KT; ++t) s[i][t] = 0.f;
#pragma unroll 4
    for (int d = 0; d < L::kDp; d += 4) {
      float4 qa[4], ka[KT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(
            q_s + (rg * 4 + i) * L::kRS + d);
      }
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        ka[t] = *reinterpret_cast<const float4*>(
            kc + (kg + 16 * t) * L::kRS + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          s[i][t] = fmaf(qa[i].x, ka[t].x, s[i][t]);
          s[i][t] = fmaf(qa[i].y, ka[t].y, s[i][t]);
          s[i][t] = fmaf(qa[i].z, ka[t].z, s[i][t]);
          s[i][t] = fmaf(qa[i].w, ka[t].w, s[i][t]);
        }
    }

    // scale and mask; only a block reaching past a row's last key masks
    const bool whole = k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        float x = s[i][t] * scale;
        if (!whole) {
          const int key = k0 + kg + 16 * t;
          const bool keep =
              key < Sk && (!causal || q0 + rg * 4 + i >= key);
          x = keep ? x : kNegInf;
        }
        s[i][t] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        s[i][t] = expf(s[i][t] - m_new);
        sum += s[i][t];
        s[i][t] = round_to<T>(s[i][t]);   // P in v's dtype for P V
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DQ; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every warp is done reading this block's K
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      *reinterpret_cast<float4*>(kc + (kg + 16 * t) * kPS + rg * 4) =
          make_float4(s[0][t], s[1][t], s[2][t], s[3][t]);
    }
    __syncthreads();

    // O += P V: per key, one float4 of P (4 rows) against this thread's
    // columns of V's row
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(kc + kk * kPS +
                                                         rg * 4);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* vr = vc + kk * L::kDp;
#pragma unroll
      for (int c = 0; c < kNV; ++c) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(vr + c * 64 + kg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c * 4 + 0] = fmaf(p[i], v4.x, acc[i][c * 4 + 0]);
          acc[i][c * 4 + 1] = fmaf(p[i], v4.y, acc[i][c * 4 + 1]);
          acc[i][c * 4 + 2] = fmaf(p[i], v4.z, acc[i][c * 4 + 2]);
          acc[i][c * 4 + 3] = fmaf(p[i], v4.w, acc[i][c * 4 + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kNS; ++r) {
        const float vs = vr[kNV * 64 + r * 16 + kg];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][kNV * 4 + r] = fmaf(p[i], vs, acc[i][kNV * 4 + r]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    T* orow = o + (bh * Sq + row) * static_cast<int64_t>(D);
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kNV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + kg * 4 + e;
        if (col < D) orow[col] = from_float<T>(acc[i][c * 4 + e] / den);
      }
#pragma unroll
    for (int r = 0; r < kNS; ++r) {
      const int col = kNV * 64 + r * 16 + kg;
      if (col < D) orow[col] = from_float<T>(acc[i][kNV * 4 + r] / den);
    }
  }
}

template <typename T, int DQ, int KT>
int launch(const T* q, const T* k, const T* v, T* o, int bh, int Sq, int Sk,
           int D, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = Layout<DQ, KT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DQ, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_kernel<T, DQ, KT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16- (fp32) or 8-byte (16-bit) copies need D % 4 == 0 and aligned bases
  // (then every row of every head starts aligned)
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
  };
  const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v);
  const dim3 grid(bh, (Sq + kBQ - 1) / kBQ);
  flash_kernel<T, DQ, KT><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, Sq, Sk, D, scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

// One dtype's dispatch over D: ceil(D / 16) columns per thread up to 128,
// an even count and 32-key blocks above.
template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int bh, int Sq,
        int Sk, int D, float scale, int causal, void* stream) {
  if (bh <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > kMaxD ||
      (Sq + kBQ - 1) / kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  auto* ot = static_cast<T*>(o);
  auto st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DQ, KT) \
  return launch<T, DQ, KT>(qt, kt, vt, ot, bh, Sq, Sk, D, scale, causal, st)
  switch ((D + 15) / 16) {
    case 1: FLASH_CASE(1, 4);
    case 2: FLASH_CASE(2, 4);
    case 3: FLASH_CASE(3, 4);
    case 4: FLASH_CASE(4, 4);
    case 5: FLASH_CASE(5, 4);
    case 6: FLASH_CASE(6, 4);
    case 7: FLASH_CASE(7, 4);
    case 8: FLASH_CASE(8, 4);
    case 9:
    case 10: FLASH_CASE(10, 2);
    case 11:
    case 12: FLASH_CASE(12, 2);
    case 13:
    case 14: FLASH_CASE(14, 2);
    default: FLASH_CASE(16, 2);
  }
#undef FLASH_CASE
}

}  // namespace flash
