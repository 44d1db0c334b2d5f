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
// Design:
//  * One CTA per (64 query rows, b*h), 256 threads: four threads per query
//    row. Each thread scores 16 of a KV block's 64 keys (key = sub + 4 j)
//    and owns every fourth output column (d = sub + 4 j); row max and row
//    sum are combined across the four threads with warp shuffles.
//  * Q, K and V blocks are staged in shared memory with padded rows; the
//    probabilities of a block go through shared memory (row-padded) to the
//    P V product. The query and key tails are masked, so any Sq and Sk
//    work (the TPU kernel needed multiples of 128).
//  * The head width D is a runtime value up to 128; the per-thread column
//    count is a template parameter (4, 8, 16, 20, 24 or 32), so D = 16, 32,
//    64, 80, 96 and 128 run fully unrolled and other widths are masked.
//
// What bounds it: on the zamba2-2.7b prefill (BH = 128, S = 1024, D = 80,
// causal) the work is ~21.5 GFLOP against ~0.17 GB of Q, K, V and O, so the
// card's bound is operations (~0.32 ms at 67 TFLOP/s fp32). This first
// version does about one shared-memory load per FMA in the score loop and
// runs one or two CTAs per SM (78.6 KiB of shared memory at D = 80), so it
// is held by the load/store units; tensor cores (bf16 / TF32 wgmma) are
// later work. PERF.md has its measured time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * D +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

template <int kDQ>  // output columns per thread: ceil(D / 4) <= kDQ
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Sq,
             int Sk, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  const int PP = kBK + 1;
  float* q_s = smem;              // (kBQ, D+1)
  float* k_s = q_s + kBQ * DP;    // (kBK, D+1)
  float* v_s = k_s + kBK * DP;    // (kBK, D)
  float* p_s = v_s + kBK * D;     // (kBQ, kBK+1)
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int q_pos = q0 + row;
  const float* qb = q + bh * Sq * static_cast<int64_t>(D);
  const float* kb = k + bh * Sk * static_cast<int64_t>(D);
  const float* vb = v + bh * Sk * static_cast<int64_t>(D);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    q_s[r * DP + d] =
        q0 + r < Sq ? qb[static_cast<int64_t>(q0 + r) * D + d] : 0.f;
  }

  float m = kNegInf;
  float l = 0.f;
  float acc[kDQ];
#pragma unroll
  for (int j = 0; j < kDQ; ++j) acc[j] = 0.f;

  // causal: KV blocks with k0 <= the tile's last query row
  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous block's readers of k_s / v_s are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const bool in = k0 + r < Sk;
      const int64_t off = static_cast<int64_t>(k0 + r) * D + d;
      k_s[r * DP + d] = in ? kb[off] : 0.f;
      v_s[r * D + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = q_s[row * DP + d];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) {
        s[j] = fmaf(qv, k_s[(sub + 4 * j) * DP + d], s[j]);
      }
    }
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const int key = k0 + sub + 4 * j;
      const bool keep = key < Sk && (!causal || q_pos >= key);
      s[j] = keep ? s[j] * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      p_s[row * PP + sub + 4 * j] = p;
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l = l * alpha + lsum;
    m = m_new;
    __syncwarp();  // a row's probabilities come from the four lanes reading them
#pragma unroll
    for (int j = 0; j < kDQ; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = p_s[row * PP + kk];
#pragma unroll
      for (int j = 0; j < kDQ; ++j) {
        const int d = sub + 4 * j;
        if (d < D) acc[j] = fmaf(p, v_s[kk * D + d], acc[j]);
      }
    }
  }

  if (q_pos < Sq) {
    float* orow = o + (bh * Sq + q_pos) * static_cast<int64_t>(D);
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < kDQ; ++j) {
      const int d = sub + 4 * j;
      if (d < D) orow[d] = acc[j] / den;
    }
  }
}

template <int kDQ>
int launch(const float* q, const float* k, const float* v, float* o, int bh,
           int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<kDQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, bh);
  flash_kernel<kDQ><<<grid, kThreads, bytes, stream>>>(q, k, v, o, Sq, Sk, D,
                                                       scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int bh, int Sq, int Sk, int D,
                                   float scale, int causal, void* stream) {
  if (bh <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  const int dq = (D + 3) / 4;
  if (dq <= 4) return launch<4>(qf, kf, vf, of, bh, Sq, Sk, D, scale, causal, st);
  if (dq <= 8) return launch<8>(qf, kf, vf, of, bh, Sq, Sk, D, scale, causal, st);
  if (dq <= 16) return launch<16>(qf, kf, vf, of, bh, Sq, Sk, D, scale, causal, st);
  if (dq <= 20) return launch<20>(qf, kf, vf, of, bh, Sq, Sk, D, scale, causal, st);
  if (dq <= 24) return launch<24>(qf, kf, vf, of, bh, Sq, Sk, D, scale, causal, st);
  return launch<32>(qf, kf, vf, of, bh, Sq, Sk, D, scale, causal, st);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
