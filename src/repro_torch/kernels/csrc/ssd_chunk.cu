// Fused Mamba2 SSD chunk scan, hand-written for Hopper (sm_90a), IEEE fp32
// on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py::ssd_chunk_scan,
// whose grid (B*H, n_chunks) kept the (N, P) state in a VMEM scratch that
// persisted along the serial chunk axis and did, per (bh, chunk):
//   L      = exp(segsum(a))                 (Q, Q), lower triangle
//   y      = ((C B^T) o L) X + exp(a_cum) o (C h_prev)
//   h_new  = h_prev exp(a_cum[-1]) + (B o exp(a_cum[-1] - a_cum))^T X
// with x (BH, nc, Q, P), a (BH, nc, Q), b/c (BH, nc, Q, N) already
// dt-discretised by the wrapper, y like x and the final state (BH, N, P).
//
// Design:
//  * One CTA per b*h. It walks its chunks in order (the TPU's serial axis
//    becomes a loop), with the (N, P) state in shared memory, so the state
//    never goes to device memory between chunks.
//  * The (Q, Q) decay/score matrix does not fit in shared memory at
//    Q = 256 (256 KiB of fp32). The intra-chunk product is tiled in
//    64-row output tiles and 64-row source tiles; only source tiles at or
//    below the output tile are visited, and exp(a_cum[l] - a_cum[s]) is
//    evaluated only where l >= s (above the diagonal it could overflow).
//    Any Q works, including Q > 256 and Q not a multiple of 64 (the model
//    falls back to one chunk of the whole sequence when the length is not
//    a multiple of the chunk): rows past Q are masked to zero.
//  * a_cum, the within-chunk cumulative sum, is a scan by warp 0 in pieces
//    of 32 (shuffles, with a carry), written to a per-CTA workspace of Q
//    floats in device memory that the wrapper allocates.
//  * Output accumulators live in registers (64 * P / 256 <= 32 per
//    thread), the state update's in registers too (N * P / 256 <= 32).
//
// What bounds it: on the zamba2-2.7b prefill (BH = 320, nc = 4, Q = 256,
// P = N = 64) the work is ~16 GFLOP of fp32 FMAs against ~0.34 GB of
// operands, so the card's bound is operations (~0.24 ms at 67 TFLOP/s).
// This first version issues two shared-memory loads per FMA and runs 320
// CTAs of 8 warps (2.4 per SM), so it is held by the load/store units and
// occupancy, not by the FMA rate. PERF.md has its measured time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;
constexpr int kThreads = 256;
constexpr int kMaxAcc = 32;  // accumulators per thread: 64 * P and N * P <= 8192

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ b, const float* __restrict__ c,
                 float* __restrict__ y, float* __restrict__ hfin,
                 float* __restrict__ acum_ws, int nc, int Q, int P, int N) {
  extern __shared__ float smem[];
  const int NP1 = N + 1;
  const int TP1 = kT + 1;
  float* h_s = smem;              // (N, P) state
  float* c_s = h_s + N * P;       // (kT, N+1) C rows of the output tile
  float* b_s = c_s + kT * NP1;    // (kT, N+1) B rows of the source tile
  float* x_s = b_s + kT * NP1;    // (kT, P)   X rows of the source tile
  float* s_s = x_s + kT * P;      // (kT, kT+1) masked, decayed scores
  float* acl = s_s + kT * TP1;    // (kT) a_cum of the output tile
  float* acs = acl + kT;          // (kT) a_cum of the source tile
  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  float* ws = acum_ws + bh * Q;

  for (int i = tid; i < N * P; i += kThreads) h_s[i] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int64_t row0 = (bh * nc + ci) * static_cast<int64_t>(Q);
    const float* xc = x + row0 * P;
    const float* ac = a + row0;
    const float* bc = b + row0 * N;
    const float* cc = c + row0 * N;
    float* yc = y + row0 * P;

    // -- a_cum: warp 0 scans the chunk, 32 steps at a time ------------------
    __syncthreads();  // every reader of the previous chunk's a_cum is done
    if (tid < 32) {
      float carry = 0.f;
      for (int q0 = 0; q0 < Q; q0 += 32) {
        const int q = q0 + tid;
        float v = q < Q ? ac[q] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (q < Q) ws[q] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float a_last = ws[Q - 1];

    // -- outputs, one tile of kT rows at a time -----------------------------
    for (int l0 = 0; l0 < Q; l0 += kT) {
      const int tl = min(kT, Q - l0);
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N;
        const int n = i - r * N;
        c_s[r * NP1 + n] = r < tl ? cc[static_cast<int64_t>(l0 + r) * N + n]
                                  : 0.f;
      }
      if (tid < kT) acl[tid] = tid < tl ? ws[l0 + tid] : 0.f;
      __syncthreads();

      // inter-chunk readout from the carried state: exp(a_cum) o (C h_prev)
      float acc[kMaxAcc];
#pragma unroll
      for (int e = 0; e < kMaxAcc; ++e) {
        const int idx = tid + e * kThreads;
        acc[e] = 0.f;
        if (idx < kT * P) {
          const int l = idx / P;
          const int p = idx - l * P;
          float s = 0.f;
          for (int n = 0; n < N; ++n) {
            s = fmaf(c_s[l * NP1 + n], h_s[n * P + p], s);
          }
          acc[e] = expf(acl[l]) * s;
        }
      }

      // intra-chunk: source tiles at or below the output tile
      for (int s0 = 0; s0 <= l0; s0 += kT) {
        const int ts = min(kT, Q - s0);
        __syncthreads();  // the previous source tile's readers are done
        for (int i = tid; i < kT * N; i += kThreads) {
          const int r = i / N;
          const int n = i - r * N;
          b_s[r * NP1 + n] =
              r < ts ? bc[static_cast<int64_t>(s0 + r) * N + n] : 0.f;
        }
        for (int i = tid; i < kT * P; i += kThreads) {
          const int r = i / P;
          const int p = i - r * P;
          x_s[i] = r < ts ? xc[static_cast<int64_t>(s0 + r) * P + p] : 0.f;
        }
        if (tid < kT) acs[tid] = tid < ts ? ws[s0 + tid] : 0.f;
        __syncthreads();
        // scores (C B^T) o exp(a_cum[l] - a_cum[s]) on the lower triangle
        for (int i = tid; i < kT * kT; i += kThreads) {
          const int l = i / kT;
          const int s = i - l * kT;
          float v = 0.f;
          if (l < tl && s < ts && l0 + l >= s0 + s) {
            float d = 0.f;
            for (int n = 0; n < N; ++n) {
              d = fmaf(c_s[l * NP1 + n], b_s[s * NP1 + n], d);
            }
            v = d * expf(acl[l] - acs[s]);
          }
          s_s[l * TP1 + s] = v;
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kMaxAcc; ++e) {
          const int idx = tid + e * kThreads;
          if (idx < kT * P) {
            const int l = idx / P;
            const int p = idx - l * P;
            float s = 0.f;
            for (int j = 0; j < kT; ++j) {
              s = fmaf(s_s[l * TP1 + j], x_s[j * P + p], s);
            }
            acc[e] += s;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kMaxAcc; ++e) {
        const int idx = tid + e * kThreads;
        if (idx < kT * P) {
          const int l = idx / P;
          const int p = idx - l * P;
          if (l < tl) yc[static_cast<int64_t>(l0 + l) * P + p] = acc[e];
        }
      }
      __syncthreads();  // c_s and acl are reloaded by the next tile
    }

    // -- state update: h = h_prev exp(a_last) + (B o decay)^T X -------------
    float hacc[kMaxAcc];
#pragma unroll
    for (int e = 0; e < kMaxAcc; ++e) hacc[e] = 0.f;
    for (int s0 = 0; s0 < Q; s0 += kT) {
      const int ts = min(kT, Q - s0);
      __syncthreads();
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N;
        const int n = i - r * N;
        b_s[r * NP1 + n] =
            r < ts ? bc[static_cast<int64_t>(s0 + r) * N + n] *
                         expf(a_last - ws[s0 + r])
                   : 0.f;
      }
      for (int i = tid; i < kT * P; i += kThreads) {
        const int r = i / P;
        const int p = i - r * P;
        x_s[i] = r < ts ? xc[static_cast<int64_t>(s0 + r) * P + p] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kMaxAcc; ++e) {
        const int idx = tid + e * kThreads;
        if (idx < N * P) {
          const int n = idx / P;
          const int p = idx - n * P;
          float s = 0.f;
          for (int j = 0; j < kT; ++j) {
            s = fmaf(b_s[j * NP1 + n], x_s[j * P + p], s);
          }
          hacc[e] += s;
        }
      }
    }
    const float dec = expf(a_last);
    // each thread updates only the state elements it accumulated, and every
    // reader of h_prev (the readouts above) finished before the last barrier
#pragma unroll
    for (int e = 0; e < kMaxAcc; ++e) {
      const int idx = tid + e * kThreads;
      if (idx < N * P) h_s[idx] = h_s[idx] * dec + hacc[e];
    }
  }
  __syncthreads();
  float* hf = hfin + bh * N * P;
  for (int i = tid; i < N * P; i += kThreads) hf[i] = h_s[i];
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) *
         (static_cast<size_t>(N) * P + 2 * kT * (N + 1) + kT * P +
          kT * (kT + 1) + 2 * kT);
}

}  // namespace

extern "C" int ssd_chunk_scan_f32(const void* x, const void* a, const void* b,
                                  const void* c, void* y, void* hfin,
                                  void* acum_ws, int bh, int nc, int Q, int P,
                                  int N, void* stream) {
  if (bh <= 0 || nc <= 0 || Q <= 0 || P <= 0 || N <= 0 ||
      kT * P > kMaxAcc * kThreads || N * P > kMaxAcc * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<<<bh, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), static_cast<float*>(hfin),
      static_cast<float*>(acum_ws), nc, Q, P, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
