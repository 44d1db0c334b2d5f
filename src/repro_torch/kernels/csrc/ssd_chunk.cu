// Mamba2 SSD chunk scan, hand-written for Hopper (sm_90a), IEEE fp32 on the
// CUDA cores, as a chunk-parallel scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py::ssd_chunk_scan,
// whose grid (B*H, n_chunks) kept the (N, P) state in a VMEM scratch that
// persisted along the serial chunk axis and did, per (bh, chunk):
//   L      = exp(segsum(a))                 (Q, Q), lower triangle
//   y      = ((C B^T) o L) X + exp(a_cum) o (C h_prev)
//   h_new  = h_prev exp(a_cum[-1]) + (B o exp(a_cum[-1] - a_cum))^T X
// with x (BH, nc, Q, P), a (BH, nc, Q), b/c (BG, nc, Q, N) already
// dt-discretised by the wrapper (BG = BH / heads_per_group: head bh reads
// group bh / heads_per_group), y like x and the final state (BH, N, P).
//
// Design. Only the state carries from one chunk to the next, and it enters
// y through one (Q, N) x (N, P) product; everything else in a chunk is
// independent of the other chunks. So the scan runs as the model's own
// chunked form does (models/mamba2.py::ssd_chunked), in launches on one
// stream, each parallel over chunks:
//  0. ssd_chunk_scores_kernel (only when heads share a group): C B^T of
//     every (group, chunk) on its lower-triangle 64 x 64 tile pairs, into
//     a workspace the group's heads all read (at zamba2-2.7b's shape, one
//     group for 80 heads, 2.6 MB that stay in L2), instead of 80 copies;
//  1. ssd_chunk_states_kernel, per (bh, chunk): a_cum (a warp scan, kept
//     in a workspace for the passes after it) and the chunk's own state
//     S_c = (B o exp(a_cum[-1] - a_cum))^T X;
//  2. ssd_chunk_recur_kernel, per (bh, element of N x P): the recurrence
//     h_c = h_{c-1} exp(a_cum_c[-1]) + S_c in chunk order, writing each
//     chunk's h_prev over its S_c, and the final state;
//  3. ssd_chunk_out_kernel, per (bh, chunk, 64-row output tile), heaviest
//     tiles first: acc = exp(a_cum) o (C h_prev), then for each source
//     tile at or below the diagonal, acc += ((C B^T) o exp(a_cum[l] -
//     a_cum[s]))_{l >= s} X. exp is evaluated only where l >= s (above the
//     diagonal it could overflow).
//
// Inside each pass the products are register-blocked for the FMA pipe: 256
// threads as 16 row groups x 16 column groups, a thread owning a 4 x 4
// micro-tile of a 64 x 64 block (4 x 4 * PV of a 64 x P output), fed by
// float4 loads from shared rows padded so that the rows a quarter-warp
// reads fall in distinct banks: 8 loads per 64 FMAs. Tiles arrive by
// cp.async (16-byte copies when N and P are multiples of 4 and the bases
// are aligned, 4-byte ones otherwise; rows past Q are zero-filled by the
// copy); the output pass double-buffers its source tiles. Any Q works,
// including the single ragged chunk the model falls back to (Q = 300) and
// Q = 1: rows past Q are zero and never stored.
//
// What bounds it: on the zamba2-2.7b prefill (BH = 320, nc = 4, Q = 256,
// P = N = 64) the work is ~16 GFLOP of fp32 FMAs against ~0.34 GB of
// operands, so the card's bound is operations (~0.24 ms at 67 TFLOP/s);
// sharing C B^T over a group's heads removes a third of it. PERF.md has the
// measured times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows of a tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kST = kT + 4;     // row stride of a transposed score tile
constexpr long long kMaxSmem = 232448;  // dynamic shared memory per CTA

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

// Rows row0 .. row0 + 63 of a (rows, W) row-major matrix into shared rows
// `ld` floats apart, columns 0 .. W-1; rows at or past `rows` are zero.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int row0,
                                          int rows, int W, bool vec) {
  const int step = vec ? 4 : 1;
  const int per_row = W / step;
  for (int i = threadIdx.x; i < kT * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * step;
    const bool in = row0 + r < rows;
    const float* g = src + static_cast<int64_t>(in ? row0 + r : 0) * W + c;
    cp_async(dst + r * ld + c, g, in, vec);
  }
}

// Entries row0 .. row0 + 63 of a vector into shared memory; past `n`, zero.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int n) {
  if (threadIdx.x < kT) {
    const int r = threadIdx.x;
    const bool in = row0 + r < n;
    cp_async(dst + r, src + (in ? row0 + r : 0), in, false);
  }
}

__device__ __forceinline__ void zero_smem(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

// s[i][t] += sum_k A[(rg*4+i) * lda + k] * B[(cg+16t) * ldb + k], k < K
// (K a multiple of 4): rows of both operands read as float4s along k.
__device__ __forceinline__ void tile_abt(const float* A, int lda,
                                         const float* B, int ldb, int K,
                                         int rg, int cg, float (&s)[4][4]) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (rg * 4 + i) * lda + k);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      b[t] = *reinterpret_cast<const float4*>(B + (cg + 16 * t) * ldb + k);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        s[i][t] = fmaf(a[i].x, b[t].x, s[i][t]);
        s[i][t] = fmaf(a[i].y, b[t].y, s[i][t]);
        s[i][t] = fmaf(a[i].z, b[t].z, s[i][t]);
        s[i][t] = fmaf(a[i].w, b[t].w, s[i][t]);
      }
  }
}

// The columns of a 64 x (64 PV) output a thread owns: c * 64 + cg * 4 + e.
template <int PV>
__device__ __forceinline__ void fma_row(const float (&av)[4], const float* br,
                                        int cg, float (&acc)[4][4 * PV]) {
#pragma unroll
  for (int c = 0; c < PV; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(br + c * 64 + cg * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][c * 4 + 0] = fmaf(av[i], b.x, acc[i][c * 4 + 0]);
      acc[i][c * 4 + 1] = fmaf(av[i], b.y, acc[i][c * 4 + 1]);
      acc[i][c * 4 + 2] = fmaf(av[i], b.z, acc[i][c * 4 + 2]);
      acc[i][c * 4 + 3] = fmaf(av[i], b.w, acc[i][c * 4 + 3]);
    }
  }
}

// acc[i][..] += sum_k At[k * lda + rg*4 + i] * B[k * ldb + ..], k < K:
// one float4 of At's row k (this thread's 4 rows) per row of B.
template <int PV>
__device__ __forceinline__ void tile_atb(const float* At, int lda,
                                         const float* B, int ldb, int K,
                                         int rg, int cg,
                                         float (&acc)[4][4 * PV]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(At + k * lda + rg * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    fma_row<PV>(av, B + k * ldb, cg, acc);
  }
}

// acc[i][..] += sum_k A[(rg*4+i) * lda + k] * B[k * ldb + ..], k < K (a
// multiple of 4): four float4s of A (4 rows x 4 k) per 4 rows of B.
template <int PV>
__device__ __forceinline__ void tile_ab(const float* A, int lda,
                                        const float* B, int ldb, int K,
                                        int rg, int cg,
                                        float (&acc)[4][4 * PV]) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (rg * 4 + i) * lda + k);
    }
    const float a0[4] = {a[0].x, a[1].x, a[2].x, a[3].x};
    const float a1[4] = {a[0].y, a[1].y, a[2].y, a[3].y};
    const float a2[4] = {a[0].z, a[1].z, a[2].z, a[3].z};
    const float a3[4] = {a[0].w, a[1].w, a[2].w, a[3].w};
    fma_row<PV>(a0, B + (k + 0) * ldb, cg, acc);
    fma_row<PV>(a1, B + (k + 1) * ldb, cg, acc);
    fma_row<PV>(a2, B + (k + 2) * ldb, cg, acc);
    fma_row<PV>(a3, B + (k + 3) * ldb, cg, acc);
  }
}

// Row stride of a (64, N) tile: N rounded up to 8, plus 4, so that
// stride / 4 is odd and 8 rows read at one column fall in distinct banks.
__host__ __device__ __forceinline__ int row_stride(int N) {
  return (N + 7) / 8 * 8 + 4;
}

// Pass 0: raw C B^T of one (group, chunk, lower-triangle tile pair (lt, st))
// into ws[((g * nc + c) * npairs + pair) * 4096 + tid * 16], in the layout
// each thread of the output pass reads back: its 4 x 4 micro-tile.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scores_kernel(const float* __restrict__ b,
                        const float* __restrict__ c,
                        float* __restrict__ ws, int nc, int Q, int N,
                        int npairs, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(N);
  float* c_s = smem;
  float* b_s = c_s + kT * ld;
  const int pair = blockIdx.x;
  const int ci = blockIdx.y;
  const int64_t gc = static_cast<int64_t>(blockIdx.z) * nc + ci;
  int lt = 0;
  while ((lt + 1) * (lt + 2) / 2 <= pair) ++lt;
  const int st = pair - lt * (lt + 1) / 2;
  zero_smem(smem, 2 * kT * ld);
  __syncthreads();
  const int64_t row0 = gc * Q;
  load_rows(c_s, ld, c + row0 * N, lt * kT, Q, N, vec);
  load_rows(b_s, ld, b + row0 * N, st * kT, Q, N, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float s[4][4] = {};
  tile_abt(c_s, ld, b_s, ld, (N + 7) / 8 * 8, rg, cg, s);
  float4* out = reinterpret_cast<float4*>(
      ws + ((gc * npairs + pair) * kThreads + threadIdx.x) * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
  }
}

// Pass 1: per (bh, chunk), a_cum into acum (BH, nc, Q) and the chunk's own
// state S_c (N, P) into states (BH, nc, N, P).
template <int PV>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_states_kernel(const float* __restrict__ x,
                        const float* __restrict__ a,
                        const float* __restrict__ b,
                        float* __restrict__ acum, float* __restrict__ states,
                        int nc, int Q, int P, int N, int rep, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kPp = 64 * PV;
  const int nb_count = (N + kT - 1) / kT;
  const int ld = nb_count * kT + 4;   // B rows, every 64-column block whole
  float* b_s = smem;                  // (64, ld) B rows, then B o decay
  float* x_s = b_s + kT * ld;         // (64, kPp) X rows
  float* w_s = x_s + kT * kPp;        // (64) decay of each row
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int64_t bc = static_cast<int64_t>(blockIdx.x) * nc + blockIdx.y;
  const int64_t gc = static_cast<int64_t>(blockIdx.x / rep) * nc +
                     blockIdx.y;
  const float* ac = a + bc * Q;
  float* ws = acum + bc * Q;
  const float* xc = x + bc * Q * P;
  const float* bcp = b + gc * Q * N;

  // a_cum: warp 0 scans the chunk, 32 steps at a time
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
  zero_smem(smem, kT * ld + kT * kPp);
  __syncthreads();
  const float a_last = ws[Q - 1];

  for (int nb = 0; nb < nb_count; ++nb) {
    float acc[4][4 * PV] = {};
    for (int q0 = 0; q0 < Q; q0 += kT) {
      __syncthreads();  // the previous tile's readers are done
      load_rows(b_s, ld, bcp, q0, Q, N, vec);
      load_rows(x_s, kPp, xc, q0, Q, P, vec);
      cp_async_commit();
      if (tid < kT) {
        w_s[tid] = q0 + tid < Q ? expf(a_last - ws[q0 + tid]) : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N;
        const int n = i - r * N;
        b_s[r * ld + n] *= w_s[r];
      }
      __syncthreads();
      tile_atb<PV>(b_s + nb * kT, ld, x_s, kPp, min(kT, Q - q0), rg, cg,
                   acc);
    }
    float* out = states + bc * N * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = nb * kT + rg * 4 + i;
      if (n >= N) continue;
#pragma unroll
      for (int cidx = 0; cidx < 4 * PV; ++cidx) {
        const int p = (cidx / 4) * 64 + cg * 4 + (cidx % 4);
        if (p < P) out[static_cast<int64_t>(n) * P + p] = acc[i][cidx];
      }
    }
  }
}

// Pass 2: the inter-chunk recurrence, elementwise in (bh, n, p): h_prev of
// each chunk over its S_c, the final state into hfin.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_recur_kernel(float* __restrict__ states,
                       const float* __restrict__ acum,
                       float* __restrict__ hfin, int nc, int Q, int NP) {
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int64_t bh = blockIdx.x;
  float h = 0.f;
  for (int ci = 0; ci < nc; ++ci) {
    float* sp = states + (bh * nc + ci) * NP + e;
    const float s = *sp;
    *sp = h;
    h = h * expf(acum[(bh * nc + ci) * Q + Q - 1]) + s;
  }
  hfin[bh * NP + e] = h;
}

// Pass 3: the output tile lt of (bh, chunk). SHARED: the raw scores come
// from pass 0's workspace, else from C and B here.
template <int PV, bool SHARED>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_out_kernel(const float* __restrict__ x,
                     const float* __restrict__ b,
                     const float* __restrict__ c,
                     const float* __restrict__ acum,
                     const float* __restrict__ hprev,
                     const float* __restrict__ scores,
                     float* __restrict__ y, int nc, int Q, int P, int N,
                     int rep, int npairs, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kPp = 64 * PV;
  const int ld = row_stride(N);
  const int K8 = (N + 7) / 8 * 8;
  const int usz = max(kT * kST, K8 * kPp);
  float* c_s = smem;                          // (64, ld) C rows, l-tile
  float* x_s = c_s + kT * ld;                 // 2 x (64, kPp) X rows
  float* u_s = x_s + 2 * kT * kPp;            // h_prev (K8, kPp), then S^T
  float* acl = u_s + usz;                     // (64) a_cum of the l-tile
  float* acs = acl + kT;                      // 2 x (64) a_cum, s-tiles
  float* b_s = acs + 2 * kT;                  // 2 x (64, ld) B rows
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int64_t bh = blockIdx.x;
  const int ci = blockIdx.y;
  const int lt = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int l0 = lt * kT;
  const int64_t bc = bh * nc + ci;
  const int64_t gc = (bh / rep) * nc + ci;
  const float* xc = x + bc * Q * P;
  const float* ac = acum + bc * Q;
  const float* bcp = b + gc * Q * N;

  zero_smem(smem,
            kT * ld + 2 * kT * kPp + usz + 3 * kT + (SHARED ? 0 : 2 * kT * ld));
  __syncthreads();
  load_rows(c_s, ld, c + gc * Q * N, l0, Q, N, vec);
  {  // h_prev (N, P) of this chunk into u_s
    const float* hp = hprev + bc * N * P;
    const int step = vec ? 4 : 1;
    const int per_row = P / step;
    for (int i = tid; i < N * per_row; i += kThreads) {
      const int r = i / per_row;
      const int col = (i - r * per_row) * step;
      cp_async(u_s + r * kPp + col, hp + static_cast<int64_t>(r) * P + col,
               true, vec);
    }
  }
  load_vec(acl, ac, l0, Q);
  if (!SHARED) load_rows(b_s, ld, bcp, 0, Q, N, vec);
  load_rows(x_s, kPp, xc, 0, Q, P, vec);
  load_vec(acs, ac, 0, Q);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // inter-chunk readout: exp(a_cum[l]) o (C h_prev)
  float acc[4][4 * PV] = {};
  tile_ab<PV>(c_s, ld, u_s, kPp, K8, rg, cg, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float e = expf(acl[rg * 4 + i]);
#pragma unroll
    for (int j = 0; j < 4 * PV; ++j) acc[i][j] *= e;
  }
  __syncthreads();  // u_s is overwritten by the score tiles below

  for (int st = 0; st <= lt; ++st) {
    const int buf = st & 1;
    const int s0 = st * kT;
    if (st < lt) {  // the next source tile into the other buffers
      const int nb = buf ^ 1;
      if (!SHARED) load_rows(b_s + nb * kT * ld, ld, bcp, s0 + kT, Q, N, vec);
      load_rows(x_s + nb * kT * kPp, kPp, xc, s0 + kT, Q, P, vec);
      load_vec(acs + nb * kT, ac, s0 + kT, Q);
    }
    cp_async_commit();

    float s[4][4] = {};
    if (SHARED) {
      const float4* sp = reinterpret_cast<const float4*>(
          scores + ((gc * npairs + lt * (lt + 1) / 2 + st) * kThreads + tid) *
                       16);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = __ldg(sp + i);
        s[i][0] = v.x; s[i][1] = v.y; s[i][2] = v.z; s[i][3] = v.w;
      }
    } else {
      tile_abt(c_s, ld, b_s + buf * kT * ld, ld, K8, rg, cg, s);
    }
    // decay and the causal mask: exp only where l >= s
    const float* as = acs + buf * kT;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int sj = cg + 16 * t;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int li = rg * 4 + i;
        v[i] = (l0 + li >= s0 + sj && l0 + li < Q)
                   ? s[i][t] * expf(acl[li] - as[sj])
                   : 0.f;
      }
      *reinterpret_cast<float4*>(u_s + sj * kST + rg * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    tile_atb<PV>(u_s, kST, x_s + buf * kT * kPp, kPp, min(kT, Q - s0), rg,
                 cg, acc);
    cp_async_wait_all();
    __syncthreads();  // the next tile is visible; S^T's readers are done
  }

  float* yc = y + bc * Q * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + rg * 4 + i;
    if (l >= Q) continue;
    float* yr = yc + static_cast<int64_t>(l) * P;
#pragma unroll
    for (int cq = 0; cq < PV; ++cq) {
      const int p = cq * 64 + cg * 4;
      if (vec && p + 3 < P) {
        *reinterpret_cast<float4*>(yr + p) =
            make_float4(acc[i][cq * 4 + 0], acc[i][cq * 4 + 1],
                        acc[i][cq * 4 + 2], acc[i][cq * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (p + e < P) yr[p + e] = acc[i][cq * 4 + e];
        }
      }
    }
  }
}

size_t states_smem(int PV, int N) {
  const int ld = (N + kT - 1) / kT * kT + 4;
  return sizeof(float) * (static_cast<size_t>(kT) * ld + kT * 64 * PV + kT);
}

size_t out_smem(int PV, int N, bool shared) {
  const int ld = row_stride(N);
  const int K8 = (N + 7) / 8 * 8;
  const size_t usz = static_cast<size_t>(
      kT * kST > K8 * 64 * PV ? kT * kST : K8 * 64 * PV);
  return sizeof(float) * (static_cast<size_t>(kT) * ld + 2 * kT * 64 * PV +
                          usz + 3 * kT + (shared ? 0 : 2 * kT * ld));
}

// The most shared memory one CTA of the tile passes asks for (the
// wrapper's _smem_bytes says the same).
long long smem_bytes(int P, int N, int rep) {
  const int pv = P <= 64 ? 1 : 2;
  const size_t s = states_smem(pv, N);
  const size_t o = out_smem(pv, N, rep > 1);
  return static_cast<long long>(s > o ? s : o);
}

template <class K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int PV>
int launch(const float* x, const float* a, const float* b, const float* c,
           float* y, float* hfin, float* acum, float* states, float* scores,
           int bh, int nc, int Q, int P, int N, int rep, int vec,
           cudaStream_t stream) {
  const bool shared = rep > 1;
  const int ntiles = (Q + kT - 1) / kT;
  const int npairs = ntiles * (ntiles + 1) / 2;
  cudaError_t err = cudaSuccess;
  if (shared) {
    const size_t bytes = sizeof(float) * 2 * kT * row_stride(N);
    err = set_smem(ssd_chunk_scores_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_scores_kernel<<<dim3(npairs, nc, bh / rep), kThreads, bytes,
                              stream>>>(b, c, scores, nc, Q, N, npairs, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  size_t bytes = states_smem(PV, N);
  err = set_smem(ssd_chunk_states_kernel<PV>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_states_kernel<PV><<<dim3(bh, nc), kThreads, bytes, stream>>>(
      x, a, b, acum, states, nc, Q, P, N, rep, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int np = N * P;
  ssd_chunk_recur_kernel<<<dim3(bh, (np + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(states, acum, hfin, nc, Q,
                                                  np);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bytes = out_smem(PV, N, shared);
  const dim3 grid(bh, nc, ntiles);
  if (shared) {
    err = set_smem(ssd_chunk_out_kernel<PV, true>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_out_kernel<PV, true><<<grid, kThreads, bytes, stream>>>(
        x, b, c, acum, states, scores, y, nc, Q, P, N, rep, npairs, vec);
  } else {
    err = set_smem(ssd_chunk_out_kernel<PV, false>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_out_kernel<PV, false><<<grid, kThreads, bytes, stream>>>(
        x, b, c, acum, states, scores, y, nc, Q, P, N, rep, npairs, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_chunk_scan_f32(const void* x, const void* a, const void* b,
                                  const void* c, void* y, void* hfin,
                                  void* workspace, int bh, int nc, int Q,
                                  int P, int N, int rep, void* stream) {
  if (bh <= 0 || nc <= 0 || Q <= 0 || P <= 0 || N <= 0 || P > 128 ||
      N > 256 || rep <= 0 || bh % rep != 0 || bh / rep > 65535 ||
      nc > 65535 || (Q + kT - 1) / kT > 65535 ||
      smem_bytes(P, N, rep) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // the scores are read and written as float4s whatever `vec` says: the
  // workspace must be 16-byte aligned, and each region starts on 4 floats
  if (!aligned(workspace)) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto round4 = [](long long n) { return (n + 3) / 4 * 4; };
  const int vec = N % 4 == 0 && P % 4 == 0 && aligned(x) && aligned(b) &&
                  aligned(c) && aligned(y);
  float* acum = static_cast<float*>(workspace);
  float* states = acum + round4(static_cast<long long>(bh) * nc * Q);
  float* scores = states + round4(static_cast<long long>(bh) * nc * N * P);
  const auto* xf = static_cast<const float*>(x);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(c);
  auto* yf = static_cast<float*>(y);
  auto* hf = static_cast<float*>(hfin);
  auto st = static_cast<cudaStream_t>(stream);
  if (P <= 64) {
    return launch<1>(xf, af, bf, cf, yf, hf, acum, states, scores, bh, nc, Q,
                     P, N, rep, vec, st);
  }
  return launch<2>(xf, af, bf, cf, yf, hf, acum, states, scores, bh, nc, Q,
                   P, N, rep, vec, st);
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
