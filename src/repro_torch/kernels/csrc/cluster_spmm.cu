// Cluster-wise SpMM C = A_bcc @ B (B dense, tall-skinny), hand-written for
// Hopper (sm_90a), IEEE fp32 on the CUDA cores. Two kernels:
//
//  * spmm_columns_kernel (entry point cluster_spmm_columns) replaces the
//    TPU kernel src/repro/kernels/cluster_spmm.py::cluster_spmm_compact,
//    whose grid (N / bn, S) added A_slab[s] @ B[tile_ids[s] * block_k :
//    +block_k, j * bn : +bn] into C[blk] over the compact (block, tile)
//    stream and zeroed the accumulator when the block id changed along the
//    serial S axis;
//  * spmm_panel_kernel (entry point cluster_spmm_padded) replaces
//    src/repro/kernels/cluster_spmm.py::cluster_spmm, the padded grid
//    (N / bn, nblocks, tiles_per_block): every block visits all of its
//    tiles_per_block slabs, and the pad slabs (zero, pointing at tile 0) are
//    summed like the others, as on the TPU.
//
// Each CTA writes its part of C once, walking each block's slabs in order
// (the TPU's serial axis becomes a loop inside the block): the compact
// kernel one (row block, column strip of bn <= 128), the panel kernel a
// panel of up to 8 consecutive row blocks and one column strip. A compact
// stream built for the kernel has every block (empty blocks carry one zero
// slab); the compact wrapper zero-fills C all the same, for a block a
// stream leaves out. Rows of B past K and columns past N are masked, so
// ragged shapes need no padded copy of B.
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
//
// spmm_panel_kernel, the padded lattice. On SparseLinear's padded path (a
// 2560 x 10240 weight at density 0.1, 4096 tokens, dense slabs) the
// product's own 21.5 GFLOP bound it at ~0.32 ms at 67 TFLOP/s fp32 (the
// padded lattice's 26.8 GFLOP: 0.40 ms). CTAs that each stage their own
// block's B tiles read 6.7 GB of B for the layer's 168 MB, about 3 flop a
// byte (~2 ms at 3.35 TB/s). The paper's cluster-wise computation is the
// cure: rows that share B tiles share the reads. Clustering leaves every block
// of the layer naming one of 16 tile sets (interleaved along the lattice,
// not in runs), so the host orders the blocks by their tile lists and
// cuts panels of up to 8 where the lists stop agreeing (kernels/
// cluster_spmm.py::spmm_panels, built once per weight), listing, per
// (panel, slot), the distinct tiles its blocks name and which blocks name
// each (an entry). One CTA takes a panel and a column strip of up to
// 128, warp w owning the panel's block w: its 8 rows, each lane 8 rows x
// 4 columns in fp32 registers. It walks the entries in slot order and,
// for each, the 64-row sub-tiles of the tile: B's sub-tile (64 x 128,
// staged in B's dtype) and the entry's blocks' 8 x 64 A sub-slabs go to
// shared memory with cp.async, double buffered with one barrier a stage,
// the next stage in flight while the warps whose block names the tile
// compute (a skip uniform across each warp). So each B sub-tile is read
// once for the panel, not once per block: ~6.7 GB x (entries per panel
// slot) / (blocks per panel), which the smoke run prints. Each output's
// part is the fmaf chain over k ascending of its block's slab at that
// slot, and acc = acc_add<TB>(acc, part) in slot order, the TPU kernel's
// order, so sums of integers stay exact and 16-bit B rounds as the plain
// version does. Nothing is skipped: pad
// slabs and dead columns are multiplied like the rest, so a non-finite
// value in B's tile 0 or under a dead column still gives NaN, as the
// whole-slab product does. A block that shares its tiles with no other is
// a panel of one: a CTA with one working warp. What bounds it now is the
// FMA issue and the shared-memory loads that feed it (12 loads for 128
// FMAs a lane) and the staging's own instructions, which a stage whose
// rows and columns are all inside B issues without masks. PERF.md has the
// measured times.
//
// Non-finite B values. The TPU kernel multiplies whole (8, block_k) slabs,
// so a dead column k of a slab (all 8 values zero) still meets B's row k,
// and 0 * inf is NaN. The walk skips dead columns, so
// cluster_spmm_columns runs nonfinite.cuh's census first: a memset of the
// flag and the per-k-tile marks, mark_tiles_kernel (the k-tiles some slab
// with a dead column covers: SparseLinear's layer has one of 80),
// count_kernel (their non-finite values per column), then
// spmm_columns_kernel, whose CTAs read the flag once after the walk and,
// when it is raised, walk their block's slabs again with dead_hits and add
// NaN where a dead column met a non-finite value. So the kernel gives the
// TPU kernel's NaN positions and inf signs, and its finite values.
//
// 16-bit B. With B in bf16 or fp16 the TPU kernels give C in B's dtype and
// add each step's fp32 product to it rounded, o += dot(...).astype(o.dtype).
// Both kernels take such a B (entry points' dtype 1 = bf16, 2 = fp16) and
// do the same: B is loaded in 16 bits (half the bytes) and widened, each
// step's part is summed in fp32 as before, rounded to B's dtype and added
// to the running C, which is rounded again after every add, in step order
// (live_columns.cuh's acc_add); C is stored in B's dtype. Rounding after
// every step is not associative, so the order is that of the fp32 path:
// the panel kernel adds each slot's part in slot order; the live-column
// walk keeps each step's fp32 part apart and group 0 adds the parts in
// step order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "live_columns.cuh"
#include "nonfinite.cuh"

namespace {

constexpr int kBNMax = 128;
using live_columns::kRows;                    // block_r
constexpr int kPanelWarps = 8;                // blocks of a panel, a warp each
constexpr int kPanelThreads = 32 * kPanelWarps;
constexpr int kKS = 64;                       // k rows of a stage
constexpr int kStages = 2;                    // stages in the ring

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// 16 bytes of T at dst (shared) from src: the first n values valid, the
// rest zero. One cp.async when all are valid and the rows are 16-byte
// aligned (vec); otherwise plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage16(T* dst, const T* src, int n,
                                        bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec && n == E) {
    cp_async16(dst, src);
  } else if (n <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dst[e] = e < n ? src[e] : dtypes::from_float<T>(0.f);
    }
  }
}

// Four consecutive values of a staged B row, widened to fp32.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int v = 0; v < 4; ++v) o[v] = dtypes::to_float(h[v]);
}

// A lane's running sums, 8 rows x 4 columns, each updated after a slot as
// acc = acc_add<TB>(acc, part): fp32 sums in fp32 registers; a 16-bit sum,
// rounded to B's dtype after every add, is held as it is, two to a 32-bit
// register (T2, the 16-bit pair type), which keeps the 16-bit kernels
// inside their register budget.
template <typename TB>
struct RowSums {
  float v[kRows][4];
  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[r][c] = 0.f;
  }
  __device__ void add(int r, const float (&part)[4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[r][c] = live_columns::acc_add<TB>(v[r][c], part[c]);
    }
  }
  __device__ float get(int r, int c) const { return v[r][c]; }
};

__device__ __forceinline__ __nv_bfloat162 pack2(float lo, float hi,
                                                __nv_bfloat162) {
  return __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ __half2 pack2(float lo, float hi, __half2) {
  return __floats2half2_rn(lo, hi);
}

template <typename TB, typename T2>
struct PackedSums {
  T2 v[kRows][2];
  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) v[r][h] = pack2(0.f, 0.f, T2());
  }
  __device__ void add(int r, const float (&part)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lo = live_columns::acc_add<TB>(__low2float(v[r][h]),
                                                 part[2 * h]);
      const float hi = live_columns::acc_add<TB>(__high2float(v[r][h]),
                                                 part[2 * h + 1]);
      v[r][h] = pack2(lo, hi, T2());  // exact: both are TB values
    }
  }
  __device__ float get(int r, int c) const {
    return c % 2 ? __high2float(v[r][c / 2]) : __low2float(v[r][c / 2]);
  }
};

template <>
struct RowSums<__nv_bfloat16> : PackedSums<__nv_bfloat16, __nv_bfloat162> {};
template <>
struct RowSums<__half> : PackedSums<__half, __half2> {};

template <typename TB>
constexpr int panel_smem_bytes() {
  return kStages * kKS * kBNMax * static_cast<int>(sizeof(TB)) +
         kStages * kPanelWarps * kRows * kKS *
             static_cast<int>(sizeof(float));
}

// CTA (panel, strip): blocks[panel_ptr[panel] .. panel_ptr[panel + 1]]
// (one warp each, in that order), columns strip * bn .. + bn. The panel's
// entries of slot t are entry_ptr[panel * tiles_per_block + t] .. [+1],
// each (tile, slot, mask of the panel's blocks whose slab at the slot
// names the tile); the entries of consecutive slots are consecutive, so
// the CTA walks entry_ptr[panel * tiles_per_block] .. entry_ptr[(panel +
// 1) * tiles_per_block] in order, ceil(block_k / kKS) stages per entry.
// B and C are TB (fp32, bf16 or fp16).
template <typename TB>
__global__ void __launch_bounds__(kPanelThreads, 2)
spmm_panel_kernel(const int32_t* __restrict__ blocks,
                  const int32_t* __restrict__ panel_ptr,
                  const int32_t* __restrict__ entry_ptr,
                  const int32_t* __restrict__ entries,
                  const float* __restrict__ a_values,
                  const TB* __restrict__ b, TB* __restrict__ out,
                  int tiles_per_block, int block_k, int K, int N, int bn,
                  int b_vec, int a_vec, int out_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the ring: [kStages][kKS][128] B values, [kStages][warps][kRows][kKS]
  // A values
  TB* b_s = reinterpret_cast<TB*>(smem);
  float* a_s = reinterpret_cast<float*>(
      smem + kStages * kKS * kBNMax * sizeof(TB));
  const int panel = blockIdx.x;
  const int col0 = blockIdx.y * bn;
  const int width = min(bn, N - col0);
  const int p0 = panel_ptr[panel];
  const int nblk = panel_ptr[panel + 1] - p0;
  __shared__ int blk_s[kPanelWarps];  // the panel's blocks, a warp each
  if (threadIdx.x < nblk) blk_s[threadIdx.x] = blocks[p0 + threadIdx.x];
  __syncthreads();
  const int e0 = entry_ptr[panel * tiles_per_block];
  const int nk = (block_k + kKS - 1) / kKS;
  const int nstages =
      (entry_ptr[(panel + 1) * tiles_per_block] - e0) * nk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // stage i: entry ei, rows kc * kKS .. of its tile (i = (ei - e0) * nk +
  // kc), into buffer i % kStages
  const auto issue = [&](int i, int ei, int kc) {
    const int32_t* e = entries + 3 * static_cast<int64_t>(ei);
    const int tile = e[0], slot = e[1], mask = e[2];
    const int k0 = kc * kKS;
    const int kt = min(kKS, block_k - k0);
    TB* bs = b_s + (i % kStages) * kKS * kBNMax;
    float* as = a_s + (i % kStages) * kPanelWarps * kRows * kKS;
    constexpr int EB = 16 / sizeof(TB);
    constexpr int CB = kBNMax / EB;          // 16-byte chunks of a B row
    constexpr int CA = kKS / 4;              // 16-byte chunks of an A row
    const int64_t row0 = static_cast<int64_t>(tile) * block_k + k0;
    const TB* bsrc = b + row0 * N + col0;
    // a stage inside B on all sides: every chunk a cp.async, no masks,
    // the A sub-slabs of all the panel's blocks
    if (kt == kKS && row0 + kKS <= K && width == kBNMax && b_vec && a_vec) {
      for (int q = threadIdx.x; q < kKS * CB; q += kPanelThreads) {
        const int r = q / CB;
        const int c = (q % CB) * EB;
        cp_async16(bs + r * kBNMax + c, bsrc + static_cast<int64_t>(r) * N + c);
      }
      for (int q = threadIdx.x; q < nblk * kRows * CA; q += kPanelThreads) {
        const int w = q / (kRows * CA);
        const int r = (q / CA) % kRows;
        const int c = (q % CA) * 4;
        cp_async16(as + (w * kRows + r) * kKS + c,
                   a_values + ((static_cast<int64_t>(blk_s[w]) *
                                    tiles_per_block + slot) * kRows + r) *
                                  block_k + k0 + c);
      }
      return;
    }
    for (int q = threadIdx.x; q < kKS * CB; q += kPanelThreads) {
      const int r = q / CB;
      const int c = (q % CB) * EB;
      const int n = (r < kt && row0 + r < K) ? min(EB, width - c) : 0;
      stage16(bs + r * kBNMax + c, bsrc + static_cast<int64_t>(r) * N + c, n,
              b_vec);
    }
    for (int q = threadIdx.x; q < nblk * kRows * CA; q += kPanelThreads) {
      const int w = q / (kRows * CA);
      if (((mask >> w) & 1) == 0) continue;
      const int r = (q / CA) % kRows;
      const int c = (q % CA) * 4;
      const float* src =
          a_values +
          ((static_cast<int64_t>(blk_s[w]) * tiles_per_block + slot) * kRows +
           r) * block_k + k0 + c;
      stage16(as + (w * kRows + r) * kKS + c, src, min(4, kt - c), a_vec);
    }
  };

  RowSums<TB> acc;
  acc.zero();
  float part[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[r][c] = 0.f;
  // stage i = (entry ce, k chunk ckc); stage i + 1 is issued while stage
  // i is computed: one barrier a stage, past which every warp is done with
  // stage i - 1, whose buffer stage i + 1 refills
  int ce = e0, ckc = 0;
  if (nstages > 0) issue(0, e0, 0);
  cp_async_commit();
  for (int i = 0; i < nstages; ++i) {
    cp_async_wait_all();  // stage i has landed
    __syncthreads();
    const bool last_k = ckc == nk - 1;
    if (i + 1 < nstages) {
      issue(i + 1, last_k ? ce + 1 : ce, last_k ? 0 : ckc + 1);
    }
    cp_async_commit();
    const int mask = entries[3 * static_cast<int64_t>(ce) + 2];
    const int kc = ckc;
    ce += last_k;
    ckc = last_k ? 0 : ckc + 1;
    if (warp >= nblk || ((mask >> warp) & 1) == 0) continue;
    const int kt = min(kKS, block_k - kc * kKS);
    const TB* bs = b_s + (i % kStages) * kKS * kBNMax + lane * 4;
    const float* as =
        a_s + ((i % kStages) * kPanelWarps + warp) * kRows * kKS;
    // past kt both sub-tiles hold zeros, so k runs in steps of 4
    for (int k = 0; k < kt; k += 4) {
      float bv[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load4(bs + (k + kk) * kBNMax, bv[kk]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(as + r * kKS + k);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          part[r][c] = fmaf(a.x, bv[0][c], part[r][c]);
          part[r][c] = fmaf(a.y, bv[1][c], part[r][c]);
          part[r][c] = fmaf(a.z, bv[2][c], part[r][c]);
          part[r][c] = fmaf(a.w, bv[3][c], part[r][c]);
        }
      }
    }
    if (kc == nk - 1) {  // this block's slab at the slot is summed
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc.add(r, part[r]);
#pragma unroll
        for (int c = 0; c < 4; ++c) part[r][c] = 0.f;
      }
    }
  }
  if (warp >= nblk) return;
  const int c = lane * 4;
  TB* o = out + static_cast<int64_t>(blk_s[warp]) * kRows * N + col0 + c;
  float sums[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < 4; ++v) sums[r][v] = acc.get(r, v);
  if (out_vec && c + 4 <= width) {
    live_columns::store_rows<4>(o, N, sums);
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (c + v < width) {
          o[static_cast<int64_t>(r) * N + v] =
              dtypes::from_float<TB>(sums[r][v]);
        }
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
      const int64_t row0 = static_cast<int64_t>(tile) * block_k;
      nonfinite::dead_hits<TB, V>(
          c0, c1, col_k, counts + static_cast<int64_t>(tile) * N + col0 + c,
          strip + row0 * N, N, K - row0, hit);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (hit[v]) acc[r][v] += nonfinite::nan_value();
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
    nonfinite::mark_tiles_kernel<<<(nsteps + 255) / 256, 256, 0, s>>>(
        static_cast<const int32_t*>(tile_ids),
        static_cast<const int32_t*>(col_ptr), nsteps, block_k, ntiles,
        flag + 1);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc == 0) {
      rc = nonfinite::count_tiles<TB>(bt, K, N, block_k, nullptr, flag + 1,
                                      ntiles, static_cast<int32_t*>(counts),
                                      flag, s);
    }
    if (rc != 0) return rc;
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

namespace {

template <typename TB>
int launch_panels(const void* blocks, const void* panel_ptr,
                  const void* entry_ptr, const void* entries,
                  const void* a_values, const void* b, void* out,
                  int npanels, int tiles_per_block, int block_k, int K, int N,
                  int bn, cudaStream_t s) {
  constexpr int bytes = panel_smem_bytes<TB>();
  const auto kernel = spmm_panel_kernel<TB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const size_t esize = sizeof(TB);
  const int b_vec = (N * esize) % 16 == 0 && (bn * esize) % 16 == 0 &&
                    aligned(b, 16);
  const int a_vec = block_k % 4 == 0 && aligned(a_values, 16);
  const int out_vec = N % 4 == 0 && bn % 4 == 0 && aligned(out, 4 * esize);
  const dim3 grid(npanels, (N + bn - 1) / bn);
  kernel<<<grid, kPanelThreads, bytes, s>>>(
      static_cast<const int32_t*>(blocks),
      static_cast<const int32_t*>(panel_ptr),
      static_cast<const int32_t*>(entry_ptr),
      static_cast<const int32_t*>(entries),
      static_cast<const float*>(a_values), static_cast<const TB*>(b),
      static_cast<TB*>(out), tiles_per_block, block_k, K, N, bn, b_vec,
      a_vec, out_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The padded lattice by panels (spmm_panel_kernel), in column strips of
// bn; B's dtype: 0 fp32, 1 bf16, 2 fp16 (C in the same dtype).
extern "C" int cluster_spmm_padded(const void* blocks,
                                   const void* panel_ptr,
                                   const void* entry_ptr,
                                   const void* entries,
                                   const void* a_values, const void* b,
                                   void* out, int npanels,
                                   int tiles_per_block, int block_k, int K,
                                   int N, int bn, int dtype,
                                   void* stream) {
  if (npanels <= 0 || tiles_per_block <= 0 || block_k <= 0 || K < 0 ||
      N <= 0 || bn <= 0 || bn > kBNMax || (N + bn - 1) / bn > 65535 ||
      dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto launch) {
    return launch(blocks, panel_ptr, entry_ptr, entries, a_values, b, out,
                  npanels, tiles_per_block, block_k, K, N, bn, s);
  };
  if (dtype == 1) return go(launch_panels<__nv_bfloat16>);
  if (dtype == 2) return go(launch_panels<__half>);
  return go(launch_panels<float>);
}

extern "C" const char* cluster_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
