// The live-column walk shared by the compact SpMM kernel (cluster_spmm.cu),
// the window kernels (cluster_spgemm.cu) and the revisit kernel
// (cluster_spgemm_revisit.cu).
//
// A BCC slab is 8 rows x block_k columns, but on a sparse operand only a
// few of its columns hold a nonzero (kron-14: ~5 of 128). The host keeps,
// per slab, its live columns (col_ptr offsets, the slab-local column col_k,
// ascending, and the column's 8 values col_vals, zeros included). A CTA
// walks a sequence of "units" -- the compact stream's steps for the SpMM
// kernel, a window's live pairs for the Sp x Sp kernel -- and for every
// live column k of a unit reads one B row (the unit's band, row k, this
// CTA's column strip) and applies it to the 8 rows of the cluster: the
// reuse cluster-wise computation is for, without the padding's zero work.
//
// Threads. A group of Q threads (rounded up to whole warps) covers the
// 8 x (Q * V) output strip: thread q owns columns q*V .. q*V + V - 1 of
// all 8 rows and does 8 FMAs per B element, the column's 8 values
// broadcast from shared memory. The host picks V (4, 2 or 1: 16-, 8- or
// 4-byte fp32 loads, half that for 16-bit B) so that a strip fills a warp
// where it can (bn = 128: V = 4; bn = 64: V = 2). A CTA holds NG such
// groups. Group g computes the sum of unit base + g in registers ("part",
// k ascending -- skipping a zero column is exact, fmaf(0, b, x) == x for
// finite b); then group 0 takes the parts in unit order through shared
// memory -- into its registers (walk), or wherever the caller's add puts
// them (walk_parts: the revisit kernel's per-block strip). So every output
// keeps the order of the padded kernels' sums -- per unit k ascending,
// units ascending -- and equals them bit for bit on finite data, while a
// unit-heavy block or window (a power-law hub) runs NG units at a time.
// The host picks NG from the mean units per output tile. Where B is not
// finite, a skipped column's 0 * inf is NaN in the padded sum: each
// kernel finds those with nonfinite.cuh's census and adds the NaN.
//
// Latency. A unit has few live columns, so dependent loads, not FMAs, are
// the cost. The CTA stages the metadata of up to kMetaChunk units (column
// range, B band) into shared memory with one round of loads; each warp
// stages up to 32 columns of its unit (col_k and the 8 values) with one
// coalesced load per lane; then each thread keeps kUnroll B rows in
// flight. On an H100 (kron-14 A^2) a thread owning all 8 rows ran the
// window kernel faster than one owning 2 or 4, whose threads sharing a
// column each loaded its B element; loading a group's next batch of
// columns a batch ahead, or 8 B rows in flight, was no faster (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace live_columns {

using dtypes::from_float;
using dtypes::round_to;
using dtypes::to_float;

constexpr int kRows = 8;          // block_r
constexpr int kUnroll = 4;        // B rows in flight per thread
constexpr int kMaxGroups = 8;
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 2;     // CTAs of kMaxThreads per SM
constexpr int kMetaChunk = 128;   // units whose metadata is staged at once
constexpr int kWarpCols = 32;     // columns a warp stages at once

// A unit's metadata: its live columns c0 .. c1 and its B band.
struct Meta {
  int c0, c1, band;
};

// The unit band a thread reads: B row k of the unit is ptr + k * stride;
// rows at or past krem read as zero.
template <typename TB>
struct Band {
  const TB* ptr;
  int64_t krem;
};

template <int V>
__device__ __forceinline__ void load_b(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = x.x; o[1] = x.y;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = __ldg(p + v);
  }
}

template <int V>
__device__ __forceinline__ void load_b(const __nv_bfloat16* p,
                                       float (&o)[V]) {
  if constexpr (V == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    o[0] = __low2float(lo); o[1] = __high2float(lo);
    o[2] = __low2float(hi); o[3] = __high2float(hi);
  } else if constexpr (V == 2) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&raw);
    o[0] = __low2float(x); o[1] = __high2float(x);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = __bfloat162float(p[v]);
  }
}

template <int V>
__device__ __forceinline__ void load_b(const __half* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __half2 lo = *reinterpret_cast<const __half2*>(&raw.x);
    const __half2 hi = *reinterpret_cast<const __half2*>(&raw.y);
    o[0] = __low2float(lo); o[1] = __high2float(lo);
    o[2] = __low2float(hi); o[3] = __high2float(hi);
  } else if constexpr (V == 2) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
    const __half2 x = *reinterpret_cast<const __half2*>(&raw);
    o[0] = __low2float(x); o[1] = __high2float(x);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = __half2float(p[v]);
  }
}

// The running sum of units in TO: fp32 adds the unit's part as it is; a
// 16-bit TO rounds the part to TO, then the sum, as the TPU kernels do
// when their output block is 16-bit (o += dot(...).astype(o.dtype)).
template <typename TO>
__device__ __forceinline__ float acc_add(float acc, float part) {
  if constexpr (sizeof(TO) == sizeof(float)) {
    return acc + part;
  } else {
    return round_to<TO>(acc + round_to<TO>(part));
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = x[v];
  }
}

__device__ __forceinline__ unsigned bits16(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ unsigned bits16(__half x) {
  return __half_as_ushort(x);
}

// V values rounded to a 16-bit type, in one 8-, 4- or 2-byte store.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[V]) {
  unsigned h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = bits16(from_float<T>(x[v]));
  if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  } else if constexpr (V == 2) {
    *reinterpret_cast<unsigned*>(p) = h[0] | (h[1] << 16);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = from_float<T>(x[v]);
  }
}

inline __host__ __device__ int group_threads(int groups_q) {
  return (groups_q + 31) / 32 * 32;
}

// Where this thread sits in its CTA, and the CTA's shared memory.
struct Geometry {
  int q;        // column group: columns q*V .. q*V+V-1 of the strip
  int grp;      // unit group
  int ngroups;  // unit groups in the CTA
  bool lane_used;  // false for the threads that round a group up to warps
  Meta* meta;      // kMetaChunk units
  int* stage_k;    // kWarpCols column ids per warp
  float* stage_v;  // kWarpCols x kRows values per warp
  float* parts;    // (ngroups - 1) x kRows x width
  __device__ Geometry(int groups_q, float4* smem) {
    const int tg = group_threads(groups_q);
    grp = threadIdx.x / tg;
    const int tt = threadIdx.x - grp * tg;
    lane_used = tt < groups_q;
    q = lane_used ? tt : 0;
    ngroups = blockDim.x / tg;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    meta = reinterpret_cast<Meta*>(smem);
    stage_k = reinterpret_cast<int*>(meta + kMetaChunk);
    float* v_base = reinterpret_cast<float*>(stage_k + nwarps * kWarpCols);
    stage_k += warp * kWarpCols;
    stage_v = v_base + warp * kWarpCols * kRows;
    parts = v_base + nwarps * kWarpCols * kRows;
  }
};

// part += sum over live columns l in [c0, c1), ascending, of
// col_vals[l][r] * band row col_k[l] (all 8 rows r, this thread's V
// columns). Every lane of the warp calls it with the same unit.
template <typename TB, int V>
__device__ __forceinline__ void unit_part(
    int c0, int c1, const int32_t* __restrict__ col_k,
    const float* __restrict__ col_vals, const Band<TB>& band, int64_t stride,
    bool active, const Geometry& g, float (&part)[kRows][V]) {
  const int lane = threadIdx.x & 31;
  for (int l0 = c0; l0 < c1; l0 += kWarpCols) {
    const int n = min(kWarpCols, c1 - l0);
    __syncwarp();  // the previous batch's readers are done
    if (lane < n) {
      g.stage_k[lane] = __ldg(col_k + l0 + lane);
      const float4* src = reinterpret_cast<const float4*>(
          col_vals + static_cast<int64_t>(l0 + lane) * kRows);
      float4* dst = reinterpret_cast<float4*>(g.stage_v + lane * kRows);
      dst[0] = __ldg(src);
      dst[1] = __ldg(src + 1);
    }
    __syncwarp();
    for (int u0 = 0; u0 < n; u0 += kUnroll) {
      float bv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v) bv[u][v] = 0.f;
        if (u0 + u < n) {
          const int k = g.stage_k[u0 + u];
          if (active && k < band.krem) {
            load_b<V>(band.ptr + k * stride, bv[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u0 + u < n) {
          const float4* av4 =
              reinterpret_cast<const float4*>(g.stage_v + (u0 + u) * kRows);
          const float4 lo = av4[0], hi = av4[1];
          const float av[kRows] = {lo.x, lo.y, lo.z, lo.w,
                                   hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              part[r][v] = fmaf(av[r], bv[u][v], part[r][v]);
            }
          }
        }
      }
    }
  }
}

// Walk units u0 .. u1: stage their metadata (units.meta(u)) kMetaChunk at a
// time, then run them in rounds of ngroups -- group g takes unit b + g of
// round b, its part summed over the unit's live columns against
// band_of(meta) -- and after each round group 0 hands the round's parts to
// add(unit, part) in unit order (only group 0's threads call it).
template <typename TB, int V, class Units, class BandOf, class Add>
__device__ __forceinline__ void walk_parts(int u0, int u1, const Units& units,
                                           const BandOf& band_of,
                                           const int32_t* __restrict__ col_k,
                                           const float* __restrict__ col_vals,
                                           int64_t stride, bool active,
                                           const Geometry& g, int groups_q,
                                           const Add& add) {
  const int width = groups_q * V;
  for (int m0 = u0; m0 < u1; m0 += kMetaChunk) {
    const int mn = min(kMetaChunk, u1 - m0);
    __syncthreads();  // the previous chunk's metadata is no longer read
    for (int i = threadIdx.x; i < mn; i += blockDim.x) {
      g.meta[i] = units.meta(m0 + i);
    }
    __syncthreads();
    for (int b = 0; b < mn; b += g.ngroups) {
      const int i = b + g.grp;
      float part[kRows][V];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) part[r][v] = 0.f;
      if (i < mn) {
        const Meta m = g.meta[i];
        unit_part<TB, V>(m.c0, m.c1, col_k, col_vals, band_of(m), stride,
                         active, g, part);
      }
      if (g.ngroups == 1) {
        add(m0 + b, part);
        continue;
      }
      if (g.grp > 0 && g.lane_used) {
        float* s = g.parts + static_cast<int64_t>(g.grp - 1) * kRows * width;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          store_vec<V>(s + r * width + g.q * V, part[r]);
        }
      }
      __syncthreads();
      if (g.grp == 0) {
        add(m0 + b, part);
        const int last = min(g.ngroups, mn - b);
        for (int j = 1; j < last; ++j) {
          const float* s =
              g.parts + static_cast<int64_t>(j - 1) * kRows * width;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int v = 0; v < V; ++v)
              part[r][v] = s[r * width + g.q * V + v];
          add(m0 + b + j, part);
        }
      }
      __syncthreads();  // the next round overwrites the parts
    }
  }
}

// walk_parts into group 0's registers: acc gets the parts in unit order,
// each rounded as acc_add<TO> says (TO = float: no rounding).
template <typename TB, int V, typename TO = float, class Units, class BandOf>
__device__ __forceinline__ void walk(int u0, int u1, const Units& units,
                                     const BandOf& band_of,
                                     const int32_t* __restrict__ col_k,
                                     const float* __restrict__ col_vals,
                                     int64_t stride, bool active,
                                     const Geometry& g, int groups_q,
                                     float (&acc)[kRows][V]) {
  walk_parts<TB, V>(u0, u1, units, band_of, col_k, col_vals, stride, active,
                    g, groups_q, [&](int, const float (&part)[kRows][V]) {
#pragma unroll
                      for (int r = 0; r < kRows; ++r)
#pragma unroll
                        for (int v = 0; v < V; ++v)
                          acc[r][v] = acc_add<TO>(acc[r][v], part[r][v]);
                    });
}

// The Sp x Sp kernels' units: live pair p walks the live columns of slab
// a_idx[p] against B tile slots[p].
struct PairUnits {
  const int32_t* a_idx;
  const int32_t* slots;
  const int32_t* col_ptr;
  __device__ Meta meta(int p) const {
    const int a = a_idx[p];
    return {col_ptr[a], col_ptr[a + 1], slots[p]};
  }
};

// Store group 0's 8 rows of V values (rows `ld` elements apart).
template <int V>
__device__ __forceinline__ void store_rows(float* o, int64_t ld,
                                           const float (&acc)[kRows][V]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) store_vec<V>(o + r * ld, acc[r]);
}

template <int V, typename T>
__device__ __forceinline__ void store_rows(T* o, int64_t ld,
                                           const float (&acc)[kRows][V]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) store_vec<T, V>(o + r * ld, acc[r]);
}

// The vector width for a strip of `width` columns whose loads and stores
// are `align`-element aligned (4, 2 or 1): the widest that still fills a
// warp, else the widest allowed.
inline int vec_for(int width, int align) {
  for (int v = 4; v > 1; v /= 2) {
    if (align % v == 0 && width >= 32 * v) return v;
  }
  return align % 4 == 0 ? 4 : (align % 2 == 0 ? 2 : 1);
}

// Launch shape for a strip of `width` columns at vector width `vec`, with
// `units` units over `tiles` output tiles (one per CTA, but several per
// revisit segment): as many unit groups as keep four units per group per
// tile on average (at most kMaxGroups, kMaxThreads threads) and, where
// `slots` is given, only while `ctas` CTAs of that size leave the card's
// `slots` thread slots unfilled -- past that a group more only adds a
// barrier to every round.
struct Shape {
  int groups_q;
  int threads;
  size_t smem_bytes;
};

inline Shape shape_for(int width, int vec, long long units, long long tiles,
                       long long ctas = 0, long long slots = 0) {
  Shape s;
  s.groups_q = (width + vec - 1) / vec;
  const int tg = group_threads(s.groups_q);
  const double mean = static_cast<double>(units) / (tiles > 0 ? tiles : 1);
  int ng = 1;
  while (2 * ng <= kMaxGroups && 2 * ng * tg <= kMaxThreads &&
         8.0 * ng <= mean && (slots == 0 || ctas * ng * tg < slots)) {
    ng *= 2;
  }
  s.threads = tg * ng;
  s.smem_bytes = kMetaChunk * sizeof(Meta) +
                 static_cast<size_t>(s.threads / 32) * kWarpCols *
                     (sizeof(int) + kRows * sizeof(float)) +
                 static_cast<size_t>(ng - 1) * kRows * s.groups_q * vec *
                     sizeof(float);
  return s;
}

}  // namespace live_columns
