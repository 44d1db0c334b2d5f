// fp32, bf16 and fp16 values to and from fp32, for the kernels that take
// 16-bit operands (cluster_spmm.cu through live_columns.cuh, and
// flash_attention.cuh). Round to nearest even, as the JAX package's
// astype does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

namespace dtypes {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __float2bfloat16_rn(x);
  } else if constexpr (std::is_same_v<T, __half>) {
    return __float2half_rn(x);
  } else {
    return x;
  }
}

// x rounded to T's precision, kept as fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

}  // namespace dtypes
