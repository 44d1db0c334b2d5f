// Flash attention (flash_attention.cuh) for fp16 q, k and v, output in the same
// dtype: replaces src/repro/kernels/flash_attention.py::flash_attention at
// that dtype. Built as a library of its own so that nvcc compiles the
// three dtypes in parallel.

#include "flash_attention.cuh"

extern "C" int flash_attention_run(const void* q, const void* k, const void* v,
                                   void* o, int bh, int Sq, int Sk, int D,
                                   float scale, int causal, void* stream) {
  return flash::run<__half>(q, k, v, o, bh, Sq, Sk, D, scale, causal, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
