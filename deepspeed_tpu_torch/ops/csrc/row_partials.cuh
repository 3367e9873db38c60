// Shared by the fused epilogue backward kernels (K3-bwd in fused_ln_bwd.cu,
// K4-bwd in fused_gelu_bwd.cu): per-element dtype access, and the
// deterministic cross-row sum. A kernel over [N, W] rows has each CTA walk
// a contiguous run of rows and write its fp32 column sums to a workspace
// [grid, cols]; col_reduce_kernel then adds the partials of each column
// in CTA order, so a run repeats bit for bit (no float atomics).
//
// dtypes: 0 = float32, 1 = bfloat16, chosen at run time per tensor.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ds_partials {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_as_float(const void* p, int dt,
                                               long long i) {
  if (dt == 1) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_from_float(void* p, int dt,
                                                 long long i, float v) {
  if (dt == 1) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// out[c] = sum over p of partial[p, c], in order p = 0, 1, ...
__global__ void __launch_bounds__(kThreads)
col_reduce_kernel(const float* __restrict__ partial, int parts, int cols,
                  float* __restrict__ out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p)
    acc += partial[static_cast<long long>(p) * cols + c];
  out[c] = acc;
}

// Add the [parts, cols] workspace into out [cols] on `st`.
inline void col_reduce(const void* workspace, int parts, int cols, void* out,
                       cudaStream_t st) {
  col_reduce_kernel<<<(cols + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(workspace), parts, cols,
      static_cast<float*>(out));
}

}  // namespace ds_partials

// The number of CTAs (workspace rows) a kernel of this family launches for
// n rows: about four per SM, each over a contiguous run of rows.
extern "C" int ds_partials_grid(int n, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (n <= 0) return 0;
  const int target = sms * 4 < n ? sms * 4 : n;
  const int rows_per_cta = (n + target - 1) / target;
  return (n + rows_per_cta - 1) / rows_per_cta;
}
