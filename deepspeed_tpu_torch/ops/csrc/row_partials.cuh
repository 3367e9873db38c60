// K3-bwd's (fused_ln_bwd.cu) per-element dtype access and deterministic
// cross-row sum (the grouped form is `kernel_variants.py gelu`'s fold for
// K4-bwd). A kernel over [N, W] rows has each CTA walk
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

// out[g, c] = sum over p of partial[g * parts + p, c], in order
// p = 0, 1, ... (groups of `parts` workspace rows; one group is the
// plain column sum)
__global__ void __launch_bounds__(kThreads)
col_reduce_kernel(const float* __restrict__ partial, int parts, int cols,
                  int groups, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(groups) * cols) return;
  const int g = static_cast<int>(i / cols);
  const int c = static_cast<int>(i % cols);
  const float* base = partial + static_cast<long long>(g) * parts * cols;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p)
    acc += base[static_cast<long long>(p) * cols + c];
  out[i] = acc;
}

// Add the [groups * parts, cols] workspace into out [groups, cols] on
// `st`, group by group.
inline void col_reduce(const void* workspace, int parts, int cols, void* out,
                       cudaStream_t st, int groups = 1) {
  const long long total = static_cast<long long>(groups) * cols;
  col_reduce_kernel<<<static_cast<int>((total + kThreads - 1) / kThreads),
                      kThreads, 0, st>>>(
      static_cast<const float*>(workspace), parts, cols, groups,
      static_cast<float*>(out));
}

}  // namespace ds_partials

// The number of CTAs (workspace rows) a kernel of this family launches
// for each of `groups` groups of rows_per_group rows: about four per SM
// in all, each over a contiguous run of rows of one group.
extern "C" int ds_partials_grid_groups(int rows_per_group, int groups,
                                       int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rows_per_group <= 0 || groups <= 0) return 0;
  int target = sms * 4 / groups;
  if (target < 1) target = 1;
  if (target > rows_per_group) target = rows_per_group;
  const int rows_per_cta = (rows_per_group + target - 1) / target;
  return (rows_per_group + rows_per_cta - 1) / rows_per_cta;
}

// The same for n rows in one group.
extern "C" int ds_partials_grid(int n, int device) {
  return ds_partials_grid_groups(n, 1, device);
}
