// K4-bwd: bias + GeLU backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_gelu_bwd_kernel` in
// deepspeed_tpu/ops/transformer/fused_ops.py (launcher
// `_gelu_bwd_launch`). From the forward's saved sum s = x + bias and the
// output cotangent dout, per element of [N, W] (`_gelu_bwd_math`):
//   tanh: t = tanh(sqrt(2/pi) * (s + 0.044715 s^3))
//         gelu'(s) = 0.5 (1 + t) + 0.5 s (1 - t^2) sqrt(2/pi) (1 + 3 * 0.044715 s^2)
//   erf:  gelu'(s) = 0.5 (1 + erf(s / sqrt 2)) + s exp(-s^2 / 2) / sqrt(2 pi)
// writes dx = dout * gelu'(s) (the cotangent of x, in dx's dtype) and
// dbias [W] = the fp32 sum of dx over all N rows. With `groups` G > 1
// (the expert form, bias [G, W]) the rows split into G equal groups and
// dbias is [G, W], each row the sum over its group's rows; every CTA
// stays inside one group, so the partials of a group reduce on their own.
//
// Bound on the H100: bytes. Per element it reads s and dout and writes dx
// (6 bytes in bf16) against ~20 flops and one transcendental. A CTA walks
// a contiguous run of rows; each thread owns the columns c = tid
// (mod 256), so loads and stores coalesce and the thread adds its
// columns' dx into a shared-memory row of partial sums without any
// synchronisation. The cross-row sum is deterministic (row_partials.cuh):
// each CTA writes its partial row to a workspace [grid, W], and a second
// kernel adds the partials of each column in CTA order.
// Accurate tanhf/erff/expf (no fast math), so it holds the plain twin
// to float roundoff.
//
// dtypes: 0 = float32, 1 = bfloat16 per tensor.
#include "row_partials.cuh"

namespace {

using ds_partials::kThreads;
using ds_partials::load_as_float;
using ds_partials::store_from_float;

__device__ __forceinline__ float gelu_grad(float s, int approximate) {
  if (approximate) {
    const float k = 0.7978845608028654f;  // sqrt(2/pi)
    const float inner = k * (s + 0.044715f * s * s * s);
    const float t = tanhf(inner);
    const float dinner = k * (1.0f + 0.134145f * s * s);  // 3 * 0.044715
    return 0.5f * (1.0f + t) + 0.5f * s * (1.0f - t * t) * dinner;
  }
  return 0.5f * (1.0f + erff(s / 1.4142135623730951f)) +
         s * expf(-0.5f * s * s) * 0.3989422804014327f;  // 1/sqrt(2 pi)
}

__global__ void __launch_bounds__(kThreads)
gelu_bwd_rows_kernel(const void* __restrict__ s, const void* __restrict__ dout,
                     void* __restrict__ dx, float* __restrict__ partial,
                     int rows_per_group, int ctas_per_group, int w,
                     int rows_per_cta, int s_dt, int dout_dt, int dx_dt,
                     int approximate) {
  extern __shared__ float acc[];  // [w] this CTA's column sums of dx
  const int tid = threadIdx.x;
  for (int c = tid; c < w; c += kThreads) acc[c] = 0.f;
  const int g = blockIdx.x / ctas_per_group;
  const int g0 = g * rows_per_group;
  const int r0 = g0 + (blockIdx.x % ctas_per_group) * rows_per_cta;
  const int r1 = min(g0 + rows_per_group, r0 + rows_per_cta);
  for (int r = r0; r < r1; ++r) {
    const long long base = static_cast<long long>(r) * w;
    for (int c = tid; c < w; c += kThreads) {
      const float d = load_as_float(dout, dout_dt, base + c) *
                      gelu_grad(load_as_float(s, s_dt, base + c), approximate);
      store_from_float(dx, dx_dt, base + c, d);
      acc[c] += d;
    }
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * w;
  for (int c = tid; c < w; c += kThreads) out[c] = acc[c];
}

}  // namespace

// Launch over n rows of width w, in `groups` equal groups, on `stream`.
// `dbias` is [groups, w] fp32; `workspace` is [groups * grid, w] fp32
// with grid from ds_partials_grid_groups(n / groups, groups).
// Returns cudaGetLastError() as an int.
extern "C" int ds_fused_gelu_bwd(const void* s, const void* dout, void* dx,
                                 void* dbias, void* workspace, int n, int w,
                                 int groups, int s_dt, int dout_dt, int dx_dt,
                                 int approximate, int device, void* stream) {
  cudaSetDevice(device);
  auto st = static_cast<cudaStream_t>(stream);
  if (n > 0 && w > 0) {
    const int rows_per_group = n / groups;
    const int grid = ds_partials_grid_groups(rows_per_group, groups, device);
    const int rows_per_cta = (rows_per_group + grid - 1) / grid;
    const size_t smem = static_cast<size_t>(w) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(gelu_bwd_rows_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    gelu_bwd_rows_kernel<<<grid * groups, kThreads, smem, st>>>(
        s, dout, dx, static_cast<float*>(workspace), rows_per_group, grid, w,
        rows_per_cta, s_dt, dout_dt, dx_dt, approximate);
    ds_partials::col_reduce(workspace, grid, w, dbias, st, groups);
  } else if (w > 0) {
    cudaMemsetAsync(dbias, 0,
                    static_cast<size_t>(groups) * w * sizeof(float), st);
  }
  return static_cast<int>(cudaGetLastError());
}
