// K3-bwd: bias + residual + LayerNorm backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_ln_bwd_kernel` in
// deepspeed_tpu/ops/transformer/fused_ops.py (launcher `_ln_bwd_launch`).
// From the forward's saved sum s = (y + bias) + residual, gamma and the
// output cotangent dout (plus, on the two-output form, the sum's own
// cotangent dsum), per row of [N, H]:
//   mu, var = E[s], max(E[s^2] - mu^2, 0)      (the forward's fast variance)
//   xhat    = (s - mu) * rsqrt(var + eps);  dxhat = dout * gamma
//   ds      = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + dsum
// writes dx = ds (the shared cotangent of y and residual, in dx's dtype)
// and, summed over all N rows in fp32: dbias = sum ds, dgamma =
// sum dout * xhat, dbeta = sum dout.
//
// Bound on the H100: bytes. Per element it reads s, dout, dsum and writes
// dx (8 bytes in bf16) against ~20 flops. The design moves each byte
// once: a CTA walks a contiguous run of rows; each thread owns the
// columns c = tid (mod 256) of every row, keeps the row's s and dout in
// shared memory between the three passes a row needs (statistics, the
// two means, then ds), and accumulates its columns' dbias/dgamma/dbeta
// in shared memory. H need not be a multiple of anything (the flagship's
// 1600 is not a multiple of 128): the loops stop at H. The cross-row
// sums are deterministic, with no float atomics: each CTA writes its
// fp32 partial sums to a workspace [grid, 3, H], and a second kernel adds
// the partials of each column in CTA order, so a run repeats bit for bit.
//
// dtypes: 0 = float32, 1 = bfloat16, chosen at run time per tensor.
// gamma is float32.
#include "row_partials.cuh"

namespace {

using ds_partials::kThreads;
using ds_partials::load_as_float;
using ds_partials::store_from_float;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of (a, b). Every thread adds the warps' partials in the
// same order, so all threads hold the same result.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float (*red)[kWarps]) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with `red`
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  float x = 0.f, y = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    x += red[0][w];
    y += red[1][w];
  }
  return make_float2(x, y);
}

__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const void* __restrict__ s, const float* __restrict__ gamma,
                   const void* __restrict__ dout, const void* __restrict__ dsum,
                   void* __restrict__ dx, float* __restrict__ partial, int n,
                   int h, int rows_per_cta, int s_dt, int dout_dt, int dsum_dt,
                   int dx_dt, float eps) {
  extern __shared__ float smem[];
  float* s_row = smem;            // [h] this row's s
  float* d_row = smem + h;        // [h] this row's dout
  float* acc_db = smem + 2 * h;   // [h] this CTA's sum of ds
  float* acc_dg = smem + 3 * h;   // [h] ... of dout * xhat
  float* acc_dbeta = smem + 4 * h;  // [h] ... of dout
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x;
  // each thread reads and writes only its own columns of the [h] arrays
  for (int c = tid; c < h; c += kThreads) {
    acc_db[c] = 0.f;
    acc_dg[c] = 0.f;
    acc_dbeta[c] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(n, r0 + rows_per_cta);
  const float hf = static_cast<float>(h);
  for (int r = r0; r < r1; ++r) {
    const long long base = static_cast<long long>(r) * h;
    float a = 0.f, b = 0.f;
    for (int c = tid; c < h; c += kThreads) {
      const float sv = load_as_float(s, s_dt, base + c);
      s_row[c] = sv;
      d_row[c] = load_as_float(dout, dout_dt, base + c);
      a += sv;
      b += sv * sv;
    }
    float2 st = block_sum2(a, b, red);
    const float mu = st.x / hf;
    const float var = fmaxf(st.y / hf - mu * mu, 0.f);
    const float rstd = rsqrtf(var + eps);
    a = 0.f;
    b = 0.f;
    for (int c = tid; c < h; c += kThreads) {
      const float xhat = (s_row[c] - mu) * rstd;
      const float dv = d_row[c];
      const float dxhat = dv * gamma[c];
      a += dxhat;
      b += dxhat * xhat;
      acc_dg[c] += dv * xhat;
      acc_dbeta[c] += dv;
    }
    st = block_sum2(a, b, red);
    const float mean_dxhat = st.x / hf;
    const float mean_dxhat_x = st.y / hf;
    for (int c = tid; c < h; c += kThreads) {
      const float xhat = (s_row[c] - mu) * rstd;
      float ds = rstd * (d_row[c] * gamma[c] - mean_dxhat - xhat * mean_dxhat_x);
      if (dsum != nullptr) ds += load_as_float(dsum, dsum_dt, base + c);
      store_from_float(dx, dx_dt, base + c, ds);
      acc_db[c] += ds;
    }
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * 3 * h;
  for (int c = tid; c < h; c += kThreads) {
    out[c] = acc_db[c];
    out[h + c] = acc_dg[c];
    out[2 * h + c] = acc_dbeta[c];
  }
}

}  // namespace

// Launch over n rows of width h on `stream`. `dsum` may be null (the
// ln_f form). `sums` is [3, h] fp32 (dbias, dgamma, dbeta); `workspace`
// is [grid, 3, h] fp32 with grid from ds_partials_grid. Returns
// cudaGetLastError() as an int.
extern "C" int ds_fused_ln_bwd(const void* s, const void* gamma,
                               const void* dout, const void* dsum, void* dx,
                               void* sums, void* workspace, int n, int h,
                               int s_dt, int dout_dt, int dsum_dt, int dx_dt,
                               float eps, int device, void* stream) {
  cudaSetDevice(device);
  auto st = static_cast<cudaStream_t>(stream);
  if (n > 0 && h > 0) {
    const int grid = ds_partials_grid(n, device);
    const int rows_per_cta = (n + grid - 1) / grid;
    const size_t smem = static_cast<size_t>(5) * h * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(ln_bwd_rows_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    ln_bwd_rows_kernel<<<grid, kThreads, smem, st>>>(
        s, static_cast<const float*>(gamma), dout, dsum, dx,
        static_cast<float*>(workspace), n, h, rows_per_cta, s_dt, dout_dt,
        dsum_dt, dx_dt, eps);
    const int cols = 3 * h;
    ds_partials::col_reduce(workspace, grid, cols, sums, st);
  } else if (h > 0) {
    cudaMemsetAsync(sums, 0, static_cast<size_t>(3) * h * sizeof(float), st);
  }
  return static_cast<int>(cudaGetLastError());
}
