// K3-fwd: bias + residual + LayerNorm forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_ln_fwd_kernel` in
// deepspeed_tpu/ops/transformer/fused_ops.py (launcher `_ln_fwd_launch`).
// Computes, per row of [N, H]:
//   s   = (y + bias) + residual                     (fp32)
//   mu  = E[s],  var = max(E[s^2] - mu^2, 0)         (flax fast variance)
//   out = (s - mu) * rsqrt(var + eps) * gamma + beta
// and writes out (out_dtype) and, optionally, s (sum_dtype).
//
// Bound on the H100: bytes. Per element it reads y and residual and
// writes out and s (8 bytes in bf16) against ~10 flops, far below the
// card's ~295 flops/byte balance point. The design moves each byte once:
// one CTA per row reads y and residual once into shared memory as fp32
// sums (any H, e.g. the flagship's 1600, which is no multiple of 128:
// the TPU kernel padded lanes to 128 and masked them, here the loops
// stop at H), reduces sum and sum-of-squares in one pass, then
// normalises from shared memory. The [H] vectors are small and stay in
// L2 across rows. Loads are scalar and coalesced (consecutive threads,
// consecutive elements).
//
// dtypes: 0 = float32, 1 = bfloat16, chosen at run time per tensor
// (the branch is uniform across the CTA). bias/gamma/beta are float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const void* __restrict__ y, const float* __restrict__ bias,
              const void* __restrict__ res, const float* __restrict__ gamma,
              const float* __restrict__ beta, void* __restrict__ out,
              void* __restrict__ sum, int h, int y_dt, int r_dt,
              int out_dt, int sum_dt, float eps) {
  extern __shared__ float s_row[];  // [h] fp32 sums of this row
  __shared__ float red[2][kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * h;
  const int tid = threadIdx.x;

  float acc = 0.f, acc2 = 0.f;
  for (int c = tid; c < h; c += kThreads) {
    float s = (load_as_float(y, y_dt, base + c) + bias[c]) +
              load_as_float(res, r_dt, base + c);
    s_row[c] = s;
    acc += s;
    acc2 += s * s;
  }
  acc = warp_sum(acc);
  acc2 = warp_sum(acc2);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red[0][warp] = acc;
    red[1][warp] = acc2;
  }
  __syncthreads();
  if (warp == 0) {
    float a = lane < kThreads / 32 ? red[0][lane] : 0.f;
    float b = lane < kThreads / 32 ? red[1][lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      red[0][0] = a;
      red[1][0] = b;
    }
  }
  __syncthreads();
  const float hf = static_cast<float>(h);
  const float mu = red[0][0] / hf;
  const float mu2 = red[1][0] / hf;
  const float var = fmaxf(mu2 - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);

  for (int c = tid; c < h; c += kThreads) {
    const float s = s_row[c];
    store_from_float(out, out_dt, base + c,
                     (s - mu) * rstd * gamma[c] + beta[c]);
    if (sum != nullptr) store_from_float(sum, sum_dt, base + c, s);
  }
}

}  // namespace

// Launch over n rows of width h on `stream`; `sum` may be null (the
// ln_f form). Returns cudaGetLastError() as an int.
extern "C" int ds_fused_ln_fwd(const void* y, const void* bias,
                               const void* res, const void* gamma,
                               const void* beta, void* out, void* sum,
                               int n, int h, int y_dt, int r_dt, int out_dt,
                               int sum_dt, float eps, int device,
                               void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    const size_t smem = static_cast<size_t>(h) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(ln_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    ln_fwd_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        y, static_cast<const float*>(bias), res,
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        out, sum, h, y_dt, r_dt, out_dt, sum_dt, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
