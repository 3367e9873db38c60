// K4-fwd: bias + GeLU forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_gelu_fwd_kernel` in
// deepspeed_tpu/ops/transformer/fused_ops.py (launcher
// `_gelu_fwd_launch`). Computes, per element of [N, W]:
//   s   = x + bias                                   (fp32)
//   out = s * (0.5 * (1 + tanh(sqrt(2/pi) * (s + 0.044715 * s^3))))  tanh
//   out = s * (erf(s / sqrt(2)) + 1) / 2                             erf
// with the JAX association, and writes out (out_dtype) and s (sum_dtype).
// With `groups` G > 1 the N rows split into G equal groups (an expert's
// capacity rows each: the JAX package vmaps the kernel over the expert
// dimension) and bias is [G, W]: row r adds bias row r / (N / G).
// G = 1 is the dense form.
//
// Bound on the H100: bytes. A pure elementwise pass (read x, write out
// and s: 6 bytes per element in bf16 against ~15 flops and one
// transcendental). The design is a grid-stride loop over the flattened
// tensor with each thread handling consecutive elements of a row in
// turn, so loads and stores coalesce; the bias row (W floats, 25.6 KB at
// the flagship width 6400) stays in L1/L2. The TPU kernel padded W to a
// lane multiple; here the flat index needs no padding. Accurate
// tanhf/erff (no fast math), so it matches the plain twin to roundoff.
//
// dtypes: 0 = float32, 1 = bfloat16 per tensor; bias is float32.
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

__global__ void __launch_bounds__(kThreads)
gelu_fwd_kernel(const void* __restrict__ x, const float* __restrict__ bias,
                void* __restrict__ out, void* __restrict__ sum,
                long long total, int w, long long group_elems, int x_dt,
                int out_dt, int sum_dt, int approximate) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long b = group_elems > 0 ? (i / group_elems) * w + i % w
                                        : i % w;
    const float s = load_as_float(x, x_dt, i) + bias[b];
    float o;
    if (approximate) {
      const float cdf =
          0.5f * (1.0f + tanhf(0.7978845608028654f *
                               (s + 0.044715f * (s * s * s))));
      o = s * cdf;
    } else {
      o = s * (erff(s / 1.4142135623730951f) + 1.0f) / 2.0f;
    }
    store_from_float(out, out_dt, i, o);
    store_from_float(sum, sum_dt, i, s);
  }
}

}  // namespace

// Launch over n rows of width w, in `groups` equal groups of rows with
// one bias row [w] each, on `stream`. Returns cudaGetLastError().
extern "C" int ds_fused_gelu_fwd(const void* x, const void* bias, void* out,
                                 void* sum, int n, int w, int groups, int x_dt,
                                 int out_dt, int sum_dt, int approximate,
                                 int device, void* stream) {
  cudaSetDevice(device);
  const long long total = static_cast<long long>(n) * w;
  if (total > 0) {
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    long long blocks = (total + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(sms) * 16;
    if (blocks > cap) blocks = cap;
    gelu_fwd_kernel<<<static_cast<int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const float*>(bias), out, sum, total, w,
        groups > 1 ? static_cast<long long>(n / groups) * w : 0LL, x_dt,
        out_dt, sum_dt, approximate);
  }
  return static_cast<int>(cudaGetLastError());
}
