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
// dimension) and bias is [G, W]: group g adds bias row g. G = 1 is the
// dense form.
//
// Bound on the H100: bytes. A pure elementwise pass: read x, write out
// and s (6 bytes per element in bf16) against ~15 flops and one tanh.
// The design (gelu_rows.cuh) streams rows in 16-byte vectors, 4 rows a
// lane fetched a block ahead, all CTAs sweeping the rows together; it
// keeps the lane's 8 bias values in registers for all its rows (read
// once, in the bias's own dtype, and widened here) and divides nothing
// per element. The dtypes are template parameters. Accurate tanhf/erff
// (no fast math), so it matches the plain twin to roundoff.
//
// dtypes: 0 = float32, 1 = bfloat16, 2 = float16 per tensor. The fp16
// form (x fp16) is instantiated with out and s in fp16 only, the dtypes
// the fp16 paths give it; the bias is read in its own dtype.
#include "gelu_rows.cuh"

namespace {

using namespace gelu_rows;

template <typename XT, typename OT, typename ST, bool Approx, bool Vec>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
gelu_fwd_kernel(const XT* __restrict__ x, const void* __restrict__ bias,
                int bias_dt, OT* __restrict__ out, ST* __restrict__ sum, int w,
                Tiling t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kStrip + lane * kCols;
  const int nc = min(kCols, w - c0);
  if (nc <= 0) return;
  int j, g0, g1;
  const int g = cta_group(t, j, g0, g1);
  const int end = g1, step = t.ctas_per_group * kRows;
  int r = g0 + j * kRows + warp;
  Raw8<XT> cur[kUnroll], nxt[kUnroll];
  // the first rows and the bias in flight together (one round trip)
  fetch_rows<Vec>(x, w, c0, nc, r, end, cur);
  float b[kCols];
  const long long boff = static_cast<long long>(g) * w + c0;
  if (bias_dt == 1) {
    Raw8<__nv_bfloat16> raw;
    fetch8<Vec>(static_cast<const __nv_bfloat16*>(bias) + boff, nc, raw);
    unpack8(raw, b);
  } else if (bias_dt == 2) {
    Raw8<__half> raw;
    fetch8<Vec>(static_cast<const __half*>(bias) + boff, nc, raw);
    unpack8(raw, b);
  } else {
    Raw8<float> raw;
    fetch8<Vec>(static_cast<const float*>(bias) + boff, nc, raw);
    unpack8(raw, b);
  }
  for (; r < end; r += step) {
    fetch_rows<Vec>(x, w, c0, nc, r + step, end, nxt);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r + u * kWarps;
      if (ru >= end) break;
      float v[kCols], s[kCols], o[kCols];
      unpack8(cur[u], v);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        s[k] = v[k] + b[k];
        o[k] = gelu<Approx>(s[k]);
      }
      const long long off = static_cast<long long>(ru) * w + c0;
      store8<Vec>(out + off, nc, o);
      store8<Vec>(sum + off, nc, s);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
}

}  // namespace

// Launch over n rows of width w, in `groups` equal groups of rows with
// one bias row [w] each, on `stream`, with the plan's tiling: a grid of
// (groups * ctas_per_group, strips) CTAs, and 16-byte accesses when vec
// is 8 (scalar ones when 1). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not tile the rows.
extern "C" int ds_fused_gelu_fwd(const void* x, const void* bias, void* out,
                                 void* sum, int n, int w, int groups,
                                 int ctas_per_group, int strips, int vec,
                                 int x_dt, int bias_dt, int out_dt,
                                 int sum_dt, int approximate, int device,
                                 void* stream) {
  cudaSetDevice(device);
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const Tiling t{groups > 0 ? n / groups : 0, ctas_per_group};
  if (!tiling_ok(n, w, groups, t, strips) || (vec != 1 && vec != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mixed_16bit({x_dt, bias_dt, out_dt, sum_dt}) ||
      (x_dt == 2) != (out_dt == 2 && sum_dt == 2) ||
      (x_dt != 2 && (out_dt == 2 || sum_dt == 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(groups * ctas_per_group, strips);
  auto st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto xt, auto ot, auto sm) {
    using XT = decltype(xt);
    using OT = decltype(ot);
    using ST = decltype(sm);
    auto* k = approximate
                  ? (vec == 8 ? gelu_fwd_kernel<XT, OT, ST, true, true>
                              : gelu_fwd_kernel<XT, OT, ST, true, false>)
                  : (vec == 8 ? gelu_fwd_kernel<XT, OT, ST, false, true>
                              : gelu_fwd_kernel<XT, OT, ST, false, false>);
    k<<<grid, kThreads, 0, st>>>(static_cast<const XT*>(x), bias, bias_dt,
                                 static_cast<OT*>(out), static_cast<ST*>(sum),
                                 w, t);
  };
  if (x_dt == 2) {
    launch(__half{}, __half{}, __half{});
  } else {
    with_type(x_dt, [&](auto xt) {
      with_type(out_dt, [&](auto ot) {
        with_type(sum_dt, [&](auto sm) { launch(xt, ot, sm); });
      });
    });
  }
  return static_cast<int>(cudaGetLastError());
}
