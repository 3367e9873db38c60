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
// dbias is [G, W], each row the sum over its group's rows.
//
// Bound on the H100: bytes. Per element it reads s and dout and writes dx
// (6 bytes in bf16) against ~20 flops and one tanh. The rows stream as
// in K4-fwd (gelu_rows.cuh: 16-byte vectors, 4 rows a lane fetched a
// block ahead, no division per element), and each lane sums its 8
// columns' dx over its rows in fp32 registers. dbias then comes out of
// the same launch, in a fixed order and with no float atomics, so a run
// repeats bit for bit:
//   1. the CTA adds its 4 warps' sums column by column in warp order
//      through shared memory and writes that partial row to a workspace
//      [groups * ctas_per_group, W];
//   2. it fences, and one thread bumps the (group, strip) integer counter;
//   3. the CTA that brings the counter to ctas_per_group (the last of its
//      group and strip to finish) adds the group's partial rows in CTA
//      order and writes dbias for its strip.
// The counters must be zero at the launch (the wrapper allocates them
// with torch.zeros); a CTA never straddles two groups, so each group's
// dbias row sums its own rows only.
// Accurate tanhf/erff/expf (no fast math), so it holds the plain twin
// to float roundoff.
//
// dtypes: 0 = float32, 1 = bfloat16, 2 = float16 per tensor. The fp16
// form (dx fp16) is instantiated with s and dout in fp16 only, the dtypes
// the fp16 paths give it; dbias stays fp32.
#include "gelu_rows.cuh"

namespace {

using namespace gelu_rows;

template <typename ST, typename DT, typename XT, bool Approx, bool Vec>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
gelu_bwd_kernel(const ST* __restrict__ s, const DT* __restrict__ dout,
                XT* __restrict__ dx, float* __restrict__ dbias,
                float* __restrict__ partial, int* __restrict__ counters, int w,
                Tiling t) {
  __shared__ __align__(16) float red[kWarps][kStrip];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kStrip + lane * kCols;
  const int nc = min(kCols, w - c0);
  int j, g0, g1;
  const int g = cta_group(t, j, g0, g1);
  float acc[kCols] = {};
  if (nc > 0) {
    const int end = g1, step = t.ctas_per_group * kRows;
    int r = g0 + j * kRows + warp;
    Raw8<ST> s_cur[kUnroll], s_nxt[kUnroll];
    Raw8<DT> d_cur[kUnroll], d_nxt[kUnroll];
    fetch_rows<Vec>(s, w, c0, nc, r, end, s_cur);
    fetch_rows<Vec>(dout, w, c0, nc, r, end, d_cur);
    for (; r < end; r += step) {
      fetch_rows<Vec>(s, w, c0, nc, r + step, end, s_nxt);
      fetch_rows<Vec>(dout, w, c0, nc, r + step, end, d_nxt);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ru = r + u * kWarps;
        if (ru >= end) break;
        float sv[kCols], dv[kCols], d[kCols];
        unpack8(s_cur[u], sv);
        unpack8(d_cur[u], dv);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          d[k] = dv[k] * gelu_grad<Approx>(sv[k]);
          acc[k] += d[k];
        }
        store8<Vec>(dx + static_cast<long long>(ru) * w + c0, nc, d);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s_cur[u] = s_nxt[u];
        d_cur[u] = d_nxt[u];
      }
    }
  }
  // 1. the CTA's partial row: its warps' sums in warp order
  float4* mine = reinterpret_cast<float4*>(&red[warp][lane * kCols]);
  mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  const int strip0 = blockIdx.y * kStrip;
  for (int c = threadIdx.x; c < kStrip && strip0 + c < w; c += kThreads) {
    float p = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) p += red[i][c];
    partial[static_cast<long long>(blockIdx.x) * w + strip0 + c] = p;
  }
  // 2. publish it, and count the CTAs of this (group, strip) done
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(&counters[g * gridDim.y + blockIdx.y], 1);
    last = done == t.ctas_per_group - 1;
  }
  __syncthreads();
  if (!last) return;
  // 3. the last CTA adds the group's partial rows in CTA order
  __threadfence();
  const float* rows =
      partial + static_cast<long long>(g) * t.ctas_per_group * w + strip0;
  for (int c = threadIdx.x; c < kStrip && strip0 + c < w; c += kThreads) {
    float total = 0.f;
    int i = 0;
    for (; i + 8 <= t.ctas_per_group; i += 8) {
      float buf[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        buf[k] = __ldcg(rows + static_cast<long long>(i + k) * w + c);
#pragma unroll
      for (int k = 0; k < 8; ++k) total += buf[k];
    }
    for (; i < t.ctas_per_group; ++i)
      total += __ldcg(rows + static_cast<long long>(i) * w + c);
    dbias[static_cast<long long>(g) * w + strip0 + c] = total;
  }
}

}  // namespace

// Launch over n rows of width w, in `groups` equal groups, on `stream`,
// with the plan's tiling (as ds_fused_gelu_fwd). `dbias` is [groups, w]
// fp32; `workspace` is [groups * ctas_per_group, w] fp32; `counters` is
// [groups, strips] int32, zero at the launch. Returns cudaGetLastError()
// as an int, or cudaErrorInvalidValue for a plan that does not tile the
// rows.
extern "C" int ds_fused_gelu_bwd(const void* s, const void* dout, void* dx,
                                 void* dbias, void* workspace, void* counters,
                                 int n, int w, int groups, int ctas_per_group,
                                 int strips, int vec, int s_dt, int dout_dt,
                                 int dx_dt,
                                 int approximate, int device, void* stream) {
  cudaSetDevice(device);
  auto st = static_cast<cudaStream_t>(stream);
  if (w <= 0 || groups <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0) {
    cudaMemsetAsync(dbias, 0,
                    static_cast<size_t>(groups) * w * sizeof(float), st);
    return static_cast<int>(cudaGetLastError());
  }
  const Tiling t{n / groups, ctas_per_group};
  if (!tiling_ok(n, w, groups, t, strips) || (vec != 1 && vec != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mixed_16bit({s_dt, dout_dt, dx_dt}) ||
      (dx_dt == 2) != (s_dt == 2 && dout_dt == 2) ||
      (dx_dt != 2 && (s_dt == 2 || dout_dt == 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(groups * ctas_per_group, strips);
  auto launch = [&](auto stype, auto dtype, auto xtype) {
    using ST = decltype(stype);
    using DT = decltype(dtype);
    using XT = decltype(xtype);
    auto* k = approximate
                  ? (vec == 8 ? gelu_bwd_kernel<ST, DT, XT, true, true>
                              : gelu_bwd_kernel<ST, DT, XT, true, false>)
                  : (vec == 8 ? gelu_bwd_kernel<ST, DT, XT, false, true>
                              : gelu_bwd_kernel<ST, DT, XT, false, false>);
    k<<<grid, kThreads, 0, st>>>(
        static_cast<const ST*>(s), static_cast<const DT*>(dout),
        static_cast<XT*>(dx), static_cast<float*>(dbias),
        static_cast<float*>(workspace), static_cast<int*>(counters), w, t);
  };
  if (dx_dt == 2) {
    launch(__half{}, __half{}, __half{});
  } else {
    with_type(s_dt, [&](auto stype) {
      with_type(dout_dt, [&](auto dtype) {
        with_type(dx_dt, [&](auto xtype) { launch(stype, dtype, xtype); });
      });
    });
  }
  return static_cast<int>(cudaGetLastError());
}
