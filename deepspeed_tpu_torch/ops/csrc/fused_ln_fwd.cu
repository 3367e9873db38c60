// K3-fwd: bias + residual + LayerNorm forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_ln_fwd_kernel` in
// deepspeed_tpu/ops/transformer/fused_ops.py (launcher `_ln_fwd_launch`).
// Computes, per row of [N, H]:
//   s   = (y + bias) + residual                     (fp32)
//   mu  = E[s],  var = max(E[s^2] - mu^2, 0)         (flax fast variance)
//   out = (s - mu) * rsqrt(var + eps) * gamma + beta
// and writes out (out's dtype) and, optionally, s (the sum's dtype; null
// on the ln_f form).
//
// Bound on the H100: bytes. Per element it reads y and the residual and
// writes out and s (8 bytes in bf16) against ~10 flops. The layout (the
// host's plan is `ln_fwd_plan` in ops/transformer/fused_ops.py) carries
// K3-bwd's rows over (gelu_rows.cuh's 8-column register vectors):
// - A row belongs to a row group of `wpr` warps, the fewest whose lanes
//   cover the row's ceil(H / 8) vectors: lane i of the group owns columns
//   8i .. 8i + 7 of every row it sees (up to 20 warps, H 5120), with
//   16-byte accesses where H % 8 == 0 and every input's pointer is
//   16-byte aligned (`Vec`), else scalar ones that stop at H. A CTA
//   holds `groups` row groups; row group k of the grid (at most one wave
//   of persistent CTAs) takes the rows k, k + G, k + 2G, ... (G row
//   groups in all), so all CTAs sweep the rows together from the top.
// - A row is loaded once and stays in registers to its stores: s is kept
//   in fp32 registers, and the next row's y and residual are fetched into
//   the raw registers (free once s is formed) before this row's
//   statistics exchange and stores, so they are in flight through both.
// - The row's sum and sum of squares go by warp shuffles and, where a row
//   spans warps, one shared-memory exchange behind a named barrier of the
//   row group's warps only: no CTA-wide barrier anywhere. Two exchange
//   buffers alternate, so a warp that writes the next row's partials
//   never overwrites one a slower warp of its group still reads.
// - bias, gamma and beta are read once per CTA, each in its own dtype
//   (fp32 or bf16: run-time flags, read before the row loop), into fp32
//   registers, with 16-byte loads where the rows take them (the plan's
//   `vec` asks the vectors' pointers to be aligned too; a lane's 24
//   scalar loads ran 8-9% slower at serving's and BERT's shapes, 30% at
//   decode's). Lanes
//   past the row's end hold zeros, so they add nothing to the sums and
//   store nothing. The three take 24 of a lane's 70 registers on the
//   bf16-output instantiations, so 28 warps fit an SM (the plan's wave);
//   a copy of gamma and beta in shared memory saved 8 and ran 12-17%
//   slower at BERT's shapes (8% faster on the ln_f form at H 1600)
//   (`kernel_variants.py ln_fwd`).
// - fp32 outputs leave whole warps a full sector a store (`put_row`):
//   their instantiations take 76-93 registers, so the C entry cuts the
//   grid to the CTAs an SM holds (the occupancy API).
// - The exchange is a static [2][2][20] array: no dynamic shared memory,
//   so no attribute to set before a launch.
//
// dtypes: 0 = float32, 1 = bfloat16. y, residual, out and the sum are
// template parameters (16 combinations, each with 16-byte or scalar
// accesses); the vectors' dtypes are run-time flags.
#include "gelu_rows.cuh"

namespace {

using gelu_rows::fetch8;
using gelu_rows::kCols;
using gelu_rows::Raw8;
using gelu_rows::store8;
using gelu_rows::unpack8;
using gelu_rows::mixed_16bit;
using gelu_rows::with_type;

// a CTA's warps: one row group of 20 spans H 5120, the widest row
constexpr int kMaxWarps = 20;
constexpr int kMaxThreads = 32 * kMaxWarps;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v = the nc <= 8 values of a [H] vector from column c, in fp32 (zeros
// past them; nc <= 0: all zeros), read in the vector's own dtype (0
// fp32, 1 bf16, 2 fp16): 16-byte loads (Vec) or scalar ones
template <bool Vec>
__device__ __forceinline__ void vector8(const void* p, int dt, int c, int nc,
                                        float (&v)[kCols]) {
  if (nc <= 0) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[k] = 0.f;
  } else if (dt == 1) {
    Raw8<__nv_bfloat16> raw;
    fetch8<Vec>(static_cast<const __nv_bfloat16*>(p) + c, nc, raw);
    unpack8(raw, v);
  } else if (dt == 2) {
    Raw8<__half> raw;
    fetch8<Vec>(static_cast<const __half*>(p) + c, nc, raw);
    unpack8(raw, v);
  } else {
    Raw8<float> raw;
    fetch8<Vec>(static_cast<const float*>(p) + c, nc, raw);
    unpack8(raw, v);
  }
}

// p[0:8] = v, a lane's 8 columns (from c0, n <= 8 of them left; n <= 0:
// none). fp32 rows of a warp that lies wholly inside the row (`whole`)
// go out a full sector at a time: a lane's 32 bytes are two 16-byte
// halves, so each of its two stores would fill half of 32 sectors; the
// warp first trades halves by shuffles (lane l takes 4 columns of lane
// l / 2, its half l % 2, then of lane 16 + l / 2), so that each store
// instruction writes 512 contiguous bytes. At BERT's shapes (fp32 out)
// the kernel ran 3-23% faster so with the L2 cache flushed and 28-47%
// faster warm, and the ln_f form at H 1600 13% slower (fewer warps fit
// its registers) (`kernel_variants.py ln_fwd`). Every lane of the warp
// calls it.
template <bool Vec, typename T>
__device__ __forceinline__ void put_row(T* __restrict__ p, int n,
                                        const float (&v)[kCols], int lane,
                                        bool whole) {
  if constexpr (Vec && sizeof(T) == 4) {
    if (whole) {
      float* base = p - kCols * lane;  // the warp's first column
      const int hi = lane & 1;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const int src = 16 * part + (lane >> 1);
        float w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float a = __shfl_sync(0xffffffffu, v[k], src);
          const float b = __shfl_sync(0xffffffffu, v[4 + k], src);
          w[k] = hi ? b : a;
        }
        reinterpret_cast<float4*>(base + 128 * part)[lane] =
            make_float4(w[0], w[1], w[2], w[3]);
      }
      return;
    }
  }
  if (n > 0) store8<Vec>(p, n, v);
}

template <typename YT, typename RT, typename OT, typename ST, bool Vec>
__global__ void __launch_bounds__(kMaxThreads)
ln_fwd_kernel(const YT* __restrict__ y, const RT* __restrict__ res,
              const void* __restrict__ bias, const void* __restrict__ gamma,
              const void* __restrict__ beta, int bias_dt, int gamma_dt,
              int beta_dt, OT* __restrict__ out, ST* __restrict__ sum, int n,
              int h, int wpr, float eps) {
  // the row groups' exchange: [2 buffers][sum, sum of squares][warp]
  __shared__ float red[2][2][kMaxWarps];
  const int tpr = 32 * wpr, groups = blockDim.x / tpr;
  const int g = threadIdx.x / tpr, i = threadIdx.x % tpr;
  const int warp = i >> 5, lane = i & 31;
  const int w0 = g * wpr;  // the group's first warp in the CTA
  const int bar = 1 + g;   // its named barrier (0 is __syncthreads')
  const int c0 = kCols * i;
  const int nc = min(kCols, h - c0);  // <= 0: the lane owns no columns
  const bool whole = (warp + 1) * 32 * kCols <= h;  // the warp's columns
  const int stride = gridDim.x * groups;
  const float hf = static_cast<float>(h);

  // the first row's y and residual, then the vectors (their loads overlap)
  Raw8<YT> yr = {};
  Raw8<RT> rr = {};
  int r = blockIdx.x * groups + g;
  if (r < n && nc > 0) {
    const long long at = static_cast<long long>(r) * h + c0;
    fetch8<Vec>(y + at, nc, yr);
    fetch8<Vec>(res + at, nc, rr);
  }
  float bv[kCols], gv[kCols], tv[kCols];
  vector8<Vec>(bias, bias_dt, c0, nc, bv);
  vector8<Vec>(gamma, gamma_dt, c0, nc, gv);
  vector8<Vec>(beta, beta_dt, c0, nc, tv);

  int parity = 0;
  for (; r < n; r += stride) {
    // 1. s = (y + bias) + residual in fp32, and its partial sums
    float s[kCols], a[kCols];
    unpack8(yr, s);
    unpack8(rr, a);
    float st[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      s[k] = (s[k] + bv[k]) + a[k];
      st[0] += s[k];
      st[1] += s[k] * s[k];
    }
    // 2. the next row's y and residual, in flight through 3 and 4
    const int rn = r + stride;
    if (rn < n && nc > 0) {
      const long long at = static_cast<long long>(rn) * h + c0;
      fetch8<Vec>(y + at, nc, yr);
      fetch8<Vec>(res + at, nc, rr);
    }
    // 3. the row's sums: shuffles, then the group's exchange
    st[0] = warp_sum(st[0]);
    st[1] = warp_sum(st[1]);
    if (wpr > 1) {
      if (lane == 0) {
        red[parity][0][w0 + warp] = st[0];
        red[parity][1][w0 + warp] = st[1];
      }
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(tpr) : "memory");
      st[0] = st[1] = 0.f;
      for (int w = 0; w < wpr; ++w) {
        st[0] += red[parity][0][w0 + w];
        st[1] += red[parity][1][w0 + w];
      }
      parity ^= 1;
    }
    const float mu = st[0] / hf;
    const float rstd = rsqrtf(fmaxf(st[1] / hf - mu * mu, 0.f) + eps);
    // 4. the stores (every lane: put_row may shuffle)
    const long long at = static_cast<long long>(r) * h + c0;
    float o[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) o[k] = (s[k] - mu) * rstd * gv[k] + tv[k];
    put_row<Vec>(out + at, nc, o, lane, whole);
    if (sum != nullptr) put_row<Vec>(sum + at, nc, s, lane, whole);
  }
}

// The CTAs of `threads` threads of one instantiation that an SM holds at
// once, from the occupancy API, cached per instantiation and CTA size
// (the same value whichever thread writes it)
template <typename YT, typename RT, typename OT, typename ST, bool Vec>
int resident_ctas(int threads) {
  static int cached[kMaxWarps + 1];
  int& c = cached[threads / 32];
  if (c == 0) {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, ln_fwd_kernel<YT, RT, OT, ST, Vec>, threads, 0);
    c = b > 0 ? b : 1;
  }
  return c;
}

}  // namespace

// Launch over n rows of width h on `stream` with the plan's layout
// (`ln_fwd_plan`): at most `grid` CTAs of `groups` row groups of `wpr`
// warps, 16-byte accesses when vec is 8 (scalar ones when 1). The grid
// is cut to the CTAs the card holds at once, so an instantiation with
// more registers than the plan's 28 warps an SM allow (fp32 outputs: up
// to 88) still runs one wave (the kernel strides by its own grid). `sum`
// may be null (the ln_f form; sum_dt then picks nothing that runs).
// Returns cudaGetLastError() as an int, or cudaErrorInvalidValue for a
// plan that does not cover the rows.
extern "C" int ds_fused_ln_fwd(const void* y, const void* res,
                               const void* bias, const void* gamma,
                               const void* beta, void* out, void* sum, int n,
                               int h, int y_dt, int r_dt, int bias_dt,
                               int gamma_dt, int beta_dt, int out_dt,
                               int sum_dt, float eps, int vec, int wpr,
                               int groups, int grid, int device,
                               void* stream) {
  cudaSetDevice(device);
  if (n <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  const long long lanes = 32ll * wpr;
  const int threads = 32 * wpr * groups;
  if ((vec != 1 && vec != 8) || wpr < 1 || groups < 1 ||
      threads > kMaxThreads || (wpr > 1 && groups > 15) ||
      lanes * kCols < h || (lanes - 32) * kCols >= h || grid < 1 ||
      (vec == 8 && h % 8 != 0) ||
      mixed_16bit({y_dt, r_dt, bias_dt, gamma_dt, beta_dt, out_dt, sum_dt}) ||
      (y_dt != 2 && (r_dt == 2 || out_dt == 2 || sum_dt == 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  static int sm_count[64];  // by device, cached
  int& sms = sm_count[device & 63];
  if (sms == 0)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  auto launch = [&](auto ytype, auto rtype, auto otype, auto stype) {
    using YT = decltype(ytype);
    using RT = decltype(rtype);
    using OT = decltype(otype);
    using ST = decltype(stype);
    auto* k = vec == 8 ? ln_fwd_kernel<YT, RT, OT, ST, true>
                       : ln_fwd_kernel<YT, RT, OT, ST, false>;
    const int per_sm = vec == 8
                           ? resident_ctas<YT, RT, OT, ST, true>(threads)
                           : resident_ctas<YT, RT, OT, ST, false>(threads);
    const int held = per_sm * sms > 0 ? per_sm * sms : 1;
    const int wave = grid < held ? grid : held;
    k<<<wave, threads, 0, st>>>(
        static_cast<const YT*>(y), static_cast<const RT*>(res), bias, gamma,
        beta, bias_dt, gamma_dt, beta_dt, static_cast<OT*>(out),
        static_cast<ST*>(sum), n, h, wpr, eps);
  };
  if (y_dt == 2) {
    // the fp16 forms the fp16 paths give it, y fp16 and (residual, out,
    // sum): fp16, fp16, fp16 (GPT-2); fp16, fp32, fp16 (BERT's first
    // post-LN LayerNorm, GPT-2's ln_f); fp32, fp32, fp32 (BERT's second)
    using H = __half;
    if (r_dt == 2 && out_dt == 2 && sum_dt == 2)
      launch(H{}, H{}, H{}, H{});
    else if (r_dt == 2 && out_dt == 0 && sum_dt == 2)
      launch(H{}, H{}, float{}, H{});
    else if (r_dt == 0 && out_dt == 0 && sum_dt == 0)
      launch(H{}, float{}, float{}, float{});
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    with_type(y_dt, [&](auto ytype) {
      with_type(r_dt, [&](auto rtype) {
        with_type(out_dt, [&](auto otype) {
          with_type(sum_dt,
                    [&](auto stype) { launch(ytype, rtype, otype, stype); });
        });
      });
    });
  }
  return static_cast<int>(cudaGetLastError());
}
