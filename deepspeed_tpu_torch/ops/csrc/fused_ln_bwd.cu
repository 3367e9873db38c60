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
// dx (8 bytes in bf16) against ~20 flops. The layout (the host's plan is
// `ln_bwd_plan` in ops/transformer/fused_ops.py) carries K4's over
// (gelu_rows.cuh's 8-column register vectors):
// - A row belongs to a row group of `wpr` warps; lane i of the group owns
//   the same 8-column vectors i, i + 32 wpr, ... (V of them: 1 up to H
//   3584, 4 beyond) of every row it sees: 16-byte accesses where
//   H % 8 == 0 and every pointer is 16-byte aligned, else scalar ones
//   that stop at H (`Vec`). A CTA holds `groups` row groups, up to 14
//   warps at one vector a lane (one CTA an SM: ptxas sizes 448 threads as
//   512, 128 registers a lane), 7 at four (255 registers); group k of the
//   grid takes the rows k, k + G_total, ..., so all CTAs sweep the rows
//   together from the top, and fetches its next row into raw registers
//   before this row's math (fp32 rows at four vectors a lane after it,
//   and dsum vector by vector as dx takes it: ahead of them they spill). A row stays packed in registers from its
//   load to its math; nothing is staged in shared memory.
// - The row's four sums (of s, s^2, dxhat and dxhat * s: the two means
//   follow from them) go by warp shuffles and, where a row spans warps,
//   one shared-memory exchange, behind a named barrier of the row group's
//   warps only.
// - gamma is read once per CTA, in its own dtype (fp32 or bf16), into an
//   fp32 copy in shared memory (registers go to rows in flight; zeros for
//   the lanes past the row's end, so no lane reads a word it did not
//   write), and each
//   lane keeps its columns' dbias, dgamma and dbeta sums in fp32
//   registers across all its rows.
// - dbias, dgamma and dbeta come out of the same launch, in a fixed order
//   and with no float atomics, so a run repeats bit for bit: the CTA adds
//   its row groups' sums in group order through shared memory and writes
//   that partial row [3, H] to the workspace; then the last CTA of each
//   fold group (found by an int counter) adds the group's partial rows in
//   CTA order into a group row, and the last of those adds the group rows
//   in order into the sums. The counters must be zero at the launch (the
//   wrapper allocates them with torch.zeros).
//
// dtypes: 0 = float32, 1 = bfloat16. s, dout and dx are template
// parameters; dsum is read in s's dtype; gamma's dtype is a run-time flag.
#include "gelu_rows.cuh"

#include <type_traits>

namespace {

using gelu_rows::fetch8;
using gelu_rows::kCols;
using gelu_rows::Raw8;
using gelu_rows::store8;
using gelu_rows::unpack8;
using gelu_rows::unpack8_16;
using gelu_rows::mixed_16bit;
using gelu_rows::with_type;

// warps of one CTA: 14 at one vector a lane (the paths' widths: one CTA
// an SM; ptxas sizes 448 threads as 512, 128 registers a lane), 7 on
// wider rows (255 registers)
constexpr int kMaxWarps = 14;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kFold = 8;           // partial rows a fold loads at once (16 spills)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums v[0 .. 4) over the row group's wpr warps: every lane ends with the
// same totals, added in warp order. `red` holds 4 * wpr floats of this
// group; the named barrier `bar` (1 + the group) joins the group's warps
// only.
__device__ __forceinline__ void group_sum(float (&v)[4], float* red, int wpr,
                                          int warp, int lane, int bar) {
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = warp_sum(v[r]);
  if (wpr == 1) return;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) red[r * wpr + warp] = v[r];
  }
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 * wpr) : "memory");
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float t = 0.f;
    for (int w = 0; w < wpr; ++w) t += red[r * wpr + w];
    v[r] = t;
  }
}

// The lane's V vectors of one row of s, dout or dsum, as raw words
template <typename T, int V>
struct Row {
  Raw8<T> v[V];
};

// The lane's V vectors (columns c0[j] .. c0[j] + nc[j]; nc <= 0: none,
// those stay zero from the start) of row r of p, if r < n
template <bool Vec, typename T, int V>
__device__ __forceinline__ void fetch_row(Row<T, V>& b,
                                          const T* __restrict__ p, int r,
                                          int n, int h, const int (&c0)[V],
                                          const int (&nc)[V]) {
  if (r >= n) return;
  const long long row = static_cast<long long>(r) * h;
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (nc[j] > 0) fetch8<Vec>(p + row + c0[j], nc[j], b.v[j]);
}

// the lane's 8 gamma values of vector j, from the CTA's fp32 copy
__device__ __forceinline__ void gamma8(const float* gs, int c,
                                       float (&g)[kCols]) {
  const float4 a = *reinterpret_cast<const float4*>(gs + c);
  const float4 b = *reinterpret_cast<const float4*>(gs + c + 4);
  g[0] = a.x, g[1] = a.y, g[2] = a.z, g[3] = a.w;
  g[4] = b.x, g[5] = b.y, g[6] = b.z, g[7] = b.w;
}

// dst[c] = the sum of src[i * cols + c] over the rows i < rows, added in
// order i = 0, 1, ...: 16-byte loads where cols % 4 == 0, kFold rows in
// flight a thread (L2 reads: the rows were written by other CTAs)
__device__ __forceinline__ void fold_rows(const float* src, int rows,
                                          int cols, float* dst) {
  const int quads = cols % 4 == 0 ? cols / 4 : 0;
  for (int c = threadIdx.x; c < quads; c += blockDim.x) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < rows; i += kFold) {
      float4 buf[kFold];
#pragma unroll
      for (int k = 0; k < kFold; ++k)
        if (i + k < rows)
          buf[k] = __ldcg(reinterpret_cast<const float4*>(
                              src + static_cast<long long>(i + k) * cols) +
                          c);
#pragma unroll
      for (int k = 0; k < kFold; ++k)
        if (i + k < rows) {
          t.x += buf[k].x;
          t.y += buf[k].y;
          t.z += buf[k].z;
          t.w += buf[k].w;
        }
    }
    reinterpret_cast<float4*>(dst)[c] = t;
  }
  for (int c = 4 * quads + threadIdx.x; c < cols; c += blockDim.x) {
    float t = 0.f;
    for (int i = 0; i < rows; ++i)
      t += __ldcg(src + static_cast<long long>(i) * cols + c);
    dst[c] = t;
  }
}

template <typename ST, typename DT, typename XT, int V, bool Vec>
__global__ void __launch_bounds__(V == 1 ? kMaxThreads : kMaxThreads / 2)
ln_bwd_kernel(const ST* __restrict__ s, const void* __restrict__ gamma,
              int gamma_dt, const DT* __restrict__ dout,
              const ST* __restrict__ dsum, XT* __restrict__ dx,
              float* __restrict__ sums, float* __restrict__ work,
              int* __restrict__ counters, int n, int h, int wpr, int fold,
              float eps) {
  extern __shared__ __align__(16) float smem[];
  const int tpr = 32 * wpr, groups = blockDim.x / tpr;
  float* gs = smem;                // [8 V tpr]: gamma in fp32, 0 past h
  float* slab = smem + 8 * V * tpr;  // [3][h]: the CTA's partial row
  const int g = threadIdx.x / tpr, i = threadIdx.x % tpr;
  const int warp = i >> 5, lane = i & 31;
  // this group's exchange: [2 buffers][4 sums][wpr]
  float* red = slab + 3 * h + g * 8 * wpr;
  const int bar = 1 + g;

  int c0[V], nc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    c0[j] = kCols * (i + j * tpr);
    nc[j] = min(kCols, h - c0[j]);
  }
  // gamma, read once in its own dtype; each lane writes (every group the
  // same values) and reads back only its own columns, so no barrier.
  // Lanes past the row's end (nc <= 0) write zeros: their rows stay zero
  // too, and the first pass reads their vectors unguarded.
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float4* dst = reinterpret_cast<float4*>(gs + c0[j]);
    if (nc[j] <= 0) {
      dst[0] = dst[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    float gv[kCols];
    if (gamma_dt != 0) {
      // bf16 or fp16: the same 16-bit loads, widened by the flag
      Raw8<__nv_bfloat16> raw;
      fetch8<Vec>(static_cast<const __nv_bfloat16*>(gamma) + c0[j], nc[j],
                  raw);
      unpack8_16(raw, gamma_dt == 2, gv);
    } else {
      Raw8<float> raw;
      fetch8<Vec>(static_cast<const float*>(gamma) + c0[j], nc[j], raw);
      unpack8(raw, gv);
    }
    dst[0] = make_float4(gv[0], gv[1], gv[2], gv[3]);
    dst[1] = make_float4(gv[4], gv[5], gv[6], gv[7]);
  }
  float adb[V][kCols], adg[V][kCols], adbeta[V][kCols];
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int k = 0; k < kCols; ++k) adb[j][k] = adg[j][k] = adbeta[j][k] = 0.f;

  // fp32 rows at four vectors a lane fetch the next row after this one's
  // math, and each vector of dsum where dx takes it: ahead of them they
  // spill
  constexpr bool kPrefetch = V == 1 || sizeof(ST) == 2;
  const int stride = gridDim.x * groups;
  const float hf = static_cast<float>(h);
  Row<ST, V> s_cur = {}, s_nxt = {}, m = {};
  Row<DT, V> d_cur = {}, d_nxt = {};
  int r = blockIdx.x * groups + g, parity = 0;
  fetch_row<Vec>(s_cur, s, r, n, h, c0, nc);
  fetch_row<Vec>(d_cur, dout, r, n, h, c0, nc);
  for (; r < n; r += stride) {
    if constexpr (kPrefetch) {
      if (dsum != nullptr) fetch_row<Vec>(m, dsum, r, n, h, c0, nc);
      fetch_row<Vec>(s_nxt, s, r + stride, n, h, c0, nc);
      fetch_row<Vec>(d_nxt, dout, r + stride, n, h, c0, nc);
    }
    // 1. the row's sums of s, s^2, dxhat = dout * gamma and dxhat * s
    // (one exchange: sum(dxhat * xhat) = rstd (sum(dxhat * s) - mu
    // sum(dxhat)), as PyTorch's own LayerNorm backward takes it)
    float st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float sv[kCols], dv[kCols], gv[kCols];
      unpack8(s_cur.v[j], sv);
      unpack8(d_cur.v[j], dv);
      gamma8(gs, c0[j], gv);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float dxhat = dv[k] * gv[k];
        st[0] += sv[k];
        st[1] += sv[k] * sv[k];
        st[2] += dxhat;
        st[3] += dxhat * sv[k];
      }
    }
    // the exchange alternates between two buffers: a lane writes the next
    // row's while the slowest lane may still read this one's
    group_sum(st, red + parity * 4 * wpr, wpr, warp, lane, bar);
    parity ^= 1;
    const float mu = st[0] / hf;
    const float rstd = rsqrtf(fmaxf(st[1] / hf - mu * mu, 0.f) + eps);
    // 2. dx, and the columns' sums
    const float mean_dxhat = st[2] / hf;
    const float mean_dxhat_x = rstd * (st[3] - mu * st[2]) / hf;
    const long long row = static_cast<long long>(r) * h;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (nc[j] <= 0) continue;
      float sv[kCols], dv[kCols], mv[kCols], gv[kCols], o[kCols];
      unpack8(s_cur.v[j], sv);
      unpack8(d_cur.v[j], dv);
      if (dsum != nullptr) {
        if constexpr (!kPrefetch)
          fetch8<Vec>(dsum + row + c0[j], nc[j], m.v[j]);
        unpack8(m.v[j], mv);
      }
      gamma8(gs, c0[j], gv);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float xhat = (sv[k] - mu) * rstd;
        float ds = rstd * (dv[k] * gv[k] - mean_dxhat - xhat * mean_dxhat_x);
        if (dsum != nullptr) ds += mv[k];
        o[k] = ds;
        adb[j][k] += ds;
        adg[j][k] += dv[k] * xhat;
        adbeta[j][k] += dv[k];
      }
      store8<Vec>(dx + row + c0[j], nc[j], o);
    }
    if constexpr (kPrefetch) {
      s_cur = s_nxt;
      d_cur = d_nxt;
    } else {
      fetch_row<Vec>(s_cur, s, r + stride, n, h, c0, nc);
      fetch_row<Vec>(d_cur, dout, r + stride, n, h, c0, nc);
    }
  }

  // the CTA's partial row: its groups' sums added in group order
  for (int gg = 0; gg < groups; ++gg) {
    if (g == gg) {
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          if (k >= nc[j]) continue;
          const int c = c0[j] + k;
          if (gg == 0) {
            slab[c] = adb[j][k];
            slab[h + c] = adg[j][k];
            slab[2 * h + c] = adbeta[j][k];
          } else {
            slab[c] += adb[j][k];
            slab[h + c] += adg[j][k];
            slab[2 * h + c] += adbeta[j][k];
          }
        }
    }
    __syncthreads();
  }
  const int cols = 3 * h, grid = gridDim.x;
  float* mine = work + static_cast<long long>(blockIdx.x) * cols;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) mine[c] = slab[c];

  // the last CTA of this fold group adds the group's partial rows in CTA
  // order; with one fold group that is the answer, else a group row
  __shared__ bool last;
  const int fg = blockIdx.x / fold, first = fg * fold;
  const int size = min(fold, grid - first);
  const int fold_groups = (grid + fold - 1) / fold;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[fg], 1) == size - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* group_rows = work + static_cast<long long>(grid) * cols;
  fold_rows(work + static_cast<long long>(first) * cols, size, cols,
            fold_groups == 1 ? sums
                             : group_rows + static_cast<long long>(fg) * cols);
  if (fold_groups == 1) return;
  // the last group row done adds the group rows in group order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[fold_groups], 1) == fold_groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_rows(group_rows, fold_groups, cols, sums);
}

}  // namespace

// Launch over n rows of width h on `stream` with the plan's layout
// (`ln_bwd_plan`): `grid` CTAs of `groups` row groups of `wpr` warps, V
// vectors of 8 columns a lane per row (vpt: 1 or 4), 16-byte accesses
// when vec is 8 (scalar ones when 1), partial rows folded in groups of
// `fold` CTAs. `dsum` may be null (the ln_f form); `sums` is [3, h] fp32
// (dbias, dgamma, dbeta); `workspace` is [grid + ceil(grid / fold), 3, h]
// fp32; `counters` is [ceil(grid / fold) + 1] int32, zero at the launch.
// Returns cudaGetLastError() as an int, or cudaErrorInvalidValue for a
// plan that does not cover the rows.
extern "C" int ds_fused_ln_bwd(const void* s, const void* gamma,
                               const void* dout, const void* dsum, void* dx,
                               void* sums, void* workspace, void* counters,
                               int n, int h, int s_dt, int gamma_dt,
                               int dout_dt, int dx_dt, float eps, int vec,
                               int vpt, int wpr, int groups, int grid,
                               int fold, int device, void* stream) {
  cudaSetDevice(device);
  auto st = static_cast<cudaStream_t>(stream);
  if (h <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0) {
    cudaMemsetAsync(sums, 0, static_cast<size_t>(3) * h * sizeof(float), st);
    return static_cast<int>(cudaGetLastError());
  }
  const long long lanes = 32ll * wpr;
  const int threads = 32 * wpr * groups;
  if ((vec != 1 && vec != 8) || (vpt != 1 && vpt != 4) ||
      wpr < 1 || groups < 1 ||
      threads > (vpt == 1 ? kMaxThreads : kMaxThreads / 2) ||
      lanes * vpt * kCols < h || (lanes - 32) * vpt * kCols >= h ||
      grid < 1 || fold < 1 || (vec == 8 && h % 8 != 0) ||
      mixed_16bit({s_dt, gamma_dt, dout_dt, dx_dt}) ||
      (dx_dt != 2 && (s_dt == 2 || dout_dt == 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(3) * h + lanes * vpt * kCols + 8 * wpr * groups) *
      sizeof(float);
  // V (vectors a lane) as a type, so that a form can be instantiated at
  // one vpt only
  auto launch = [&](auto stype, auto dtype, auto xtype, auto vtag) {
    using ST = decltype(stype);
    using DT = decltype(dtype);
    using XT = decltype(xtype);
    constexpr int V = decltype(vtag)::value;
    auto* k = vec == 8 ? ln_bwd_kernel<ST, DT, XT, V, true>
                       : ln_bwd_kernel<ST, DT, XT, V, false>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    k<<<grid, threads, smem, st>>>(
        static_cast<const ST*>(s), gamma, gamma_dt,
        static_cast<const DT*>(dout), static_cast<const ST*>(dsum),
        static_cast<XT*>(dx), static_cast<float*>(sums),
        static_cast<float*>(workspace), static_cast<int*>(counters), n, h, wpr,
        fold, eps);
  };
  using V1 = std::integral_constant<int, 1>;
  using V4 = std::integral_constant<int, 4>;
  if (dx_dt == 2) {
    // the fp16 forms the fp16 paths give it, one vector a lane (H up to
    // 3584): dx fp16 and (s, dout) fp16, fp16 (GPT-2); fp16, fp32 (BERT's
    // first post-LN LayerNorm, GPT-2's ln_f); fp32, fp32 (BERT's second)
    using H = __half;
    if (vpt != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (s_dt == 2 && dout_dt == 2)
      launch(H{}, H{}, H{}, V1{});
    else if (s_dt == 2 && dout_dt == 0)
      launch(H{}, float{}, H{}, V1{});
    else if (s_dt == 0 && dout_dt == 0)
      launch(float{}, float{}, H{}, V1{});
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    with_type(s_dt, [&](auto stype) {
      with_type(dout_dt, [&](auto dtype) {
        with_type(dx_dt, [&](auto xtype) {
          if (vpt == 1)
            launch(stype, dtype, xtype, V1{});
          else
            launch(stype, dtype, xtype, V4{});
        });
      });
    });
  }
  return static_cast<int>(cudaGetLastError());
}
