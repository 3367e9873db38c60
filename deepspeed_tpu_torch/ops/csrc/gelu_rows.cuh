// Shared by K4-fwd (fused_gelu_fwd.cu) and K4-bwd (fused_gelu_bwd.cu): the
// tiling of [N, W] rows, 8-column register vectors and the GeLU math.
//
// Tiling (the host's plan is `gelu_plan` in ops/transformer/fused_ops.py):
// a CTA of 4 warps owns a strip of 256 columns (blockIdx.y; one warp
// spans it, 8 consecutive columns a lane) and every `ctas_per_group`-th
// block of 16 rows of one group (blockIdx.x): CTA j of group g takes the
// group's blocks j, j + ctas_per_group, ..., so all CTAs sweep the rows
// together from the top (the card's reads stay within a window of
// ctas_per_group blocks per group, as a flat elementwise pass's do) and
// no CTA straddles two groups. Warp w takes rows w, w + 4, w + 8 and
// w + 12 of a block, and fetches the four rows of its next block before
// it runs this block's math, so the next loads are in flight while this
// block's math and stores run; each lane keeps its 8 bias values (or its
// 8 dbias sums) in registers for all its rows.
// The group is worked out once per CTA and each row's 64-bit offset once
// per row: nothing is divided per element.
//
// Loads and stores are 16 bytes a lane (one bf16 or fp16 vector, or two
// fp32 ones) where the plan allows it (`Vec`: W a multiple of 8 and every
// pointer 16-byte aligned); otherwise 8 scalar accesses stop at W.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace gelu_rows {

// 4 warps a CTA and 2 CTAs per SM (up to 255 registers a lane): 8 warps,
// 1 or 4 CTAs per SM, or 2 or 8 rows in flight measured slower
// (`kernel_variants.py gelu`)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 8;                  // columns a lane owns
constexpr int kStrip = 32 * kCols;        // columns a CTA owns
constexpr int kUnroll = 4;                // rows in flight per lane
constexpr int kRows = kWarps * kUnroll;   // rows a CTA takes at a time
constexpr int kCtasPerSm = 2;             // the plan's CTAs per SM

// The plan's split of the rows, as the kernels take it.
struct Tiling {
  int rows_per_group, ctas_per_group;
};

// This CTA's group, its index j among the group's CTAs, and the group's
// rows [g0, g1).
__device__ __forceinline__ int cta_group(const Tiling& t, int& j, int& g0,
                                         int& g1) {
  const int g = blockIdx.x / t.ctas_per_group;
  j = blockIdx.x - g * t.ctas_per_group;
  g0 = g * t.rows_per_group;
  g1 = g0 + t.rows_per_group;
  return g;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// The bits of a lane's 8 elements of one row as loaded: one 16-byte
// vector in bf16 or fp16, two in fp32. Rows are fetched a block ahead into these
// and widened to fp32 only when their math runs.
template <typename T>
struct Raw8 {
  uint4 q[sizeof(T) / 2];
};

__device__ __forceinline__ uint32_t& word(uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}
__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// raw = p[0:8]: 16-byte loads (Vec), or scalar ones that stop at the
// n <= 8 columns left in the row (zeros past them)
template <bool Vec, typename T>
__device__ __forceinline__ void fetch8(const T* __restrict__ p, int n,
                                       Raw8<T>& raw) {
  if constexpr (Vec) {
#pragma unroll
    for (int i = 0; i < int(sizeof(T)) / 2; ++i)
      raw.q[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  } else if constexpr (sizeof(T) == 2) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 2 * i < n ? h[2 * i] : 0u;
      const uint32_t hi = 2 * i + 1 < n ? h[2 * i + 1] : 0u;
      word(raw.q[0], i) = lo | (hi << 16);
    }
  } else {
    const uint32_t* f = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      word(raw.q[i / 4], i % 4) = i < n ? f[i] : 0u;
  }
}

// v = the 8 elements of raw in fp32
template <typename T>
__device__ __forceinline__ void unpack8(const Raw8<T>& raw,
                                        float (&v)[kCols]) {
  if constexpr (kIsHalf<T>) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = word(raw.q[0], i);
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = word(raw.q[0], i);
      v[2 * i] = __uint_as_float(w << 16);
      v[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      v[i] = __uint_as_float(word(raw.q[i / 4], i % 4));
  }
}

// v = the 8 16-bit elements of raw in fp32, as fp16 when `half` and as
// bf16 otherwise: one load path for a vector whose 16-bit type is a
// run-time flag
__device__ __forceinline__ void unpack8_16(const Raw8<__nv_bfloat16>& raw,
                                           bool half, float (&v)[kCols]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = word(raw.q[0], i);
    if (half) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    } else {
      v[2 * i] = __uint_as_float(w << 16);
      v[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
}

// Fetch a lane's 8 columns (from c0, nc of them left) of the block's rows
// r, r + 4, r + 8, r + 12 that lie before `end`.
template <bool Vec, typename T>
__device__ __forceinline__ void fetch_rows(const T* __restrict__ p, int w,
                                           int c0, int nc, int r, int end,
                                           Raw8<T> (&raw)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int ru = r + u * kWarps;
    if (ru < end)
      fetch8<Vec>(p + static_cast<long long>(ru) * w + c0, nc, raw[u]);
  }
}

// p[k] = v[k] (rounded to T) for the n <= 8 columns left in the row
template <bool Vec, typename T>
__device__ __forceinline__ void store8(T* __restrict__ p, int n,
                                       const float (&v)[kCols]) {
  if constexpr (Vec && sizeof(T) == 2) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kIsHalf<T>) {
        const __half2 h = __floats2half2_rn(v[2 * k], v[2 * k + 1]);
        w[k] = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        w[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (Vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (k < n) p[k] = from_float<T>(v[k]);
  }
}

// The forward's formulas in the JAX association (`_gelu_fwd_math`).
template <bool Approx>
__device__ __forceinline__ float gelu(float s) {
  if constexpr (Approx) {
    const float cdf = 0.5f * (1.0f + tanhf(0.7978845608028654f *
                                           (s + 0.044715f * (s * s * s))));
    return s * cdf;
  } else {
    return s * (erff(s / 1.4142135623730951f) + 1.0f) / 2.0f;
  }
}

// d gelu(s) / ds (`_gelu_bwd_math`).
template <bool Approx>
__device__ __forceinline__ float gelu_grad(float s) {
  if constexpr (Approx) {
    const float k = 0.7978845608028654f;  // sqrt(2/pi)
    const float inner = k * (s + 0.044715f * s * s * s);
    const float t = tanhf(inner);
    const float dinner = k * (1.0f + 0.134145f * s * s);  // 3 * 0.044715
    return 0.5f * (1.0f + t) + 0.5f * s * (1.0f - t * t) * dinner;
  } else {
    return 0.5f * (1.0f + erff(s / 1.4142135623730951f)) +
           s * expf(-0.5f * s * s) * 0.3989422804014327f;  // 1/sqrt(2 pi)
  }
}

// The host side's check of a plan against the rows it tiles: a strip
// covers at most kStrip columns and the grid's y dimension at most 65535
// strips.
inline bool tiling_ok(int n, int w, int groups, const Tiling& t, int strips) {
  return groups > 0 && n % groups == 0 && t.rows_per_group == n / groups &&
         strips > 0 && strips <= 65535 &&
         static_cast<long long>(strips) * kStrip >= w &&
         static_cast<long long>(strips - 1) * kStrip < w &&
         t.ctas_per_group > 0;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. Calls f(T{}) with
// T the tensor's element type, of the bf16 forms (fp32 or bf16).
template <typename F>
inline void with_type(int dt, F&& f) {
  if (dt == 1) {
    f(__nv_bfloat16{});
  } else {
    f(float{});
  }
}

// Whether the dtype codes of one launch mix the two 16-bit types (no
// instantiation takes both), or name neither fp32 nor a 16-bit type.
inline bool mixed_16bit(std::initializer_list<int> dts) {
  bool bf = false, hf = false;
  for (int dt : dts) {
    if (dt < 0 || dt > 2) return true;
    bf = bf || dt == 1;
    hf = hf || dt == 2;
  }
  return bf && hf;
}

}  // namespace gelu_rows
