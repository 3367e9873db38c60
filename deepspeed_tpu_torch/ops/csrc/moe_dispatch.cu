// K8: fused MoE dispatch and combine, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of deepspeed_tpu/moe/fused_dispatch.py:
// `_dispatch_kernel` (launcher `_dispatch_pallas`) and the kernel of
// `_make_combine_kernel` (launcher `_combine_pallas`). Two row gathers:
//
//   gather   out[s, :] = w[s] * x[src[s], :]   (w = 1 when no weights)
//            and zeros where src[s] >= n (the empty-slot sentinel n);
//            the forward dispatch [N, H] -> [E*C, H], and the combine
//            backward's d_ye = cw * dy scattered to the token's slots
//            (each slot has one token, so the scatter is this gather
//            through the slot -> token map, with per-slot weights);
//   combine  out[t, :] = sum_j cw[t, j] * ye[dest[t, j], :]   (fp32)
//            the forward combine [E*C, H] -> [N, H], and the dispatch
//            backward's dx (cw = keep: a token's <= k slots summed).
//
// Both backward passes are gathers, so no float atomics: a run repeats
// bit for bit, which the XLA segment sums of the JAX package's VJPs do
// not promise on a GPU.
//
// Bound on the H100: bytes. Each output row is one gather (and k
// weighted adds) of a row of H elements: no arithmetic to speak of.
// The TPU kernel steered a (1, H) BlockSpec per grid step through
// scalar-prefetched indices and appended a zero row to x for the
// sentinel; here one warp owns an output row, reads its index (and
// weight) once, moves the row in 16-byte vectors (8 bf16 or 4 fp32
// per lane, consecutive lanes on consecutive addresses) and writes
// zeros for an empty slot without reading anything. Rows whose byte
// width is no multiple of 16, or unaligned pointers, take a scalar
// loop. Products and sums use __fmul_rn/__fadd_rn (no FMA contraction),
// so the combine adds its k terms exactly as the plain twin does.
//
// dtypes: 0 = float32, 1 = bfloat16, 2 = float16, the same for the rows
// read and the rows written; weights float32; indices int32. A 16-bit
// row is widened to fp32, scaled and summed there, and rounded once to
// its dtype on the store (fp16: a sum past 65504 becomes inf, as the JAX
// kernel's `astype(out_dtype)` makes it).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_as_float(const void* p, int dt,
                                               long long i) {
  if (dt == 1) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  if (dt == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_from_float(void* p, int dt,
                                                 long long i, float v) {
  if (dt == 1) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else if (dt == 2) {
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ int elem_size(int dt) { return dt == 0 ? 4 : 2; }

// 16 bytes as 8 floats (bf16, fp16) or 4 floats (fp32)
__device__ __forceinline__ void unpack(const uint4& v, int dt, float* f) {
  if (dt == 1) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(b[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else if (dt == 2) {
    const __half2* b = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(b[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    const float* a = reinterpret_cast<const float*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = a[i];
  }
}

__device__ __forceinline__ uint4 pack(const float* f, int dt) {
  uint4 v;
  if (dt == 1) {
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  } else if (dt == 2) {
    __half2* b = reinterpret_cast<__half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    }
  } else {
    float* a = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = f[i];
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const void* __restrict__ x, const int* __restrict__ src,
                   const float* __restrict__ w, void* __restrict__ out,
                   int n, int slots, int h, int dt, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= slots) return;
  const int tok = src[row];
  const bool empty = tok < 0 || tok >= n;
  const float scale = (w != nullptr && !empty) ? w[row] : 1.0f;
  const int esize = elem_size(dt);
  if (vec) {
    const int per = 16 / esize;          // elements per 16-byte vector
    const int nvec = h / per;
    uint4* o = reinterpret_cast<uint4*>(static_cast<char*>(out) +
                                        static_cast<long long>(row) * h * esize);
    if (empty) {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int c = lane; c < nvec; c += 32) o[c] = z;
      return;
    }
    const uint4* in = reinterpret_cast<const uint4*>(
        static_cast<const char*>(x) + static_cast<long long>(tok) * h * esize);
    if (w == nullptr) {
      for (int c = lane; c < nvec; c += 32) o[c] = in[c];
      return;
    }
    for (int c = lane; c < nvec; c += 32) {
      float f[8];
      unpack(in[c], dt, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < per) f[i] = __fmul_rn(f[i], scale);
      }
      o[c] = pack(f, dt);
    }
    return;
  }
  const long long obase = static_cast<long long>(row) * h;
  const long long ibase = static_cast<long long>(tok) * h;
  for (int c = lane; c < h; c += 32) {
    float v = 0.0f;
    if (!empty) {
      v = load_as_float(x, dt, ibase + c);
      if (w != nullptr) v = __fmul_rn(v, scale);
    }
    store_from_float(out, dt, obase + c, v);
  }
}

__global__ void __launch_bounds__(kThreads)
combine_rows_kernel(const void* __restrict__ ye, const int* __restrict__ dest,
                    const float* __restrict__ cw, void* __restrict__ out,
                    int n, int k, int h, int dt, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const int esize = elem_size(dt);
  const int* d = dest + static_cast<long long>(row) * k;
  const float* wt = cw + static_cast<long long>(row) * k;
  if (vec) {
    const int per = 16 / esize;
    const int nvec = h / per;
    uint4* o = reinterpret_cast<uint4*>(static_cast<char*>(out) +
                                        static_cast<long long>(row) * h * esize);
    for (int c = lane; c < nvec; c += 32) {
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
      for (int j = 0; j < k; ++j) {
        const float wj = wt[j];
        const uint4* in = reinterpret_cast<const uint4*>(
            static_cast<const char*>(ye) +
            static_cast<long long>(d[j]) * h * esize);
        float f[8];
        unpack(in[c], dt, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < per) {
            const float p = __fmul_rn(f[i], wj);
            acc[i] = j == 0 ? p : __fadd_rn(acc[i], p);
          }
        }
      }
      o[c] = pack(acc, dt);
    }
    return;
  }
  const long long obase = static_cast<long long>(row) * h;
  for (int c = lane; c < h; c += 32) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float p = __fmul_rn(
          load_as_float(ye, dt, static_cast<long long>(d[j]) * h + c), wt[j]);
      acc = j == 0 ? p : __fadd_rn(acc, p);
    }
    store_from_float(out, dt, obase + c, acc);
  }
}

int grid_for(int rows) { return (rows + kWarps - 1) / kWarps; }

}  // namespace

// out [slots, h] from x [n, h] through src [slots] (sentinel: >= n),
// scaled by w [slots] when w is not null. `vec`: rows are 16-byte
// aligned multiples of 16 bytes. Returns cudaGetLastError().
extern "C" int ds_moe_gather_rows(const void* x, const void* src,
                                  const void* w, void* out, int n, int slots,
                                  int h, int dt, int vec, int device,
                                  void* stream) {
  cudaSetDevice(device);
  if (slots > 0 && h > 0) {
    gather_rows_kernel<<<grid_for(slots), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const int*>(src), static_cast<const float*>(w), out,
        n, slots, h, dt, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [n, h] = sum over j < k of cw[t, j] * ye[dest[t, j], :], fp32
// accumulation, written in ye's dtype. Returns cudaGetLastError().
extern "C" int ds_moe_combine_rows(const void* ye, const void* dest,
                                   const void* cw, void* out, int n, int k,
                                   int h, int dt, int vec, int device,
                                   void* stream) {
  cudaSetDevice(device);
  if (n > 0 && h > 0) {
    if (k > 0) {
      combine_rows_kernel<<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
          ye, static_cast<const int*>(dest), static_cast<const float*>(cw),
          out, n, k, h, dt, vec);
    } else {
      cudaMemsetAsync(out, 0,
                      static_cast<size_t>(n) * h * (dt == 0 ? 4 : 2),
                      static_cast<cudaStream_t>(stream));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
