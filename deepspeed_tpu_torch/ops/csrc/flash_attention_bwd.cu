// K2: flash attention backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_bwd_dkv_kernel`, `_bwd_dq_kernel`,
// `_bwd_fused_kernel` and their packed twins in
// deepspeed_tpu/ops/transformer/flash_attention.py (launcher `_bwd`).
// From q, k, v, the forward's out and log2-space lse (K1-fwd writes both)
// and the output cotangent dO, with scores scaled by sm_scale * log2(e)
// and masked entries at -1e30 as in the forward:
//   delta = rowsum(dO * O) - log2(e) * dlse         (dlse optional)
//   P  = exp2(S - lse);   dP = dO V^T;   dS = P * (dP - delta) * sm_scale
//   dV = P^T dO;   dK = dS^T Q;   dQ = dS K
// with P cast to dO's dtype and dS to q's dtype before their products,
// fp32 accumulation throughout, and dQ/dK/dV written in the input dtype
// as [B, T, H, D]. The lse cotangent enters only through delta (the TPU
// launcher's shift, `_bwd` :767-772), so flash_attention_with_lse is
// differentiable in both outputs.
//
// Three kernels per call, on one stream: a delta pre-pass (one warp per
// (b, t, h) row), then the TPU kernel's two sweeps. The dK/dV kernel
// runs one CTA per (b*h, 64-row k tile) that walks the q tiles at or
// below the diagonal; the dQ kernel one CTA per (b*h, 64-row q tile)
// that walks the k tiles up to the diagonal. Both recompute S and P, so
// the score work is done twice, but every output row is owned by one
// CTA: no atomics, and a run repeats bit for bit. Within a CTA each of
// the 4 warps owns 16 rows of the scores it computes and 16 rows of the
// gradient it accumulates; the accumulators stay in registers (WMMA
// fragments for bf16, per-lane fp32 arrays for fp32) for the whole walk.
//
// Bound on the H100: at the flagship shape (bf16, causal, T=1024, D=64)
// the backward does 2.5x the forward's matmul work over ~1.6x its bytes,
// so operations bound it at the tensor-core rate. This first kernel
// takes the simple route: WMMA 16x16x16 bf16 fragments with fp32
// accumulation, plain 16-byte loads, no TMA, no wgmma, no pipelining,
// and the scores computed twice. fp32 inputs take a CUDA-core path (the
// TPU kernel's fp32 dots were exact fp32; the tensor cores would round
// to TF32). q/k/v/dO/O are read through their [B, T, H, D] strides, so
// the qkv column slices need no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kB = 64;          // q-tile and k-tile rows
constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Pad {
  static constexpr int value = 8;
};
template <>
struct Pad<float> {
  static constexpr int value = 4;
};

// Shared-memory layout. Every region starts on a 32-byte boundary and
// every leading dimension satisfies WMMA's (a multiple of 8 elements for
// bf16, of 4 for fp32); rows are padded against bank conflicts.
template <typename T, int D>
struct Layout {
  static constexpr int LD = D + Pad<T>::value;     // Q, K, V, dO tiles
  static constexpr int LDS = kB + 4;               // S -> P, dP (fp32)
  static constexpr int LDP = kB + Pad<T>::value;   // P, dS (input dtype)
  static constexpr size_t tile = sizeof(T) * kB * LD;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + tile;
  static constexpr size_t k_off = do_off + tile;
  static constexpr size_t v_off = k_off + tile;
  static constexpr size_t s_off = v_off + tile;
  static constexpr size_t dp_off = s_off + sizeof(float) * kB * LDS;
  static constexpr size_t p_off = dp_off + sizeof(float) * kB * LDS;
  static constexpr size_t ds_off = p_off + sizeof(T) * kB * LDP;
  static constexpr size_t lse_off = ds_off + sizeof(T) * kB * LDP;
  static constexpr size_t delta_off = lse_off + sizeof(float) * kB;
  static constexpr size_t stage_off = delta_off + sizeof(float) * kB;
  static constexpr size_t bytes = stage_off + sizeof(float) * 4 * 256;
};

// element strides (b, t, h) of q, k, v, dO; the head dim is contiguous
struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, db, dt, dh;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// rows [t0, t0+64) of one head, row stride `st` elements, D contiguous
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int t0,
                                          long long st) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int LD = Layout<T, D>::LD;
  for (int i = threadIdx.x; i < kB * kPerRow; i += kThreads) {
    const int row = i / kPerRow;
    const int cv = i % kPerRow;
    *reinterpret_cast<uint4*>(dst + row * LD + cv * kVec) =
        *reinterpret_cast<const uint4*>(src + (t0 + row) * st + cv * kVec);
  }
}

// s[16 rows, 0:64] = a[16 rows, :D] b[0:64, :D]^T (unscaled, fp32): the
// 16 rows of one warp (a and s point at the warp's first row).
template <int D>
__device__ __forceinline__ void scores(const bf16* a, const bf16* b,
                                       float* s, int lane) {
  using L = Layout<bf16, D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kB / 16];
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk * 16, L::LD);
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      // b^T as a column-major B operand: element (d, n) at b[n*LD + d]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + j * 16 * L::LD + kk * 16, L::LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kB / 16; ++j)
    wmma::store_matrix_sync(s + j * 16, acc[j], L::LDS, wmma::mem_row_major);
}

template <int D>
__device__ __forceinline__ void scores(const float* a, const float* b,
                                       float* s, int lane) {
  using L = Layout<float, D>;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float b0 = b[lane * L::LD + d];
    const float b1 = b[(lane + 32) * L::LD + d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float av = a[r * L::LD + d];
      acc[r][0] = fmaf(av, b0, acc[r][0]);
      acc[r][1] = fmaf(av, b1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    s[r * L::LDS + lane] = acc[r][0];
    s[r * L::LDS + lane + 32] = acc[r][1];
  }
}

// One warp's fp32 accumulator of 16 output rows x D columns, kept in
// registers across the walk over tiles.
template <typename T, int D>
struct WarpAcc;

template <int D>
struct WarpAcc<bf16, D> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[D / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) wmma::fill_fragment(f[c], 0.f);
  }
  // += A B: A the warp's 16 rows x 64 (row-major at a, ld lda), B 64 x D
  // (row-major at b, ld ldb)
  __device__ __forceinline__ void mma_rows(const bf16* a, int lda,
                                           const bf16* b, int ldb, int) {
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b + kk * 16 * ldb + c * 16, ldb);
        wmma::mma_sync(f[c], fa, fb, f[c]);
      }
    }
  }
  // += A^T B: A is 64 x the warp's 16 columns (row-major at a, ld lda),
  // read as a column-major A operand; B 64 x D (row-major at b, ld ldb)
  __device__ __forceinline__ void mma_cols(const bf16* a, int lda,
                                           const bf16* b, int ldb, int) {
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, a + kk * 16 * lda, lda);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b + kk * 16 * ldb + c * 16, ldb);
        wmma::mma_sync(f[c], fa, fb, f[c]);
      }
    }
  }
  // out[r * row_stride + c] for the 16 rows, through a per-warp 16x16
  // fp32 staging tile
  __device__ __forceinline__ void store(bf16* out, long long row_stride,
                                        float* stage, int lane) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      wmma::store_matrix_sync(stage, f[c], 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32)
        out[(i >> 4) * row_stride + c * 16 + (i & 15)] =
            __float2bfloat16(stage[i]);
      __syncwarp();
    }
  }
};

template <int D>
struct WarpAcc<float, D> {
  static constexpr int kCols = D / 32;  // lane owns columns lane + 32 i
  float v[16][kCols];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < kCols; ++i) v[r][i] = 0.f;
  }
  __device__ __forceinline__ void mma_rows(const float* a, int lda,
                                           const float* b, int ldb,
                                           int lane) {
    for (int j = 0; j < kB; ++j) {
      float bv[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) bv[i] = b[j * ldb + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float av = a[r * lda + j];
#pragma unroll
        for (int i = 0; i < kCols; ++i) v[r][i] = fmaf(av, bv[i], v[r][i]);
      }
    }
  }
  __device__ __forceinline__ void mma_cols(const float* a, int lda,
                                           const float* b, int ldb,
                                           int lane) {
    for (int j = 0; j < kB; ++j) {
      float bv[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) bv[i] = b[j * ldb + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float av = a[j * lda + r];
#pragma unroll
        for (int i = 0; i < kCols; ++i) v[r][i] = fmaf(av, bv[i], v[r][i]);
      }
    }
  }
  __device__ __forceinline__ void store(float* out, long long row_stride,
                                        float*, int lane) {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        out[r * row_stride + lane + 32 * i] = v[r][i];
  }
};

// P and dS for the warp's 16 query rows of the (q0, k0) tile pair:
// sS holds the raw scores, sdP = dO V^T. Writes P (input dtype) into sP
// when sP is non-null, and dS (input dtype) into sdS.
template <typename T, int D>
__device__ __forceinline__ void p_and_ds(const float* sS, const float* sdP,
                                         T* sP, T* sdS, const float* sL,
                                         const float* sDl, int warp, int lane,
                                         int q0, int k0, float scale_log2,
                                         float sm_scale, int causal) {
  using L = Layout<T, D>;
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    const int qpos = q0 + row;
    const float lse = sL[row];
    const float dl = sDl[row];
    for (int c = lane; c < kB; c += 32) {
      float s = sS[row * L::LDS + c] * scale_log2;
      if (causal && k0 + c > qpos) s = kNegInf;
      const float p = exp2f(s - lse);
      const float ds = p * (sdP[row * L::LDS + c] - dl) * sm_scale;
      if (sP != nullptr) sP[row * L::LDP + c] = from_float<T>(p);
      sdS[row * L::LDP + c] = from_float<T>(ds);
    }
  }
}

// delta[b*h, t] = sum_d dO * O - log2(e) * dlse[b*h, t]: one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             const float* __restrict__ dlse, float* __restrict__ delta,
             int batch, int seq, int heads, long long sob, long long sot,
             long long soh, long long sdb, long long sdt, long long sdh) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(batch) * seq * heads) return;
  const int h = static_cast<int>(row % heads);
  const int t = static_cast<int>((row / heads) % seq);
  const int b = static_cast<int>(row / (static_cast<long long>(heads) * seq));
  const T* o = out + b * sob + t * sot + h * soh;
  const T* g = dout + b * sdb + t * sdt + h * sdh;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_float(g[d]) * to_float(o[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long i = (static_cast<long long>(b) * heads + h) * seq + t;
    delta[i] = dlse != nullptr ? acc - kLog2e * dlse[i] : acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int heads, Strides st,
                     float scale_log2, float sm_scale, int causal) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sdO = reinterpret_cast<T*>(smem + L::do_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sdP = reinterpret_cast<float*>(smem + L::dp_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  T* sdS = reinterpret_cast<T*>(smem + L::ds_off);
  float* sL = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDl = reinterpret_cast<float*>(smem + L::delta_off);
  float* stage = reinterpret_cast<float*>(smem + L::stage_off);

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qh = q + b * st.qb + h * st.qh;
  const T* kh = k + b * st.kb + h * st.kh;
  const T* vh = v + b * st.vb + h * st.vh;
  const T* dh = dout + b * st.db + h * st.dh;
  const float* lse_h = lse + static_cast<long long>(bh) * seq;
  const float* delta_h = delta + static_cast<long long>(bh) * seq;

  load_tile<T, D>(sK, kh, kt * kB, st.kt);
  load_tile<T, D>(sV, vh, kt * kB, st.vt);
  WarpAcc<T, D> acc_dk, acc_dv;
  acc_dk.zero();
  acc_dv.zero();

  // kB == kB for q and k: causal q tiles strictly below kt see no key here
  const int nq = seq / kB;
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<T, D>(sQ, qh, qt * kB, st.qt);
    load_tile<T, D>(sdO, dh, qt * kB, st.dt);
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      sL[i] = lse_h[qt * kB + i];
      sDl[i] = delta_h[qt * kB + i];
    }
    __syncthreads();
    // the warp's 16 query rows: S = Q K^T, dP = dO V^T, then P and dS
    scores<D>(sQ + warp * 16 * L::LD, sK, sS + warp * 16 * L::LDS, lane);
    scores<D>(sdO + warp * 16 * L::LD, sV, sdP + warp * 16 * L::LDS, lane);
    __syncwarp();
    p_and_ds<T, D>(sS, sdP, sP, sdS, sL, sDl, warp, lane, qt * kB, kt * kB,
                   scale_log2, sm_scale, causal);
    __syncthreads();  // every query row's P and dS is in place
    // the warp's 16 key rows: dV += P^T dO, dK += dS^T Q
    acc_dv.mma_cols(sP + warp * 16, L::LDP, sdO, L::LD, lane);
    acc_dk.mma_cols(sdS + warp * 16, L::LDP, sQ, L::LD, lane);
  }

  const long long row_stride = static_cast<long long>(heads) * D;
  const long long first =
      (static_cast<long long>(b) * seq + kt * kB + warp * 16) * row_stride +
      static_cast<long long>(h) * D;
  acc_dk.store(dk + first, row_stride, stage + warp * 256, lane);
  acc_dv.store(dv + first, row_stride, stage + warp * 256, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int seq, int heads, Strides st, float scale_log2,
                    float sm_scale, int causal) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sdO = reinterpret_cast<T*>(smem + L::do_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sdP = reinterpret_cast<float*>(smem + L::dp_off);
  T* sdS = reinterpret_cast<T*>(smem + L::ds_off);
  float* sL = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDl = reinterpret_cast<float*>(smem + L::delta_off);
  float* stage = reinterpret_cast<float*>(smem + L::stage_off);

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qh = q + b * st.qb + h * st.qh;
  const T* kh = k + b * st.kb + h * st.kh;
  const T* vh = v + b * st.vb + h * st.vh;
  const T* dh = dout + b * st.db + h * st.dh;
  const float* lse_h = lse + static_cast<long long>(bh) * seq;
  const float* delta_h = delta + static_cast<long long>(bh) * seq;

  load_tile<T, D>(sQ, qh, qt * kB, st.qt);
  load_tile<T, D>(sdO, dh, qt * kB, st.dt);
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    sL[i] = lse_h[qt * kB + i];
    sDl[i] = delta_h[qt * kB + i];
  }
  WarpAcc<T, D> acc_dq;
  acc_dq.zero();

  const int nk = causal ? qt + 1 : seq / kB;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kh, kt * kB, st.kt);
    load_tile<T, D>(sV, vh, kt * kB, st.vt);
    __syncthreads();
    scores<D>(sQ + warp * 16 * L::LD, sK, sS + warp * 16 * L::LDS, lane);
    scores<D>(sdO + warp * 16 * L::LD, sV, sdP + warp * 16 * L::LDS, lane);
    __syncwarp();
    p_and_ds<T, D>(sS, sdP, static_cast<T*>(nullptr), sdS, sL, sDl, warp,
                   lane, qt * kB, kt * kB, scale_log2, sm_scale, causal);
    __syncwarp();
    // dQ += dS K over the warp's own 16 query rows
    acc_dq.mma_rows(sdS + warp * 16 * L::LDP, L::LDP, sK, L::LD, lane);
    __syncwarp();
  }

  const long long row_stride = static_cast<long long>(heads) * D;
  const long long first =
      (static_cast<long long>(b) * seq + qt * kB + warp * 16) * row_stride +
      static_cast<long long>(h) * D;
  acc_dq.store(dq + first, row_stride, stage + warp * 256, lane);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, const float* dlse, void* dq,
           void* dk, void* dv, float* delta, int batch, int seq, int heads,
           const long long* s, float scale_log2, float sm_scale, int causal,
           cudaStream_t stream) {
  using L = Layout<T, D>;
  const long long rows = static_cast<long long>(batch) * seq * heads;
  const int warps = kThreads / 32;
  delta_kernel<T, D><<<static_cast<unsigned>((rows + warps - 1) / warps),
                       kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), dlse, delta,
      batch, seq, heads, s[9], s[10], s[11], s[12], s[13], s[14]);
  Strides st{s[0], s[1], s[2], s[3], s[4], s[5],
             s[6], s[7], s[8], s[12], s[13], s[14]};
  auto dkv = flash_bwd_dkv_kernel<T, D>;
  auto dqk = flash_bwd_dq_kernel<T, D>;
  cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(L::bytes));
  cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(L::bytes));
  dim3 grid(seq / kB, batch * heads);
  dkv<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), seq, heads, st, scale_log2,
      sm_scale, causal);
  dqk<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), seq, heads, st, scale_log2, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Element strides (b, t, h), in this order, of q, k, v, out, dout (15
// values); the head dim of each is contiguous. dq/dk/dv are contiguous
// [B, T, H, D]; lse, dlse (may be null) and the delta workspace are
// [B*H, T] fp32. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError(), or -1 for an unsupported (dtype, D).
extern "C" int ds_flash_attn_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* dout,
                                 const float* lse, const float* dlse,
                                 void* dq, void* dk, void* dv, float* delta,
                                 int batch, int seq, int heads, int head_dim,
                                 const long long* strides, float scale_log2,
                                 float sm_scale, int causal, int dtype,
                                 int device, void* stream) {
  cudaSetDevice(device);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch * seq == 0) return 0;
  if (dtype == 1 && head_dim == 64)
    return launch<bf16, 64>(q, k, v, out, dout, lse, dlse, dq, dk, dv, delta,
                            batch, seq, heads, strides, scale_log2, sm_scale,
                            causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch<bf16, 128>(q, k, v, out, dout, lse, dlse, dq, dk, dv,
                             delta, batch, seq, heads, strides, scale_log2,
                             sm_scale, causal, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, dout, lse, dlse, dq, dk, dv,
                             delta, batch, seq, heads, strides, scale_log2,
                             sm_scale, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, dout, lse, dlse, dq, dk, dv,
                              delta, batch, seq, heads, strides, scale_log2,
                              sm_scale, causal, s);
  return -1;
}
