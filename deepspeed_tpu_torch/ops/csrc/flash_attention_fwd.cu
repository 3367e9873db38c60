// K1-fwd: flash attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_fwd_kernel` and `_fwd_kernel_packed` in
// deepspeed_tpu/ops/transformer/flash_attention.py (launcher `_fwd`).
// Computes softmax(Q K^T * sm_scale) V over [B, T, H, D], causal or not,
// with the online softmax in log2 space (sm_scale * log2(e) folded into
// the scores, exp2 throughout, masked scores set to -1e30), and writes
//   out [B, T, H, D]   (input dtype)
//   lse [B*H, T]       (fp32, log2 space: m + log2(l))
// which is exactly what the later backward (K2) and the ring merge (K5)
// consume. The packed TPU variant (two d=64 heads per step, a K=128 MXU
// device) computes the same function, so every head_packing value runs
// this one kernel.
//
// Bound on the H100: at the flagship shape (bf16, causal, T=1024, D=64)
// the work is ~250 flops per byte moved once, just under the card's ~295
// balance point, so bytes bound it and the tensor-core rate nearly does:
// a kernel near the bound needs both. The design keeps the
// [T, T] score matrix out of device memory: one CTA of 4 warps per
// (b*h, 64-row q tile) walks the 64-row k tiles, causal tiles above the
// diagonal skipped, with the running (m, l) per row in registers and
// the fp32 output accumulator in shared memory. Each warp owns 16 query
// rows end to end (scores, softmax, rescale, P·V), so the only
// CTA-wide barriers are around the K/V tile loads. bf16 products run on
// the tensor cores through WMMA 16x16x16 fragments with fp32
// accumulation; fp32 inputs take a CUDA-core path (the TPU kernel's
// fp32 dots were exact fp32, which the tensor cores' TF32 would not
// be). Q/K/V are read through their [B, T, H, D] strides with 16-byte
// loads, so the q/k/v column slices of the fused qkv projection are
// read in place (the TPU launcher's transpose to [B*H, T, D] was a
// layout step for its BlockSpecs). This is the simple first kernel:
// no TMA, no wgmma, no pipelining of the tile loads yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr float kNegInf = -1e30f;

template <typename T>
struct Pad {
  static constexpr int value = 8;
};
template <>
struct Pad<float> {
  static constexpr int value = 4;
};

// Shared-memory layout; every region starts on a 32-byte boundary and
// every leading dimension satisfies WMMA's (multiple of 8 for bf16, of
// 4 for fp32). Rows are padded against bank conflicts.
template <typename T, int D>
struct Layout {
  static constexpr int LD = D + Pad<T>::value;    // Q, K, V rows
  static constexpr int LDS = kBK + 4;             // S (fp32)
  static constexpr int LDP = kBK + Pad<T>::value; // P (input dtype)
  static constexpr int LDO = D + 4;               // O accumulator (fp32)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * kBQ * LD;
  static constexpr size_t v_off = k_off + sizeof(T) * kBK * LD;
  static constexpr size_t s_off = v_off + sizeof(T) * kBK * LD;
  static constexpr size_t p_off = s_off + sizeof(float) * kBQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(T) * kBQ * LDP;
  static constexpr size_t bytes = o_off + sizeof(float) * kBQ * LDO;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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

// rows [t0, t0+64) of one head, row stride `st` elements, D contiguous
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int t0,
                                          long long st) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int LD = Layout<T, D>::LD;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int row = i / kPerRow;
    const int cv = i % kPerRow;
    *reinterpret_cast<uint4*>(dst + row * LD + cv * kVec) =
        *reinterpret_cast<const uint4*>(src + (t0 + row) * st + cv * kVec);
  }
}

// S[rows of this warp, 0:64] = Q K^T (unscaled, fp32)
template <int D>
__device__ __forceinline__ void scores(const bf16* sQ, const bf16* sK,
                                       float* sS, int warp, int lane) {
  using L = Layout<bf16, D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sQ + warp * 16 * L::LD + kk * 16, L::LD);
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      // K^T as a column-major B operand: element (d, n) at sK[n*LD + d]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, sK + j * 16 * L::LD + kk * 16, L::LD);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    wmma::store_matrix_sync(sS + warp * 16 * L::LDS + j * 16, acc[j], L::LDS,
                            wmma::mem_row_major);
}

template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sK,
                                       float* sS, int warp, int lane) {
  using L = Layout<float, D>;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float k0 = sK[lane * L::LD + d];
    const float k1 = sK[(lane + 32) * L::LD + d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float qv = sQ[(warp * 16 + r) * L::LD + d];
      acc[r][0] = fmaf(qv, k0, acc[r][0]);
      acc[r][1] = fmaf(qv, k1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    sS[(warp * 16 + r) * L::LDS + lane] = acc[r][0];
    sS[(warp * 16 + r) * L::LDS + lane + 32] = acc[r][1];
  }
}

// O[rows of this warp, :] += P V
template <int D>
__device__ __forceinline__ void accumulate_pv(const bf16* sP, const bf16* sV,
                                              float* sO, int warp, int lane) {
  using L = Layout<bf16, D>;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    float* optr = sO + warp * 16 * L::LDO + c * 16;
    wmma::load_matrix_sync(o, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + warp * 16 * L::LDP + kk * 16, L::LDP);
      wmma::load_matrix_sync(b, sV + kk * 16 * L::LD + c * 16, L::LD);
      wmma::mma_sync(o, a, b, o);
    }
    wmma::store_matrix_sync(optr, o, L::LDO, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void accumulate_pv(const float* sP,
                                              const float* sV, float* sO,
                                              int warp, int lane) {
  using L = Layout<float, D>;
  constexpr int kCols = D / 32;
  float acc[16][kCols];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      acc[r][i] = sO[(warp * 16 + r) * L::LDO + lane + 32 * i];
  for (int j = 0; j < kBK; ++j) {
    float vv[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) vv[i] = sV[j * L::LD + lane + 32 * i];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float p = sP[(warp * 16 + r) * L::LDP + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      sO[(warp * 16 + r) * L::LDO + lane + 32 * i] = acc[r][i];
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int seq, int heads, long long sqb,
                 long long sqt, long long sqh, long long skb, long long skt,
                 long long skh, long long svb, long long svt, long long svh,
                 float scale_log2, int causal) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qh = q + b * sqb + h * sqh;
  const T* kh = k + b * skb + h * skh;
  const T* vh = v + b * svb + h * svh;

  load_tile<T, D>(sQ, qh, qt * kBQ, sqt);
  for (int i = threadIdx.x; i < kBQ * L::LDO; i += kThreads) sO[i] = 0.f;

  float m_r[16], l_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }
  // kBQ == kBK: causal tiles strictly above the diagonal are skipped
  const int nk = causal ? qt + 1 : seq / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kh, kt * kBK, skt);
    load_tile<T, D>(sV, vh, kt * kBK, svt);
    __syncthreads();

    scores<D>(sQ, sK, sS, warp, lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int qpos = qt * kBQ + row;
      float s0 = sS[row * L::LDS + lane] * scale_log2;
      float s1 = sS[row * L::LDS + lane + 32] * scale_log2;
      if (causal) {
        if (kt * kBK + lane > qpos) s0 = kNegInf;
        if (kt * kBK + lane + 32 > qpos) s1 = kNegInf;
      }
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new);
      const float p1 = exp2f(s1 - m_new);
      const float alpha = exp2f(m_r[r] - m_new);
      l_r[r] = alpha * l_r[r] + warp_sum(p0 + p1);
      m_r[r] = m_new;
      // the P·V product takes p in the value dtype, the row sum in fp32
      sP[row * L::LDP + lane] = from_float<T>(p0);
      sP[row * L::LDP + lane + 32] = from_float<T>(p1);
      for (int c = lane; c < D; c += 32) sO[row * L::LDO + c] *= alpha;
    }
    __syncwarp();
    accumulate_pv<D>(sP, sV, sO, warp, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    const int t = qt * kBQ + row;
    T* orow = out + ((static_cast<long long>(b) * seq + t) * heads + h) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = from_float<T>(sO[row * L::LDO + c] / l_r[r]);
    if (lane == 0)
      lse[static_cast<long long>(bh) * seq + t] = m_r[r] + log2f(l_r[r]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int batch, int seq, int heads, const long long* st,
           float scale_log2, int causal, cudaStream_t stream) {
  using L = Layout<T, D>;
  auto kern = flash_fwd_kernel<T, D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(L::bytes));
  dim3 grid(seq / kBQ, batch * heads);
  kern<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, seq, heads,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v strides in elements, in the order (b, t, h) for q, then k, then
// v; the last dimension is contiguous. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError(), or -1 for an unsupported (dtype, D).
extern "C" int ds_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int batch, int seq,
                                 int heads, int head_dim,
                                 const long long* strides, float scale_log2,
                                 int causal, int dtype, int device,
                                 void* stream) {
  cudaSetDevice(device);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch * seq == 0) return 0;
  if (dtype == 1 && head_dim == 64)
    return launch<bf16, 64>(q, k, v, out, lse, batch, seq, heads, strides,
                            scale_log2, causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch<bf16, 128>(q, k, v, out, lse, batch, seq, heads, strides,
                             scale_log2, causal, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, lse, batch, seq, heads, strides,
                             scale_log2, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, lse, batch, seq, heads, strides,
                              scale_log2, causal, s);
  return -1;
}
