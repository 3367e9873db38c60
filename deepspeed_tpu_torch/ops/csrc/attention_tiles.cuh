// Tiles and kernel bodies shared by the attention kernels: K1-fwd and
// K5 (flash_attention_fwd.cu), K2 (flash_attention_bwd.cu) and K7
// (block_sparse_attention.cu). K1, K5 and K2 take these bodies for fp32
// and for head dims 192 and 256; in bf16 at head dims 64 and 128 they
// run the Hopper bodies of attention_hopper.cuh.
//
// Every kernel works on 64-row tiles of one (batch, head) with 4 warps,
// each warp owning 16 rows. Q/K/V/dO tiles are loaded with 16-byte
// vectors through the [B, T, H, D] row stride into padded shared-memory
// rows; bf16 products run on the tensor cores through WMMA 16x16x16
// fragments with fp32 accumulation, fp32 products on the CUDA cores (the
// TPU kernels' fp32 dots were exact fp32, which TF32 would not be).
// Leading dimensions satisfy WMMA (a multiple of 8 elements for bf16, of
// 4 for fp32) and are padded against bank conflicts.
//
// The three bodies at the end (fwd_body, dkv_body, dq_body) are
// templates over a Walk: the list of tiles one CTA visits and the
// visibility of each score in them. Dense flash attention walks every
// tile up to the causal diagonal; block-sparse attention walks its
// visible-tile tables. A Walk provides
//   int count() const            the number of tiles to visit
//   int tile(int s) const        the s-th tile's index along the walk
//   Vis vis(int s, int q0, int k0) const
// where Vis is a functor, bool operator()(int row, int col), for score
// (row, col) of the 64 x 64 tile pair starting at positions (q0, k0).
//
// Head dims 64 and 128 keep whole rows in shared memory. Head dims 192
// and 256 (dense flash only) take the "wide" bodies, which hold the rows
// in two column halves of D / 2: the score products accumulate over the
// halves, and the backward runs one CTA per output half, so that its
// register accumulators are those of a D / 2 head (the scores are
// computed by both halves' CTAs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace attn {

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

// leading dimensions of the shared-memory tiles
template <typename T, int D>
struct Ld {
  static constexpr int LD = D + Pad<T>::value;     // Q, K, V, dO rows
  static constexpr int LDS = kB + 4;               // S, dP (fp32)
  static constexpr int LDP = kB + Pad<T>::value;   // P, dS (input dtype)
  static constexpr int LDO = D + 4;                // O accumulator (fp32)
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) {
  return __half2float(v);
}

// rows [t0, t0+64) of one head, row stride `st` elements, D contiguous
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int t0,
                                          long long st) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int LD = Ld<T, D>::LD;
  for (int i = threadIdx.x; i < kB * kPerRow; i += kThreads) {
    const int row = i / kPerRow;
    const int cv = i % kPerRow;
    *reinterpret_cast<uint4*>(dst + row * LD + cv * kVec) =
        *reinterpret_cast<const uint4*>(src + (t0 + row) * st + cv * kVec);
  }
}

// s[16 rows, 0:64] = a[16 rows, :D] b[0:64, :D]^T (unscaled, fp32): the
// 16 rows of one warp (a and s point at the warp's first row). With
// Accumulate the product adds to what s holds (a second column half).
template <int D, bool Accumulate = false>
__device__ __forceinline__ void scores(const bf16* a, const bf16* b,
                                       float* s, int lane) {
  using L = Ld<bf16, D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kB / 16];
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) {
    if constexpr (Accumulate)
      wmma::load_matrix_sync(acc[j], s + j * 16, L::LDS,
                             wmma::mem_row_major);
    else
      wmma::fill_fragment(acc[j], 0.f);
  }
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

template <int D, bool Accumulate = false>
__device__ __forceinline__ void scores(const float* a, const float* b,
                                       float* s, int lane) {
  using L = Ld<float, D>;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if constexpr (Accumulate) {
      acc[r][0] = s[r * L::LDS + lane];
      acc[r][1] = s[r * L::LDS + lane + 32];
    } else {
      acc[r][0] = acc[r][1] = 0.f;
    }
  }
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

// O[16 rows of the warp, :] += P V, with the fp32 accumulator O in shared
// memory (the forward rescales its rows by the online-softmax alpha, so
// it must know which element is which row); p, o point at the warp's
// first row, v at the tile's.
template <int D>
__device__ __forceinline__ void accumulate_pv(const bf16* p, const bf16* v,
                                              float* o, int lane) {
  using L = Ld<bf16, D>;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* optr = o + c * 16;
    wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p + kk * 16, L::LDP);
      wmma::load_matrix_sync(b, v + kk * 16 * L::LD + c * 16, L::LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void accumulate_pv(const float* p, const float* v,
                                              float* o, int lane) {
  using L = Ld<float, D>;
  constexpr int kCols = D / 32;
  float acc[16][kCols];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[r][i] = o[r * L::LDO + lane + 32 * i];
  for (int j = 0; j < kB; ++j) {
    float vv[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) vv[i] = v[j * L::LD + lane + 32 * i];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float pj = p[r * L::LDP + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[r * L::LDO + lane + 32 * i] = acc[r][i];
}

// One warp's fp32 accumulator of 16 output rows x D columns, kept in
// registers across the walk over tiles (the backward's dQ, dK, dV).
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

// delta[b*h, t] = sum_d dO * O - log2(e) * dlse[b*h, t] (dlse may be
// null): one warp per (b, t, h) row, O and dO read through their
// [B, T, H, D] strides
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

// launch delta_kernel over all batch * seq * heads rows
template <typename T, int D>
void launch_delta(const void* out, const void* dout, const float* dlse,
                  float* delta, int batch, int seq, int heads,
                  const long long* so, const long long* sd,
                  cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * seq * heads;
  const int warps = kThreads / 32;
  delta_kernel<T, D><<<static_cast<unsigned>((rows + warps - 1) / warps),
                       kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), dlse, delta,
      batch, seq, heads, so[0], so[1], so[2], sd[0], sd[1], sd[2]);
}


// element strides (b, t, h) of q, k, v and dO; the head dim is contiguous
struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, db, dt, dh;
};

// the causal triangle (or every score) of a tile pair
struct CausalVis {
  int q0, k0, causal;
  __device__ __forceinline__ bool operator()(int row, int col) const {
    return !causal || k0 + col <= q0 + row;
  }
};

// dense flash attention's walk: tiles first .. first + n - 1, the causal
// triangle masked (the forward and the dQ sweep of q tile qt walk k tiles
// 0 .. (causal ? qt : nt - 1); the dK/dV sweep of k tile kt walks q tiles
// (causal ? kt : 0) .. nt - 1)
struct DenseWalk {
  int first, n, causal;
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int tile(int s) const { return first + s; }
  __device__ __forceinline__ CausalVis vis(int, int q0, int k0) const {
    return CausalVis{q0, k0, causal};
  }
};

// Shared-memory layouts; every region starts on a 32-byte boundary.
template <typename T, int D>
struct FwdLayout : Ld<T, D> {
  using L = Ld<T, D>;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * kB * L::LD;
  static constexpr size_t v_off = k_off + sizeof(T) * kB * L::LD;
  static constexpr size_t s_off = v_off + sizeof(T) * kB * L::LD;
  static constexpr size_t p_off = s_off + sizeof(float) * kB * L::LDS;
  static constexpr size_t o_off = p_off + sizeof(T) * kB * L::LDP;
  static constexpr size_t bytes = o_off + sizeof(float) * kB * L::LDO;
};

template <typename T, int D>
struct BwdLayout : Ld<T, D> {
  using L = Ld<T, D>;
  static constexpr size_t tile = sizeof(T) * kB * L::LD;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + tile;
  static constexpr size_t k_off = do_off + tile;
  static constexpr size_t v_off = k_off + tile;
  static constexpr size_t s_off = v_off + tile;
  static constexpr size_t dp_off = s_off + sizeof(float) * kB * L::LDS;
  static constexpr size_t p_off = dp_off + sizeof(float) * kB * L::LDS;
  static constexpr size_t ds_off = p_off + sizeof(T) * kB * L::LDP;
  static constexpr size_t lse_off = ds_off + sizeof(T) * kB * L::LDP;
  static constexpr size_t delta_off = lse_off + sizeof(float) * kB;
  static constexpr size_t stage_off = delta_off + sizeof(float) * kB;
  static constexpr size_t bytes = stage_off + sizeof(float) * 4 * 256;
};

// Shared-memory layout of the wide forward (D 192, 256): Q and the fp32
// O accumulator in two column halves of D / 2, one K or V half tile.
template <typename T, int D>
struct WideFwdLayout {
  static constexpr int DC = D / 2;
  using L = Ld<T, DC>;
  static constexpr size_t tile = sizeof(T) * kB * L::LD;
  static constexpr size_t q_off = 0;  // two halves
  static constexpr size_t kv_off = q_off + 2 * tile;
  static constexpr size_t s_off = kv_off + tile;
  static constexpr size_t p_off = s_off + sizeof(float) * kB * L::LDS;
  static constexpr size_t o_off = p_off + sizeof(T) * kB * L::LDP;
  static constexpr size_t o_half = sizeof(float) * kB * L::LDO;
  static constexpr size_t bytes = o_off + 2 * o_half;
};

// K5's operands: the prior softmax partial, prev_out fp32 [B, T, H, D]
// read through its (b, t, h) strides and prev_lse [B*H, T] (log2 space,
// -1e30 = an empty partial), and the block's own lse_n [B*H, T] that
// the merge writes for the backward.
struct MergeIn {
  const float* prev_out;
  long long pb, pt, ph;
  const float* prev_lse;
  float* lse_n;
};

// the forward's output type: K1 writes the input dtype, K5 fp32
template <bool Merge, typename T>
using FwdOut = std::conditional_t<Merge, float, T>;

// The epilogue of one output row t of head (b, h), with the walk's
// running max m and sum l and acc(c), the unnormalised fp32 accumulator
// of column c. K1 writes out = acc / l and lse = m + log2(l); a row
// that saw nothing (l = 0) writes out = 0 and lse = +inf, so that the
// backward's exp2(s - lse) is 0. K5 folds the prior partial in:
//   lse_n = m + log2(l),  mm = max(lse_n, lse_p)
//   out = (prev * 2^(lse_p - mm) + acc * 2^(m - mm))
//         / (2^(lse_p - mm) + 2^(lse_n - mm))
//   lse = mm + log2(2^(lse_p - mm) + 2^(lse_n - mm))
// (the 1/l folded into acc's weight 2^(m - mm)), and writes lse_n. A row
// that saw nothing merges as an empty partial (lse_n = -inf: out = prev,
// lse = lse_p) and keeps +inf in the lse_n the backward reads.
template <typename T, int D, bool Merge, typename Acc>
__device__ __forceinline__ void fwd_store_row(const Acc& acc, float m,
                                              float l, int b, int h, int t,
                                              int bh, int seq, int heads,
                                              FwdOut<Merge, T>* out,
                                              float* lse, const MergeIn& mg,
                                              int lane) {
  const float inf = __int_as_float(0x7f800000);
  const long long row = static_cast<long long>(bh) * seq + t;
  FwdOut<Merge, T>* orow =
      out + ((static_cast<long long>(b) * seq + t) * heads + h) * D;
  if constexpr (!Merge) {
    const float l_safe = fmaxf(l, 1e-30f);
    for (int c = lane; c < D; c += 32)
      orow[c] = from_float<T>(acc(c) / l_safe);
    if (lane == 0) lse[row] = l > 0.f ? m + log2f(l) : inf;
  } else {
    const float lse_n = l > 0.f ? m + log2f(l) : -inf;
    const float plse = mg.prev_lse[row];
    const float mm = fmaxf(lse_n, plse);
    const float w_p = exp2f(plse - mm);
    const float w_sum = w_p + exp2f(lse_n - mm);
    const float w_acc = exp2f(m - mm);
    const float* prow = mg.prev_out + b * mg.pb + t * mg.pt + h * mg.ph;
    for (int c = lane; c < D; c += 32)
      orow[c] = (prow[c] * w_p + acc(c) * w_acc) / w_sum;
    if (lane == 0) {
      lse[row] = mm + log2f(w_sum);
      mg.lse_n[row] = l > 0.f ? lse_n : inf;
    }
  }
}

// The online-softmax update of the warp's 16 rows for one tile pair:
// reads the raw scores of sSw, writes p (value dtype) into sPw, updates
// the running (m, l) and calls rescale(r, alpha) for the accumulator of
// row r. Masked scores are -1e30. A row that has seen nothing visible
// yet keeps m = -1e30 and its exponents use -5e29 instead, which sends
// every masked p to exactly 0.
template <typename T, typename Vis, typename Rescale>
__device__ __forceinline__ void softmax_rows(const float* sSw, T* sPw,
                                             float* m_r, float* l_r,
                                             const Vis& vis, int row0,
                                             int lane, float scale_log2,
                                             const Rescale& rescale) {
  using L = Ld<T, 64>;  // LDS and LDP do not depend on the head dim
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float s0 = sSw[r * L::LDS + lane] * scale_log2;
    float s1 = sSw[r * L::LDS + lane + 32] * scale_log2;
    if (!vis(row0 + r, lane)) s0 = kNegInf;
    if (!vis(row0 + r, lane + 32)) s1 = kNegInf;
    const float m_new = fmaxf(m_r[r], warp_max(fmaxf(s0, s1)));
    const float m_safe = fmaxf(m_new, 0.5f * kNegInf);
    const float p0 = exp2f(s0 - m_safe);
    const float p1 = exp2f(s1 - m_safe);
    const float alpha = exp2f(fminf(m_r[r] - m_safe, 0.f));
    l_r[r] = alpha * l_r[r] + warp_sum(p0 + p1);
    m_r[r] = m_new;
    // the P·V product takes p in the value dtype, the row sum in fp32
    sPw[r * L::LDP + lane] = from_float<T>(p0);
    sPw[r * L::LDP + lane + 32] = from_float<T>(p1);
    rescale(r, alpha);
  }
}

// Forward of one 64-row q tile of head (b, h): the online softmax in
// log2 space over the walk's K/V tiles, the running max m and sum l of
// each row in registers, the fp32 output accumulator in shared memory
// (the rescale by alpha must know which element is which row). Writes
// out [B, T, H, D] and lse [B*H, T] through `fwd_store_row` (with Merge,
// K5's merged out, lse and lse_n).
template <typename T, int D, typename Walk, bool Merge = false>
__device__ __forceinline__ void fwd_body(const T* __restrict__ q,
                                         const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         FwdOut<Merge, T>* __restrict__ out,
                                         float* __restrict__ lse, int seq,
                                         int heads, const Strides& st,
                                         float scale_log2, int qt, int bh,
                                         const Walk& walk,
                                         const MergeIn& mg = MergeIn{}) {
  using L = FwdLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);

  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const T* kh = k + b * st.kb + h * st.kh;
  const T* vh = v + b * st.vb + h * st.vh;

  load_tile<T, D>(sQ, q + b * st.qb + h * st.qh, qt * kB, st.qt);
  for (int i = threadIdx.x; i < kB * L::LDO; i += kThreads) sO[i] = 0.f;
  const T* sQw = sQ + row0 * L::LD;
  float* sSw = sS + row0 * L::LDS;
  T* sPw = sP + row0 * L::LDP;
  float* sOw = sO + row0 * L::LDO;

  float m_r[16], l_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }
  const int n = walk.count();
  for (int s = 0; s < n; ++s) {
    const int kt = walk.tile(s);
    const auto vis = walk.vis(s, qt * kB, kt * kB);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kh, kt * kB, st.kt);
    load_tile<T, D>(sV, vh, kt * kB, st.vt);
    __syncthreads();

    scores<D>(sQw, sK, sSw, lane);
    __syncwarp();
    softmax_rows<T>(sSw, sPw, m_r, l_r, vis, row0, lane, scale_log2,
                    [&](int r, float alpha) {
                      for (int c = lane; c < D; c += 32)
                        sOw[r * L::LDO + c] *= alpha;
                    });
    __syncwarp();
    accumulate_pv<D>(sPw, sV, sOw, lane);
    __syncwarp();
  }
  __syncthreads();  // the zeroed O is in place even after an empty walk

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float* orow = sOw + r * L::LDO;
    fwd_store_row<T, D, Merge>([&](int c) { return orow[c]; }, m_r[r],
                               l_r[r], b, h, qt * kB + row0 + r, bh, seq,
                               heads, out, lse, mg, lane);
  }
}

// fwd_body for D 192 and 256: Q and the O accumulator in two column
// halves (WideFwdLayout), the K tile loaded half by half with the score
// product accumulating over the halves, then the V tile half by half,
// each half's P·V into its own half of O.
template <typename T, int D, typename Walk, bool Merge = false>
__device__ __forceinline__ void fwd_body_wide(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, FwdOut<Merge, T>* __restrict__ out,
    float* __restrict__ lse, int seq, int heads, const Strides& st,
    float scale_log2, int qt, int bh, const Walk& walk,
    const MergeIn& mg = MergeIn{}) {
  constexpr int DC = D / 2;
  using W = WideFwdLayout<T, D>;
  using L = Ld<T, DC>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + W::q_off);  // half c at c * kB * LD
  T* sKV = reinterpret_cast<T*>(smem + W::kv_off);
  float* sS = reinterpret_cast<float*>(smem + W::s_off);
  T* sP = reinterpret_cast<T*>(smem + W::p_off);
  float* sO = reinterpret_cast<float*>(smem + W::o_off);  // c * kB * LDO

  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const T* qh = q + b * st.qb + h * st.qh;
  const T* kh = k + b * st.kb + h * st.kh;
  const T* vh = v + b * st.vb + h * st.vh;

  for (int c = 0; c < 2; ++c)
    load_tile<T, DC>(sQ + c * kB * L::LD, qh + c * DC, qt * kB, st.qt);
  for (int i = threadIdx.x; i < 2 * kB * L::LDO; i += kThreads) sO[i] = 0.f;
  float* sSw = sS + row0 * L::LDS;
  T* sPw = sP + row0 * L::LDP;
  float* sOw0 = sO + row0 * L::LDO;
  float* sOw1 = sO + kB * L::LDO + row0 * L::LDO;

  float m_r[16], l_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }
  const int n = walk.count();
  for (int s = 0; s < n; ++s) {
    const int kt = walk.tile(s);
    const auto vis = walk.vis(s, qt * kB, kt * kB);
    __syncthreads();  // every warp is done with the previous V half
    load_tile<T, DC>(sKV, kh, kt * kB, st.kt);
    __syncthreads();
    scores<DC>(sQ + row0 * L::LD, sKV, sSw, lane);
    __syncthreads();  // every warp is done with the first K half
    load_tile<T, DC>(sKV, kh + DC, kt * kB, st.kt);
    __syncthreads();
    scores<DC, true>(sQ + kB * L::LD + row0 * L::LD, sKV, sSw, lane);
    __syncwarp();
    softmax_rows<T>(sSw, sPw, m_r, l_r, vis, row0, lane, scale_log2,
                    [&](int r, float alpha) {
                      for (int c = lane; c < DC; c += 32) {
                        sOw0[r * L::LDO + c] *= alpha;
                        sOw1[r * L::LDO + c] *= alpha;
                      }
                    });
    __syncwarp();
    for (int c = 0; c < 2; ++c) {
      __syncthreads();  // every warp is done with the K or V half held
      load_tile<T, DC>(sKV, vh + c * DC, kt * kB, st.vt);
      __syncthreads();
      accumulate_pv<DC>(sPw, sKV, c == 0 ? sOw0 : sOw1, lane);
    }
    __syncwarp();
  }
  __syncthreads();  // the zeroed O is in place even after an empty walk

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float* o0 = sOw0 + r * L::LDO;
    const float* o1 = sOw1 + r * L::LDO;
    fwd_store_row<T, D, Merge>(
        [&](int c) { return c < DC ? o0[c] : o1[c - DC]; }, m_r[r], l_r[r],
        b, h, qt * kB + row0 + r, bh, seq, heads, out, lse, mg, lane);
  }
}

// P and dS for the warp's 16 query rows of a tile pair: sS holds the
// raw scores, sdP = dO V^T. Writes P (input dtype) into sP when sP is
// non-null, and dS (input dtype) into sdS.
template <typename T, int D, typename Vis>
__device__ __forceinline__ void p_and_ds(const float* sS, const float* sdP,
                                         T* sP, T* sdS, const float* sL,
                                         const float* sDl, int warp, int lane,
                                         float scale_log2, float sm_scale,
                                         const Vis& vis) {
  using L = Ld<T, D>;
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    const float lse = sL[row];
    const float dl = sDl[row];
    for (int c = lane; c < kB; c += 32) {
      float s = sS[row * L::LDS + c] * scale_log2;
      if (!vis(row, c)) s = kNegInf;
      const float p = exp2f(s - lse);
      const float ds = p * (sdP[row * L::LDS + c] - dl) * sm_scale;
      if (sP != nullptr) sP[row * L::LDP + c] = from_float<T>(p);
      sdS[row * L::LDP + c] = from_float<T>(ds);
    }
  }
}

// dK, dV of one 64-row k tile of head (b, h) over the walk's q tiles:
// P = exp2(S - lse), dP = dO V^T, dS = P (dP - delta) sm_scale, then
// dV += P^T dO and dK += dS^T Q, each warp accumulating 16 key rows in
// registers. No atomics: the CTA owns its rows of dK and dV.
template <typename T, int D, typename Walk>
__device__ __forceinline__ void dkv_body(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int seq, int heads,
    const Strides& st, float scale_log2, float sm_scale, int kt, int bh,
    const Walk& walk) {
  using L = BwdLayout<T, D>;
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

  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qh = q + b * st.qb + h * st.qh;
  const T* dh = dout + b * st.db + h * st.dh;
  const float* lse_h = lse + static_cast<long long>(bh) * seq;
  const float* delta_h = delta + static_cast<long long>(bh) * seq;

  load_tile<T, D>(sK, k + b * st.kb + h * st.kh, kt * kB, st.kt);
  load_tile<T, D>(sV, v + b * st.vb + h * st.vh, kt * kB, st.vt);
  WarpAcc<T, D> acc_dk, acc_dv;
  acc_dk.zero();
  acc_dv.zero();

  const int n = walk.count();
  for (int s = 0; s < n; ++s) {
    const int qt = walk.tile(s);
    const auto vis = walk.vis(s, qt * kB, kt * kB);
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
    p_and_ds<T, D>(sS, sdP, sP, sdS, sL, sDl, warp, lane, scale_log2,
                   sm_scale, vis);
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

// dQ of one 64-row q tile of head (b, h) over the walk's K/V tiles:
// dQ += dS K, each warp accumulating its own 16 query rows in registers.
template <typename T, int D, typename Walk>
__device__ __forceinline__ void dq_body(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int seq, int heads, const Strides& st,
    float scale_log2, float sm_scale, int qt, int bh, const Walk& walk) {
  using L = BwdLayout<T, D>;
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

  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kh = k + b * st.kb + h * st.kh;
  const T* vh = v + b * st.vb + h * st.vh;
  const float* lse_h = lse + static_cast<long long>(bh) * seq;
  const float* delta_h = delta + static_cast<long long>(bh) * seq;

  load_tile<T, D>(sQ, q + b * st.qb + h * st.qh, qt * kB, st.qt);
  load_tile<T, D>(sdO, dout + b * st.db + h * st.dh, qt * kB, st.dt);
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    sL[i] = lse_h[qt * kB + i];
    sDl[i] = delta_h[qt * kB + i];
  }
  WarpAcc<T, D> acc_dq;
  acc_dq.zero();

  const int n = walk.count();
  for (int s = 0; s < n; ++s) {
    const int kt = walk.tile(s);
    const auto vis = walk.vis(s, qt * kB, kt * kB);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kh, kt * kB, st.kt);
    load_tile<T, D>(sV, vh, kt * kB, st.vt);
    __syncthreads();
    scores<D>(sQ + warp * 16 * L::LD, sK, sS + warp * 16 * L::LDS, lane);
    scores<D>(sdO + warp * 16 * L::LD, sV, sdP + warp * 16 * L::LDS, lane);
    __syncwarp();
    p_and_ds<T, D>(sS, sdP, static_cast<T*>(nullptr), sdS, sL, sDl, warp,
                   lane, scale_log2, sm_scale, vis);
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

// The backward of D 192 and 256: one CTA per 64-row tile and column
// half `half` (DC = D / 2) of its output. BwdLayout<T, DC> holds Q, dO,
// K and V one column half at a time; S = Q K^T and dP = dO V^T
// accumulate over the two halves, the CTA's own half loaded last so
// that its Q and dO (dK/dV) or K (dQ) are in place for the products,
// and WarpAcc<T, DC> keeps the accumulators of a DC-wide head.
template <typename T, int D>
__device__ __forceinline__ void wide_scores(
    const T* qh, const T* dh, const T* kh, const T* vh, const Strides& st,
    int qt, int kt, int half, T* sQ, T* sdO, T* sK, T* sV, float* sS,
    float* sdP, int warp, int lane) {
  constexpr int DC = D / 2;
  using L = BwdLayout<T, DC>;
  for (int i = 0; i < 2; ++i) {
    const int c = i == 0 ? 1 - half : half;
    __syncthreads();  // every warp is done with the halves held
    load_tile<T, DC>(sQ, qh + c * DC, qt * kB, st.qt);
    load_tile<T, DC>(sdO, dh + c * DC, qt * kB, st.dt);
    load_tile<T, DC>(sK, kh + c * DC, kt * kB, st.kt);
    load_tile<T, DC>(sV, vh + c * DC, kt * kB, st.vt);
    __syncthreads();
    float* s = sS + warp * 16 * L::LDS;
    float* dp = sdP + warp * 16 * L::LDS;
    if (i == 0) {
      scores<DC>(sQ + warp * 16 * L::LD, sK, s, lane);
      scores<DC>(sdO + warp * 16 * L::LD, sV, dp, lane);
    } else {
      scores<DC, true>(sQ + warp * 16 * L::LD, sK, s, lane);
      scores<DC, true>(sdO + warp * 16 * L::LD, sV, dp, lane);
    }
  }
}

template <typename T, int D, typename Walk>
__device__ __forceinline__ void dkv_body_wide(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int seq, int heads,
    const Strides& st, float scale_log2, float sm_scale, int kt, int bh,
    int half, const Walk& walk) {
  constexpr int DC = D / 2;
  using L = BwdLayout<T, DC>;
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

  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qh = q + b * st.qb + h * st.qh;
  const T* dh = dout + b * st.db + h * st.dh;
  const T* kh = k + b * st.kb + h * st.kh;
  const T* vh = v + b * st.vb + h * st.vh;
  const float* lse_h = lse + static_cast<long long>(bh) * seq;
  const float* delta_h = delta + static_cast<long long>(bh) * seq;
  WarpAcc<T, DC> acc_dk, acc_dv;
  acc_dk.zero();
  acc_dv.zero();

  const int n = walk.count();
  for (int s = 0; s < n; ++s) {
    const int qt = walk.tile(s);
    const auto vis = walk.vis(s, qt * kB, kt * kB);
    __syncthreads();  // every warp is done with the previous lse/delta
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      sL[i] = lse_h[qt * kB + i];
      sDl[i] = delta_h[qt * kB + i];
    }
    wide_scores<T, D>(qh, dh, kh, vh, st, qt, kt, half, sQ,
                                     sdO, sK, sV, sS, sdP, warp, lane);
    __syncwarp();
    p_and_ds<T, DC>(sS, sdP, sP, sdS, sL, sDl, warp, lane, scale_log2,
                    sm_scale, vis);
    __syncthreads();  // every query row's P and dS is in place
    acc_dv.mma_cols(sP + warp * 16, L::LDP, sdO, L::LD, lane);
    acc_dk.mma_cols(sdS + warp * 16, L::LDP, sQ, L::LD, lane);
  }

  const long long row_stride = static_cast<long long>(heads) * D;
  const long long first =
      (static_cast<long long>(b) * seq + kt * kB + warp * 16) * row_stride +
      static_cast<long long>(h) * D + half * DC;
  acc_dk.store(dk + first, row_stride, stage + warp * 256, lane);
  acc_dv.store(dv + first, row_stride, stage + warp * 256, lane);
}

template <typename T, int D, typename Walk>
__device__ __forceinline__ void dq_body_wide(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int seq, int heads, const Strides& st,
    float scale_log2, float sm_scale, int qt, int bh, int half,
    const Walk& walk) {
  constexpr int DC = D / 2;
  using L = BwdLayout<T, DC>;
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

  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qh = q + b * st.qb + h * st.qh;
  const T* dh = dout + b * st.db + h * st.dh;
  const T* kh = k + b * st.kb + h * st.kh;
  const T* vh = v + b * st.vb + h * st.vh;
  const float* lse_h = lse + static_cast<long long>(bh) * seq;
  const float* delta_h = delta + static_cast<long long>(bh) * seq;
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    sL[i] = lse_h[qt * kB + i];
    sDl[i] = delta_h[qt * kB + i];
  }
  WarpAcc<T, DC> acc_dq;
  acc_dq.zero();

  const int n = walk.count();
  for (int s = 0; s < n; ++s) {
    const int kt = walk.tile(s);
    const auto vis = walk.vis(s, qt * kB, kt * kB);
    wide_scores<T, D>(qh, dh, kh, vh, st, qt, kt, half, sQ,
                                     sdO, sK, sV, sS, sdP, warp, lane);
    __syncwarp();
    p_and_ds<T, DC>(sS, sdP, static_cast<T*>(nullptr), sdS, sL, sDl, warp,
                    lane, scale_log2, sm_scale, vis);
    __syncwarp();
    // dQ += dS K over the warp's own 16 query rows, K's own half
    acc_dq.mma_rows(sdS + warp * 16 * L::LDP, L::LDP, sK, L::LD, lane);
    __syncwarp();
  }

  const long long row_stride = static_cast<long long>(heads) * D;
  const long long first =
      (static_cast<long long>(b) * seq + qt * kB + warp * 16) * row_stride +
      static_cast<long long>(h) * D + half * DC;
  acc_dq.store(dq + first, row_stride, stage + warp * 256, lane);
}

// Raise a kernel's dynamic shared-memory limit to its layout's size.
template <typename Kernel>
void allow_smem(Kernel kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
}

// (input dtype, head dim) as types, for `dispatch_dense`
template <typename T_, int D_>
struct Kind {
  using T = T_;
  static constexpr int D = D_;
};

// fn(Kind<T, D>{}) for dtype (0 = float32, 1 = bfloat16, 2 = float16)
// and the dense kernels' head dims 64, 128, 192, 256 (fp16: 64 and 128,
// the Hopper bodies'); -1 for anything else.
template <typename Fn>
int dispatch_dense(int dtype, int head_dim, Fn&& fn) {
  if (dtype == 2) {
    if (head_dim == 64) return fn(Kind<__half, 64>{});
    if (head_dim == 128) return fn(Kind<__half, 128>{});
    return -1;
  }
  if (dtype == 1) {
    if (head_dim == 64) return fn(Kind<bf16, 64>{});
    if (head_dim == 128) return fn(Kind<bf16, 128>{});
    if (head_dim == 192) return fn(Kind<bf16, 192>{});
    if (head_dim == 256) return fn(Kind<bf16, 256>{});
  } else if (dtype == 0) {
    if (head_dim == 64) return fn(Kind<float, 64>{});
    if (head_dim == 128) return fn(Kind<float, 128>{});
    if (head_dim == 192) return fn(Kind<float, 192>{});
    if (head_dim == 256) return fn(Kind<float, 256>{});
  }
  return -1;
}

}  // namespace attn
