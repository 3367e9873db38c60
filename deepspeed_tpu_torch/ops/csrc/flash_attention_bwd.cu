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
// the qkv column slices need no copy. Head dims 192 and 256 take the
// tile body's wide form: one CTA per tile and output column half, the
// scores accumulated over the halves (and so computed by both halves'
// CTAs), so the register accumulators stay those of a 128-wide head.
//
// The given-delta entry (`ds_flash_attn_bwd_delta`) is K5's backward (the
// TPU launcher's `_bwd(..., delta=)` with out None, driven by
// `_flash_merge_bwd`): the caller computes delta from the merge weights,
// no `out` exists, and a one-pass kernel writes delta - log2(e) * dlse
// into the workspace, leaving the caller's delta as it was.
#include "attention_tiles.cuh"

namespace {

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int heads, Strides st,
                     float scale_log2, float sm_scale, int causal) {
  const int kt = blockIdx.x;
  const int nt = seq / kB;
  // causal q tiles strictly below kt see no key here
  const DenseWalk walk{causal ? kt : 0, causal ? nt - kt : nt, causal};
  if constexpr (D > 128)
    dkv_body_wide<T, D>(q, k, v, dout, lse, delta, dk, dv, seq, heads, st,
                        scale_log2, sm_scale, kt, blockIdx.y, blockIdx.z,
                        walk);
  else
    dkv_body<T, D>(q, k, v, dout, lse, delta, dk, dv, seq, heads, st,
                   scale_log2, sm_scale, kt, blockIdx.y, walk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int seq, int heads, Strides st, float scale_log2,
                    float sm_scale, int causal) {
  const int qt = blockIdx.x;
  const DenseWalk walk{0, causal ? qt + 1 : seq / kB, causal};
  if constexpr (D > 128)
    dq_body_wide<T, D>(q, k, v, dout, lse, delta, dq, seq, heads, st,
                       scale_log2, sm_scale, qt, blockIdx.y, blockIdx.z,
                       walk);
  else
    dq_body<T, D>(q, k, v, dout, lse, delta, dq, seq, heads, st, scale_log2,
                  sm_scale, qt, blockIdx.y, walk);
}

// delta[i] = delta_in[i] - log2(e) * dlse[i] (dlse may be null)
__global__ void shift_delta_kernel(const float* __restrict__ delta_in,
                                   const float* __restrict__ dlse,
                                   float* __restrict__ delta, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n)
    delta[i] = dlse != nullptr ? delta_in[i] - kLog2e * dlse[i]
                               : delta_in[i];
}

// the dK/dV and dQ sweeps off lse and a ready delta
template <typename T, int D>
int launch_sweeps(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int batch, int seq,
                  int heads, const long long* s, float scale_log2,
                  float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = D > 128 ? BwdLayout<T, D / 2>::bytes
                                   : BwdLayout<T, D>::bytes;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5],
                   s[6], s[7], s[8], s[12], s[13], s[14]};
  auto dkv = flash_bwd_dkv_kernel<T, D>;
  auto dqk = flash_bwd_dq_kernel<T, D>;
  allow_smem(dkv, bytes);
  allow_smem(dqk, bytes);
  dim3 grid(seq / kB, batch * heads, D > 128 ? 2 : 1);
  dkv<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), seq, heads, st, scale_log2,
      sm_scale, causal);
  dqk<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), seq, heads, st, scale_log2, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Element strides (b, t, h), in this order, of q, k, v, out, dout (15
// values); the head dim of each is contiguous. dq/dk/dv are contiguous
// [B, T, H, D]; lse, dlse (may be null) and the delta workspace are
// [B*H, T] fp32. dtype: 0 = float32, 1 = bfloat16; head_dim 64, 128, 192
// or 256. Returns cudaGetLastError(), or -1 for an unsupported (dtype, D).
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
  return dispatch_dense(dtype, head_dim, [&](auto kind) {
    using K = decltype(kind);
    using T = typename K::T;
    launch_delta<T, K::D>(out, dout, dlse, delta, batch, seq, heads,
                          strides + 9, strides + 12, s);
    return launch_sweeps<T, K::D>(q, k, v, dout, lse, delta, dq, dk, dv,
                                  batch, seq, heads, strides, scale_log2,
                                  sm_scale, causal, s);
  });
}

// The given-delta backward: as ds_flash_attn_bwd with no `out` (its
// three strides are not read) and delta_in [B*H, T] fp32 given; delta,
// the workspace, receives delta_in - log2(e) * dlse (dlse may be null)
// and delta_in is left as it was.
extern "C" int ds_flash_attn_bwd_delta(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dlse, const float* delta_in, void* dq,
    void* dk, void* dv, float* delta, int batch, int seq, int heads,
    int head_dim, const long long* strides, float scale_log2,
    float sm_scale, int causal, int dtype, int device, void* stream) {
  cudaSetDevice(device);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch * seq == 0) return 0;
  return dispatch_dense(dtype, head_dim, [&](auto kind) {
    using K = decltype(kind);
    const long long n = static_cast<long long>(batch) * heads * seq;
    shift_delta_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         s>>>(delta_in, dlse, delta, n);
    return launch_sweeps<typename K::T, K::D>(
        q, k, v, dout, lse, delta, dq, dk, dv, batch, seq, heads, strides,
        scale_log2, sm_scale, causal, s);
  });
}
