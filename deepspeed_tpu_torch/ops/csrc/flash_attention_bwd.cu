// K2: flash attention backward in two sweeps, for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_bwd_dkv_kernel`, `_bwd_dq_kernel` and
// their packed twins in deepspeed_tpu/ops/transformer/flash_attention.py
// (launcher `_bwd`), which the JAX package runs where the sequence is
// more than one tile of its 1024-row default block. Its one-tile kernel
// `_bwd_fused_kernel` (every T <= 1024) is K2-fused,
// flash_attention_bwd_fused.cu, and the wrapper routes as `_bwd` does:
// these sweeps run at T > 1024 (the ring leg's 8k and 32k), and in fp32
// and at head dims 192 and 256 at every T.
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
// (b, t, h) row), then the TPU kernel's two sweeps. The dK/dV sweep
// runs one CTA per (b*h, k tile) that walks the q tiles at or below the
// diagonal; the dQ sweep one CTA per (b*h, q tile) that walks the k
// tiles up to the diagonal. Both recompute S and P, so the score work is
// done twice (7 products per visible pair against K2-fused's 5),
// but every output row is owned by one CTA: no atomics, and a run
// repeats bit for bit.
//
// Bound on the H100: at the ring leg's [1, 8192, 4, 64] (bf16, causal)
// the backward does 2.5x the forward's matmul work over ~1.6x its bytes,
// so operations bound it at the tensor-core rate (0.0869 ms for the 5
// products a pair needs). bf16 and fp16 at head dims 64 and 128 run the
// Hopper sweeps of attention_hopper.cuh: 128 keys (dK/dV) or
// queries (dQ) resident per CTA, two warpgroups of 64 rows, the other
// side streamed by TMA in 64-row tiles through a 3-stage ring (with the
// step's lse and delta rows), scores and gradients in wgmma registers;
// the dK/dV sweep forms the transposed scores so that P^T and dS^T feed
// its products as register operands. Measured on the H100 (PERF.md) it
// holds ~1.3x the time of torch's SDPA backward at the flagship shape
// (where the paths now take K2-fused) and less than SDPA's at head dim
// 128, ~17% of the bound. fp32 inputs
// and head dims 192/256 keep attention_tiles.cuh's bodies: WMMA
// 16x16x16 bf16 fragments (or a CUDA-core path for fp32: the TPU
// kernel's fp32 dots were exact fp32; the tensor cores would round to
// TF32) with the accumulators in registers, plain 16-byte loads; head
// dims 192 and 256 one CTA per tile and output column half, the scores
// accumulated over the halves (and so computed by both halves' CTAs), so
// the register accumulators stay those of a 128-wide head. q/k/v/dO/O
// are read through their [B, T, H, D] strides everywhere, so the qkv
// column slices need no copy.
//
// The given-delta entry (`ds_flash_attn_bwd_delta`) is K5's backward (the
// TPU launcher's `_bwd(..., delta=)` with out None, driven by
// `_flash_merge_bwd`): the caller computes delta from the merge weights,
// no `out` exists, and a one-pass kernel writes delta - log2(e) * dlse
// into the workspace, leaving the caller's delta as it was.
#include "attention_hopper.cuh"

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

// bf16 and fp16 (E) at D 64 and 128 (attention_hopper.cuh), each sweep
// one CTA per (b*h, 128-row tile) in `GridOrder`'s order: the dK/dV
// sweep's k tiles from the first (the longest causal walk), the dQ
// sweep's from the last
template <typename E, int D>
__global__ void __launch_bounds__(sm90::kThreads,
                                  sm90::BwdCfg<D>::kDkvBlocks)
flash_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          E* __restrict__ dk, E* __restrict__ dv,
                          int seq, int heads, float scale_log2,
                          float sm_scale, int causal,
                          sm90::GridOrder order) {
  const int nt = (seq + sm90::kRows - 1) / sm90::kRows;
  int bh, kt;
  order.at(nt, bh, kt);
  // 64-row q steps; causal steps wholly before the tile's first key are
  // skipped
  const int first = causal ? kt * sm90::kRows / sm90::kStep : 0;
  const sm90::DenseWalk90 walk{first, seq / sm90::kStep - first, causal,
                               seq};
  sm90::dkv_body<D>(mq, mk, mv, mdo, lse, delta, dk, dv, seq, heads,
                    scale_log2, sm_scale, kt, bh, walk);
}

template <typename E, int D>
__global__ void __launch_bounds__(sm90::kThreads, sm90::BwdCfg<D>::kDqBlocks)
flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         E* __restrict__ dq, int seq, int heads,
                         float scale_log2, float sm_scale, int causal,
                         sm90::GridOrder order) {
  const int nt = (seq + sm90::kRows - 1) / sm90::kRows;
  int bh, rank;
  order.at(nt, bh, rank);
  const int qt = nt - 1 - rank;
  // 64-row k steps up to the tile's last query (causal)
  const int nk = seq / sm90::kStep;
  const int last = (qt + 1) * sm90::kRows / sm90::kStep;
  const sm90::DenseWalk90 walk{0, causal && last < nk ? last : nk, causal,
                               seq};
  sm90::dq_body<D>(mq, mk, mv, mdo, lse, delta, dq, seq, heads, scale_log2,
                   sm_scale, qt, bh, walk);
}

template <typename E, int D>
int launch_sweeps_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int batch, int seq, int heads, const long long* s,
                       float scale_log2, float sm_scale, int causal,
                       cudaStream_t stream) {
  using L = sm90::BwdCfg<D>;
  constexpr int R = sm90::kRows, S = sm90::kStep;
  // resident (R rows) and streamed (S rows) maps of each operand
  CUtensorMap q_r, q_s, k_r, k_s, v_r, v_s, do_r, do_s;
  const void* ptr[4] = {q, k, v, dout};
  CUtensorMap* res[4] = {&q_r, &k_r, &v_r, &do_r};
  CUtensorMap* str[4] = {&q_s, &k_s, &v_s, &do_s};
  const long long* st[4] = {s, s + 3, s + 6, s + 12};
  constexpr auto dt = sm90::map_type<E>();
  for (int i = 0; i < 4; ++i)
    if (sm90::make_map(res[i], ptr[i], batch, seq, heads, D, st[i][0],
                       st[i][1], st[i][2], R, dt) ||
        sm90::make_map(str[i], ptr[i], batch, seq, heads, D, st[i][0],
                       st[i][1], st[i][2], S, dt))
      return sm90::kMapError;
  auto dkv = flash_bwd_dkv_kernel_sm90<E, D>;
  auto dqk = flash_bwd_dq_kernel_sm90<E, D>;
  allow_smem(dkv, L::bytes);
  allow_smem(dqk, L::bytes);
  const long long bhs = static_cast<long long>(batch) * heads;
  const unsigned grid = static_cast<unsigned>((seq + R - 1) / R * bhs);
  const sm90::GridOrder order = sm90::grid_order(bhs, seq, D);
  dkv<<<grid, sm90::kThreads, L::bytes, stream>>>(
      q_s, k_r, v_r, do_s, lse, delta, static_cast<E*>(dk),
      static_cast<E*>(dv), seq, heads, scale_log2, sm_scale, causal,
      order);
  dqk<<<grid, sm90::kThreads, L::bytes, stream>>>(
      q_r, k_s, v_s, do_r, lse, delta, static_cast<E*>(dq), seq, heads,
      scale_log2, sm_scale, causal, order);
  return static_cast<int>(cudaGetLastError());
}

// the Hopper sweeps where they apply, attention_tiles.cuh's otherwise
template <typename T, int D>
int route_sweeps(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, int batch, int seq, int heads,
                 const long long* s, float scale_log2, float sm_scale,
                 int causal, cudaStream_t stream) {
  if constexpr (sm90::kOnSm90<T, D>)
    return launch_sweeps_sm90<T, D>(q, k, v, dout, lse, delta, dq, dk, dv,
                                 batch, seq, heads, s, scale_log2, sm_scale,
                                 causal, stream);
  else
    return launch_sweeps<T, D>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                               seq, heads, s, scale_log2, sm_scale, causal,
                               stream);
}

}  // namespace

// Element strides (b, t, h), in this order, of q, k, v, out, dout (15
// values); the head dim of each is contiguous. dq/dk/dv are contiguous
// [B, T, H, D]; lse, dlse (may be null) and the delta workspace are
// [B*H, T] fp32. dtype: 0 = float32, 1 = bfloat16, 2 = float16 (head dims
// 64 and 128 only); head_dim 64, 128, 192 or 256. Returns
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
  return dispatch_dense(dtype, head_dim, [&](auto kind) {
    using K = decltype(kind);
    using T = typename K::T;
    launch_delta<T, K::D>(out, dout, dlse, delta, batch, seq, heads,
                          strides + 9, strides + 12, s);
    return route_sweeps<T, K::D>(q, k, v, dout, lse, delta, dq, dk, dv,
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
  // K5's backward in fp16 is not ported: no fp16 instantiation
  return dispatch_dense<false>(dtype, head_dim, [&](auto kind) {
    using K = decltype(kind);
    const long long n = static_cast<long long>(batch) * heads * seq;
    shift_delta_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         s>>>(delta_in, dlse, delta, n);
    return route_sweeps<typename K::T, K::D>(
        q, k, v, dout, lse, delta, dq, dk, dv, batch, seq, heads, strides,
        scale_log2, sm_scale, causal, s);
  });
}
