// K1-fwd: flash attention forward, and K5: the same forward merged with
// a prior softmax partial in its epilogue, for Hopper (sm_90a).
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
// balance point, so bytes bound it (0.0434 ms) and the tensor-core rate
// nearly does (0.0373 ms): a kernel near the bound needs both. Every
// design keeps the [T, T] score matrix out of device memory, reads q,
// k, v through their [B, T, H, D] strides (so the q/k/v column slices
// of the fused qkv projection are read in place; the TPU launcher's
// transpose to [B*H, T, D] was a layout step for its BlockSpecs), and
// skips causal tiles above the diagonal.
//
// bf16 at head dims 64 and 128, the main path, runs the Hopper body of
// attention_hopper.cuh: TMA loads through 4-D tensor maps, wgmma from
// 128-byte-swizzled shared memory, scores, softmax and O in registers,
// one CTA of two 64-row warpgroups per 128-row q tile walking 64-row
// K/V tiles in a 4-stage ring (2 at D 128), two CTAs per SM. At D 64
// exp2 (one MUFU op per score, 16 a clock per SM) costs as much time as
// the two products of that score on the tensor cores, so the softmax
// is cut to one FFMA, one MUFU, a max and an add per score (the scale
// folded into the exponent, the row max taken on raw scores, masks only
// on tiles that cross the diagonal, O rescaled only where a row's max
// moved); measured on the H100 (PERF.md) it holds ~1.35x the time of
// torch's SDPA forward at the flagship shape, ~27% of the bound. fp32
// inputs and head dims 192/256 keep attention_tiles.cuh's bodies: 4
// warps per 64-row tile, WMMA 16x16x16 bf16 fragments (or CUDA-core
// fp32: the TPU kernel's fp32 dots were exact fp32, which TF32 would
// not be), the fp32 output accumulator in shared memory, synchronous
// 16-byte loads; head dims 192 and 256 in two column halves of Q, K, V
// and O, which fits the 227 KB of shared memory in fp32 too.
//
// K5 replaces the same Pallas kernels in merge mode (`_fwd_kernel` :262
// and `_fwd_kernel_packed` :337 with merge=True, launcher `_fwd(prev=)`,
// entry `flash_attention_merge`), the body of a ring-attention step: the
// flash forward of q over one K/V block whose epilogue folds the running
// ring carry (prev_out fp32 [B, T, H, D] through its strides, prev_lse
// [B*H, T] log2) into the block's (m, l, acc) before the single write
// of out (fp32), the merged lse and the block's own lse_n (the
// backward's residual). Its bound is K1's plus the carry: it reads
// prev_out and writes out in fp32, 14 bytes per output element against
// K1's 8 at bf16 (q, k, v read, out written), while the score work is
// K1's, so where K1 is near the balance point the merge makes it bytes
// bound. The design keeps that traffic to
// one pass: the carry is read and the merged row written in the
// epilogue, once per row (8-byte reads and writes on the Hopper body),
// where a separate merge would read and write the partial and the
// carry again. An empty row of the block (none on a
// ring's chunk-causal walk) merges as an empty partial, and -1e30 in
// prev_lse marks an empty carry (the ring's first step).
#include "attention_hopper.cuh"

namespace {

using namespace attn;

template <typename T, int D, bool Merge>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, FwdOut<Merge, T>* __restrict__ out,
                 float* __restrict__ lse, int seq, int heads, Strides st,
                 float scale_log2, int causal, MergeIn mg) {
  const int qt = blockIdx.x;
  // kB rows in both tiles: causal tiles strictly above the diagonal are
  // skipped
  const DenseWalk walk{0, causal ? qt + 1 : seq / kB, causal};
  if constexpr (D > 128)
    fwd_body_wide<T, D, DenseWalk, Merge>(q, k, v, out, lse, seq, heads,
                                          st, scale_log2, qt, blockIdx.y,
                                          walk, mg);
  else
    fwd_body<T, D, DenseWalk, Merge>(q, k, v, out, lse, seq, heads, st,
                                     scale_log2, qt, blockIdx.y, walk, mg);
}

template <typename T, int D, bool Merge>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int batch, int seq, int heads, const long long* s,
           float scale_log2, int causal, const MergeIn& mg,
           cudaStream_t stream) {
  constexpr size_t bytes =
      D > 128 ? WideFwdLayout<T, D>::bytes : FwdLayout<T, D>::bytes;
  auto kern = flash_fwd_kernel<T, D, Merge>;
  allow_smem(kern, bytes);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                   0, 0, 0};
  dim3 grid(seq / kB, batch * heads);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<FwdOut<Merge, T>*>(out), lse,
      seq, heads, st, scale_log2, causal, mg);
  return static_cast<int>(cudaGetLastError());
}

// bf16 and fp16 (E) at D 64 and 128: one CTA per (b*h, 128-row q tile),
// in `GridOrder`'s order
template <typename E, int D, bool Merge>
__global__ void __launch_bounds__(sm90::kThreads, sm90::FwdCfg<D>::kBlocks)
flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      FwdOut<Merge, E>* __restrict__ out,
                      float* __restrict__ lse, int seq, int heads,
                      float scale_log2, int causal, sm90::GridOrder order,
                      MergeIn mg) {
  const int nt = (seq + sm90::kRows - 1) / sm90::kRows;
  int bh, rank;
  order.at(nt, bh, rank);
  const int qt = nt - 1 - rank;
  // 64-row K/V tiles up to the tile's last row (causal)
  const int nk = seq / sm90::FwdCfg<D>::kN;
  const int last = (qt + 1) * sm90::kRows / sm90::FwdCfg<D>::kN;
  const sm90::DenseWalk90 walk{0, causal && last < nk ? last : nk, causal,
                               seq};
  sm90::fwd_body<D, Merge, sm90::DenseWalk90, E>(mq, mk, mv, out, lse, seq,
                                                heads, scale_log2, qt, bh,
                                                walk, mg);
}

template <typename E, int D, bool Merge>
int launch_sm90(const void* q, const void* k, const void* v, void* out,
                float* lse, int batch, int seq, int heads,
                const long long* s, float scale_log2, int causal,
                const MergeIn& mg, cudaStream_t stream) {
  using L = sm90::FwdCfg<D>;
  constexpr auto dt = sm90::map_type<E>();
  CUtensorMap mq, mk, mv;
  if (sm90::make_map(&mq, q, batch, seq, heads, D, s[0], s[1], s[2],
                     sm90::kRows, dt) ||
      sm90::make_map(&mk, k, batch, seq, heads, D, s[3], s[4], s[5],
                     L::kN, dt) ||
      sm90::make_map(&mv, v, batch, seq, heads, D, s[6], s[7], s[8], L::kN,
                     dt))
    return sm90::kMapError;
  auto kern = flash_fwd_kernel_sm90<E, D, Merge>;
  allow_smem(kern, L::bytes);
  const long long nt = (seq + sm90::kRows - 1) / sm90::kRows;
  kern<<<static_cast<unsigned>(nt * batch * heads), sm90::kThreads, L::bytes,
         stream>>>(mq, mk, mv, static_cast<FwdOut<Merge, E>*>(out), lse,
                   seq, heads, scale_log2, causal,
                   sm90::grid_order(static_cast<long long>(batch) * heads,
                                    seq, D),
                   mg);
  return static_cast<int>(cudaGetLastError());
}

// the Hopper body where it applies, attention_tiles.cuh's otherwise
template <typename T, int D, bool Merge>
int route(const void* q, const void* k, const void* v, void* out,
          float* lse, int batch, int seq, int heads, const long long* s,
          float scale_log2, int causal, const MergeIn& mg,
          cudaStream_t stream) {
  if constexpr (sm90::kOnSm90<T, D>)
    return launch_sm90<T, D, Merge>(q, k, v, out, lse, batch, seq, heads, s,
                                 scale_log2, causal, mg, stream);
  else
    return launch<T, D, Merge>(q, k, v, out, lse, batch, seq, heads, s,
                               scale_log2, causal, mg, stream);
}

}  // namespace

// q/k/v strides in elements, in the order (b, t, h) for q, then k, then
// v; the last dimension is contiguous. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16 (head dims 64 and 128 only); head_dim 64, 128, 192 or 256.
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
  return dispatch_dense(dtype, head_dim, [&](auto kind) {
    using K = decltype(kind);
    return route<typename K::T, K::D, false>(q, k, v, out, lse, batch, seq,
                                             heads, strides, scale_log2,
                                             causal, MergeIn{}, s);
  });
}

// K5: as ds_flash_attn_fwd, merged with the prior partial (prev_out fp32,
// read through its (b, t, h) strides, the 10th-12th of the 12 strides
// after q's, k's and v's; prev_lse [B*H, T] fp32). Writes out fp32
// [B, T, H, D] (contiguous), the merged lse and the block's own lse_n,
// both [B*H, T] fp32.
extern "C" int ds_flash_attn_fwd_merge(
    const void* q, const void* k, const void* v, const float* prev_out,
    const float* prev_lse, float* out, float* lse, float* lse_n, int batch,
    int seq, int heads, int head_dim, const long long* strides,
    float scale_log2, int causal, int dtype, int device, void* stream) {
  cudaSetDevice(device);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch * seq == 0) return 0;
  const MergeIn mg{prev_out, strides[9], strides[10], strides[11], prev_lse,
                   lse_n};
  return dispatch_dense(dtype, head_dim, [&](auto kind) {
    using K = decltype(kind);
    return route<typename K::T, K::D, true>(q, k, v, out, lse, batch, seq,
                                            heads, strides, scale_log2,
                                            causal, mg, s);
  });
}
