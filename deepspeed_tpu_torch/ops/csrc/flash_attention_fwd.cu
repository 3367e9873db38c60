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
// no TMA, no wgmma, no pipelining of the tile loads yet. Head dims 192
// and 256 take the tile body's wide form (two column halves of Q, K, V
// and O), which fits the 227 KB of shared memory in fp32 too.
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
// epilogue, once per row, where a separate merge would read and write
// the partial and the carry again. An empty row of the block (none on a
// ring's chunk-causal walk) merges as an empty partial, and -1e30 in
// prev_lse marks an empty carry (the ring's first step).
#include "attention_tiles.cuh"

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

}  // namespace

// q/k/v strides in elements, in the order (b, t, h) for q, then k, then
// v; the last dimension is contiguous. dtype: 0 = float32, 1 = bfloat16;
// head_dim 64, 128, 192 or 256. Returns cudaGetLastError(), or -1 for an
// unsupported (dtype, D).
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
    return launch<typename K::T, K::D, false>(q, k, v, out, lse, batch, seq,
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
    return launch<typename K::T, K::D, true>(q, k, v, out, lse, batch, seq,
                                             heads, strides, scale_log2,
                                             causal, mg, s);
  });
}
