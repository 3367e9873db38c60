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
#include "attention_tiles.cuh"

namespace {

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int seq, int heads, Strides st,
                 float scale_log2, int causal) {
  const int qt = blockIdx.x;
  // kB rows in both tiles: causal tiles strictly above the diagonal are
  // skipped
  const DenseWalk walk{0, causal ? qt + 1 : seq / kB, causal};
  fwd_body<T, D>(q, k, v, out, lse, seq, heads, st, scale_log2, qt,
                 blockIdx.y, walk);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int batch, int seq, int heads, const long long* s,
           float scale_log2, int causal, cudaStream_t stream) {
  using L = FwdLayout<T, D>;
  auto kern = flash_fwd_kernel<T, D>;
  allow_smem(kern, L::bytes);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                   0, 0, 0};
  dim3 grid(seq / kB, batch * heads);
  kern<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, seq, heads, st,
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
