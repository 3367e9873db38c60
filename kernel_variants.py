#!/usr/bin/env python3
"""Where the Hopper kernels' time goes, on one NVIDIA GPU.

    python3 kernel_variants.py forward     # K1-fwd with parts switched off
    python3 kernel_variants.py backward    # K2's sweeps and delta pre-pass
    python3 kernel_variants.py fused_bwd   # K2-fused with parts switched off
    python3 kernel_variants.py order       # the grid order's L2 budget
    python3 kernel_variants.py qmm         # K6 with parts switched off
    python3 kernel_variants.py sparse_bwd  # K7-dkv and K7-dq on Hopper
    python3 kernel_variants.py gelu        # K4-fwd and K4-bwd
    python3 kernel_variants.py ln_bwd      # K3-bwd
    python3 kernel_variants.py ln_fwd      # K3-fwd
    python3 kernel_variants.py sparse_fwd  # K7-fwd on Hopper
    python3 kernel_variants.py compare DIR [phase ...]
                                           # chip_smoke.py phases from the
                                           # tree DIR and this one, in turns
    python3 kernel_variants.py checkpoint_io
                                           # phase 21 with np.savez and
                                           # np.load, and as it is, in turns
    python3 kernel_variants.py remat_policies
                                           # training steps under each remat
                                           # policy and full remat, in turns

Each variant is a copy of deepspeed_tpu_torch/ops/csrc/ with a few text
substitutions (a product, the softmax, an epilogue or a whole sweep
switched off, or a constant changed), built with the same nvcc flags as
ops/_build.py into build/kernel_variants/ (git-ignored), all variants in
parallel. The script times each one's library, through the port's own
wrapper, at the main path's shapes with CUDA events (mean of 20 calls
after 3): the attention modes at bf16 shapes with torch's
scaled_dot_product_attention beside them as the yardstick, `qmm` at the
flagship's four projections (the launch alone, on operands in the
kernel's layouts) with torch._int_mm and the bf16 matmul beside them,
`sparse_bwd` K7-dkv (its delta pre-pass included) and K7-dq on the
Hopper sweeps at the sparse path's shape ([1, 16384, 16, 64] bf16,
block 256, causal) under BSLongformer, Fixed and BigBird, `gelu` K4-fwd
and K4-bwd (tanh form, bf16 rows) at the serving, decode, training and
MoE shapes with torch's own GeLU forward and backward beside them,
`ln_bwd` K3-bwd at the training (block and ln_f forms) and MoE shapes
and at the gpt2-6.7b and gpt2-13b widths beside torch's LayerNorm
backward, `ln_fwd` K3-fwd at every path's shape (LN_FWD_SHAPES) with its
stores, its statistics exchange, its vector loads or its prefetch
switched off and under other plans, beside torch's LayerNorm forward,
`sparse_fwd` K7-fwd on the Hopper
body under BigBird at head dims 64 and 128 beside the WMMA table
forward, `fused_bwd` K2-fused at the flagship's shape (causal and not),
the MoE cell's, BERT's and a head dim of 128 by CUDA graph, beside K2's
sweeps. A
variant with a part switched off computes garbage: it is timed, never
checked (`chip_smoke.py` and tests/test_torch_cuda.py check the kernels).
A substitution that no longer applies to the sources fails the run.
Prints one JSON line per variant, then the card's name and power limit.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "kernel_variants")
H, FWD, BWD = "attention_hopper.cuh", "flash_attention_fwd.cu", \
    "flash_attention_bwd.cu"

# the parts a variant switches off, as (file, text, replacement)
NO_SOFTMAX = (H, "      float alpha[2];\n#pragma unroll\n      for (int i = 0; "
              "i < 2; ++i) {", "      float alpha[2] = {1.f, 1.f};\n#pragma "
              "unroll\n      for (int i = 0; i < 0; ++i) {")
NO_PV = (H, "      gemm_pb<D, kN, kN>(o, p, sV + st * kN * D, 0);\n",
         "      if (it < 0) gemm_pb<D, kN, kN>(o, p, sV + st * kN * D, 0);\n")
NO_S = (H, "      gemm_abt<D, kRows, kN>(s, sQ, wg * 64, sK + st * kN * D, 0);"
        "\n", "      if (it < 0) gemm_abt<D, kRows, kN>(s, sQ, wg * 64, "
        "sK + st * kN * D, 0);\n")
NO_MASK = (H, "      if (walk.partial(it, q0, 64, k0, kN))\n        hide(s,",
           "      if (it < 0)\n        hide(s,")
NO_DQ = (BWD, "  dqk<<<grid, sm90::kThreads, L::bytes, stream>>>(",
         "  if (seq < 0) dqk<<<grid, sm90::kThreads, L::bytes, stream>>>(")
NO_DKV = (BWD, "  dkv<<<grid, sm90::kThreads, L::bytes, stream>>>(",
          "  if (seq < 0) dkv<<<grid, sm90::kThreads, L::bytes, stream>>>(")
DKV_NO_ELEMENTWISE = (H, "#pragma unroll\n      for (int j = 0; j < kStep / "
                      "8; ++j) {\n        const int c = 8 * j",
                      "#pragma unroll\n      for (int j = 0; j < 0; ++j) {\n"
                      "        const int c = 8 * j")
DKV_NO_SCORES = (H, "      gemm_abt<D, kRows, kStep>(st_, sK, wg * 64, q_s, 0);"
                 "\n      gemm_abt<D, kRows, kStep>(dpt, sV, wg * 64, do_s, 0);"
                 "\n", "      if (it < 0) gemm_abt<D, kRows, kStep>(st_, sK, "
                 "wg * 64, q_s, 0);\n      if (it < 0) gemm_abt<D, kRows, "
                 "kStep>(dpt, sV, wg * 64, do_s, 0);\n")
DKV_NO_GRADS = (H, "      gemm_pb<D, kStep, kStep>(acc_dv, pa, do_s, 0);\n"
                "      gemm_pb<D, kStep, kStep>(acc_dk, da, q_s, 0);\n",
                "      if (it < 0) gemm_pb<D, kStep, kStep>(acc_dv, pa, do_s, "
                "0);\n      if (it < 0) gemm_pb<D, kStep, kStep>(acc_dk, da, "
                "q_s, 0);\n")


# K2-fused (flash_attention_bwd_fused.cu): the ordered adds (no baton
# waited for or passed: the partials land in any order), the dQ exchange
# made local (every partial stored into the workspace: no add at L2, no
# read-back; unordered too, since no partial waits), the dQ phase (its
# product and exchange; the dS^T hand-off barrier kept), the steps alone
# (no dQ phase, no dS^T stores, no hand-off barrier), and without the
# prologue's own delta rows too; and the layout's parts one at a time:
# the ring's depth at head dim 64, the second key block's K/V loaded at
# the switch rather than at the start, and a fence of each adder's own
# before the baton's barrier
FB = "flash_attention_bwd_fused.cu"
FUSED_UNORDERED = (FB, "  static constexpr bool kOrdered = true;",
                   "  static constexpr bool kOrdered = false;")
FUSED_DQ_LOCAL = (FB, "    const bool first = plan.first[c][p], last = "
                  "plan.next_cta[c][p] < 0;",
                  "    const bool first = true, last = plan.first[c][p] && "
                  "plan.next_cta[c][p] < 0;")
FUSED_NO_DQ = (FB, "    return pair_qb(p) * kRows + wg * kStep < seq;",
               "    return seq < 0;")
FUSED_NO_HANDOFF = (FB, "    if (cb == 0) named_sync(1, kThreads);\n",
                    "    if (seq < 0) named_sync(1, kThreads);\n")
FUSED_NO_DS_STORES = (FB, "          for (int x = 0; x < 4; ++x)\n"
                      "            *reinterpret_cast<uint32_t*>(",
                      "          for (int x = 0; x < 4; ++x)\n"
                      "            if (seq < 0) *reinterpret_cast<uint32_t*>(")
FUSED_NO_OWN_DELTA = (FB, "        const bool rows = live && delta_in == nullptr;",
                      "        const bool rows = false;")
FUSED_KV_AT_SWITCH = (FB, "  static constexpr bool kPrefetchKV = true;",
                      "  static constexpr bool kPrefetchKV = false;")


def fused_stages(n):
    """K2-fused's ring of n stages at head dim 64."""
    return (FB, "  static constexpr int kS = D == 64 ? 3 : 2;",
            f"  static constexpr int kS = D == 64 ? {n} : 2;")


FUSED_ADDER_FENCE = (FB, "    named_sync(2 + wg, 128);\n    if (tid % 128 "
                     "== 0)\n      baton_pass(",
                     "    asm volatile(\"fence.acq_rel.gpu;\\n\" ::: \"memory\");"
                     "\n    named_sync(2 + wg, 128);\n    if (tid % 128 == 0)\n"
                     "      baton_pass(")

# K7-dkv and K7-dq on the Hopper sweeps (block_sparse_attention.cu over
# attention_hopper.cuh): the dQ sweep's counterparts of the dK/dV parts
# above, the masks of both, the CTAs' order and the long walks
B = "block_sparse_attention.cu"
BWD_NO_MASKS = [(H, "      if (walk.partial(it, q0, kStep, k0, 64))\n"
                 "        hide_t(", "      if (it < 0)\n        hide_t("),
                (H, "      if (walk.partial(it, q0, 64, k0, kStep))\n"
                 "        hide(s,", "      if (it < 0)\n        hide(s,"),
                (B, "    if ((w >> 20) & 1) m = half_mask<kKeys>(w, q0, k0);",
                 "")]
DQ_NO_ELEMENTWISE = (H, "      for (int e = 0; e < kStep / 2; ++e) {\n"
                     "        const int i = (e / 2) % 2;",
                     "      for (int e = 0; e < 0; ++e) {\n"
                     "        const int i = (e / 2) % 2;")
DQ_NO_SCORES = (H, "      gemm_abt<D, kRows, kStep>(s, sQ, wg * 64, k_s, 0);\n"
                "      gemm_abt<D, kRows, kStep>(dp, sdO, wg * 64, "
                "sV + st * kStep * D, 0);\n",
                "      if (it < 0) gemm_abt<D, kRows, kStep>(s, sQ, wg * 64, "
                "k_s, 0);\n      if (it < 0) gemm_abt<D, kRows, kStep>(dp, "
                "sdO, wg * 64, sV + st * kStep * D, 0);\n")
DQ_NO_GRADS = (H, "      gemm_pb<D, kStep, kStep>(acc, da, k_s, 0);\n",
               "      if (it < 0) gemm_pb<D, kStep, kStep>(acc, da, k_s, 0);\n")
# the (head, tile) pairs in index order in place of longest walk first
NATURAL_ORDER = (B, "  const int pair = order[blockIdx.x / batch];",
                 "  const int pair = blockIdx.x / batch;")
# every walk cut to its first 64 steps (the global columns' long rows cut)
SHORT_WALKS = (B, "  const int n = count[row];",
               "  const int n = min(count[row], 64);")


# K6 (quantized_matmul.cu): the loads, the products, the per-block
# epilogue, the output's store, the ring's depth, the tiles' order, the
# conversion
Q = "quantized_matmul.cu"
QMM_NO_PRODUCTS = (Q, "        wgmma_s8_n128(part, desc_sw128(a0 + kk * 32, 16, "
                   "1024),", "        if (it < 0) wgmma_s8_n128(part, "
                   "desc_sw128(a0 + kk * 32, 16, 1024),")
QMM_NO_EPILOGUE = (Q, "      if (k % spb == spb - 1) {\n        const float* sws",
                   "      if (it < 0) {\n        const float* sws")
# the consumer warpgroups issue their products in turn (named barriers)
QMM_TURNS = [(Q, "      const bool first = k % spb == 0;\n      wg_fence();",
              "      const bool first = k % spb == 0;\n      if (wg == 1)\n"
              "        asm volatile(\"bar.sync 1, 256;\" ::: \"memory\");\n"
              "      else if (it > 0)\n"
              "        asm volatile(\"bar.sync 2, 256;\" ::: \"memory\");\n"
              "      wg_fence();"),
             (Q, "      wg_commit();\n      wg_wait();",
              "      wg_commit();\n      if (wg == 0)\n"
              "        asm volatile(\"bar.arrive 1, 256;\" ::: \"memory\");\n"
              "      else if (it + 1 < steps)\n"
              "        asm volatile(\"bar.arrive 2, 256;\" ::: \"memory\");\n"
              "      wg_wait();")]
QMM_NO_STORE = (Q, "      if (row >= m) continue;", "      if (row >= 0) continue;")
QMM_NO_LOADS = [(Q, "    mbar_expect_tx(bar, Cfg::stage_bytes);\n    tma_load_3d(",
                 "    mbar_expect_tx(bar, 0);\n    if (it < 0) tma_load_3d("),
                (Q, "    tma_load_3d(sB + st * kBN * kBK, mb,",
                 "    if (it < 0) tma_load_3d(sB + st * kBN * kBK, mb,"),
                (Q, "    tma_load_2d(sS + it % (2 * kS) * kBN,",
                 "    if (it < 0) tma_load_2d(sS + it % (2 * kS) * kBN,")]
QMM_6_STAGES = (Q, "constexpr int kS = 4;", "constexpr int kS = 6;")
# the tiles' order: N fastest, or N fastest within groups of 8 M tiles
QMM_ORDER = (Q, "    m0 = tile % tm * kBM;\n    n0 = tile / tm % tn * kBN;")
QMM_N_FASTEST = QMM_ORDER + ("    n0 = tile % tn * kBN;\n"
                             "    m0 = tile / tn % tm * kBM;",)
QMM_GROUPS_OF_8 = QMM_ORDER + (
    "    const int r = tile % (tm * tn), gr = r / (8 * tn), w = r % (8 * tn),"
    "\n              rows = min(8, tm - gr * 8);\n"
    "    m0 = (gr * 8 + w % rows) * kBM;\n    n0 = w / rows * kBN;",)
# the magic-number conversion in place of cvt (exact for block <= 256)
QMM_MAGIC = [(Q, "__fmul_rn(__int2float_rn(part[e]),",
              "__fmul_rn(__fsub_rn(__int_as_float(part[e] + 0x4B400000), "
              "12582912.0f),"),
             (Q, "__fmul_rn(__int2float_rn(part[e + 1]), s2.y)",
              "__fmul_rn(__fsub_rn(__int_as_float(part[e + 1] + 0x4B400000), "
              "12582912.0f), s2.y)")]


# K4 (fused_gelu_{fwd,bwd}.cu over gelu_rows.cuh): the GeLU math, the
# bias add, dbias's sums and folds, the fold's last-CTA protocol, the
# tanh's accuracy, the next block's prefetch
GF, GB, GR = "fused_gelu_fwd.cu", "fused_gelu_bwd.cu", "gelu_rows.cuh"
FWD_NO_MATH = (GF, "        o[k] = gelu<Approx>(s[k]);",
               "        o[k] = s[k];")
FWD_NO_BIAS = (GF, "        s[k] = v[k] + b[k];", "        s[k] = v[k];")
BWD_NO_MATH = (GB, "          d[k] = dv[k] * gelu_grad<Approx>(sv[k]);",
               "          d[k] = dv[k] + sv[k];")
# no dbias: the lanes' sums, the CTA's fold and the last CTA's (dx only)
BWD_NO_DBIAS = (GB, "  // 1. the CTA's partial row: its warps' sums in warp "
                "order\n", "  if (w > 0) return;\n")
# the CTAs write their partial rows, and nothing counts or folds them
BWD_NO_LAST_FOLD = (GB, "  // 2. publish it, and count the CTAs of this "
                    "(group, strip) done\n", "  if (w > 0) return;\n")
# the fold of partial rows by a second launch (K4-bwd's and K3-bwd's
# before their Hopper layouts): out[g, c] is the sum over p of
# partial[g * parts + p, c], added in order p = 0, 1, ...
COL_REDUCE_SRC = """
namespace ds_partials {
constexpr int kThreads = 256;
__global__ void __launch_bounds__(kThreads)
col_reduce_kernel(const float* __restrict__ partial, int parts, int cols,
                  int groups, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(groups) * cols) return;
  const int g = static_cast<int>(i / cols);
  const int c = static_cast<int>(i % cols);
  const float* base = partial + static_cast<long long>(g) * parts * cols;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p)
    acc += base[static_cast<long long>(p) * cols + c];
  out[i] = acc;
}
inline void col_reduce(const void* workspace, int parts, int cols, void* out,
                       cudaStream_t st, int groups = 1) {
  const long long total = static_cast<long long>(groups) * cols;
  col_reduce_kernel<<<static_cast<int>((total + kThreads - 1) / kThreads),
                      kThreads, 0, st>>>(
      static_cast<const float*>(workspace), parts, cols, groups,
      static_cast<float*>(out));
}
}  // namespace ds_partials
"""
# the partial rows folded by col_reduce_kernel, a second launch
BWD_COL_REDUCE = [BWD_NO_LAST_FOLD,
                  (GB, '#include "gelu_rows.cuh"\n',
                   '#include "gelu_rows.cuh"\n' + COL_REDUCE_SRC),
                  (GB, "      });\n    });\n  }\n  return static_cast<int>("
                   "cudaGetLastError());",
                   "      });\n    });\n  }\n  ds_partials::col_reduce("
                   "workspace, ctas_per_group, w, dbias, st, groups);\n"
                   "  return static_cast<int>(cudaGetLastError());")]
# tanh.approx.f32 (one MUFU op) in place of the accurate tanhf
FAST_TANH = [(GR, "namespace gelu_rows {\n",
              "namespace gelu_rows {\n__device__ __forceinline__ float "
              "tanh_approx(float x) {\n  float y;\n  asm(\"tanh.approx.f32 "
              "%0, %1;\" : \"=f\"(y) : \"f\"(x));\n  return y;\n}\n"),
             (GR, "0.5f * (1.0f + tanhf(0.7978845608028654f *",
              "0.5f * (1.0f + tanh_approx(0.7978845608028654f *"),
             (GR, "const float t = tanhf(inner);",
              "const float t = tanh_approx(inner);")]
# each block's rows fetched after the last block's math and stores, not
# before them
FWD_NO_PREFETCH = [
    (GF, "    fetch_rows<Vec>(x, w, c0, nc, r + step, end, nxt);\n", ""),
    (GF, "#pragma unroll\n    for (int u = 0; u < kUnroll; ++u) cur[u] = "
     "nxt[u];", "    fetch_rows<Vec>(x, w, c0, nc, r + step, end, cur);")]
BWD_NO_PREFETCH = [
    (GB, "      fetch_rows<Vec>(s, w, c0, nc, r + step, end, s_nxt);\n"
     "      fetch_rows<Vec>(dout, w, c0, nc, r + step, end, d_nxt);\n", ""),
    (GB, "#pragma unroll\n      for (int u = 0; u < kUnroll; ++u) {\n"
     "        s_cur[u] = s_nxt[u];\n        d_cur[u] = d_nxt[u];\n      }",
     "      fetch_rows<Vec>(s, w, c0, nc, r + step, end, s_cur);\n"
     "      fetch_rows<Vec>(dout, w, c0, nc, r + step, end, d_cur);")]
# evict-first cache hints on every load and store (each byte is used once)
STREAMING_HINTS = [
    (GR, "      raw.q[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);",
     "      raw.q[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);"),
    (GR, "    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);",
     "    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], "
     "w[3]));"),
    (GR, "    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], "
     "v[3]);\n    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], "
     "v[6], v[7]);",
     "    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], "
     "v[3]));\n    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], "
     "v[5], v[6], v[7]));")]


# K3-bwd (fused_ln_bwd.cu): the row exchange, the math, the column sums
# and their folds, the next row's prefetch, the CTA's shape
LB = "fused_ln_bwd.cu"
LN_NO_REDUCTIONS = [(LB, "    group_sum(st, red + parity * 4 * wpr, wpr, "
                     "warp, lane, bar);\n", "")]
LN_NO_MATH = (LB, "        float ds = rstd * (dv[k] * gv[k] - mean_dxhat - "
              "xhat * mean_dxhat_x);", "        float ds = sv[k] + dv[k];")
# no column sums: the sums, the CTA's partial row and every fold off
LN_NO_SUMS = (LB, "  // the CTA's partial row: its groups' sums added in group "
              "order\n", "  if (h > 0) return;\n")
# the CTAs write their partial rows, and nothing counts or folds them
LN_NO_FOLD = (LB, "  // the last CTA of this fold group adds the group's "
              "partial rows in CTA\n", "  if (h > 0) return;\n")
# the partial rows folded by col_reduce_kernel, a second launch
LN_COL_REDUCE = [LN_NO_FOLD,
                 (LB, '#include "gelu_rows.cuh"\n',
                  '#include "gelu_rows.cuh"\n' + COL_REDUCE_SRC),
                 (LB, "      });\n    });\n  }\n  return static_cast<int>("
                  "cudaGetLastError());",
                  "      });\n    });\n  }\n  ds_partials::col_reduce("
                  "workspace, grid, 3 * h, sums, st);\n"
                  "  return static_cast<int>(cudaGetLastError());")]
# each row fetched after the last row's math and stores, not before them
LN_NO_PREFETCH = [(LB, "constexpr bool kPrefetch = V == 1 || sizeof(ST) == 2;",
                   "constexpr bool kPrefetch = false;")]


# CTAs of up to 21 warps (14 in the kernel): ptxas sizes 672 threads as
# 768, 85 registers a lane
LN_21_WARPS = (LB, "constexpr int kMaxWarps = 14;",
               "constexpr int kMaxWarps = 21;")


# the plan's (warps a CTA, CTAs per SM) where a variant sets them (14
# and 1 in the kernel's plan)
LN_VARIANT_PLANS = {"7_warp_ctas_2_per_sm": dict(warps=7, per_sm=2),
                    "21_warp_ctas": dict(warps=21)}


# K3-fwd (fused_ln_fwd.cu): the stores, the row groups' exchange, the
# vector loads, the next row's prefetch, where gamma and beta live
LF = "fused_ln_fwd.cu"
LF_NO_EXCHANGE = (LF, "    if (wpr > 1) {\n      if (lane == 0) {",
                  "    if (wpr < 0) {\n      if (lane == 0) {")
# the outputs folded into one value whose store never runs, so the loads
# and the math stay
LF_NO_STORES = (LF, "    put_row<Vec>(out + at, nc, o, lane, whole);\n"
                "    if (sum != nullptr) put_row<Vec>(sum + at, nc, s, lane, "
                "whole);\n",
                "    float keep = 0.f;\n#pragma unroll\n"
                "    for (int k = 0; k < kCols; ++k) keep += o[k] + s[k];\n"
                "    if (keep == -1.2345e30f)\n"
                "      out[at] = gelu_rows::from_float<OT>(keep);\n")
LF_NO_VECTOR_LOADS = [
    (LF, "  vector8<Vec>(bias, bias_dt, c0, nc, bv);\n"
     "  vector8<Vec>(gamma, gamma_dt, c0, nc, gv);\n"
     "  vector8<Vec>(beta, beta_dt, c0, nc, tv);\n",
     "#pragma unroll\n  for (int k = 0; k < kCols; ++k) {\n"
     "    bv[k] = 0.125f * k;\n    gv[k] = 1.f + 0.01f * k;\n"
     "    tv[k] = 0.5f * k;\n  }\n")]
# two rows in flight a row group: its first two rows fetched at the
# start, and row r + 2 stride while row r's exchange and stores run (one
# row ahead in the kernel)
LF_TWO_AHEAD = [
    (LF, "    fetch8<Vec>(res + at, nc, rr);\n  }\n",
     "    fetch8<Vec>(res + at, nc, rr);\n  }\n"
     "  Raw8<YT> yr2 = {};\n  Raw8<RT> rr2 = {};\n"
     "  if (r + stride < n && nc > 0) {\n"
     "    const long long at = static_cast<long long>(r + stride) * h + c0;\n"
     "    fetch8<Vec>(y + at, nc, yr2);\n    fetch8<Vec>(res + at, nc, rr2);\n"
     "  }\n"),
    (LF, "    const int rn = r + stride;\n    if (rn < n && nc > 0) {\n"
     "      const long long at = static_cast<long long>(rn) * h + c0;\n"
     "      fetch8<Vec>(y + at, nc, yr);\n"
     "      fetch8<Vec>(res + at, nc, rr);\n    }\n",
     "    yr = yr2;\n    rr = rr2;\n"
     "    const int rn = r + 2 * stride;\n    if (rn < n && nc > 0) {\n"
     "      const long long at = static_cast<long long>(rn) * h + c0;\n"
     "      fetch8<Vec>(y + at, nc, yr2);\n"
     "      fetch8<Vec>(res + at, nc, rr2);\n    }\n")]
# fp32 outputs stored as two half-sector 16-byte stores a lane (a full
# sector a store from whole warps in the kernel, `put_row`)
LF_HALF_SECTOR_STORES = [(LF, "  const bool whole = (warp + 1) * 32 * kCols "
                          "<= h;", "  const bool whole = false;")]
# the vectors read with scalar loads (16-byte ones in the kernel where
# the rows take them)
LF_SCALAR_VECTOR_LOADS = [(LF, "vector8<Vec>(", "vector8<false>(")]
# gamma and beta in an fp32 copy in shared memory (in registers in the
# kernel, as bias): each lane writes its 8 columns of each and reads
# them back for every row
LF_VECTORS_IN_SHARED = [
    (LF, "  vector8<Vec>(gamma, gamma_dt, c0, nc, gv);\n"
     "  vector8<Vec>(beta, beta_dt, c0, nc, tv);\n",
     "  __shared__ __align__(16) float gb[2][kCols * kMaxThreads];\n"
     "  vector8<Vec>(gamma, gamma_dt, c0, nc, gv);\n"
     "  vector8<Vec>(beta, beta_dt, c0, nc, tv);\n"
     "#pragma unroll\n  for (int k = 0; k < kCols; ++k)\n"
     "    gb[0][c0 + k] = gv[k], gb[1][c0 + k] = tv[k];\n"),
    (LF, "    for (int k = 0; k < kCols; ++k) o[k] = (s[k] - mu) * rstd * "
     "gv[k] + tv[k];\n",
     "    for (int k = 0; k < kCols; ++k)\n"
     "      o[k] = (s[k] - mu) * rstd * gb[0][c0 + k] + gb[1][c0 + k];\n")]
# the next row fetched after this row's stores, not before its exchange
LF_FETCH = ("    const int rn = r + stride;\n    if (rn < n && nc > 0) {\n"
            "      const long long at = static_cast<long long>(rn) * h + c0;\n"
            "      fetch8<Vec>(y + at, nc, yr);\n"
            "      fetch8<Vec>(res + at, nc, rr);\n    }\n")
LF_NO_PREFETCH = [
    (LF, "    // 2. the next row's y and residual, in flight through 3 and 4\n"
     + LF_FETCH, ""),
    (LF, "    if (sum != nullptr) put_row<Vec>(sum + at, nc, s, lane, whole);"
     "\n  }\n}\n",
     "    if (sum != nullptr) put_row<Vec>(sum + at, nc, s, lane, whole);\n"
     + LF_FETCH + "  }\n}\n")]
# the plan's warps a CTA and a wave's warps an SM where a variant sets
# them (8 and 28 in the kernel's plan; the C entry cuts the grid to the
# CTAs the card holds at once, so more warps an SM change nothing)
LN_FWD_VARIANT_PLANS = {"16_warp_ctas": dict(cta_warps=16),
                        "4_warp_ctas": dict(cta_warps=4),
                        "16_warps_an_sm": dict(sm_warps=16),
                        "24_warps_an_sm": dict(sm_warps=24)}


# K7-fwd on the Hopper body (bs_fwd_kernel_sm90): two CTAs per SM at D
# 128 (one in the kernel; two spill), the masks, the walks cut short;
# NATURAL_ORDER and SHORT_WALKS above apply to it too
FWD_TABLE_2_PER_SM = (B, "  static constexpr int kBlocks = D == 64 ? 2 : 1;\n"
                      "  static size_t bytes(int nmax) { return walk + 12 * "
                      "size_t(nmax) + 1024; }\n};\n\n// bf16 at D 64 and 128: "
                      "one CTA per (b*h, 128-row q tile) over the\n// forward",
                      "  static constexpr int kBlocks = 2;\n"
                      "  static size_t bytes(int nmax) { return walk + 12 * "
                      "size_t(nmax) + 1024; }\n};\n\n// bf16 at D 64 and 128: "
                      "one CTA per (b*h, 128-row q tile) over the\n// forward")
FWD_NO_MASK = (H, "      if (walk.partial(it, q0, 64, k0, kN))\n        hide(s,",
               "      if (it < 0)\n        hide(s,")


def unroll(rows):
    """Each lane's rows in flight per block (4 in the kernels)."""
    return (GR, "constexpr int kUnroll = 4;", f"constexpr int kUnroll = {rows};")


# CTAs of 8 warps (32-row blocks) in place of 4
EIGHT_WARPS = (GR, "constexpr int kWarps = 4;", "constexpr int kWarps = 8;")
# the plan's CTAs per SM where a variant sets it (2 in the kernels' plan)
GELU_VARIANT_PLANS = {}


def gelu_variants(side, lib, base):
    """K4's variants on one side (fwd or bwd): its own parts switched off
    (`base`), and the layout's constants with the plan's CTAs per SM."""
    out = {f"{side}_{name}": (lib, subs) for name, subs in base.items()}
    for name, subs, per_sm in (
            ("8_warps", [EIGHT_WARPS], 2),
            ("unroll_2", [unroll(2)], 2),
            ("unroll_8", [unroll(8)], 2),
            ("plan_1", [], 1),
            ("plan_4", [], 4)):
        out[f"{side}_{name}"] = (lib, subs)
        GELU_VARIANT_PLANS[f"{side}_{name}"] = per_sm
    return out


def budget(value):
    return (H, "constexpr long long kL2Budget = 32ll << 20;",
            f"constexpr long long kL2Budget = {value};")


SETS = {
    "forward": ("flash_attention_fwd", {
        "kernel": [],
        "no_softmax": [NO_SOFTMAX],
        "scores_only": [NO_SOFTMAX, NO_PV],
        "pv_only": [NO_SOFTMAX, NO_S],
        "data_only": [NO_SOFTMAX, NO_S, NO_PV, NO_MASK],
    }),
    "backward": ("flash_attention_bwd", {
        "kernel": [],
        "delta_and_dkv": [NO_DQ],
        "dkv_no_elementwise": [NO_DQ, DKV_NO_ELEMENTWISE],
        "dkv_no_score_products": [NO_DQ, DKV_NO_SCORES],
        "dkv_no_gradient_products": [NO_DQ, DKV_NO_GRADS],
        "dkv_data_only": [NO_DQ, DKV_NO_ELEMENTWISE, DKV_NO_SCORES,
                          DKV_NO_GRADS],
        "delta_and_dq": [NO_DKV],
        "delta_only": [NO_DKV, NO_DQ],
    }),
    "fused_bwd": ("flash_attention_bwd_fused", {
        "kernel": [],
        "ordered_adds_off": [FUSED_UNORDERED],
        "dq_exchange_local": [FUSED_UNORDERED, FUSED_DQ_LOCAL],
        "no_dq_phase": [FUSED_NO_DQ],
        "steps_only": [FUSED_NO_DQ, FUSED_NO_HANDOFF, FUSED_NO_DS_STORES],
        "ring_2_stages": [fused_stages(2)],
        "ring_4_stages": [fused_stages(4)],
        "steps_only_no_own_delta": [FUSED_NO_DQ, FUSED_NO_HANDOFF,
                                    FUSED_NO_DS_STORES, FUSED_NO_OWN_DELTA],
        "kv_loaded_at_switch": [FUSED_KV_AT_SWITCH],
        "adder_fence": [FUSED_ADDER_FENCE],
    }),
    "order": (None, {
        f"{lib}_{name}": (lib, [budget(v)] if v else [])
        for lib in ("flash_attention_fwd", "flash_attention_bwd")
        for name, v in (("32MB", None), ("8MB", "8ll << 20"),
                        ("tile_major", "1ll << 50"), ("head_major", "1"))}),
    "sparse_bwd": ("block_sparse_attention", {
        "kernel": [],
        "no_masks": BWD_NO_MASKS,
        "no_elementwise": [DKV_NO_ELEMENTWISE, DQ_NO_ELEMENTWISE],
        "no_score_products": [DKV_NO_SCORES, DQ_NO_SCORES],
        "no_gradient_products": [DKV_NO_GRADS, DQ_NO_GRADS],
        "loads_only": BWD_NO_MASKS + [DKV_NO_ELEMENTWISE, DQ_NO_ELEMENTWISE,
                                      DKV_NO_SCORES, DQ_NO_SCORES,
                                      DKV_NO_GRADS, DQ_NO_GRADS],
        "natural_order": [NATURAL_ORDER],
        "walks_cut_to_64_steps": [SHORT_WALKS],
    }),
    "gelu": (None, {
        **gelu_variants("fwd", "fused_gelu_fwd", {
            "kernel": [], "math_off": [FWD_NO_MATH],
            "loads_stores_only": [FWD_NO_MATH, FWD_NO_BIAS],
            "fast_tanh": FAST_TANH, "no_prefetch": FWD_NO_PREFETCH,
            "streaming_hints": STREAMING_HINTS}),
        **gelu_variants("bwd", "fused_gelu_bwd", {
            "kernel": [], "math_off": [BWD_NO_MATH],
            "no_dbias": [BWD_NO_DBIAS],
            "loads_stores_only": [BWD_NO_MATH, BWD_NO_DBIAS],
            "no_last_fold": [BWD_NO_LAST_FOLD],
            "col_reduce_fold": BWD_COL_REDUCE, "fast_tanh": FAST_TANH,
            "no_prefetch": BWD_NO_PREFETCH,
            "streaming_hints": STREAMING_HINTS}),
    }),
    "ln_bwd": ("fused_ln_bwd", {
        "kernel": [],
        "no_row_exchange": LN_NO_REDUCTIONS,
        "math_off": [LN_NO_MATH],
        "no_column_sums": [LN_NO_SUMS],
        "loads_stores_only": LN_NO_REDUCTIONS + [LN_NO_MATH, LN_NO_SUMS],
        "no_last_fold": [LN_NO_FOLD],
        "col_reduce_fold": LN_COL_REDUCE,
        "no_prefetch": LN_NO_PREFETCH,
        "7_warp_ctas_2_per_sm": [],
        "21_warp_ctas": [LN_21_WARPS],
    }),
    "ln_fwd": ("fused_ln_fwd", {
        "kernel": [],
        "no_exchange": [LF_NO_EXCHANGE],
        "no_stores": [LF_NO_STORES],
        "no_vector_loads": LF_NO_VECTOR_LOADS,
        "scalar_vector_loads": LF_SCALAR_VECTOR_LOADS,
        "vectors_in_shared_memory": LF_VECTORS_IN_SHARED,
        "half_sector_fp32_stores": LF_HALF_SECTOR_STORES,
        "two_rows_ahead": LF_TWO_AHEAD,
        "loads_only": [LF_NO_EXCHANGE, LF_NO_STORES],
        "no_prefetch": LF_NO_PREFETCH,
        "streaming_hints": STREAMING_HINTS,
        **{name: [] for name in LN_FWD_VARIANT_PLANS},
    }),
    "sparse_fwd": ("block_sparse_attention", {
        "kernel": [],
        "natural_order": [NATURAL_ORDER],
        "d128_2_ctas_per_sm": [FWD_TABLE_2_PER_SM],
        "no_masks": [FWD_NO_MASK],
        "walks_cut_to_64_steps": [SHORT_WALKS],
    }),
    "qmm": ("quantized_matmul", {
        "kernel": [],
        "no_products": [QMM_NO_PRODUCTS],
        "no_epilogue": [QMM_NO_EPILOGUE],
        "loads_only": [QMM_NO_PRODUCTS, QMM_NO_EPILOGUE],
        "no_loads": QMM_NO_LOADS,
        "products_only": QMM_NO_LOADS + [QMM_NO_EPILOGUE],
        "epilogue_only": QMM_NO_LOADS + [QMM_NO_PRODUCTS],
        "turns": QMM_TURNS,
        "no_store": [QMM_NO_STORE],
        "epilogue_only_no_store": QMM_NO_LOADS + [QMM_NO_PRODUCTS,
                                                  QMM_NO_STORE],
        "epilogue_only_magic": QMM_NO_LOADS + [QMM_NO_PRODUCTS] + QMM_MAGIC,
        "6_stages": [QMM_6_STAGES],
        "n_fastest": [QMM_N_FASTEST],
        "groups_of_8": [QMM_GROUPS_OF_8],
        "magic": QMM_MAGIC,
    }),
}
SHAPES = (((11, 1024, 25, 64), True), ((11, 1024, 25, 64), False),
          ((1, 8192, 4, 64), True), ((4, 1024, 16, 128), True))
# K2-fused's: the flagship causal and not, the MoE cell's, BERT-large's,
# a head dim of 128
FUSED_SHAPES = (((11, 1024, 25, 64), True), ((11, 1024, 25, 64), False),
                ((16, 1024, 16, 64), True), ((16, 128, 16, 64), False),
                ((4, 1024, 16, 128), True))
# `compare`'s fused_bwd_shapes: (shape, causal, dtype, given delta), the
# paths' K2-fused forms (the flagship, sp_training's given delta, the MoE
# cell, BERT-large, fp16 paths A and B) and a head dim of 128
FUSED_COMPARE_CASES = (
    ((11, 1024, 25, 64), True, "bfloat16", False),
    ((11, 1024, 25, 64), False, "bfloat16", False),
    ((16, 1024, 16, 64), True, "bfloat16", False),
    ((16, 128, 16, 64), False, "bfloat16", False),
    ((11, 1024, 25, 64), True, "float16", False),
    ((16, 128, 16, 64), False, "float16", False),
    ((11, 1024, 25, 64), True, "bfloat16", True),
    ((11, 1024, 25, 64), True, "float16", True),
    ((4, 1024, 16, 128), True, "bfloat16", False))
# the flagship's projections (M = 11 x 1024; K padded to blocks of 128)
QMM_SHAPES = (("c_attn", 1664, 4800), ("c_proj", 1664, 1600),
              ("c_fc", 1664, 6400), ("mlp_c_proj", 6400, 1600))
QMM_M, QMM_BLOCK = 11 * 1024, 128


def build(name, lib, subs):
    from deepspeed_tpu_torch.ops import _build
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for fname, old, new in subs:
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise SystemExit(f"variant {name}: its substitution no longer "
                             f"applies to {fname}: {old[:60]!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    lib_path = os.path.join(d, lib + ".so")
    log = open(lib_path + ".log", "w")
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             lib_path, os.path.join(d, lib + ".cu")],
                            stdout=log, stderr=subprocess.STDOUT), lib_path


def use(lib, path, original):
    """Route the port's wrappers to the variant's library."""
    from deepspeed_tpu_torch.ops import _build
    cdll = ctypes.CDLL(path)

    def function(lib_name, fn_name, argtypes):
        if lib_name != lib:
            return original(lib_name, fn_name, argtypes)
        fn = getattr(cdll, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        return fn
    _build.function = function


def main(argv):
    if len(argv) >= 2 and argv[0] == "compare":
        return compare(argv[1], argv[2:] or COMPARE_PHASES)
    if argv == ["checkpoint_io"]:
        return checkpoint_io()
    if argv == ["remat_policies"]:
        return remat_policies()
    if len(argv) != 1 or argv[0] not in SETS:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    lib_all, variants = SETS[argv[0]]
    variants = {n: v if lib_all is None else (lib_all, v)
                for n, v in variants.items()}
    _build.build_all()
    procs = {n: build(n, lib, subs) for n, (lib, subs) in variants.items()}
    for n, (proc, path) in procs.items():
        if proc.wait() != 0:
            with open(path + ".log") as f:
                log = f.read()[-3000:]
            raise SystemExit(f"variant {n}: nvcc failed\n{log}")

    bf16, gen = torch.bfloat16, torch.Generator(device="cuda")
    gen.manual_seed(0)
    if argv[0] == "qmm":
        return time_qmm(variants, procs, cs, gen)
    if argv[0] == "sparse_bwd":
        return time_sparse_bwd(variants, procs, cs, gen)
    if argv[0] == "gelu":
        return time_gelu(variants, procs, cs, gen)
    if argv[0] == "ln_bwd":
        return time_ln_bwd(variants, procs, cs, gen)
    if argv[0] == "ln_fwd":
        return time_ln_fwd(variants, procs, cs, gen)
    if argv[0] == "sparse_fwd":
        return time_sparse_fwd(variants, procs, cs, gen)
    cases, sdpa = [], {}
    fused = lib_all == "flash_attention_bwd_fused"
    for shape, causal in FUSED_SHAPES if fused else SHAPES:
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                         .to(bf16) for _ in range(4))
        out, lse = fa._flash_fwd_launch(q, k, v, shape[3] ** -0.5, causal)
        cases.append((shape, causal, q, k, v, dout, out, lse))
        qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        fwd = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        fwd_bwd = cs.time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
            (qt, kt, vt), dout.transpose(1, 2)))
        sdpa[f"{list(shape)} causal={causal}"] = dict(fwd_ms=fwd,
                                                      bwd_ms=fwd_bwd - fwd)
    print(json.dumps({"sdpa": sdpa}), flush=True)

    original = _build.function
    for n, (lib, _) in variants.items():
        use(lib, procs[n][1], original)
        rows = {}
        for shape, causal, q, k, v, dout, out, lse in cases:
            sm = shape[3] ** -0.5
            if lib == "flash_attention_fwd":
                ms = cs.time_ms(lambda: fa._flash_fwd_launch(q, k, v, sm,
                                                             causal))
            elif fused:
                ms = cs.graph_ms(lambda: fa._flash_bwd_fused_launch(
                    q, k, v, out, lse, dout, None, sm, causal))
            else:
                ms = cs.time_ms(lambda: fa._flash_bwd_launch(
                    q, k, v, out, lse, dout, None, sm, causal))
            rows[f"{list(shape)} causal={causal}"] = ms
        _build.function = original
        print(json.dumps({"variant": n, "library": lib, "ms": rows}),
              flush=True)
    if fused:
        # how many clusters of 1-8 CTAs the card runs at once (the
        # occupancy API on the kernel's own launch configuration)
        at_once = _build.function("flash_attention_bwd_fused",
                                  "ds_flash_attn_bwd_fused_clusters",
                                  [ctypes.c_int] * 4)
        print(json.dumps({"clusters_at_once": {
            f"D{d}": {n: at_once(n, d, 1, 0) for n in range(1, 9)}
            for d in (64, 128)}}), flush=True)
        # K2's sweeps on the same inputs, the route the fused kernel took
        # over (device time from CUDA graphs, as the variants')
        print(json.dumps({"variant": "sweeps", "ms": {
            f"{list(shape)} causal={causal}": cs.graph_ms(
                lambda: fa._flash_bwd_launch(q, k, v, out, lse, dout, None,
                                             shape[3] ** -0.5, causal))
            for shape, causal, q, k, v, dout, out, lse in cases}}),
            flush=True)
    print(cs.card_line(), flush=True)
    return 0


def time_qmm(variants, procs, cs, gen):
    """K6's variants at the flagship's projections: the launch alone
    (`_qmm_kernel`) on int8 operands in its layouts, bf16 output."""
    import importlib
    import torch
    from deepspeed_tpu_torch.ops import _build
    qm = importlib.import_module(
        "deepspeed_tpu_torch.ops.transformer.quantized_matmul")
    cases, yard = [], {}
    for name, kp, n in QMM_SHAPES:
        xq = torch.randint(-127, 128, (1, QMM_M, kp), generator=gen,
                           device="cuda", dtype=torch.int8)
        wqt = torch.randint(-127, 128, (1, n, kp), generator=gen,
                            device="cuda", dtype=torch.int8)
        sx = torch.rand((1, QMM_M, 1), generator=gen, device="cuda")
        sw = torch.rand((1, kp // QMM_BLOCK, n), generator=gen, device="cuda")
        cases.append((name, xq, wqt, sx, sw))
        w_kn = wqt[0].t()       # [Kp, N], column-major: _int_mm's layout
        xb = torch.randn((QMM_M, kp), generator=gen, device="cuda").to(
            torch.bfloat16)
        wb = torch.randn((kp, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        yard[name] = dict(
            int_mm_ms=cs.time_ms(lambda: torch._int_mm(xq[0], w_kn)),
            bf16_matmul_ms=cs.time_ms(lambda: torch.matmul(xb, wb)),
            bound_ms=2.0 * QMM_M * kp * n / 1979e12 * 1e3)
    print(json.dumps({"yardsticks": yard}), flush=True)
    original = _build.function
    for n, (lib, _) in variants.items():
        use(lib, procs[n][1], original)
        rows = {name: cs.time_ms(lambda: qm._qmm_kernel(
                    xq, wqt, sx, sw, QMM_BLOCK, torch.bfloat16))
                for name, xq, wqt, sx, sw in cases}
        _build.function = original
        print(json.dumps({"variant": n, "library": lib, "ms": rows}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


def time_sparse_bwd(variants, procs, cs, gen):
    """K7-dkv's (with its delta pre-pass) and K7-dq's variants on the
    Hopper sweeps at [1, 16384, 16, 64] bf16, block 256, causal, under
    the sparse path's three layouts, from one K7-fwd output each."""
    import torch
    from deepspeed_tpu_torch.ops import _build
    bsa = cs._sparse()
    cases = []
    for pattern in ("bslongformer", "fixed", "bigbird"):
        layout = cs.sparse_config(pattern).make_layout(16384)
        q, k, v, dout = (torch.randn((1, 16384, 16, 64), generator=gen,
                                     device="cuda").to(torch.bfloat16)
                         for _ in range(4))
        square = bsa._plan(layout, True, 256, bsa.TILE, q.device)
        pair = bsa._plan(layout, True, 256, bsa._SM90_TILES, q.device)
        out, lse = bsa._bs_fwd_launch(q, k, v, square, 0.125)
        cases.append((pattern, (q, k, v, out, lse, dout), pair))
    original = _build.function
    for n, (lib, _) in variants.items():
        use(lib, procs[n][1], original)
        rows = {}
        for pattern, args, pair in cases:
            delta = bsa._bs_bwd_dkv_sm90_launch(*args, pair, 0.125)[2]
            rows[pattern] = dict(
                dkv_ms=cs.time_ms(lambda: bsa._bs_bwd_dkv_sm90_launch(
                    *args, pair, 0.125)),
                dq_ms=cs.time_ms(lambda: bsa._bs_bwd_dq_sm90_launch(
                    *args, delta, pair, 0.125)))
        _build.function = original
        print(json.dumps({"variant": n, "library": lib, "ms": rows}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


# K4's shapes on the main paths: (label, N, W, bias groups)
GELU_SHAPES = (("serving N4096 W6400", 4096, 6400, 1),
               ("decode N4 W6400", 4, 6400, 1),
               ("training N11264 W6400", 11264, 6400, 1),
               ("MoE dense blocks N16384 W4096", 16384, 4096, 1),
               ("MoE experts G8 x 5120 x W4096", 8 * 5120, 4096, 8))


def time_gelu(variants, procs, cs, gen):
    """K4-fwd's and K4-bwd's variants through the port's wrappers (tanh
    form, bf16 rows, fp32 bias), each under its plan's CTAs per SM, and
    torch's GeLU forward and backward at the same shapes;
    at the decode shape (N 4) device times from a CUDA graph of 20 calls
    (`chip_smoke.graph_ms`)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    bf16, cases, yard = torch.bfloat16, [], {}
    for label, n, w, groups in GELU_SHAPES:
        x, dout = (torch.randn((n, w), generator=gen, device="cuda").to(bf16)
                   for _ in range(2))
        bias = 0.1 * torch.randn((groups, w) if groups > 1 else (w,),
                                 generator=gen, device="cuda")
        cases.append((label, x, bias, dout, groups if groups > 1 else None))
        timer = cs.graph_ms if n < 64 else cs.time_ms
        yard[label] = dict(
            gelu_fwd_ms=timer(lambda: F.gelu(x, approximate="tanh")),
            gelu_bwd_ms=timer(lambda: torch.ops.aten.gelu_backward(
                dout, x, approximate="tanh")),
            bound_ms=n * w * 6 / 3.35e12 * 1e3)
    print(json.dumps({"yardsticks": yard}), flush=True)

    def timed(fn, n):
        # back-to-back calls at the decode shape time the host
        return cs.graph_ms(fn) if n < 64 else cs.time_ms(fn)

    def rows(fwd):
        out = {}
        for label, x, bias, dout, groups in cases:
            if fwd:
                out[label] = timed(lambda: fo.fused_bias_gelu_with_sum(
                    x, bias, approximate=True), x.shape[0])
            else:
                out[label] = timed(lambda: fo.fused_bias_gelu_backward(
                    x, dout, approximate=True, groups=groups), x.shape[0])
        return out

    original, default = _build.function, fo._GELU_CTAS_PER_SM
    for n, (lib, _) in variants.items():
        use(lib, procs[n][1], original)
        fo._GELU_CTAS_PER_SM = GELU_VARIANT_PLANS.get(n, default)
        fo.gelu_plan.cache_clear()
        try:
            ms = rows(lib == "fused_gelu_fwd")
        finally:
            _build.function, fo._GELU_CTAS_PER_SM = original, default
            fo.gelu_plan.cache_clear()
        print(json.dumps({"variant": n, "library": lib,
                          "ctas_per_sm": GELU_VARIANT_PLANS.get(n, default),
                          "ms": ms}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


# K3-bwd's shapes on the main paths, then at the widths of the
# gpt2-6.7b and gpt2-13b presets (two vectors a lane; on no path):
# (label, N, H, dout dtype, with dsum)
LN_BWD_SHAPES = (("training N11264 H1600", 11264, 1600, "bf16", True),
                 ("training ln_f N11264 H1600", 11264, 1600, "fp32", False),
                 ("MoE N16384 H1024", 16384, 1024, "bf16", True),
                 ("gpt2-6.7b N11264 H4096", 11264, 4096, "bf16", True),
                 ("gpt2-13b N11264 H5120", 11264, 5120, "bf16", True))


def time_ln_bwd(variants, procs, cs, gen):
    """K3-bwd's variants through the port's wrapper (bf16 s, dsum, dx and
    gamma; dout bf16, or fp32 on the ln_f form), each under its plan,
    back to back (`ms`) and as device time from a CUDA graph (`graph_ms`,
    the median of three), and torch's own LayerNorm backward (dx, dgamma, dbeta of a plain
    LayerNorm, no dsum: a yardstick) at the same shapes."""
    import torch
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    bf16, cases, yard = torch.bfloat16, [], {}
    for label, n, h, d_dt, with_dsum in LN_BWD_SHAPES:
        s, dsum = (torch.randn((n, h), generator=gen, device="cuda").to(bf16)
                   for _ in range(2))
        dout = torch.randn((n, h), generator=gen, device="cuda").to(
            torch.float32 if d_dt == "fp32" else bf16)
        gamma = (1.0 + 0.1 * torch.randn((h,), generator=gen,
                                         device="cuda")).to(bf16)
        cases.append((label, s, gamma, dout, dsum if with_dsum else None))
        mean = s.float().mean(-1, keepdim=True)
        rstd = torch.rsqrt(s.float().var(-1, keepdim=True) + 1e-5)
        yard[label] = dict(
            aten_layer_norm_backward_ms=cs.time_ms(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dout.to(bf16), s, [h], mean, rstd, gamma, gamma,
                    [True, True, True])),
            # s, dout, dsum read and dx written once; gamma, the sums
            bound_ms=(n * h * (2 + dout.element_size() + 2 * with_dsum + 2)
                      + 14 * h) / 3.35e12 * 1e3)
    print(json.dumps({"yardsticks": yard}), flush=True)
    original, defaults = _build.function, (fo._sm_count,
                                           fo._LN_BWD_MAX_WARPS)
    for n, (lib, _) in variants.items():
        use(lib, procs[n][1], original)
        plan = LN_VARIANT_PLANS.get(n, {})
        # CTAs per SM: the plan sizes the grid to one CTA per SM
        per_sm = plan.get("per_sm", 1)
        fo._sm_count = lambda dev, per_sm=per_sm: per_sm * defaults[0](dev)
        fo._LN_BWD_MAX_WARPS = plan.get("warps", defaults[1])
        fo.ln_bwd_plan.cache_clear()
        try:
            ms, dev = {}, {}
            for label, s, gamma, dout, dsum in cases:
                def run():
                    return fo.fused_bias_residual_layernorm_backward(
                        s, gamma, dout, dsum)
                try:
                    fo.ln_bwd_plan(*s.shape, fo._sm_count(0))
                except ValueError:      # the variant's CTA has no layout
                    ms[label] = dev[label] = None
                    continue
                ms[label] = cs.time_ms(run)
                # device time alone (a CUDA graph of 20 calls), the
                # median of three
                dev[label] = sorted(cs.graph_ms(run) for _ in range(3))[1]
        finally:
            _build.function = original
            fo._sm_count, fo._LN_BWD_MAX_WARPS = defaults
            fo.ln_bwd_plan.cache_clear()
        with open(procs[n][1] + ".log") as f:
            ptxas = cs.sm90_ptxas(f.read())
        print(json.dumps({"variant": n, "library": lib, "plan": plan,
                          "ms": ms, "graph_ms": dev, "ptxas": ptxas}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


# K3-fwd's shapes on the paths: (label, N, H, y, residual, vectors, out,
# sum dtype or None for the ln_f form, eps). Serving holds fp32
# parameters, the training paths bf16 compute copies; the flagship's row
# with fp32 vectors times the kernel alone where the parent layout's
# wrapper casts bf16 ones
LN_FWD_SHAPES = (
    ("serving N4096 H1600", 4096, 1600, "bf16", "bf16", "fp32", "bf16",
     "bf16", 1e-5),
    ("decode N4 H1600", 4, 1600, "bf16", "bf16", "fp32", "bf16", "bf16",
     1e-5),
    ("prefill chunk N128 H1600", 128, 1600, "bf16", "bf16", "fp32", "bf16",
     "bf16", 1e-5),
    ("training N11264 H1600", 11264, 1600, "bf16", "bf16", "bf16", "bf16",
     "bf16", 1e-5),
    ("training fp32 vectors N11264 H1600", 11264, 1600, "bf16", "bf16",
     "fp32", "bf16", "bf16", 1e-5),
    ("training ln_f N11264 H1600", 11264, 1600, "bf16", "bf16", "bf16",
     "fp32", None, 1e-5),
    ("MoE N16384 H1024", 16384, 1024, "bf16", "bf16", "bf16", "bf16",
     "bf16", 1e-5),
    ("BERT bf16 residual N2048 H1024", 2048, 1024, "bf16", "bf16", "bf16",
     "fp32", "bf16", 1e-12),
    ("BERT fp32 residual N2048 H1024", 2048, 1024, "bf16", "fp32", "bf16",
     "fp32", "fp32", 1e-12),
)
# what `compare`'s ln_fwd_shapes phase and the ln_fwd mode run: the
# shapes' inputs from `gen`, through one tree's `_ln_forward`
LN_FWD_CASES = """
def ln_fwd_cases(gen, shapes):
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    out = []
    for label, n, h, y_dt, r_dt, v_dt, o_dt, s_dt, eps in shapes:
        y = torch.randn((n, h), generator=gen, device="cuda").to(dts[y_dt])
        res = torch.randn((n, h), generator=gen, device="cuda").to(
            dts[r_dt])
        bias, gamma, beta = (0.1 * torch.randn((h,), generator=gen,
                                               device="cuda")
                             for _ in range(3))
        vecs = [v.to(dts[v_dt]) for v in (bias, gamma + 1.0, beta)]
        args = (y, vecs[0], res, vecs[1], vecs[2], eps, dts[o_dt],
                dts[s_dt or r_dt], s_dt is not None)
        # y and the residual read, out and the sum written, the vectors
        # once, at the card's 3.35 TB/s
        nbytes = n * h * (y.element_size() + res.element_size() +
                          (4 if o_dt == "fp32" else 2) +
                          (0 if s_dt is None else
                           4 if s_dt == "fp32" else 2)) + \\
            3 * h * vecs[0].element_size()
        out.append((label, args, nbytes / 3.35e12 * 1e3,
                    lambda args=args: fo._ln_forward(*args)))
    return out


def cold_ms(run, calls=20):
    # (the K3-fwd kernel's device time, every kernel's but the flush) a
    # call, from torch.profiler, with the L2 cache flushed (128 MB
    # zeroed) before each call: the inputs come from device memory, as
    # on a path, where they were written many kernels before
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            run()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "Fill" not in e.key]
    k3 = sum(e.self_device_time_total for e in ev
             if "ln_fwd_kernel" in e.key)
    return k3 / 1e3 / calls, \\
        sum(e.self_device_time_total for e in ev) / 1e3 / calls
"""


def time_ln_fwd(variants, procs, cs, gen):
    """K3-fwd's variants through the port's wrapper at LN_FWD_SHAPES,
    each under its plan, back to back (`ms`), as device time from a
    CUDA graph (`graph_ms`, the median of three) and as the kernel's
    device time with the L2 cache flushed before each call (`cold_ms`,
    torch.profiler), beside torch's own
    LayerNorm forward (F.layer_norm of y, no bias, residual or sum: a
    yardstick) at the same shapes."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    scope = {"torch": torch}
    exec(LN_FWD_CASES, scope)
    cases = scope["ln_fwd_cases"](gen, LN_FWD_SHAPES)
    yard = {}
    for label, args, bound_ms, _ in cases:
        y, gamma, beta = args[0], args[3].to(args[0].dtype), \
            args[4].to(args[0].dtype)
        yard[label] = dict(
            layer_norm_graph_ms=cs.graph_ms(lambda: F.layer_norm(
                y, (y.shape[-1],), gamma, beta)), bound_ms=bound_ms)
    print(json.dumps({"yardsticks": yard}), flush=True)
    original = _build.function
    defaults = (fo._LN_FWD_CTA_WARPS, fo._LN_FWD_SM_WARPS)
    for n, (lib, _) in variants.items():
        use(lib, procs[n][1], original)
        plan = LN_FWD_VARIANT_PLANS.get(n, {})
        fo._LN_FWD_CTA_WARPS = plan.get("cta_warps", defaults[0])
        fo._LN_FWD_SM_WARPS = plan.get("sm_warps", defaults[1])
        fo.ln_fwd_plan.cache_clear()
        try:
            ms, dev, share, cold = {}, {}, {}, {}
            for label, _, bound_ms, run in cases:
                ms[label] = cs.time_ms(run)
                dev[label] = sorted(cs.graph_ms(run) for _ in range(3))[1]
                share[label] = bound_ms / dev[label]
                cold[label] = scope["cold_ms"](run)[0]
        finally:
            _build.function = original
            fo._LN_FWD_CTA_WARPS, fo._LN_FWD_SM_WARPS = defaults
            fo.ln_fwd_plan.cache_clear()
        with open(procs[n][1] + ".log") as f:
            ptxas = cs.sm90_ptxas(f.read())
        print(json.dumps({"variant": n, "library": lib, "plan": plan,
                          "ms": ms, "graph_ms": dev,
                          "graph_share_of_bound": share, "cold_ms": cold,
                          "ptxas": ptxas}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


def time_sparse_fwd(variants, procs, cs, gen):
    """K7-fwd's variants on the Hopper body at the sparse path's BigBird
    ([1, 16384, 16, 64] bf16, block 256, causal) and at head dim 128
    ([1, 16384, 8, 128]), with the WMMA table forward beside them."""
    import torch
    from deepspeed_tpu_torch.ops import _build
    bsa = cs._sparse()
    cases = []
    for h, d in ((16, 64), (8, 128)):
        layout = cs.sparse_config("bigbird", h=h).make_layout(16384)
        q, k, v = (torch.randn((1, 16384, h, d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        pair = bsa._plan(layout, True, 256, bsa._SM90_TILES, q.device)
        square = bsa._plan(layout, True, 256, bsa.TILE, q.device)
        label = f"bigbird causal [1, 16384, {h}, {d}]"
        cases.append((label, (q, k, v), pair, d ** -0.5))
        print(json.dumps({"wmma_table_forward": label, "ms": cs.time_ms(
            lambda: bsa._bs_fwd_launch(q, k, v, square, d ** -0.5))}),
            flush=True)
    original = _build.function
    for n, (lib, _) in variants.items():
        use(lib, procs[n][1], original)
        ms = {label: cs.time_ms(lambda: bsa._bs_fwd_sm90_launch(*qkv, pair,
                                                                 sm))
              for label, qkv, pair, sm in cases}
        _build.function = original
        print(json.dumps({"variant": n, "library": lib, "ms": ms}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


# `compare`'s phases: chip_smoke.py functions that time the kernels this
# tree changed, run from each tree; `ln_bwd_wide`, K3-bwd through each
# tree's wrapper at LN_BWD_SHAPES's preset widths (bf16 rows, gamma and
# dsum), back to back (`ms`) and from a CUDA graph (`graph_ms`); and
# `ln_fwd_shapes`, K3-fwd through each tree's `_ln_forward` at
# LN_FWD_SHAPES on the same inputs (the vectors in the path's dtype),
# `graph_ms` the median of three, `cold_ms` with the L2 cache flushed
# before each call; `bert_epilogues`, BERT-large's step with its
# profile's epilogue kernels one by one; `fused_bwd_shapes`, K2-fused
# through each tree's wrapper at FUSED_COMPARE_CASES on the same inputs,
# the median of three CUDA-graph times
COMPARE_PHASES = ("ln_fwd_shapes", "kernel_ln", "kernel_bert",
                  "bert_epilogues")

# checkpoint_io: the JAX module's np.savez and np.load in place of the
# port's one-buffer member writer and reader
NPZ_CALLS = (('    _savez(base + ".npz", main)',
              '    np.savez(base + ".npz", **main)'),
             ('_load_npz(base + ".npz").items()',
              'np.load(base + ".npz").items()'))

COMPARE_CODE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
from deepspeed_tpu_torch.ops import _build
assert cs.__file__.startswith({root!r})
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
peaks = cs.peaks_for(torch.cuda.get_device_name(0))
# the paths (seed, card) rather than kernel phases (peaks, generator)
PATHS = ("sparse_attention_path", "train_and_check", "moe_train_and_check",
         "checkpoint_and_check", "bert_training", "serve_and_check")


def ln_bwd_wide(gen):
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    res = {{}}
    for label, n, h in {wide!r}:
        s, dout, dsum = (torch.randn((n, h), generator=gen, device="cuda")
                         .to(torch.bfloat16) for _ in range(3))
        gamma = (1.0 + 0.1 * torch.randn((h,), generator=gen,
                                         device="cuda")).to(torch.bfloat16)
        def run():
            return fo.fused_bias_residual_layernorm_backward(
                s, gamma, dout, dsum)
        res[label] = dict(ms=cs.time_ms(run), graph_ms=cs.graph_ms(run))
    return res


{ln_fwd_cases}

def ln_fwd_shapes(gen):
    res = {{}}
    for label, _, bound_ms, run in ln_fwd_cases(gen, {ln_fwd!r}):
        dev = sorted(cs.graph_ms(run) for _ in range(3))[1]
        cold, cold_all = cold_ms(run)
        res[label] = dict(ms=cs.time_ms(run), graph_ms=dev,
                          bound_ms=bound_ms,
                          graph_share_of_bound=bound_ms / dev,
                          cold_ms=cold, cold_share_of_bound=bound_ms / cold,
                          cold_all_kernels_ms=cold_all)
    return res


def fused_bwd_shapes(gen):
    # K2-fused through each tree's wrapper on the same inputs: the median
    # of three CUDA-graph times
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    res = {{}}
    for (b, t, h, d), causal, dtype, given in {fused!r}:
        dt = getattr(torch, dtype)
        q, k, v, dout = (torch.randn((b, t, h, d), generator=gen,
                                     device="cuda").to(dt) for _ in range(4))
        out, lse = fa._flash_fwd_launch(q, k, v, d ** -0.5, causal)
        delta = torch.randn((b, h, t), generator=gen, device="cuda") \
            if given else None

        def run():
            return fa._flash_bwd_fused_launch(
                q, k, v, None if given else out, lse, dout, None,
                d ** -0.5, causal, delta)
        label = f"{{dtype}} {{[b, t, h, d]}} causal={{causal}}" + \
            (" given delta" if given else "")
        res[label] = sorted(cs.graph_ms(run) for _ in range(3))[1]
        del q, k, v, dout, out, lse, delta
    return res


def bert_epilogues():
    # BERT-large's step (chip_smoke.bert_training) with its profile's
    # epilogue group split by kernel
    split = tuple((f"epilogue {{k}}", (k,)) for k in (
        "ln_fwd_kernel", "ln_bwd_kernel", "gelu_fwd_kernel",
        "gelu_bwd_kernel"))
    cs.KERNEL_GROUPS = split + tuple(
        g for g in cs.KERNEL_GROUPS if g[0] != "port kernels: epilogues")
    lines, emit = [], cs.emit
    cs.emit = lines.append
    try:
        cs.bert_training(0, cs.card_line())
    finally:
        cs.emit = emit
    prof = next(d for d in lines if d.get("phase") == "bert_training_profile")
    return {{k: prof.get(k) for k in (
        "step_ms", "device_busy_ms_per_step", "device_idle_share",
        "kernel_launches_per_step", "device_ms_per_step_by_group")}}


for phase in {phases!r}:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if phase == "ln_bwd_wide":
        res = ln_bwd_wide(gen)
    elif phase == "ln_fwd_shapes":
        res = ln_fwd_shapes(gen)
    elif phase == "bert_epilogues":
        res = bert_epilogues()
    elif phase == "fused_bwd_shapes":
        res = fused_bwd_shapes(gen)
    else:
        fn = getattr(cs, phase)
        if phase in PATHS:
            res = fn(0, cs.card_line())
        elif phase == "kernel_bert":      # its own generator
            res = fn(peaks)[0]
        else:
            res = fn(peaks, gen)[0]
    print(json.dumps({{"tree": {label!r}, "phase": phase, "result": res}},
                     default=str), flush=True)
"""


def checkpoint_io():
    """Copy the port and chip_smoke.py into build/kernel_variants/np_io
    with np.savez and np.load in the checkpoint writer and loader, then
    `compare` its checkpoint phase (labelled "parent") with this tree's
    in turns."""
    d = os.path.join(OUT, "np_io")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "deepspeed_tpu_torch"),
                    os.path.join(d, "deepspeed_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
    path = os.path.join(d, "deepspeed_tpu_torch", "runtime", "checkpoint.py")
    with open(path) as f:
        text = f.read()
    for old, new in NPZ_CALLS:
        if old not in text:
            raise SystemExit(f"checkpoint_io: {old!r} is not in {path}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return compare(d, ["checkpoint_and_check"])


# remat_policies: windows of steps a policy, rounds of windows in turns
POLICY_STEPS, POLICY_ROUNDS = 4, 3


def _policy_windows(label, makers, cs):
    """Build each engine of `makers` [(name, make)], warm it by 2 steps,
    then take POLICY_ROUNDS rounds of windows in turns (A B B A, then
    B A A B, ...), each POLICY_STEPS steps: its ms a step (host clock
    to the device's end) and the host's enqueue ms a step (until the
    last train_batch returned, before the device is waited for); then a
    torch.profiler window of 2 steps per engine. Prints one JSON line."""
    import time
    import numpy as np
    import torch
    built = {}
    for name, make in makers:
        feed = make()
        for _ in range(2):
            feed()
        torch.cuda.synchronize()
        built[name] = feed
    names = [n for n, _ in makers]
    res = {n: {"ms": [], "enqueue_ms": []} for n in names}
    for r in range(POLICY_ROUNDS):
        order = names if r % 2 == 0 else names[::-1]
        for n in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(POLICY_STEPS):
                built[n]()
            enq = time.perf_counter() - t0
            torch.cuda.synchronize()
            res[n]["ms"].append((time.perf_counter() - t0) /
                                POLICY_STEPS * 1e3)
            res[n]["enqueue_ms"].append(enq / POLICY_STEPS * 1e3)
    for n in names:
        prof = cs.profile_steps(lambda: [built[n]() for _ in range(2)], 2)
        res[n].update(busy_ms=prof.get("device_busy_ms_per_step"),
                      launches=prof.get("kernel_launches_per_step"),
                      median_ms=float(np.median(res[n]["ms"])),
                      median_enqueue_ms=float(np.median(
                          res[n]["enqueue_ms"])))
    print(json.dumps({"remat_policies": label, "steps_a_window":
                      POLICY_STEPS, "results": res}), flush=True)
    del built
    cs.release()


def remat_policies():
    """The flagship (phase 7's engine) under full remat and under
    save_fused_epilogues, then path G's gpt2-350m under full remat and
    under dots_with_no_batch_dims_saveable, fed directly and through
    engine.prefetch, all engines of a model resident in one process
    (`_policy_windows`)."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()

    def flagship(policy):
        def make():
            cfg = cs.train_config(remat_policy=policy)
            model = GPT2ForCausalLM(cfg)
            engine = dst.initialize(
                model=model, model_parameters=model.init(0),
                config=cs.flagship_ds_config(cs.TRAIN_BATCH))[0]
            ids = np.random.default_rng(0).integers(
                0, cfg.vocab_size, (1, cs.TRAIN_BATCH, cs.TRAIN_SEQ))
            staged = engine.stage_batch({"input_ids": ids})
            return lambda: engine.train_batch(batch=staged)
        return make

    loaders = []

    def small(policy, prefetch=False):
        def make():
            cfg = cs.selective_config(policy)
            model = GPT2ForCausalLM(cfg)
            engine = dst.initialize(
                model=model, model_parameters=model.init(0),
                config=cs.selective_ds_config(POLICY_STEPS))[0]
            ids = np.random.default_rng(0).integers(
                0, cfg.vocab_size, (cs.SEL_BATCH, cs.SEL_SEQ))
            if prefetch:
                loader = engine.prefetch(({"input_ids": ids}
                                          for _ in range(10 ** 6)))
                loaders.append(loader)
                return lambda: engine.train_batch(data_iter=loader)
            staged = engine.stage_batch({"input_ids": ids[None]})
            return lambda: engine.train_batch(batch=staged)
        return make

    _policy_windows("gpt2-1.5b", [
        ("full", flagship(None)),
        ("save_fused_epilogues", flagship("save_fused_epilogues"))], cs)
    _policy_windows("gpt2-350m", [
        ("full", small(None)), ("dots", small(cs.SEL_POLICY)),
        ("dots_prefetch", small(cs.SEL_POLICY, True)),
        ("full_prefetch", small(None, True))], cs)
    for loader in loaders:
        loader.close()
    print(cs.card_line(), flush=True)
    return 0


def compare(parent, phases):
    """Time `phases` (chip_smoke.py functions: kernel phases, or the
    paths in PATHS with their own lines; or `ln_bwd_wide`,
    `ln_fwd_shapes`, `fused_bwd_shapes` or `bert_epilogues`) from another
    tree (the parent
    commit unpacked under build/, say) and from this one, in turns:
    parent, this, this, parent, each in its own process with its own
    build. Prints each process's JSON lines under a marker line, then the
    card line."""
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 2
    parent = os.path.abspath(parent)
    for label, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                        ("parent", parent)):
        code = COMPARE_CODE.format(
            root=root, phases=tuple(phases), label=label,
            wide=[(lb, n, h) for lb, n, h, _, _ in LN_BWD_SHAPES
                  if lb.startswith("gpt2")],
            ln_fwd_cases=LN_FWD_CASES, ln_fwd=LN_FWD_SHAPES,
            fused=FUSED_COMPARE_CASES)
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True)
        # the phases' own lines (the paths emit theirs) under a marker
        print(json.dumps({"tree": label, "root": root}), flush=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
