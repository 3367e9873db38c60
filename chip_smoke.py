#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run, on one card

Phases, each printing one JSON line:
  1. environment: card name and power limit (nvidia-smi), torch/CUDA
     versions; TF32 is switched off for matmuls and cuDNN;
  2. build: the kernels compiled from ops/csrc/ into build/torch_kernels/,
     with ptxas's registers and spills of each Hopper (TMA + wgmma)
     kernel: the attention bodies, K7-fwd's, K7-band's, K7-dkv's,
     K7-dq's and K6, and of K4's 64, K3-bwd's 32 and K3-fwd's 32
     instantiations; none may spill;
  3. kernels vs their plain PyTorch twins at the slice's shapes, with
     max errors against stated tolerances, and the kernel's time beside
     the twin's, a bound (the least time the card could take: bytes
     over memory bandwidth or operations over peak rate, whichever is
     larger) and, for attention, torch's scaled_dot_product_attention
     as a yardstick (timed here only, never called by the port);
  4. serving: gpt2-1.5b at full width and depth with random weights
     from --seed, InferenceEngine + ServingLoop answering 4 greedy
     requests (prompts of 100-300 tokens, chunked prefill 128, 32 new
     tokens each), with each request's time to first token and mean
     token gap, then the same requests stepped one decode at a time to
     record per-step logits and time prefill and decode, and a
     torch.profiler window over decode steps (device busy and idle
     share, top kernels);
  5. oracle: each request's prompt + generated tokens teacher-forced
     through GPT2ForCausalLM.apply (flash attention and the fused
     epilogues, i.e. the kernels), compared with the engine's decode
     logits at the same positions;
  6. launch counts: every kernel's count is zeroed before phase 4 and
     each forward kernel's must be > 0 after phase 5;
  7. training: gpt2-1.5b at full width and depth through
     deepspeed_tpu_torch.initialize -> engine.train_batch with
     bench.py's flagship ds_config (micro batch 11, seq 1024, bf16
     without master weights, ZeRO-2, AdamW, full-block remat), 2
     warm-up and 6 timed steps on one repeated batch: step ms,
     tokens/s, peak memory, the loss at every step (finite, falling),
     launches per step of every kernel (zeroed right before the steps,
     each must be > 0), and a torch.profiler window over 2 steps (with
     the attention kernels' device ms per step beside the step ms, as
     in every training phase's profile);
  8. training oracle: 2 layers at gpt2-1.5b width, bf16, micro batch 11,
     seq 1024, loss and every gradient through the kernels against the
     plain-torch route;
  9. quantized training: phase 7 again with the quantized_compute block
     ({"enabled": true, "mode": "on", "block": 128}), so all four
     projections of every block run the int8 GEMM K6; the same numbers
     and profile, K6's launches per step, and each step's loss within
     0.2 of phase 7's at the same step (same weights, batch and seed);
 10. quantized oracle: 2 layers at gpt2-1.5b width, the kernel route
     (K6 and K1-K4) against the plain route (K6's twin, fused ops off,
     dense attention), after counting the int8 activation entries the
     two routes round differently at each projection;
 11. MoE training: gpt2-350m-moe8 (gpt2-350m at full width and depth,
     8 experts, top-2, capacity factor 1.25, every other layer) through
     initialize -> train_batch with bench.py's bench_gpt2_350m config
     (micro batch 16, seq 1024, bf16 with fp32 master weights, ZeRO-0,
     AdamW, full-block remat) and the `moe` block: as phase 7, plus the
     router's drop fraction and per-expert load at every step; every
     kernel must have launched, K8 (dispatch, combine) and the grouped
     K4 included;
 12. MoE oracle: 4 layers (2 MoE) at that width and batch, the kernel
     route against the plain-torch route (einsum dispatch/combine) with
     the routing held equal, after counting the assignments the plain
     route would choose differently on its own;
 13. quantized MoE training: phase 11 with quantized experts and the
     quantized_compute block (K6 for c_attn/c_proj of every block, the
     dense blocks' MLPs and, grouped over the 8 experts, wi and wo);
 14. kernel_sparse: the K7 kernels (block-sparse attention) against
     their twins at bench.py's sparse_attention_16k shape ([1, 16384,
     16, 64] bf16, block 256, causal; BSLongformer w4 and Fixed l4 g1 on
     K7-band's Hopper body, BigBird on K7-fwd's Hopper body (128-row q
     tiles over the forward pair table), each with its earlier WMMA body
     beside it, K7-dkv/K7-dq under all three on the Hopper
     sweeps, and on their earlier WMMA bodies beside them), timed
     beside a bound over the visible scores (with TFLOP/s and the
     backward walks' steps per CTA beside the visible tile pairs), the
     twin, SDPA with the expanded boolean layout mask and the dense
     K1/K2; checks at the paths' other shapes ([2, 32768] BSLongformer
     and Fixed, BERT's default Fixed at block 128, bidirectional), at
     block 32 (fp32, bf16), on per-head layouts at D 128 and on the
     Hopper bodies at every block, head dims 64 and 128, T 448;
 15. sparse_attention: the bench leg through SparseSelfAttention(...)
     (q, q, q, causal=True), forward + backward, BSLongformer and Fixed
     at [1, 16384] and [2, 32768], BigBird at [1, 16384]: ms (CUDA
     events, allocator warm), the ratio to dense K1/K2, peak memory;
     every K7 kernel must have launched;
 16. bert_sparse: BertSparseSelfAttention(1024, 16) (default Fixed,
     bidirectional) on [1, 16384, 1024] bf16, forward + backward finite;
 17. sparse_oracle: the kernel route against the dense masked fallback
     at T 4096, outputs and dQ/dK/dV by relative L2, fp32 (K7's WMMA
     bodies) and bf16 (the Hopper ones), every K7 kernel launched;
 18. kernel_merge: K5 (flash attention merged with a prior softmax
     partial in its epilogue) against its twin at the ring leg's
     [1, 8192, 4, 64] (bf16 causal and full, fp32) and the sp_training
     shape, with a prior partial from K1 over a disjoint block whose
     first rows are empty; timed there and at [1, 32768, 16, 64] against
     K1 on the same q, beside its bound, the twin and SDPA's forward;
     K2's given-delta entry (K5's backward) against its twin;
 19. sequence_parallel: bench.py's ring leg in a one-rank NCCL group
     (file:// rendezvous): ring_attention (flash and fallback bodies)
     and ulysses_attention, forward + backward, each held to K1, timed;
     then four ranks' ring folds played in one process on chunks of
     [1, 32768, 16, 64] and [1, 8192, 4, 64], held to K1/K2 on the whole
     sequence with exactly 10 K5 and 10 K2 launches per pass;
 20. sp_training: phase 7 with sequence_parallel="ring" in the one-rank
     group (2 warm-up and 4 timed steps), each step's loss within 1e-2
     of phase 7's, K5 on every layer;
 21. checkpoint: phase 7's flagship saves, resumes and continues. Engine
     A takes 2 steps and a 4-step window without a save, saves the same
     state sync and async (the async writer copying to pinned host
     memory on its own CUDA stream), and takes 4 more steps while the
     writer runs; engine B, fresh from other weights, loads `latest`
     and takes those 4 steps on the same batches. Gates: the async call
     returns before its commit, `latest` names the tag with no staging
     dir left, the sync and async directories are byte-identical, every
     leaf B loaded equals the file's bytes, B's losses equal A's bit for
     bit, every training kernel launched. Printed: bytes written, the
     blocked ms of both calls, the two windows' ms and the stall,
     fetch, commit and load ms, peak device memory and host RSS during
     the save; the checkpoint directory lives under build/ and is
     removed at the end;
 22. kernel_bert: K1-fwd and K2 (bf16 non-causal [16, 128, 16, 64]),
     K3-fwd and K3-bwd in the post-LN form (N 2,048, H 1024; the
     residual in bf16 and in fp32, fp32 out, the sum for the backward
     only) and K4 erf (N 2,048, W 4096) against their twins at
     BERT-large's pretraining shapes, timed beside their bounds, SDPA's
     non-causal forward and backward, F.gelu and aten.gelu_backward;
 23. bert_training: BERT-large (24 layers, hidden 1024, 16 heads,
     intermediate 4096, vocab 30522) through initialize -> train_batch
     with bench.py's bench_bert_large settings (micro batch 16, gas 16,
     seq 128, bf16 with fp32 masters, AdamW, dropout 0), 2 warm-up and 3
     timed steps on one repeated batch: step ms, samples/s, tokens/s,
     TFLOP/s (samples/s * 128 * 6 * n_params), peak memory, exactly 24
     K1-fwd, 24 K2, 48 K3-fwd, 48 K3-bwd, 24 K4-fwd and 24 K4-bwd
     launches per micro batch; 3 more steps (the 8 losses finite, the
     last below the first), a profile of one step, and 3 steps of the
     plain-torch route from the same weights, each loss within 1e-2 of
     the kernel route's;
 24. bert_oracle: two BERT-large-wide layers, bf16, micro batch 16, seq
     128: the loss and every gradient through the kernels against the
     plain-torch route (fused ops off, dense attention).
Phase 3 holds the forward kernels at the serving, the training and the
MoE training shapes, and the backward kernels (K2, K3-bwd, K4-bwd) at
both training shapes, against their twins, with fp32 cases, SDPA's
causal backward as K2's yardstick, two launches of each deterministic
backward compared bit for bit (K2 at every case), K1 and K2 on their
Hopper bodies (bf16, head dims 64 and 128) at T 320 too, where the last
128-row tile runs past T, and K1 at B*H = 65550 (past grid.y's 65535),
K3-fwd at the serving (with the decode and prefill-chunk shapes),
training and MoE shapes and both ln_f forms, each with its device time
from a CUDA graph beside the back-to-back time, and at its layout's edges
(the models' other widths, H 1602, unaligned views, fp32 throughout;
each launched twice and compared bit for bit), each timed attention
case with its achieved TFLOP/s, share of its bound and ratio to the
library call, K4 at the decode shape too (with its device time from a
CUDA graph), with torch's own GeLU forward and
backward as yardsticks and at its layout's edges (W 100 and 6401, odd
N, unaligned views, fp32 out, bf16 bias, groups of 37 rows; each case
launched twice and compared bit for bit), K4 in its grouped (expert)
form and K8 at the MoE shape (N 16,384 tokens, 8 x 5,120 slots, H
1024) in bf16 and fp32, k 1 and 2, with empty slots and dropped
assignments
(`torch.index_select` on the padded tokens is dispatch's yardstick),
and K6 at the projection shapes of the flagship and of gpt2-350m-moe8
and the experts' two grouped shapes, bit for bit its twin there and at
block 256 (torch._int_mm and the bf16 matmul as its yardsticks); each
kernel is timed at the shapes of the paths that run it.
Then the `kernels` summary line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failed phase raises and the script
exits non-zero without printing a result. It needs a CUDA device and
the repository around it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s,
# int8 tensor-core OP/s, fp32 CUDA-core FLOP/s, HBM bytes/s. Matched
# against the card's name.
PEAKS = (
    ("H100 PCIe", dict(bf16=756e12, int8=1513e12, fp32=51e12, hbm=2.0e12)),
    ("H100 NVL", dict(bf16=835e12, int8=1671e12, fp32=60e12, hbm=3.9e12)),
    ("H200", dict(bf16=989e12, int8=1979e12, fp32=67e12, hbm=4.8e12)),
    ("H100", dict(bf16=989e12, int8=1979e12, fp32=67e12, hbm=3.35e12)),
)

# tolerances (max |kernel - twin|, same inputs on the card)
#  - fp32 outputs: reductions in another order, ~1e-6 relative
#  - bf16 outputs: one rounding of the result, so up to ~2 bf16 ulps
#    (2^-7 relative) where the fp32 values straddle a rounding point
TOL_F32 = dict(atol=1e-4, rtol=1e-4)
TOL_BF16 = dict(atol=1e-2, rtol=1e-2)
# engine decode logits vs the kernel-driven full forward, both bf16:
# the two paths round the residual stream, the attention scores (bf16
# score product in paged attention, fp32 in flash) and the logits at
# different places through 48 layers. Logits are ~N(0, 0.8) here and
# one bf16 ulp at |x| in [2, 4) is 0.0156, so the bound is 8 such ulps.
TOL_LOGITS = 0.125
# gradients, kernel against twin, by relative L2 error ||got - ref|| /
# ||ref||: fp32 to reduction-order roundoff; bf16 within one rounding of
# each output plus the bf16 rounding of P and dS inside attention, which
# flips by one ulp where the kernel's and the twin's fp32 scores differ
# in the last bit
GRAD_TOL_F32 = 1e-5
GRAD_TOL_BF16 = 1e-2
# training oracle, kernel route against plain-torch route, bf16: the
# routes round the residual stream, the LayerNorm and GeLU outputs and
# the attention probabilities at different places (bf16 keeps 8 bits,
# 2^-9 relative per rounding); a value meets a few dozen such roundings
# through two layers forward and backward, a random walk of ~2%, so
# gradients agree within 5% relative L2 and the mean loss within 1%
TOL_TRAIN_LOSS = 1e-2
TOL_TRAIN_GRAD = 5e-2

ROOT = os.path.dirname(os.path.abspath(__file__))
# the generator of the checks added for the Hopper attention bodies, so
# that every earlier check keeps its inputs
SM90_SEED = 7


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name):
    for key, peaks in PEAKS:
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for card {name!r}")


def time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20):
    """Device time per call of `fn`, from `calls` calls captured in one
    CUDA graph and replayed: the host's cost of each call (the wrapper's
    checks, allocations and launch) left out, for calls so small that
    back-to-back launches time the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, iters=5, warmup=1) / calls
    del graph
    return ms


def max_err(got, ref, atol, rtol):
    """(max abs error, max error / (atol + rtol*|ref|)); the check
    passes when the second is <= 1."""
    import torch
    g, r = got.detach().float(), ref.detach().float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), float("inf")
    diff = (g - r).abs()
    return float(diff.max()), float((diff / (atol + rtol * r.abs())).max())


def bound(flops, flops_peak, nbytes, peaks):
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate of their type and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops = flops / flops_peak * 1e3
    t_bytes = nbytes / peaks["hbm"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# K4's instantiations: 2 x 2 x 2 element types x the two GeLU forms x
# 16-byte or scalar accesses, forward and backward, and the fp16 forms
# (all fp16) x the GeLU forms x access width, forward and backward
K4_KERNELS = 2 * 32 + 2 * 4
# K3-bwd's: 2 x 2 x 2 element types (s, dout, dx) x 1 or 4 vectors a
# lane x 16-byte or scalar accesses, and the 3 fp16 forms (dx fp16;
# fused_ops.LN_BWD_FP16_FORMS) at one vector a lane x access width
K3_BWD_KERNELS = 32 + 6
# K3-fwd's: 2 x 2 x 2 x 2 element types (y, residual, out, sum) x
# 16-byte or scalar accesses, and the 3 fp16 forms (y fp16;
# fused_ops.LN_FWD_FP16_FORMS) x access width
K3_FWD_KERNELS = 32 + 6
# the attention bodies and K6 (18), the fp16 forms of K1-fwd and of K2's
# two sweeps at head dims 64 and 128 (6), K2-fused in bf16 and fp16 at
# head dims 64 and 128 (4) and K7's four Hopper kernels in fp16 at head
# dims 64 and 128 (8)
ATTN_KERNELS = 18 + 6 + 4 + 8
# the Hopper kernels the build must report, none spilling: the attention
# bodies and K6, and K4's, K3-bwd's and K3-fwd's instantiations
SM90_KERNELS = ATTN_KERNELS + K4_KERNELS + K3_BWD_KERNELS + K3_FWD_KERNELS
SM90_LIBS = ("flash_attention_fwd", "flash_attention_bwd",
             "flash_attention_bwd_fused", "block_sparse_attention",
             "quantized_matmul", "fused_gelu_fwd", "fused_gelu_bwd",
             "fused_ln_bwd", "fused_ln_fwd")


def sm90_ptxas(log):
    """{kernel<args>: "R registers, no spill" or "..., N bytes spill
    stores"} of the Hopper kernels in one library's ptxas report (nvcc
    -Xptxas -v): the attention bodies (K1, K5, K2, K7-fwd, K7-band,
    K7-dkv and K7-dq, by head dim), K6 (by output type), K4 (by element
    types, GeLU form and access width), K3-bwd (by element types,
    vectors a lane and access width) and K3-fwd (by element types and
    access width)."""
    import re
    out, name = {}, None
    # the mangled types: f float, 13__nv_bfloat16 bf16, 6__half fp16, and
    # back-references (S1_) to the 16-bit type of the instantiation (none
    # mixes bf16 and fp16)
    types_re = r"f|13__nv_bfloat16|6__half|S\d*_"

    def types(mangled):
        half = "fp16" if "6__half" in mangled else "bf16"
        return ", ".join("float" if t == "f" else half
                         for t in re.findall(types_re, mangled))

    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"((?:flash_(?:fwd|bwd_dkv|bwd_dq|bwd_fused)|"
                          r"band_fwd|bs_fwd|"
                          r"bs_bwd_dkv|bs_bwd_dq)_kernel_sm90)I"
                          r"(13__nv_bfloat16|6__half)?Li(\d+)E"
                          r"(?:Lb(\d)E)?", ln)
            q = re.search(r"qmm_kernelI(f|13__nv_bfloat16)E", ln)
            k4 = re.search(rf"(gelu_(?:fwd|bwd)_kernel)I((?:{types_re}){{3}})"
                           r"Lb(\d)ELb(\d)E", ln)
            k3 = re.search(rf"(ln_bwd_kernel)I((?:{types_re}){{3}})"
                           r"Li(\d)ELb(\d)E", ln)
            k3f = re.search(rf"(ln_fwd_kernel)I((?:{types_re}){{4}})"
                            r"Lb(\d)E", ln)
            name = None
            if m is not None:
                name = (f"{m.group(1)}<" +
                        ("fp16, " if m.group(2) == "6__half" else "") +
                        m.group(3) +
                        (f", merge={m.group(4)}" if m.group(4) else "") +
                        ">")
            elif q is not None:
                name = f"qmm_kernel<{'float' if q.group(1) == 'f' else 'bf16'}>"
            elif k4 is not None:
                name = (f"{k4.group(1)}<{types(k4.group(2))}, "
                        f"{'tanh' if k4.group(3) == '1' else 'erf'}, "
                        f"{'vec' if k4.group(4) == '1' else 'scalar'}>")
            elif k3 is not None:
                name = (f"{k3.group(1)}<{types(k3.group(2))}, "
                        f"{k3.group(3)} vector(s) a lane, "
                        f"{'vec' if k3.group(4) == '1' else 'scalar'}>")
            elif k3f is not None:
                name = (f"{k3f.group(1)}<{types(k3f.group(2))}, "
                        f"{'vec' if k3f.group(3) == '1' else 'scalar'}>")
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            out[name] = "no spill" if m.group(1) == "0" else \
                f"{m.group(1)} bytes spill stores"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
            name = None
    return out


def release():
    """Free what the last phase left before the next one measures its
    peak memory: an engine holds a reference cycle (`engine.optimizer` is
    the engine), so `del` alone leaves its state on the card until the
    garbage collector runs."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ----------------------------------------------------------------------
# phase 3: kernels vs plain twins
# ----------------------------------------------------------------------
def check(label, got, ref, tol, checks):
    abs_err, ratio = max_err(got, ref, **tol)
    row = {"check": label, "max_abs_err": abs_err, "tol": tol,
           "worst_err_over_tol": ratio}
    checks.append(row)
    if not ratio <= 1.0:
        raise AssertionError(f"{label}: error {abs_err} outside {tol}")
    return abs_err


def rates(row, flops):
    """A timed row's achieved TFLOP/s (the algorithm's operations over
    the kernel's time), its share of the bound (bound_ms / ms) and its
    time over the library call's (None where there is none)."""
    lib = row.get("library_ms")
    row.update(tflops=flops / row["ms"] / 1e9,
               share_of_bound=row["bound_ms"] / row["ms"],
               ratio_to_library=row["ms"] / lib
               if isinstance(lib, float) and lib > 0 else None)
    return row


def kernel_flash(peaks, gen):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    checks, out = [], {}

    def qkv_views(b, t, h, d, dtype, g):
        # the model's layout: q/k/v are column slices of one qkv tensor
        c = h * d
        qkv = torch.randn((b, t, 3 * c), generator=g, device="cuda",
                          dtype=torch.float32).to(dtype)
        return [p.view(b, t, h, d) for p in qkv.split(c, dim=-1)]

    cases = (
        # (label, B, T, H, D, dtype, causal, timed as)
        ("bf16 causal B4 T1024 H25 D64", 4, 1024, 25, 64,
         torch.bfloat16, True, "serving"),
        ("bf16 causal B11 T1024 H25 D64 (training shape)", 11, 1024, 25,
         64, torch.bfloat16, True, "training"),
        ("bf16 causal B1 T384 H25 D64 (oracle shape)", 1, 384, 25, 64,
         torch.bfloat16, True, None),
        ("bf16 causal B16 T1024 H16 D64 (MoE training shape)", 16, 1024,
         16, 64, torch.bfloat16, True, "moe_training"),
        ("fp32 non-causal B4 T256 H25 D64", 4, 256, 25, 64,
         torch.float32, False, None),
        # the wide head dims (the tile body's two column halves)
        ("bf16 causal B11 T1024 H4 D256 (head dim 256)", 11, 1024, 4, 256,
         torch.bfloat16, True, "head_dim_256"),
        ("fp32 non-causal B2 T512 H3 D192", 2, 512, 3, 192, torch.float32,
         False, None),
    )
    # the Hopper body's ragged last q tile (T a multiple of 64, not of
    # 128) and B*H past the WMMA bodies' grid.y limit of 65535, on inputs
    # of their own generator (the cases above keep theirs)
    gen_sm90 = torch.Generator(device="cuda")
    gen_sm90.manual_seed(SM90_SEED)
    sm90_cases = (
        ("bf16 causal B2 T320 H3 D128 (ragged T)", 2, 320, 3, 128,
         torch.bfloat16, True, None),
        ("bf16 non-causal B2 T320 H3 D64 (ragged T)", 2, 320, 3, 64,
         torch.bfloat16, False, None),
        ("bf16 causal B32775 T64 H2 D64 (B*H 65550)", 32775, 64, 2, 64,
         torch.bfloat16, True, None),
    )
    for (label, b, t, h, d, dtype, causal, timed), g in \
            [(c, gen) for c in cases] + [(c, gen_sm90) for c in sm90_cases]:
        q, k, v = qkv_views(b, t, h, d, dtype, g)
        sm = 1.0 / d ** 0.5
        got, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = fa._flash_fwd_plain(q, k, v, sm, causal)
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        err = check(f"flash out, {label}", got, ref, tol, checks)
        check(f"flash log2-lse, {label}", lse[..., 0], ref_lse, TOL_F32,
              checks)
        del got, lse, ref, ref_lse
        if timed:
            itemsize = q.element_size()
            pairs = t * (t + 1) // 2 if causal else t * t
            flops = 4.0 * b * h * d * pairs
            nbytes = 4 * b * t * h * d * itemsize + b * h * t * 4
            peak = peaks["bf16"] if dtype == torch.bfloat16 \
                else peaks["fp32"]
            bound_ms, bound_by = bound(flops, peak, nbytes, peaks)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out[timed] = rates(dict(
                max_abs_err=err,
                ms=time_ms(lambda: fa.flash_attention_with_lse(
                    q, k, v, causal=causal)),
                plain_ms=time_ms(lambda: fa._flash_fwd_plain(
                    q, k, v, sm, causal), iters=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal)),
                shape=label), flops)
        del q, k, v
        release()
    return out, checks


def kernel_ln(peaks, gen):
    """K3-fwd at each path's shapes: serving N 4096 H 1600 (fp32
    vectors: serving's fp32 parameters) and its ln_f form, the decode
    shape N 4 and the prefill chunk N 128; the training flagship's N
    11,264 H 1600 and its ln_f form and the MoE cell's N 16,384 H 1024,
    with bias, gamma and beta in bf16 as the training paths hold them
    (read in their own dtype: one launch a call). Every row is timed back
    to back (`ms`) and as device time from a CUDA graph (`graph_ms`: at
    these sizes back-to-back calls time the host), with its share of the
    bound and the plain twin's time. Then the layout's edges (LN_SEED):
    the models' other widths, a ragged width, unaligned views and fp32
    throughout, each against the twin, one launch a call and repeated
    bit for bit."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    checks, out = [], {}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (
        # (label, N, vectors' dtype, out dtype, sum dtype or None for
        #  the ln_f form, timed as)
        ("N4096 H1600 bf16 out+sum", 4096, f32, bf16, bf16, "serving"),
        ("N4096 H1600 ln_f form (fp32 out, no sum)", 4096, f32, f32, None,
         "serving_ln_f"),
        ("N4 H1600 bf16 (decode shape)", 4, f32, bf16, bf16,
         "serving_decode"),
        ("N128 H1600 bf16 (prefill chunk shape)", 128, f32, bf16, bf16,
         "serving_prefill_chunk"),
        ("N11264 H1600 bf16 out+sum, bf16 vectors (training shape)", 11264,
         bf16, bf16, bf16, "training"),
        ("N11264 H1600 ln_f form, bf16 vectors (training shape)", 11264,
         bf16, f32, None, "training_ln_f"),
        ("N16384 H1024 bf16 out+sum, bf16 vectors (MoE training shape)",
         16384, bf16, bf16, bf16, "moe_training"),
    )
    for label, n, v_dt, out_dt, sum_dt, timed in cases:
        h = 1024 if "H1024" in label else 1600
        y = torch.randn((n, h), generator=gen, device="cuda").to(bf16)
        res = torch.randn((n, h), generator=gen, device="cuda").to(bf16)
        bias, gamma, beta = (0.1 * torch.randn(
            (h,), generator=gen, device="cuda") for _ in range(3))
        bias, gamma, beta = bias.to(v_dt), (gamma + 1.0).to(v_dt), \
            beta.to(v_dt)
        ret_sum = sum_dt is not None

        def run():
            return fo.fused_bias_residual_layernorm(
                y, bias, res, gamma, beta, eps=1e-5, out_dtype=out_dt,
                sum_dtype=sum_dt, return_sum=ret_sum)

        before = fo.fused_bias_residual_layernorm.launches
        got = run()
        torch.cuda.synchronize()
        if fo.fused_bias_residual_layernorm.launches != before + 1:
            raise AssertionError(f"ln {label}: not one launch")
        ref_out, ref_s = fo._ln_fwd_math(y, bias, res, gamma, beta, 1e-5)
        tol = TOL_BF16 if out_dt == bf16 else TOL_F32
        if ret_sum:
            err = check(f"ln out, {label}", got[0], ref_out.to(out_dt), tol,
                        checks)
            check(f"ln sum, {label}", got[1], ref_s.to(sum_dt), TOL_BF16,
                  checks)
        else:
            err = check(f"ln out, {label}", got, ref_out, tol, checks)
        # read y and residual (bf16), write out and the sum, the [H]
        # vectors once; fp32 arithmetic: 2 adds, square and 2
        # accumulates, subtract, 2 multiplies and an add per element
        nbytes = n * h * (2 + 2 + torch.finfo(out_dt).bits // 8 +
                          (2 if ret_sum else 0)) + \
            3 * h * bias.element_size()
        bound_ms, bound_by = bound(9 * n * h, peaks["fp32"], nbytes, peaks)
        g_ms = graph_ms(run)
        out[timed] = rates(dict(
            max_abs_err=err, ms=time_ms(run), graph_ms=g_ms,
            graph_share_of_bound=bound_ms / g_ms,
            plain_ms=time_ms(lambda: fo._ln_fwd_math(
                y, bias, res, gamma, beta, 1e-5)),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, shape=label,
            plan=fo.ln_fwd_plan(n, h, fo._sm_count(0))._asdict()), 9 * n * h)
    # the layout's edges, each launched twice: (label, N, H, y, residual,
    # vectors, out, sum dtype, y's and the residual's storage offsets)
    g2 = torch.Generator(device="cuda")
    g2.manual_seed(LN_SEED)
    edges = [(f"N1024 H{h} bf16, bf16 vectors", 1024, h, bf16, bf16, bf16,
              bf16, bf16, 0, 0) for h in (768, 1536, 2560, 4096, 5120)]
    edges += [
        ("N301 H1602 (ragged: scalar accesses)", 301, 1602, bf16, bf16,
         bf16, bf16, bf16, 0, 0),
        ("N4096 H1600, y 1 element into its storage (scalar accesses)",
         4096, 1600, bf16, bf16, bf16, bf16, bf16, 1, 0),
        ("N4096 H1600, y and residual 1 row into their storage", 4096,
         1600, bf16, bf16, bf16, bf16, bf16, 1600, 1600),
        ("N333 H1602 fp32 residual 1 element into its storage, fp32 out",
         333, 1602, bf16, f32, f32, f32, f32, 0, 1),
        ("N1024 H1600 fp32 throughout", 1024, 1600, f32, f32, f32, f32, f32,
         0, 0),
        ("N1 H5120 bf16, bf16 vectors", 1, 5120, bf16, bf16, bf16, bf16,
         bf16, 0, 0),
    ]
    for label, n, h, y_dt, r_dt, v_dt, out_dt, sum_dt, y_off, r_off in edges:
        y = k4_rows(n, h, y_dt, y_off, g2)
        res = k4_rows(n, h, r_dt, r_off, g2)
        bias, beta = ((0.1 * torch.randn((h,), generator=g2, device="cuda"))
                      .to(v_dt) for _ in range(2))
        gamma = (1.0 + 0.1 * torch.randn((h,), generator=g2,
                                         device="cuda")).to(v_dt)
        before = fo.fused_bias_residual_layernorm.launches
        got = fo.fused_bias_residual_layernorm(
            y, bias, res, gamma, beta, out_dtype=out_dt, sum_dtype=sum_dt)
        again = fo.fused_bias_residual_layernorm(
            y, bias, res, gamma, beta, out_dtype=out_dt, sum_dtype=sum_dt)
        torch.cuda.synchronize()
        ref_out, ref_s = fo._ln_fwd_math(y, bias, res, gamma, beta, 1e-5)
        check(f"ln out, {label}", got[0], ref_out.to(out_dt),
              TOL_BF16 if out_dt == bf16 else TOL_F32, checks)
        check(f"ln sum, {label}", got[1], ref_s.to(sum_dt),
              TOL_BF16 if sum_dt == bf16 else TOL_F32, checks)
        if fo.fused_bias_residual_layernorm.launches != before + 2:
            raise AssertionError(f"ln {label}: not two launches")
        if not (torch.equal(got[0], again[0]) and
                torch.equal(got[1], again[1])):
            raise AssertionError(f"ln {label}: two launches differ")
    return out, checks


# the generator of the checks added for K3-fwd's Hopper layout (the
# models' widths, ragged and unaligned rows), so that every earlier check
# keeps its inputs
LN_SEED = 14


# the generator of the checks added for K4's Hopper layout (ragged and
# unaligned rows, mixed dtypes, groups cut short), so that every earlier
# check keeps its inputs
K4_SEED = 10


def k4_rows(n, w, dtype, offset, gen, scale=1.0):
    """[n, w] rows on the card, a view `offset` elements into its
    storage (offset 1 leaves the rows unaligned: K4's scalar accesses)."""
    import torch
    flat = scale * torch.randn((n * w + offset,), generator=gen,
                               device="cuda")
    return flat.to(dtype)[offset:].view(n, w)


def kernel_gelu(peaks, gen):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    checks, out = [], {}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (  # (label, N, W, bias groups, tanh form, timed as)
        ("N4096 W6400 bf16 tanh", 4096, 6400, 1, True, "serving"),
        ("N4096 W6400 bf16 erf", 4096, 6400, 1, False, None),
        ("N4 W6400 bf16 tanh (decode shape)", 4, 6400, 1, True,
         "serving_decode"),
        ("N11264 W6400 bf16 tanh (training shape)", 11264, 6400, 1, True,
         "training"),
        ("N16384 W4096 bf16 tanh (MoE dense blocks)", 16384, 4096, 1, True,
         "moe_training_dense"),
        ("G8 x 5120 x W4096 bf16 tanh, bias [8, 4096] (MoE experts)",
         8 * 5120, 4096, 8, True, "moe_training"))
    for label, n, w, groups, approx, timed in cases:
        x = torch.randn((n, w), generator=gen, device="cuda").to(bf16)
        bias = 0.1 * torch.randn((groups, w) if groups > 1 else (w,),
                                 generator=gen, device="cuda")

        def run():
            return fo.fused_bias_gelu_with_sum(x, bias, approximate=approx,
                                               out_dtype=bf16)

        got_out, got_s = run()
        torch.cuda.synchronize()
        ref_out, ref_s = fo._gelu_fwd_math(x, bias, approx)
        err = check(f"gelu out, {label}", got_out, ref_out.to(bf16),
                    TOL_BF16, checks)
        check(f"gelu sum, {label}", got_s, ref_s.to(bf16), TOL_BF16, checks)
        if timed:
            # read x, write out and sum (bf16), the bias row once; fp32
            # arithmetic of the tanh form: 10 operations and a tanh
            # (counted as one) per element
            nbytes = n * w * (2 + 2 + 2) + groups * w * 4
            bound_ms, bound_by = bound(11 * n * w, peaks["fp32"], nbytes,
                                       peaks)
            out[timed] = rates(dict(
                max_abs_err=err, ms=time_ms(run),
                graph_ms=graph_ms(run) if n < 64 else None,
                plain_ms=time_ms(lambda: fo._gelu_fwd_math(x, bias, approx)),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, shape=label,
                # PyTorch's own elementwise GeLU at the same shape: what
                # its elementwise path streams (no bias, no saved sum);
                # never called by the port
                yardstick="F.gelu(x, approximate='tanh'), bf16 [N, W]",
                yardstick_ms=time_ms(
                    lambda: F.gelu(x, approximate="tanh"))), 11 * n * w)
    # the layout's edges: (label, N, W, groups, rows', output and bias
    # dtypes, storage offset), each against the twin and repeated bit
    # for bit, with the launches counted
    g2 = torch.Generator(device="cuda")
    g2.manual_seed(K4_SEED)
    edges = (
        ("N63 W100 (scalar accesses)", 63, 100, 1, bf16, bf16, f32, 0),
        ("N33 W6401 (scalar tail)", 33, 6401, 1, bf16, bf16, f32, 0),
        ("N4095 W6400 (odd N)", 4095, 6400, 1, bf16, bf16, f32, 0),
        ("N4096 W6400, rows 1 element into their storage", 4096, 6400, 1,
         bf16, bf16, f32, 1),
        ("N4096 W6400, rows 1 row into their storage", 4096, 6400, 1, bf16,
         bf16, f32, 6400),
        ("N4096 W6400 bf16 rows, fp32 out", 4096, 6400, 1, bf16, f32, f32,
         0),
        ("N1024 W6400 fp32", 1024, 6400, 1, f32, f32, f32, 0),
        ("G8 x 37 x W4096, bf16 bias (groups cut short)", 8 * 37, 4096, 8,
         bf16, bf16, bf16, 0))
    for label, n, w, groups, x_dt, out_dt, bias_dt, offset in edges:
        x = k4_rows(n, w, x_dt, offset, g2)
        bias = (0.1 * torch.randn((groups, w) if groups > 1 else (w,),
                                  generator=g2, device="cuda")).to(bias_dt)
        before = fo.fused_bias_gelu.launches
        got = fo.fused_bias_gelu_with_sum(x, bias, approximate=True,
                                          out_dtype=out_dt)
        again = fo.fused_bias_gelu_with_sum(x, bias, approximate=True,
                                            out_dtype=out_dt)
        torch.cuda.synchronize()
        ref_out, ref_s = fo._gelu_fwd_math(x, bias, True)
        check(f"gelu out, {label}", got[0], ref_out.to(out_dt),
              TOL_BF16 if out_dt == bf16 else TOL_F32, checks)
        check(f"gelu sum, {label}", got[1], ref_s.to(x_dt),
              TOL_BF16 if x_dt == bf16 else TOL_F32, checks)
        if fo.fused_bias_gelu.launches != before + 2:
            raise AssertionError(f"gelu {label}: not two launches")
        if not (torch.equal(got[0], again[0]) and
                torch.equal(got[1], again[1])):
            raise AssertionError(f"gelu {label}: two launches differ")
    return out, checks


def rel_l2(got, ref):
    """||got - ref|| / ||ref|| in fp32."""
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


def check_rel(label, got, ref, tol, checks):
    """A gradient check by relative L2 error; returns the max abs error."""
    err = rel_l2(got, ref)
    abs_err = float((got.detach().float() - ref.detach().float())
                    .abs().max())
    checks.append({"check": label, "rel_l2": err, "tol_rel_l2": tol,
                   "max_abs_err": abs_err})
    if not (err <= tol and torch_isfinite(got)):
        raise AssertionError(f"{label}: relative L2 error {err} outside "
                             f"{tol}")
    return abs_err


def torch_isfinite(x):
    import torch
    return bool(torch.isfinite(x.float()).all())


def kernel_flash_bwd(peaks, gen):
    """K2's sweeps (the delta pre-pass, then the dK/dV and dQ sweeps:
    `_flash_bwd_launch`, the route of T > 1024, fp32 and head dims
    192/256) at the training flagship's shape (B11 T1024 H25 D64 bf16
    causal, q/k/v column slices of one qkv tensor) and the MoE training
    shape (B16 T1024 H16 D64), where the paths now take K2-fused (the
    sweeps launched directly, as the earlier kernel at those shapes),
    plus fp32 and d=128 cases and the wide head dims (192, 256; D256
    timed), against `_flash_bwd_plain` on the forward kernel's own (out,
    lse). The library yardstick is SDPA's causal backward (its forward +
    backward, minus its forward)."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    checks, out = [], {}
    cases = (
        # (label, B, T, H, D, dtype, causal, timed as)
        ("bf16 causal B11 T1024 H25 D64", 11, 1024, 25, 64,
         torch.bfloat16, True, "training"),
        ("bf16 causal B16 T1024 H16 D64 (MoE training shape)", 16, 1024, 16,
         64, torch.bfloat16, True, "moe_training"),
        ("bf16 non-causal B2 T256 H4 D128", 2, 256, 4, 128,
         torch.bfloat16, False, None),
        ("fp32 causal B2 T256 H25 D64", 2, 256, 25, 64, torch.float32,
         True, None),
        ("fp32 non-causal B2 T256 H4 D128", 2, 256, 4, 128,
         torch.float32, False, None),
        ("bf16 causal B11 T1024 H4 D256 (head dim 256)", 11, 1024, 4, 256,
         torch.bfloat16, True, "head_dim_256"),
        ("fp32 causal B2 T256 H3 D192", 2, 256, 3, 192, torch.float32, True,
         None),
    )
    # the Hopper sweeps' ragged last tile, on inputs of their own
    # generator (the cases above keep theirs)
    gen_sm90 = torch.Generator(device="cuda")
    gen_sm90.manual_seed(SM90_SEED)
    sm90_cases = (
        ("bf16 causal B2 T320 H3 D128 (ragged T)", 2, 320, 3, 128,
         torch.bfloat16, True, None),
        ("bf16 non-causal B2 T320 H3 D64 (ragged T)", 2, 320, 3, 64,
         torch.bfloat16, False, None),
    )
    for (label, b, t, h, d, dtype, causal, timed), g in \
            [(c, gen) for c in cases] + [(c, gen_sm90) for c in sm90_cases]:
        timed_case = timed is not None
        c = h * d
        qkv = torch.randn((b, t, 3 * c), generator=g, device="cuda",
                          dtype=torch.float32).to(dtype)
        q, k, v = (p.view(b, t, h, d) for p in qkv.split(c, dim=-1))
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        lse = lse[..., 0].contiguous()
        dout = torch.randn((b, t, h, d), generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)
        dlse = None if timed_case else torch.randn(
            (b, h, t), generator=g, device="cuda")
        sm = 1.0 / d ** 0.5

        def run():
            return fa._flash_bwd_launch(q, k, v, o, lse, dout, dlse, sm,
                                        causal)

        got = run()
        torch.cuda.synchronize()
        ref = fa._flash_bwd_plain(q, k, v, o, lse, dout, dlse, sm, causal)
        tol = GRAD_TOL_BF16 if dtype == torch.bfloat16 else GRAD_TOL_F32
        errs = [check_rel(f"flash bwd d{n}, {label}", x, y, tol, checks)
                for n, x, y in zip("qkv", got, ref)]
        # two deterministic sweeps, no atomics: a second launch repeats
        # the first bit for bit
        again = run()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        checks.append({"check": f"flash bwd repeats bit for bit, {label}",
                       "equal": same})
        if not same:
            raise AssertionError(f"K2 {label}: a second launch differs")
        del ref, again
        if timed_case:
            itemsize = q.element_size()
            pairs = t * (t + 1) // 2 if causal else t * t
            # five products per visible (q, k) pair: S, dP, dV, dK, dQ
            flops = 10.0 * b * h * d * pairs
            # read q, k, v, out, dout and lse; write dq, dk, dv
            nbytes = 8 * b * t * h * d * itemsize + b * h * t * 4
            bound_ms, bound_by = bound(flops, peaks["bf16"], nbytes, peaks)
            out[timed] = rates(dict(
                max_abs_err=max(errs), ms=time_ms(run), graph_ms=graph_ms(run),
                plain_ms=time_ms(lambda: fa._flash_bwd_plain(
                    q, k, v, o, lse, dout, dlse, sm, causal), iters=3,
                    warmup=1),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=sdpa_ms(q, k, v, dout, True)[2], shape=label),
                flops)
    return out, checks


def fused_bwd_bound(peaks, b, t, h, d, causal, itemsize=2):
    """(flops, bound_ms, bound_by) of one backward: five products per
    visible (q, k) pair (S, dP, dV, dK, dQ); bytes q, k, v, out and dout
    read, lse read, dq, dk and dv written."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 10.0 * b * h * d * pairs
    nbytes = 8 * b * t * h * d * itemsize + b * h * t * 4
    return (flops, *bound(flops, peaks["bf16"], nbytes, peaks))


def sdpa_ms(q, k, v, dout, causal):
    """SDPA on the same inputs, back to back and from CUDA graphs: its
    forward (fwd_ms, fwd_graph_ms) and its backward, forward + backward
    less forward (bwd_ms, bwd_graph_ms). The library yardstick, never
    called by the port."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt, dt = (x.transpose(1, 2).detach().clone()
                      for x in (q, k, v, dout))
    for x in (qt, kt, vt):
        x.requires_grad_(True)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dt)

    fwd_ms, fwd_graph_ms = time_ms(fwd), graph_ms(fwd)
    return (fwd_ms, fwd_graph_ms, time_ms(fwd_bwd) - fwd_ms,
            graph_ms(fwd_bwd) - fwd_graph_ms)


def kernel_flash_bwd_fused(peaks, gen):
    """K2-fused (`_flash_bwd_fused_launch`, the backward of every path at
    T <= 1024) against its twin `_flash_bwd_fused_plain` on the forward
    kernel's own (out, lse): at the training flagship's shape (B11 T1024
    H25 D64 bf16 causal, q/k/v column slices of one qkv tensor: clusters
    of 8 CTAs) and the MoE training shape (B16 T1024 H16 D64), timed;
    then at head dim 128, at a ragged last key block (T 192, 320), at a
    one-CTA cluster (T 64) and in fp16, causal and not, with an lse
    cotangent. Each case launched twice and compared bit for bit. Timed
    back to back (`ms`) and from CUDA graphs (`graph_ms`), beside the
    bound, the twin, K2's sweeps on the same inputs (`sweeps_ms`,
    `sweeps_graph_ms`) and SDPA's backward (`library_ms`,
    `library_graph_ms`)."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    bf16, f16 = torch.bfloat16, torch.float16
    checks, out = [], {}
    cases = (
        # (label, B, T, H, D, dtype, causal, with dlse, timed as)
        ("bf16 causal B11 T1024 H25 D64", 11, 1024, 25, 64, bf16, True,
         False, "training"),
        ("bf16 causal B16 T1024 H16 D64 (MoE training shape)", 16, 1024, 16,
         64, bf16, True, False, "moe_training"),
        ("bf16 non-causal B2 T1024 H4 D128", 2, 1024, 4, 128, bf16, False,
         True, None),
        ("bf16 causal B2 T192 H3 D64 (ragged last key block)", 2, 192, 3,
         64, bf16, True, True, None),
        ("bf16 non-causal B2 T320 H3 D128 (ragged last key block)", 2, 320,
         3, 128, bf16, False, True, None),
        ("bf16 non-causal B4 T64 H3 D64 (one CTA)", 4, 64, 3, 64, bf16,
         False, True, None),
        ("fp16 causal B2 T512 H4 D128", 2, 512, 4, 128, f16, True, True,
         None),
        ("fp16 non-causal B2 T384 H4 D64", 2, 384, 4, 64, f16, False, True,
         None),
    )
    for label, b, t, h, d, dtype, causal, with_dlse, timed in cases:
        c = h * d
        qkv = torch.randn((b, t, 3 * c), generator=gen, device="cuda",
                          dtype=torch.float32).to(dtype)
        q, k, v = (p.view(b, t, h, d) for p in qkv.split(c, dim=-1))
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        lse = lse[..., 0].contiguous()
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
        dlse = torch.randn((b, h, t), generator=gen, device="cuda") \
            if with_dlse else None
        sm = 1.0 / d ** 0.5

        def run():
            return fa._flash_bwd_fused_launch(q, k, v, o, lse, dout, dlse,
                                              sm, causal)

        def sweeps():
            return fa._flash_bwd_launch(q, k, v, o, lse, dout, dlse, sm,
                                        causal)

        got = run()
        torch.cuda.synchronize()
        ref = fa._flash_bwd_fused_plain(q, k, v, o, lse, dout, dlse, sm,
                                        causal)
        tol = GRAD_TOL_BF16 if dtype == bf16 else GRAD_TOL_F16
        errs = [check_rel(f"flash bwd fused d{n}, {label}", x, y, tol,
                          checks) for n, x, y in zip("qkv", got, ref)]
        # every dQ row summed in one fixed order: a second launch repeats
        # the first bit for bit
        again = run()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        checks.append({"check": f"flash bwd fused repeats bit for bit, "
                                f"{label}", "equal": same})
        if not same:
            raise AssertionError(f"K2-fused {label}: a second launch "
                                 "differs")
        del ref, again
        if timed is not None:
            flops, bound_ms, bound_by = fused_bwd_bound(peaks, b, t, h, d,
                                                        causal)
            lib_ms, lib_graph_ms = sdpa_ms(q, k, v, dout, causal)[2:]
            out[timed] = rates(dict(
                max_abs_err=max(errs), ms=time_ms(run), graph_ms=graph_ms(run),
                plain_ms=time_ms(lambda: fa._flash_bwd_fused_plain(
                    q, k, v, o, lse, dout, dlse, sm, causal), iters=3,
                    warmup=1),
                bound_ms=bound_ms, bound_by=bound_by,
                sweeps_ms=time_ms(sweeps), sweeps_graph_ms=graph_ms(sweeps),
                library_ms=lib_ms, library_graph_ms=lib_graph_ms,
                library_call="F.scaled_dot_product_attention fwd+bwd less "
                             "fwd", shape=label), flops)
        del qkv, q, k, v, o, lse, dout, got
        release()
    return out, checks


def kernel_ln_bwd(peaks, gen):
    """K3-bwd at the training flagship's shape (N = 11 x 1024 rows,
    H 1600) and the MoE training shape (N 16,384, H 1024): the block
    form (bf16 rows, sum cotangent) and the ln_f form (fp32 dout, no sum
    cotangent), with gamma in the parameters' dtype (bf16 on both
    training cells), plus an fp32 case; each launched twice and compared
    bit for bit, one launch per call. The timed rows carry the kernel's
    launch plan (`ln_bwd_plan`)."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    checks, out = [], {}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (
        # (label, N, s dtype, dout dtype, with dsum, timed as)
        ("N11264 H1600 bf16 with dsum", 11264, bf16, bf16, True, "training"),
        ("N11264 H1600 ln_f form (fp32 dout, no dsum)", 11264, bf16, f32,
         False, None),
        ("N1024 H1600 fp32 with dsum", 1024, f32, f32, True, None),
        ("N16384 H1024 bf16 with dsum (MoE training shape)", 16384, bf16,
         bf16, True, "moe_training"),
    )
    for label, n, s_dt, d_dt, with_dsum, timed in cases:
        h = 1024 if "H1024" in label else 1600
        s = (2.0 * torch.randn((n, h), generator=gen, device="cuda")) \
            .to(s_dt)
        gamma = (1.0 + 0.1 * torch.randn((h,), generator=gen,
                                         device="cuda")).to(s_dt)
        dout = torch.randn((n, h), generator=gen, device="cuda").to(d_dt)
        dsum = torch.randn((n, h), generator=gen, device="cuda") \
            .to(s_dt) if with_dsum else None

        def run():
            return fo.fused_bias_residual_layernorm_backward(
                s, gamma, dout, dsum, eps=1e-5, dx_dtype=s_dt)

        before = fo.fused_bias_residual_layernorm_backward.launches
        got = run()
        torch.cuda.synchronize()
        if fo.fused_bias_residual_layernorm_backward.launches != before + 1:
            raise AssertionError(f"ln bwd {label}: not one launch")
        ds, dg, db = fo._ln_bwd_math(s, gamma, dout, dsum, 1e-5)
        ref = (ds.to(s_dt), ds.sum(0), dg.sum(0), db.sum(0))
        tol = GRAD_TOL_BF16 if s_dt == bf16 else GRAD_TOL_F32
        errs = [check_rel(f"ln bwd {name}, {label}", x, y,
                          tol if name == "dx" else GRAD_TOL_F32 * 10, checks)
                for name, x, y in zip(("dx", "dbias", "dgamma", "dbeta"),
                                      got, ref)]
        again = run()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"ln bwd {label}: two launches differ")
        if timed:
            # read s, dout, dsum, write dx (bf16), gamma (bf16) and the
            # three sums once; fp32 arithmetic ~22 operations per element
            nbytes = n * h * (2 + 2 + 2 + 2) + h * 2 + 3 * h * 4
            bound_ms, bound_by = bound(22 * n * h, peaks["fp32"], nbytes,
                                       peaks)
            plan = fo.ln_bwd_plan(n, h, fo._sm_count(0))
            out[timed] = rates(dict(
                max_abs_err=errs[0], ms=time_ms(run), graph_ms=graph_ms(run),
                plain_ms=time_ms(lambda: fo._ln_bwd_math(
                    s, gamma, dout, dsum, 1e-5)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=label, plan=plan._asdict()), 22 * n * h)
    return out, checks


def kernel_gelu_bwd(peaks, gen):
    """K4-bwd at the training flagship's shape (N = 11 x 1024 rows,
    W 6400), both GeLU forms, plus an fp32 case; at the MoE training
    shapes, the dense blocks' N 16,384 x W 4096 and the experts' grouped
    form (8 groups of 5,120 rows, dbias [8, 4096]); at the serving and
    decode shapes (N 4096 and 4, W 6400: no path runs K4-bwd there,
    timed to compare with K4-fwd); then the layout's edges."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    checks, out = [], {}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (  # (label, N, W, bias groups or None, dtype, tanh, timed as)
        ("N11264 W6400 bf16 tanh", 11264, 6400, None, bf16, True,
         "training"),
        ("N11264 W6400 bf16 erf", 11264, 6400, None, bf16, False, None),
        ("N1024 W6400 fp32 tanh", 1024, 6400, None, f32, True, None),
        ("N16384 W4096 bf16 tanh (MoE dense blocks)", 16384, 4096, None,
         bf16, True, "moe_training_dense"),
        ("G8 x 5120 x W4096 bf16 tanh, dbias [8, 4096] (MoE experts)",
         8 * 5120, 4096, 8, bf16, True, "moe_training"),
        ("N4096 W6400 bf16 tanh (serving shape)", 4096, 6400, None, bf16,
         True, "serving_shape"),
        ("N4 W6400 bf16 tanh (decode shape)", 4, 6400, None, bf16, True,
         "decode_shape"))
    for label, n, w, groups, dt, approx, timed in cases:
        s = (2.0 * torch.randn((n, w), generator=gen, device="cuda")).to(dt)
        dout = torch.randn((n, w), generator=gen, device="cuda").to(dt)

        def run():
            return fo.fused_bias_gelu_backward(s, dout, approximate=approx,
                                               groups=groups)

        dx, dbias = run()
        torch.cuda.synchronize()
        ref = fo._gelu_bwd_math(s, dout, approx)
        ref_dbias = ref.sum(0) if groups is None else \
            ref.reshape(groups, -1, w).sum(1)
        tol = GRAD_TOL_BF16 if dt == bf16 else GRAD_TOL_F32
        err = check_rel(f"gelu bwd dx, {label}", dx, ref.to(dt), tol, checks)
        check_rel(f"gelu bwd dbias, {label}", dbias, ref_dbias,
                  GRAD_TOL_F32 * 10, checks)
        again = run()
        if not (torch.equal(dx, again[0]) and torch.equal(dbias, again[1])):
            raise AssertionError(f"gelu bwd {label}: two launches differ")
        if timed:
            # read s and dout, write dx (bf16), dbias once; fp32
            # arithmetic of the tanh form: ~18 operations and a tanh
            nbytes = n * w * (2 + 2 + 2) + (groups or 1) * w * 4
            bound_ms, bound_by = bound(19 * n * w, peaks["fp32"], nbytes,
                                       peaks)
            out[timed] = rates(dict(
                max_abs_err=err, ms=time_ms(run),
                graph_ms=graph_ms(run) if n < 64 else None,
                plain_ms=time_ms(lambda: fo._gelu_bwd_math(s, dout, approx)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=label,
                # PyTorch's own GeLU backward at the same shape (no
                # dbias); never called by the port
                yardstick="aten.gelu_backward(dout, s, approximate='tanh'), "
                          "bf16 [N, W]",
                yardstick_ms=time_ms(
                    lambda: torch.ops.aten.gelu_backward(
                        dout, s, approximate="tanh"))), 19 * n * w)
    g2 = torch.Generator(device="cuda")
    g2.manual_seed(K4_SEED)
    edges = (  # (label, N, W, groups, s dtype, dout/dx dtype, offset)
        ("N63 W100 (scalar accesses)", 63, 100, None, bf16, bf16, 0),
        ("N33 W6401 (scalar tail)", 33, 6401, None, bf16, bf16, 0),
        ("N11263 W6400 (odd N)", 11263, 6400, None, bf16, bf16, 0),
        ("N4096 W6400, dout 1 element into its storage", 4096, 6400, None,
         bf16, bf16, 1),
        ("N4096 W6400 bf16 s, fp32 dout and dx", 4096, 6400, None, bf16,
         f32, 0),
        ("G8 x 37 x W4096 (groups cut short)", 8 * 37, 4096, 8, bf16, bf16,
         0),
        ("G8 x 5117 x W4096 fp32", 8 * 5117, 4096, 8, f32, f32, 0))
    for label, n, w, groups, s_dt, d_dt, offset in edges:
        s = k4_rows(n, w, s_dt, 0, g2, scale=2.0)
        dout = k4_rows(n, w, d_dt, offset, g2)
        before = fo.fused_bias_gelu_backward.launches
        got = fo.fused_bias_gelu_backward(s, dout, approximate=True,
                                          dx_dtype=d_dt, groups=groups)
        again = fo.fused_bias_gelu_backward(s, dout, approximate=True,
                                            dx_dtype=d_dt, groups=groups)
        torch.cuda.synchronize()
        ref = fo._gelu_bwd_math(s, dout, True)
        ref_dbias = ref.sum(0) if groups is None else \
            ref.reshape(groups, -1, w).sum(1)
        check_rel(f"gelu bwd dx, {label}", got[0], ref.to(d_dt),
                  GRAD_TOL_BF16 if d_dt == bf16 else GRAD_TOL_F32, checks)
        check_rel(f"gelu bwd dbias, {label}", got[1], ref_dbias,
                  GRAD_TOL_F32 * 10, checks)
        if fo.fused_bias_gelu_backward.launches != before + 2:
            raise AssertionError(f"gelu bwd {label}: not two launches")
        if not (torch.equal(got[0], again[0]) and
                torch.equal(got[1], again[1])):
            raise AssertionError(f"gelu bwd {label}: two launches differ")
    return out, checks


# the MoE training cell (gpt2-350m-moe8): micro batch 16 x seq 1024
# tokens, 8 experts, top-2, capacity factor 1.25, every other layer
MOE_BATCH, MOE_SEQ, MOE_EXPERTS, MOE_TOP_K, MOE_CF = 16, 1024, 8, 2, 1.25
# K8 against its twin: dispatch copies rows (exact); combine adds k
# products in fp32 in the twin's order and rounds once, so it matches to
# the last bit, and the bound is one rounding: one bf16 ulp (at most
# 2^-7 relative) or 1e-6 in fp32
TOL_K8_BF16 = dict(atol=1e-6, rtol=2 ** -7)
TOL_K8_F32 = dict(atol=1e-6, rtol=1e-6)


def moe_routing(gen, n, k, skew):
    """Routing of n tokens over MOE_EXPERTS experts (the port's router on
    random logits; `skew` added to expert 0's logit overfills it, so
    assignments drop), its slot maps, capacity and kept count."""
    import torch
    from deepspeed_tpu_torch.moe import (router_capacity, routing_slots,
                                         top_k_gating_indexed)
    logits = torch.randn((n, MOE_EXPERTS), generator=gen, device="cuda")
    logits[:, 0] += skew
    cap = router_capacity(n, MOE_EXPERTS, k, MOE_CF)
    routing, stats = top_k_gating_indexed(logits, k, cap)
    src, dest = routing_slots(routing, MOE_EXPERTS, cap)
    return routing, stats, src, dest, cap


def kernel_moe(peaks, gen):
    """K8 at the MoE training shape (N 16,384 tokens, E 8, C 5,120, H
    1024), bf16 and fp32, k = 1 and 2, with empty slots and dropped
    assignments: both gathers against their twins. Returns the dispatch
    and combine results (each timed at the bf16 k = 2 case, the path's)."""
    import importlib
    import torch
    fd = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")
    checks, disp, comb = [], {}, {}
    n, h = MOE_BATCH * MOE_SEQ, 1024
    cases = (  # (label, dtype, k, logit skew of expert 0, timed)
        ("bf16 k2 N16384 H1024 E8 C5120", torch.bfloat16, 2, 1.0, True),
        ("fp32 k2 N16384 H1024 E8 C5120", torch.float32, 2, 1.0, False),
        ("bf16 k1 N16384 H1024 E8", torch.bfloat16, 1, 1.0, False),
        ("fp32 k1 N16384 H1024 E8", torch.float32, 1, 1.0, False))
    for label, dtype, k, skew, timed in cases:
        routing, stats, src, dest, cap = moe_routing(gen, n, k, skew)
        ec = MOE_EXPERTS * cap
        occupied = int((src < n).sum())
        kept = int(routing["keep"].sum())
        if not (occupied < ec and kept < n * k):
            raise AssertionError(f"{label}: no empty slot or no drop")
        x = torch.randn((n, h), generator=gen, device="cuda").to(dtype)
        ye = torch.randn((ec, h), generator=gen, device="cuda").to(dtype)
        cw = (routing["keep"] * routing["w"]).float().contiguous()
        xe = fd.gather_rows(x, src)
        y = fd.combine_rows(ye, dest, cw)
        torch.cuda.synchronize()
        exact = torch.equal(xe, fd._gather_rows_plain(x, src))
        checks.append({"check": f"dispatch, {label}", "exact": exact,
                       "occupied_slots": occupied, "slots": ec,
                       "dropped_fraction": float(stats[-2])})
        if not exact:
            raise AssertionError(f"dispatch {label}: differs from the twin")
        tol = TOL_K8_BF16 if dtype == torch.bfloat16 else TOL_K8_F32
        err = check(f"combine, {label}", y,
                    fd._combine_rows_plain(ye, dest, cw), tol, checks)
        if not timed:
            continue
        esize = x.element_size()
        # dispatch: read each occupied slot's token row and the slot map,
        # write every slot row; combine: read the kept assignments' rows,
        # dest and cw, write every token row; no arithmetic to speak of
        d_bound, d_by = bound(0, peaks["bf16"], (occupied + ec) * h * esize
                              + ec * 4, peaks)
        c_bound, c_by = bound(2 * kept * h, peaks["fp32"],
                              (kept + n) * h * esize + n * k * 8, peaks)
        xp = torch.cat([x, x.new_zeros((1, h))])
        srcl = src.long()
        disp = dict(max_abs_err=0.0, ms=time_ms(lambda: fd.gather_rows(x, src)),
                    plain_ms=time_ms(lambda: fd._gather_rows_plain(x, src)),
                    bound_ms=d_bound, bound_by=d_by,
                    library_ms=time_ms(lambda: xp.index_select(0, srcl)),
                    shape=label)
        comb = dict(max_abs_err=err,
                    ms=time_ms(lambda: fd.combine_rows(ye, dest, cw)),
                    plain_ms=time_ms(lambda: fd._combine_rows_plain(
                        ye, dest, cw)),
                    bound_ms=c_bound, bound_by=c_by, library_ms=None,
                    shape=label)
    return {"moe_training": disp}, {"moe_training": comb}, checks


# K6 against its twin: both take exact integer block partials, scale and
# add them in the same order with no fused multiply-add, and round the
# output once, so they agree bit for bit (`exact`, which must hold); the
# bound is one rounding of the output (one bf16 ulp, 2^-7 relative; 1e-6
# relative in fp32)
TOL_K6_BF16 = dict(atol=1e-6, rtol=2 ** -7)
TOL_K6_F32 = dict(atol=1e-6, rtol=1e-6)
QUANT_BLOCK = 128


def _qmm():
    import importlib
    return importlib.import_module(
        "deepspeed_tpu_torch.ops.transformer.quantized_matmul")


def kernel_qmm(peaks, gen):
    """K6 at the shapes of the quantized paths: the flagship's four
    projections (M = 11 x 1024 tokens; K/N 1600/4800, 1600/1600,
    1600/6400, 6400/1600; K = 1600 pads to 13 blocks of 128), the four
    ungrouped projections of gpt2-350m-moe8 (M = 16 x 1024; K/N
    1024/3072, 1024/1024, 1024/4096, 4096/1024: c_attn and c_proj of
    every block, the dense blocks' MLPs) and its experts' two grouped
    projections (G 8, C 5,120; 1024/4096 and 4096/1024), bf16 output,
    each timed; plus fp32 output, a ragged M, the experts' ragged C 77
    and block 256. Operands are quantized as the path quantizes them;
    each result must equal its twin bit for bit. `ms` is the wrapper as
    the path calls it (the per-call weight transpose included, as the
    earlier kernel was timed), `kernel_ms` the launch alone on the
    transposed weights; TOP/s and the share of the bound are the
    kernel's. Yardsticks, never
    called by the port: torch._int_mm on the same padded int8 operands
    (the int8 product without per-block scales) and the bf16 matmul the
    quantized path replaces."""
    import torch
    qm = _qmm()
    checks, out = [], {}
    bf16, f32 = torch.bfloat16, torch.float32
    flag_m = TRAIN_BATCH * TRAIN_SEQ
    moe_m = MOE_BATCH * MOE_SEQ
    cases = (
        # (label, G, M, K, N, out dtype, timed as)
        ("c_attn M11264 K1600 N4800", 1, flag_m, 1600, 4800, bf16,
         "quant_training:c_attn"),
        ("c_proj M11264 K1600 N1600", 1, flag_m, 1600, 1600, bf16,
         "quant_training:c_proj"),
        ("c_fc M11264 K1600 N6400", 1, flag_m, 1600, 6400, bf16,
         "quant_training:c_fc"),
        ("mlp_c_proj M11264 K6400 N1600", 1, flag_m, 6400, 1600, bf16,
         "quant_training:mlp_c_proj"),
        ("c_attn M16384 K1024 N3072", 1, moe_m, 1024, 3072, bf16,
         "moe_quant_training:c_attn"),
        ("c_proj M16384 K1024 N1024", 1, moe_m, 1024, 1024, bf16,
         "moe_quant_training:c_proj"),
        ("c_fc M16384 K1024 N4096", 1, moe_m, 1024, 4096, bf16,
         "moe_quant_training:c_fc"),
        ("mlp_c_proj M16384 K4096 N1024", 1, moe_m, 4096, 1024, bf16,
         "moe_quant_training:mlp_c_proj"),
        ("experts wi G8 C5120 K1024 N4096", MOE_EXPERTS, 5120, 1024, 4096,
         bf16, "moe_quant_training:wi"),
        ("experts wo G8 C5120 K4096 N1024", MOE_EXPERTS, 5120, 4096, 1024,
         bf16, "moe_quant_training:wo"),
        ("c_proj fp32 out", 1, flag_m, 1600, 1600, f32, None),
        ("c_attn ragged M11227 (M % 128 = 91)", 1, flag_m - 37, 1600, 4800,
         bf16, None),
        ("experts G8 ragged C77 K1024 N4096 fp32 out", MOE_EXPERTS, 77, 1024,
         4096, f32, None),
        ("c_fc block 256", 1, flag_m, 1600, 6400, bf16, None),
    )
    for label, g, m, k, n, out_dt, timed in cases:
        block = 256 if "block 256" in label else QUANT_BLOCK
        x = torch.randn((g, m, k), generator=gen, device="cuda").to(bf16)
        w = (0.02 * torch.randn((g, k, n), generator=gen, device="cuda")) \
            .to(bf16)
        wq, sw = qm.quantize_kernel_int8(w, block)
        xq, sx = qm.quantize_rows_int8(x)
        kp = wq.shape[-2]
        xq = torch.nn.functional.pad(xq, (0, kp - k)).contiguous()

        def run():
            return qm._qmm_launch(xq, wq, sx, sw, block, out_dt)

        got = run()
        torch.cuda.synchronize()
        ref = qm._qmm_plain(xq, wq, sx, sw, block, out_dt)
        tol = TOL_K6_BF16 if out_dt == bf16 else TOL_K6_F32
        err = check(f"qmm, {label}", got, ref, tol, checks)
        checks[-1]["exact"] = bool(torch.equal(got, ref))
        if not checks[-1]["exact"]:
            raise AssertionError(f"qmm, {label}: not bit for bit its twin")
        del got, ref
        if not timed:
            continue
        nb = kp // block
        # 2 operations per int8 product; read xq, wq, sx, sw once, write
        # the bf16 output once
        flops = 2.0 * g * m * kp * n
        nbytes = g * (m * kp + kp * n + m * 4 + nb * n * 4 + m * n * 2)
        bound_ms, bound_by = bound(flops, peaks["int8"], nbytes, peaks)
        wqt_t = [wq[i].t().contiguous().t() for i in range(g)]  # [Kp, N]
        try:
            int_mm_ms = time_ms(lambda: [torch._int_mm(xq[i], wqt_t[i])
                                         for i in range(g)])
        except RuntimeError as exc:    # a yardstick only
            int_mm_ms = None
            checks.append({"check": f"torch._int_mm, {label}",
                           "unavailable": str(exc)[:200]})
        xb = x if g > 1 else x[0]
        wb = w if g > 1 else w[0]
        wqt = wq.transpose(1, 2).contiguous()
        swp = torch.nn.functional.pad(sw, (0, -n % 4)).contiguous()
        kernel_ms = time_ms(lambda: qm._qmm_kernel(xq, wqt, sx, swp, block,
                                                   out_dt))
        out[timed] = dict(
            max_abs_err=err, ms=time_ms(run), kernel_ms=kernel_ms,
            tops=flops / kernel_ms / 1e9,
            share_of_bound=bound_ms / kernel_ms,
            plain_ms=time_ms(lambda: qm._qmm_plain(xq, wq, sx, sw, block,
                                                   out_dt),
                             iters=3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=int_mm_ms,
            library_call=("torch._int_mm on the padded int8 operands, no "
                          "per-block scales" + (f", {g} calls" if g > 1
                                                else "")),
            bf16_matmul_ms=time_ms(lambda: torch.matmul(xb, wb)),
            shape=label)
        del x, w, wq, sw, xq, sx, wqt_t, wqt, swp
    from deepspeed_tpu_torch.ops import _build
    ptxas = sm90_ptxas(_build.build_log("quantized_matmul"))
    for row in out.values():
        row["ptxas"] = ptxas
    return out, checks


# ----------------------------------------------------------------------
# phases 4-5: serving and the oracle
# ----------------------------------------------------------------------
def serve_and_check(seed, card, device="cuda", n_layer=None):
    """Phases 4-5. `device` and `n_layer` exist for a rehearsal on the
    CPU at cut depth (the kernels' plain twins run there); the run on
    the card uses the defaults."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference import (InferenceEngine, Request,
                                               ServingLoop)
    from deepspeed_tpu_torch.models.gpt2 import (GPT2ForCausalLM,
                                                 gpt2_config)

    overrides = {} if n_layer is None else {"n_layer": n_layer}
    cfg = gpt2_config("gpt2-1.5b", **overrides)
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg, device=device)
    params = model.init(seed)
    icfg = {"inference": {"max_slots": 4, "prefill_chunk": 128,
                          "sync_every": 8, "max_new_tokens": 32,
                          "kv_cache": {"num_pages": 128, "page_size": 16}}}
    engine = InferenceEngine(cfg, params, icfg, device=device)
    sync(device)
    setup_s = time.perf_counter() - t0

    rng = np.random.RandomState(seed)
    lengths = (100, 167, 233, 300)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    new = 32

    # warm-up (cuBLAS handles, allocator), not counted
    ServingLoop(engine).serve([Request(rid="warm", tokens=prompts[0][:40],
                                       max_new_tokens=4)])
    engine.reset()
    sync(device)
    reset_counts()

    # 4a: continuous batching through the ServingLoop
    t0 = time.perf_counter()
    done = ServingLoop(engine).serve(
        [Request(rid=i, tokens=p, max_new_tokens=new)
         for i, p in enumerate(prompts)])
    sync(device)
    serve_s = time.perf_counter() - t0
    served = {r.rid: r.out_tokens for r in done}
    gen_tokens = sum(len(t) for t in served.values())
    if sorted(served) != [0, 1, 2, 3] or any(
            len(served[i]) != new for i in served):
        raise AssertionError(f"serving returned {served}")
    # per request, by rid: time to first token (all arrive at 0) and the
    # mean gap between its later tokens, both as seen at the fences.
    # A fence comes every sync_every decode steps, so the first one
    # already delivers sync_every tokens (greedy, no EOS here): the
    # gap is the time after it over the tokens that came after it.
    burst = min(icfg["inference"]["sync_every"], new)
    by_rid = sorted(done, key=lambda r: r.rid)
    ttft_ms = [r.first_token_at * 1e3 for r in by_rid]
    gap_ms = [(r.finished_at - r.first_token_at) * 1e3 / (new - burst)
              for r in by_rid]

    # 4b: the same requests stepped one decode at a time
    engine.reset()
    sync(device)
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        engine.start_request(i, p, max_new=new)
    sync(device)
    prefill_s = time.perf_counter() - t0
    step_logits = []
    t0 = time.perf_counter()
    for _ in range(new):
        step_logits.append(engine.decode_once())
    sync(device)
    decode_s = time.perf_counter() - t0
    stepped = engine.fetch_state()["out_tokens"]
    step_logits = torch.stack(step_logits, dim=1)    # [slots, new, vocab]
    profile = profile_steps(lambda: engine.decode_block(8), 8) \
        if device == "cuda" else None
    same_tokens = int(sum(int((stepped[i] == served[i]).sum())
                          for i in range(4)))

    emit({"phase": "serving", "model": "gpt2-1.5b", "n_layer": cfg.n_layer,
          "n_embd": cfg.n_embd, "n_head": cfg.n_head,
          "vocab": cfg.vocab_size, "dtype": "bfloat16 compute, fp32 params",
          "requests": 4, "prompt_tokens": list(lengths),
          "new_tokens_each": new, "setup_s": setup_s,
          "serve_wall_s": serve_s,
          "served_tokens_per_s": gen_tokens / serve_s,
          "ttft_ms": ttft_ms, "token_gap_ms": gap_ms,
          "prefill_ms_total": prefill_s * 1e3,
          "prefill_ms_per_request": prefill_s * 1e3 / 4,
          "prefill_tokens_per_s": sum(n - 1 for n in lengths) / prefill_s,
          "decode_ms_per_step": decode_s * 1e3 / new,
          "decode_tokens_per_s": 4 * new / decode_s,
          "stepped_tokens_equal_served": same_tokens,
          "of": 4 * new, "card": card})
    emit({"phase": "decode_profile", **(profile or {}), "card": card})

    # 5: oracle — teacher-force prompt + generated tokens through the
    # kernel-driven forward; pad to a multiple of 128 so flash is taken
    worst, checked, agree, n_pos = 0.0, 0, 0, 0
    for i, p in enumerate(prompts):
        seq = np.concatenate([p, stepped[i]]).astype(np.int64)
        t = len(p)
        padded = -(-len(seq) // 128) * 128
        ids = np.zeros((1, padded), np.int64)
        ids[0, :len(seq)] = seq
        logits = model.apply(params, ids)[0, t - 1:t - 1 + new].float()
        eng = step_logits[i].float()
        if not bool(torch.isfinite(eng).all()) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"request {i}: non-finite logits")
        worst = max(worst, float((eng - logits).abs().max()))
        top2 = torch.topk(logits, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS
        match = logits.argmax(-1) == eng.argmax(-1)
        checked += int(clear.sum())
        agree += int((match & clear).sum())
        n_pos += new
    sync(device)
    ok = worst <= TOL_LOGITS and agree == checked
    emit({"phase": "oracle", "positions": n_pos,
          "max_abs_logit_diff": worst, "tol": TOL_LOGITS,
          "argmax_checked": checked, "argmax_agree": agree, "ok": ok})
    if not ok:
        raise AssertionError("engine decode logits disagree with the "
                             "kernel-driven forward")


# ----------------------------------------------------------------------
# phases 7-10: training, its oracle, quantized training, its oracle
# ----------------------------------------------------------------------
def flagship_ds_config(micro_batch):
    """bench.py's bench_gpt2_15b ds_config (the JAX package's training
    flagship), with the micro batch as given."""
    return {
        "train_micro_batch_size_per_gpu": micro_batch,
        "gradient_accumulation_steps": 1,
        "steps_per_print": 1000,
        "bf16": {"enabled": True, "master_weights": False},
        "zero_optimization": {"stage": 2},
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 1e-4, "weight_decay": 0.01}},
    }


# the training flagship's shape (bench_gpt2_15b)
TRAIN_BATCH, TRAIN_SEQ = 11, 1024
# the quantized_compute block of the quantized paths
QUANT_BLOCK_CONFIG = {"enabled": True, "mode": "on", "block": QUANT_BLOCK}
# quant_training against the unquantized training phase, step by step
# (same weights, batch and seed): the JAX package's bound on its
# quantized_matmul leg (bench.py:2926-2930)
TOL_QUANT_LOSS = 0.2


def train_config(**overrides):
    import torch
    from deepspeed_tpu_torch.models.gpt2 import gpt2_config
    kw = dict(n_positions=TRAIN_SEQ, dropout=0.0, dtype=torch.bfloat16,
              param_dtype=torch.bfloat16, remat=True, remat_policy=None)
    kw.update(overrides)
    return gpt2_config("gpt2-1.5b", **kw)


def train_and_check(seed, card, warmup=2, steps=6, quantized=False,
                    sequence_parallel=None):
    """Phase 7: the JAX package's training flagship (bench_gpt2_15b:
    gpt2-1.5b, micro batch 11, seq 1024, bf16 without master weights,
    ZeRO-2, AdamW, full-block remat, dropout 0) through initialize ->
    train_batch, on one fixed batch repeated, so the loss must fall.
    With `quantized` (phase `quant_training`) the ds_config carries the
    quantized_compute block, so every projection runs K6. With
    `sequence_parallel` (phase `sp_training`) the model attends through
    ring or Ulysses attention over the default process group. Returns
    the launch counts of its steps and the losses."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM

    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    cfg = train_config(sequence_parallel=sequence_parallel)
    ds_config = flagship_ds_config(batch)
    if quantized:
        ds_config["quantized_compute"] = dict(QUANT_BLOCK_CONFIG)
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg)
    engine, _, _, _ = dst.initialize(model=model,
                                     model_parameters=model.init(seed),
                                     config=ds_config)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, batch, seq)).astype(np.int32)
    staged = engine.stage_batch({"input_ids": ids})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(engine.train_batch(batch=staged))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(engine.train_batch(batch=staged))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    loss_vals = [float(x) for x in torch.stack(losses).float().cpu()]
    profile = profile_steps(
        lambda: [engine.train_batch(batch=staged) for _ in range(2)], 2)
    ok = all(np.isfinite(loss_vals)) and loss_vals[-1] < loss_vals[0]
    phase = "quant_training" if quantized else \
        "sp_training" if sequence_parallel else "training"
    emit({"phase": phase, "model": "gpt2-1.5b", "n_layer": cfg.n_layer,
          "n_embd": cfg.n_embd, "n_head": cfg.n_head,
          "vocab": cfg.vocab_size, "micro_batch": batch, "seq": seq,
          "dtype": "bf16 params and moments (master_weights false), "
                   "stochastic rounding",
          "zero_stage": 2, "remat": "full block",
          "sequence_parallel": sequence_parallel,
          "quantized_compute": ds_config.get("quantized_compute"),
          "quantized_projections": type(
              engine.module.module.h[0].c_fc).__name__,
          "setup_s": setup_s,
          "warmup_steps": warmup, "warmup_s": warm_s, "steps": steps,
          "step_ms": step_s * 1e3,
          "tokens_per_s": batch * seq / step_s,
          "max_memory_allocated_gib": peak / 2 ** 30,
          "losses": loss_vals, "loss_falls": ok,
          "launches_per_step": {k: v / (warmup + steps)
                                for k, v in counts.items()},
          "card": card})
    emit({"phase": phase + "_profile", "step_ms": step_s * 1e3, **profile,
          "card": card})
    if not ok:
        raise AssertionError(f"{phase} losses {loss_vals}: not finite or "
                             "not falling on the repeated batch")
    # one K2-fused launch per layer a step (the full-block recompute runs
    # the forward only); the ring's count is checked in main
    fused = counts["flash_attention_bwd_fused"] / (warmup + steps)
    if not sequence_parallel and fused != cfg.n_layer:
        raise AssertionError(f"{phase}: {fused} K2-fused launches a step, "
                             f"expected {cfg.n_layer}")
    del engine, model, staged
    return counts, loss_vals


def training_oracle(seed, n_layer=2):
    """Phase 8: one gpt2-1.5b-wide model, `n_layer` layers, bf16, at
    the flagship's micro batch and sequence, the same weights and batch
    through two routes: the kernels (fused ops and flash: K1-K4 forward
    and backward, under remat) and plain torch (fused_ops "off", dense
    attention). The loss and every gradient must agree within
    TOL_TRAIN_LOSS / TOL_TRAIN_GRAD (relative L2)."""
    import dataclasses
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM

    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    cfg = train_config(n_layer=n_layer)
    kernel = GPT2ForCausalLM(cfg)
    params = kernel.init(seed)
    plain = GPT2ForCausalLM(dataclasses.replace(
        cfg, fused_ops="off", attention_impl="xla"))
    ids = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (batch, seq)), device="cuda")
    reset_counts()
    results = []
    for model in (kernel, plain):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = model.loss_fn(p, {"input_ids": ids}, deterministic=True)
        grads = torch.autograd.grad(loss, list(p.values()))
        results.append((float(loss.detach()), grads))
        if model is kernel:
            launched = read_counts()
    torch.cuda.synchronize()
    (lk, gk), (lp, gp) = results
    loss_err = abs(lk - lp) / abs(lp)
    errs = {name: rel_l2(a, b) for name, a, b in zip(params, gk, gp)}
    worst = max(errs, key=errs.get)
    finite = all(torch_isfinite(g) for g in gk)
    # the kernel route must have run every kernel
    ok = finite and loss_err <= TOL_TRAIN_LOSS and \
        errs[worst] <= TOL_TRAIN_GRAD and \
        all(launched[k] > 0 for k in TRAINING_KERNELS)
    emit({"phase": "training_oracle", "n_layer": n_layer, "batch": batch,
          "seq": seq, "loss_kernels": lk, "loss_plain": lp,
          "loss_rel_err": loss_err, "tol_loss": TOL_TRAIN_LOSS,
          "grads": len(errs), "worst_grad": worst,
          "worst_grad_rel_l2": errs[worst],
          "median_grad_rel_l2": float(np.median(list(errs.values()))),
          "tol_grad_rel_l2": TOL_TRAIN_GRAD,
          "kernel_route_launches": launched, "ok": ok})
    if not ok:
        raise AssertionError("kernel-route loss/gradients disagree with "
                             "the plain-torch route")


def quant_oracle(seed, n_layer=2):
    """Phase 10: quantized compute at gpt2-1.5b width, `n_layer` layers,
    bf16, micro batch 11, seq 1024: the kernel route (K6 and K1-K4, under
    remat) against the plain route (fused_ops "off", dense attention and
    K6's twin for every quantized product). int8 rounding is
    discontinuous: the routes' bf16 roundings differ upstream, so some
    activations land on the neighbouring int8 value. The phase counts,
    at each projection of the forward, the activation entries whose int8
    value differs between the routes, then holds the loss within
    TOL_TRAIN_LOSS and every gradient within TOL_TRAIN_GRAD relative L2,
    as training_oracle does."""
    import dataclasses
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    qm = _qmm()

    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    cfg = train_config(n_layer=n_layer, quantized_compute="on",
                       quant_block=QUANT_BLOCK)
    kernel = GPT2ForCausalLM(cfg)
    params = kernel.init(seed)
    plain = GPT2ForCausalLM(dataclasses.replace(
        cfg, fused_ops="off", attention_impl="xla"))
    ids = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (batch, seq)), device="cuda")
    n_proj = 4 * n_layer
    quantize_rows, qmm = qm.quantize_rows_int8, qm._qmm

    def run(model, recorded):
        def recording(x, gen=None, values_dtype=torch.int8):
            q, s = quantize_rows(x, gen, values_dtype)
            if len(recorded) < n_proj:      # the forward's, not remat's
                recorded.append(q)
            return q, s
        qm.quantize_rows_int8 = recording
        try:
            p = {k: v.clone().requires_grad_(True)
                 for k, v in params.items()}
            loss = model.loss_fn(p, {"input_ids": ids}, deterministic=True)
            grads = torch.autograd.grad(loss, list(p.values()))
        finally:
            qm.quantize_rows_int8 = quantize_rows
        return float(loss.detach()), grads

    reset_counts()
    q_kernel, q_plain = [], []
    lk, gk = run(kernel, q_kernel)
    launched = read_counts()
    qm._qmm = qm._qmm_plain          # the plain route: K6's twin
    try:
        lp, gp = run(plain, q_plain)
    finally:
        qm._qmm = qmm
    torch.cuda.synchronize()
    names = ("c_attn", "c_proj", "c_fc", "mlp_c_proj")
    flips = {f"h.{i // 4}.{names[i % 4]}": int((a != b).sum())
             for i, (a, b) in enumerate(zip(q_kernel, q_plain))}
    entries = {f"h.{i // 4}.{names[i % 4]}": a.numel()
               for i, a in enumerate(q_kernel)}
    del q_kernel, q_plain
    loss_err = abs(lk - lp) / abs(lp)
    errs = {name: rel_l2(a, b) for name, a, b in zip(params, gk, gp)}
    worst = max(errs, key=errs.get)
    finite = all(torch_isfinite(g) for g in gk)
    missing = [k for k in QUANT_KERNELS if launched[k] <= 0]
    ok = finite and loss_err <= TOL_TRAIN_LOSS and \
        errs[worst] <= TOL_TRAIN_GRAD and not missing
    emit({"phase": "quant_oracle", "n_layer": n_layer, "batch": batch,
          "seq": seq, "int8_activation_entries_differing": flips,
          "int8_activation_entries": entries,
          "loss_kernels": lk, "loss_plain": lp,
          "loss_rel_err": loss_err, "tol_loss": TOL_TRAIN_LOSS,
          "grads": len(errs), "worst_grad": worst,
          "worst_grad_rel_l2": errs[worst],
          "median_grad_rel_l2": float(np.median(list(errs.values()))),
          "tol_grad_rel_l2": TOL_TRAIN_GRAD,
          "kernel_route_launches": launched, "ok": ok})
    if not ok:
        raise AssertionError("quantized kernel-route loss/gradients disagree "
                             f"with the plain route (missing: {missing})")


# ----------------------------------------------------------------------
# phase 21: checkpoints on the training flagship
# ----------------------------------------------------------------------
# steps before the saves, then a window without a save and a window
# with the async save's writer running, of as many steps each; the
# resumed engine takes the save window's steps again
CKPT_STEPS_BEFORE, CKPT_STEPS_WINDOW = 2, 4
# the flagship's depth in this phase (its width always 1600): cut from
# 48 to 16 layers to keep the whole run, with the fp16 phases, within
# half its time limit (the save, load and resume paths are the same at
# any depth; the bytes scale with it)
CKPT_N_LAYER = 16


def _rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _same_bits(a, b):
    """Tensors equal in dtype, shape and every byte."""
    import torch
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _loaded_leaves_match(engine, flat):
    """(leaves compared, keys that differ): every tensor the engine
    loads (its checkpoint trees of the live state) against the file's
    entry, byte for byte, a stacked entry layer by layer."""
    from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io
    module, opt_state = engine._ckpt_trees(
        list(engine.params.values()), engine.state.opt_state, None,
        engine._remat())
    compared, bad = 0, []
    for key, dest in ckpt_io.tree_to_entries(module, "module") + \
            ckpt_io.tree_to_entries(opt_state, "optim"):
        if isinstance(dest, ckpt_io.Stacked):
            same = len(dest) == flat[key].shape[0] and all(
                _same_bits(d, s) for d, s in zip(dest, flat[key]))
        elif hasattr(dest, "is_cuda"):
            same = _same_bits(dest, flat[key])
        else:
            continue
        compared += 1
        if not same:
            bad.append(key)
    return compared, bad


def checkpoint_and_check(seed, card, n_layer=CKPT_N_LAYER):
    """Phase 21: the training flagship (phase 7's config) saves, resumes
    and continues. Engine A takes CKPT_STEPS_BEFORE steps, then a window
    of CKPT_STEPS_WINDOW steps without a save; a sync save and an async
    save of the same state; then as many steps while the async writer
    copies on its side stream and serializes, then the barrier. Engine
    B, fresh from other weights, loads `latest` and takes the save
    window's steps on the same batches. Gates: the async call returns
    before its commit; `latest` names its tag and no staging dir is
    left; the sync and async directories are byte-identical; every
    leaf B loaded equals the file's bytes; B's losses equal A's bit for
    bit; every training kernel launched. Printed: bytes written, the
    calls' blocked ms, the windows' ms and the stall, the writer's
    device-to-host fetch and commit ms, load ms, peak device memory and
    host RSS during each save. Returns the launch counts of the phase's
    steps (zeroed right before A's first)."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io

    k, m = CKPT_STEPS_BEFORE, CKPT_STEPS_WINDOW
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    cfg = train_config(n_layer=n_layer)
    ds_config = flagship_ds_config(batch)

    def engine(s):
        model = GPT2ForCausalLM(cfg)
        return dst.initialize(model=model, model_parameters=model.init(s),
                              config=ds_config)[0]

    a = engine(seed)
    state = list(a.params.values()) + a.state.opt_state.mu + \
        a.state.opt_state.nu
    state_bytes = sum(t.numel() * t.element_size() for t in state)
    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    free = shutil.disk_usage(parent).free
    # the sync and the async save of one state lie side by side
    need = int(2.1 * state_bytes) + (1 << 30)
    if free < need:
        raise RuntimeError(f"checkpoint phase: {free} bytes free under "
                           f"{parent}, {need} needed")
    ids = np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_size, (k + 2 * m, 1, batch, seq)).astype(np.int32)
    staged = [a.stage_batch({"input_ids": x}) for x in ids]
    root = tempfile.mkdtemp(prefix="checkpoint_", dir=parent)
    marks = {"fetch_ms": []}
    fetch, write = a._fetch, a._write_checkpoint

    def timed_fetch(*args, **kwargs):
        t = time.perf_counter()
        out = fetch(*args, **kwargs)
        marks["fetch_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    def timed_write(*args, **kwargs):
        write(*args, **kwargs)
        marks["committed"] = time.perf_counter()

    a._fetch, a._write_checkpoint = timed_fetch, timed_write
    try:
        reset_counts()
        for b in staged[:k]:
            a.train_batch(batch=b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in staged[k:k + m]:
            a.train_batch(batch=b)
        torch.cuda.synchronize()
        quiet_ms = (time.perf_counter() - t0) * 1e3
        # host RSS sampled every 20 ms from before the sync save to the
        # async save's commit (the pinned buffers the sync save takes
        # are cached, and the async save reuses them)
        before = _rss_bytes()
        rss = {"before": before, "sync": before, "async": before}
        window = ["sync"]
        stop = threading.Event()

        def sample():
            while not stop.wait(0.02):
                rss[window[0]] = max(rss[window[0]], _rss_bytes())

        sampler = threading.Thread(target=sample)
        sampler.start()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        a.save_checkpoint(root, tag="sync", async_save=False,
                          save_latest=False)
        sync_ms = (time.perf_counter() - t0) * 1e3
        peak_device_sync = torch.cuda.max_memory_allocated()
        rss["async"] = _rss_bytes()
        window[0] = "async"
        torch.cuda.reset_peak_memory_stats()
        tag = "async"
        t0 = time.perf_counter()
        accepted = a.save_checkpoint(root, tag=tag)
        async_ms = (time.perf_counter() - t0) * 1e3
        before_commit = a._ckpt_writer.pending() == 1 and \
            ckpt_io.read_latest_tag(root) is None and \
            not os.path.exists(os.path.join(root, tag))
        losses_a = []
        t1 = time.perf_counter()
        for b in staged[k + m:]:
            losses_a.append(a.train_batch(batch=b))
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t1) * 1e3
        a.wait_for_checkpoint()
        waited_ms = (time.perf_counter() - t1) * 1e3 - window_ms
        stop.set()
        sampler.join()
        peak_device = torch.cuda.max_memory_allocated()
        commit_ms = (marks["committed"] - t0) * 1e3
        latest_ok = ckpt_io.read_latest_tag(root) == tag and not any(
            ckpt_io.is_staging_name(n) for n in os.listdir(root))
        tag_dir = os.path.join(root, tag)
        files = {n: os.path.getsize(os.path.join(tag_dir, n))
                 for n in sorted(os.listdir(tag_dir))}
        identical = ckpt_io.checkpoint_dirs_bit_identical(
            os.path.join(root, "sync"), tag_dir)
        shutil.rmtree(os.path.join(root, "sync"))
        losses_a = [float(x) for x in torch.stack(losses_a).cpu()]
        steps_a = a.global_steps
        del a, state
        release()

        b = engine(seed + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path, client = b.load_checkpoint(root)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        flat = ckpt_io.load_checkpoint_flat(root, tag)[0]
        compared, differ = _loaded_leaves_match(b, flat)
        del flat
        losses_b = [float(x) for x in torch.stack(
            [b.train_batch(batch=x) for x in staged[k + m:]]).cpu()]
        counts = read_counts()
        resumed_steps = b.global_steps
        del b
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = {"async_accepted": accepted,
          "async_returned_before_commit": before_commit,
          "latest_names_tag_no_staging_left": latest_ok,
          "sync_and_async_dirs_identical": identical,
          "loaded_leaves_equal_file": compared > 0 and not differ,
          "resumed_losses_bit_equal": losses_b == losses_a,
          "resumed_global_steps": resumed_steps == steps_a}
    emit({"phase": "checkpoint", "model": "gpt2-1.5b", "n_layer": n_layer,
          "n_embd": cfg.n_embd, "micro_batch": batch, "seq": seq,
          "dtype": "bf16 params and moments (master_weights false)",
          "zero_stage": 2, "steps_before": k, "window_steps": m,
          "state_bytes": state_bytes, "bytes_written": sum(files.values()),
          "files": files,
          "sync_save_blocked_ms": sync_ms,
          "async_save_blocked_ms": async_ms,
          "writer_fetch_ms": {"sync": marks["fetch_ms"][0],
                              "async": marks["fetch_ms"][1]},
          "commit_ms": commit_ms,
          "no_save_window_ms": quiet_ms, "save_window_ms": window_ms,
          "stall_ms": window_ms - quiet_ms,
          "stall_share": window_ms / quiet_ms - 1.0,
          "wait_after_window_ms": waited_ms,
          "load_ms": load_ms, "loaded_path": os.path.basename(path),
          "client_state": client,
          "leaves_compared": compared, "leaves_differing": differ[:10],
          "peak_device_memory_gib": {"sync_save": peak_device_sync / 2 ** 30,
                                     "async_save_and_window":
                                         peak_device / 2 ** 30},
          "host_rss_gib": {k: v / 2 ** 30 for k, v in rss.items()},
          "losses_a": losses_a, "losses_resumed": losses_b,
          "disk_free_gib": free / 2 ** 30, "gates": ok, "card": card})
    failed = [name for name, good in ok.items() if not good]
    if failed:
        raise AssertionError(f"checkpoint phase gates failed: {failed}")
    return counts


# ----------------------------------------------------------------------
# phases 11-13: MoE training, its oracle, quantized MoE training
# ----------------------------------------------------------------------
def moe_ds_config():
    """bench.py's bench_gpt2_350m ds_config (micro batch 16, bf16 with
    fp32 master weights, ZeRO-0, AdamW) with the `moe` block of
    bench_moe_vs_dense (8 experts, top-2, capacity factor 1.25, every
    other layer)."""
    return {
        "train_micro_batch_size_per_gpu": MOE_BATCH,
        "gradient_accumulation_steps": 1,
        "steps_per_print": 1000,
        "bf16": {"enabled": True},
        "zero_optimization": {"stage": 0},
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 1e-4, "weight_decay": 0.01}},
        "moe": {"enabled": True, "num_experts": MOE_EXPERTS,
                "top_k": MOE_TOP_K, "capacity_factor": MOE_CF,
                "every_n_layers": 2},
    }


def moe_config(quantized_experts="off", **overrides):
    """gpt2-350m (24 layers, n_embd 1024, 16 heads) with MoEConfig's
    defaults every other layer, bf16, full-block remat, dropout 0."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import gpt2_config
    from deepspeed_tpu_torch.moe import MoEConfig
    moe = MoEConfig(num_experts=MOE_EXPERTS, top_k=MOE_TOP_K,
                    capacity_factor=MOE_CF, every_n_layers=2,
                    quantized_experts=quantized_experts,
                    quant_block=QUANT_BLOCK).validate()
    return gpt2_config("gpt2-350m", n_positions=MOE_SEQ, dropout=0.0,
                       dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                       remat=True, remat_policy=None, moe=moe, **overrides)


def moe_train_and_check(seed, card, warmup=2, steps=6, quantized=False):
    """Phase 11: gpt2-350m-moe8 through initialize (with the moe block)
    -> train_batch on one fixed batch repeated: step ms, tokens/s, peak
    memory, losses (finite, falling), the router's drop fraction and
    per-expert load at every step (the stats of the loss the engine
    differentiates, kept as device tensors until the end), launches per
    step, a profile. With `quantized` (phase `moe_quant_training`) the
    model's experts are quantized (MoEConfig(quantized_experts="on")) and
    the ds_config carries the quantized_compute block, so every
    projection runs K6. Returns the launch counts of its steps."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.moe import STAT_DROP, router_capacity

    cfg = moe_config(quantized_experts="on" if quantized else "off")
    ds_config = moe_ds_config()
    if quantized:
        ds_config["quantized_compute"] = dict(QUANT_BLOCK_CONFIG)
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg)
    params = model.init(seed)
    n_params = sum(p.numel() for p in params.values())
    router_stats = []
    loss_fn = model.loss_fn

    def recording_loss_fn(p, batch, rngs=None, deterministic=False):
        loss, stats = loss_fn(p, batch, rngs=rngs,
                              deterministic=deterministic,
                              return_router_stats=True)
        router_stats.append(stats.detach())
        return loss

    model.loss_fn = recording_loss_fn
    engine, _, _, _ = dst.initialize(model=model, model_parameters=params,
                                     config=ds_config)
    del params
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, MOE_BATCH, MOE_SEQ)).astype(np.int32)
    staged = engine.stage_batch({"input_ids": ids})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(engine.train_batch(batch=staged))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(engine.train_batch(batch=staged))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    loss_vals = [float(x) for x in torch.stack(losses).float().cpu()]
    stats = torch.stack(router_stats).float().cpu()
    profile = profile_steps(
        lambda: [engine.train_batch(batch=staged) for _ in range(2)], 2)
    ok = all(np.isfinite(loss_vals)) and loss_vals[-1] < loss_vals[0]
    tokens = MOE_BATCH * MOE_SEQ
    phase = "moe_quant_training" if quantized else "moe_training"
    emit({"phase": phase, "model": "gpt2-350m-moe8",
          "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
          "n_head": cfg.n_head, "vocab": cfg.vocab_size,
          "moe": {"num_experts": MOE_EXPERTS, "top_k": MOE_TOP_K,
                  "capacity_factor": MOE_CF, "every_n_layers": 2,
                  "moe_layers": cfg.moe_cells,
                  "quantized_experts": cfg.moe.quantized_experts,
                  "capacity": router_capacity(tokens, MOE_EXPERTS,
                                              MOE_TOP_K, MOE_CF)},
          "quantized_compute": ds_config.get("quantized_compute"),
          "params": n_params, "micro_batch": MOE_BATCH, "seq": MOE_SEQ,
          "dtype": "bf16 compute and params, fp32 master weights and "
                   "moments",
          "zero_stage": 0, "remat": "full block", "setup_s": setup_s,
          "warmup_steps": warmup, "warmup_s": warm_s, "steps": steps,
          "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": peak / 2 ** 30,
          "losses": loss_vals, "loss_falls": ok,
          "router_drop_fraction": [float(r[STAT_DROP]) for r in stats],
          "router_load": [[round(float(v), 5) for v in r[:MOE_EXPERTS]]
                          for r in stats],
          "launches_per_step": {k: v / (warmup + steps)
                                for k, v in counts.items()},
          "card": card})
    emit({"phase": phase + "_profile", "step_ms": step_s * 1e3, **profile,
          "card": card})
    if not ok:
        raise AssertionError(f"{phase} losses {loss_vals}: not finite "
                             "or not falling on the repeated batch")
    fused = counts["flash_attention_bwd_fused"] / (warmup + steps)
    if fused != cfg.n_layer:
        raise AssertionError(f"{phase}: {fused} K2-fused launches a step, "
                             f"expected {cfg.n_layer}")
    del engine, model, staged
    return counts


def moe_oracle(seed, n_layer=4):
    """Phase 12: gpt2-350m-moe8 at full width, `n_layer` layers (two MoE
    layers), bf16, micro batch 16, seq 1024, one set of weights and one
    batch through two routes: the kernels (K8 dispatch/combine, grouped
    K4, flash, the fused epilogues) and plain torch (the one-hot einsum
    pair, fused_ops "off", dense attention). Routing is discontinuous:
    one bf16 ulp upstream can send a token to another expert. So the
    phase reports how many (token, choice) assignments the plain route
    chooses differently on its own, then runs the plain route again with
    the kernel route's choices forced (`MoEMLP.route_override`; the gate
    values still come from its own router), and holds the loss within
    TOL_TRAIN_LOSS and every gradient within TOL_TRAIN_GRAD relative L2
    of the kernel route: the same bf16 roundings as `training_oracle`,
    plus the einsum route's bf16 combine weights (one more rounding)."""
    import dataclasses
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.moe import MoEMLP

    cfg = moe_config(n_layer=n_layer)
    kernel = GPT2ForCausalLM(cfg)
    params = kernel.init(seed)
    plain = GPT2ForCausalLM(dataclasses.replace(
        cfg, fused_ops="off", attention_impl="xla",
        moe=dataclasses.replace(cfg.moe, fused_dispatch="off")))
    ids = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ)), device="cuda")

    def mlps(model):
        return [m for m in model.module.modules() if isinstance(m, MoEMLP)]

    def loss_and_grads(model):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = model.loss_fn(p, {"input_ids": ids}, deterministic=True)
        return float(loss.detach()), torch.autograd.grad(loss,
                                                         list(p.values()))

    reset_counts()
    lk, gk = loss_and_grads(kernel)
    launched = read_counts()
    chosen = [m.last_expert_idx for m in mlps(kernel)]
    with torch.no_grad():
        plain.loss_fn(params, {"input_ids": ids}, deterministic=True)
    own = [m.last_expert_idx for m in mlps(plain)]
    differ = [int((a != b).sum()) for a, b in zip(chosen, own)]
    for m, c in zip(mlps(plain), chosen):
        m.route_override = c
    lp, gp = loss_and_grads(plain)
    torch.cuda.synchronize()
    loss_err = abs(lk - lp) / abs(lp)
    errs = {name: rel_l2(a, b) for name, a, b in zip(params, gk, gp)}
    worst = max(errs, key=errs.get)
    finite = all(torch_isfinite(g) for g in gk)
    missing = [k for k in MOE_KERNELS if launched[k] <= 0]
    ok = finite and loss_err <= TOL_TRAIN_LOSS and \
        errs[worst] <= TOL_TRAIN_GRAD and not missing
    emit({"phase": "moe_oracle", "n_layer": n_layer,
          "moe_layers": cfg.moe_cells, "batch": MOE_BATCH, "seq": MOE_SEQ,
          "assignments_per_layer": MOE_BATCH * MOE_SEQ * MOE_TOP_K,
          "assignments_chosen_differently_by_plain_route": differ,
          "loss_kernels": lk, "loss_plain_same_routing": lp,
          "loss_rel_err": loss_err, "tol_loss": TOL_TRAIN_LOSS,
          "grads": len(errs), "worst_grad": worst,
          "worst_grad_rel_l2": errs[worst],
          "median_grad_rel_l2": float(np.median(list(errs.values()))),
          "tol_grad_rel_l2": TOL_TRAIN_GRAD,
          "kernel_route_launches": launched, "ok": ok})
    if not ok:
        raise AssertionError("MoE kernel-route loss/gradients disagree with "
                             f"the plain-torch route (missing: {missing})")


# ----------------------------------------------------------------------
# block-sparse attention (K7): kernels, the bench leg's path, BERT, oracle
# ----------------------------------------------------------------------
SPARSE_H, SPARSE_D, SPARSE_BLOCK = 16, 64, 256
# bench.py's sparse_attention_16k leg: (pattern, batch, seq) at H16 D64
# bf16, block 256, causal; BigBird is the table kernel's layout
SPARSE_PATH = (("bslongformer", 1, 16384), ("fixed", 1, 16384),
               ("bigbird", 1, 16384), ("bslongformer", 2, 32768),
               ("fixed", 2, 32768))
# the oracle: kernel route against the dense masked fallback at T 4096.
# fp32: both routes compute exact fp32 products (the kernel on the CUDA
# cores), summed in another order: reduction roundoff. bf16: the
# fallback rounds its score product to bf16 (as the JAX einsum does) and
# the kernel rounds p before P.V, each ~2^-9 relative, so outputs and
# gradients differ by ~0.5% and stay under 3% relative L2.
SPARSE_ORACLE_T = 4096
TOL_SPARSE_ORACLE = {"float32": 1e-5, "bfloat16": 3e-2}


def _sparse():
    import importlib
    return importlib.import_module(
        "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")


def sparse_config(pattern, h=SPARSE_H, block=SPARSE_BLOCK):
    """The bench leg's SparsityConfigs (bench.py:415-422) and BigBird
    (random 1, window 3, global 1), by name."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    if pattern == "bslongformer":
        return sa.BSLongformerSparsityConfig(num_heads=h, block=block,
                                             num_sliding_window_blocks=4)
    if pattern == "fixed":
        return sa.FixedSparsityConfig(num_heads=h, block=block,
                                      num_local_blocks=4, num_global_blocks=1)
    return sa.BigBirdSparsityConfig(num_heads=h, block=block,
                                    num_random_blocks=1,
                                    num_sliding_window_blocks=3,
                                    num_global_blocks=1)


def visible_scores(layout, block, causal):
    """Visible (query, key) pairs summed over heads: the work a
    block-sparse kernel must do (causal: only keys at or before the
    query)."""
    import numpy as np
    lay = np.asarray(layout) != 0
    if not causal:
        return int(lay.sum()) * block * block
    diag = np.einsum("hii->", lay.astype(np.int64))
    below = int(np.tril(lay, -1).sum())
    return below * block * block + int(diag) * block * (block + 1) // 2


def walk_stats(plan, square, name, b):
    """The backward walk of `plan` (a square plan's transpose (dkv) or
    forward (dq) table, or the Hopper pair's tables of the same name)
    beside the visible 64 x 64 tile pairs it serves: CTAs, steps per CTA
    (mean and most) and the share of a step's 64-row halves that see the
    step's tile (the rest wait on a load they skip)."""
    import numpy as np
    hm = square.head_map
    pairs = b * int((square.qcnt if name == "dkv" else square.kcnt)[hm].sum())
    if plan is square:
        count, halves = (square.qcnt if name == "dkv" else square.kcnt), 1
    else:
        count, halves = plan.pairs[name][1], 2
    steps = b * int(count[hm].sum())
    ctas = b * count[hm].size
    return {"walk": {"ctas": ctas, "steps": steps,
                     "steps_per_cta_mean": steps / ctas,
                     "steps_per_cta_max": int(np.max(count)),
                     "visible_tile_pairs": pairs,
                     "halves_seeing_their_step": pairs / (halves * steps)
                     if steps else None}}


def kernel_sparse(peaks, gen):
    """K7 at the bench leg's shape ([1, 16384, 16, 64] bf16, block 256,
    causal): K7-band under BSLongformer (w 4, sliding) and Fixed (l 4,
    g 1, aligned) on the Hopper body (and, as the earlier kernel, on the
    WMMA body), K7-fwd under BigBird, K7-dkv and K7-dq under all three on
    the Hopper sweeps (and, as the earlier kernels, on the WMMA bodies),
    each against its twin, timed beside its bound (the visible scores
    only), its twin, SDPA with the expanded boolean layout mask (the
    library yardstick, never called by the port) and the dense K1/K2 at
    the same shape; the fp16 forms (the Hopper kernels on __half) the
    same way at that shape under BSLongformer and BigBird, and checked
    under Fixed; then checks, untimed, at the paths' other shapes
    (BSLongformer and Fixed at [2, 32768]; BERT's default Fixed, block
    128, bidirectional, at [1, 16384], bf16 and fp16), at block 32 (T
    2048, fp32 on the WMMA bodies and bf16 on the Hopper ones,
    non-causal), on per-head layouts, and on the Hopper bodies at every
    block and head dim they take (`band_layouts`, `table_layouts`; fp16
    at blocks 16, 64 and 256). Returns {kernel: {case: numbers}} and the
    checks."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    bsa = _sparse()
    checks = []
    res = {"block_sparse_fwd_sm90": {}, "block_sparse_fwd": {},
           "block_sparse_band_fwd_sm90": {},
           "block_sparse_band_fwd": {}, "block_sparse_bwd_dkv_sm90": {},
           "block_sparse_bwd_dq_sm90": {}, "block_sparse_bwd_dkv": {},
           "block_sparse_bwd_dq": {}}
    # the fp16 forms: the Hopper kernels on __half (rows "<name>_fp16")
    res.update({k: {} for k, base in FP16_KERNELS.items()
                if base.startswith("block_sparse")})
    ptxas = sm90_ptxas(_build.build_log("block_sparse_attention"))

    def backward(q, k, v, out, lse, dout, plan, sm, label, gtol, hopper):
        """K7-dkv and K7-dq (on the Hopper sweeps or the WMMA bodies)
        against the twin on `plan`: (names, launchers, delta, max errors
        of dK/dV and dQ)."""
        if hopper:
            sfx = "_fp16" if q.dtype == torch.float16 else ""
            names = ("block_sparse_bwd_dkv_sm90" + sfx,
                     "block_sparse_bwd_dq_sm90" + sfx)
            launches = (bsa._bs_bwd_dkv_sm90_launch,
                        bsa._bs_bwd_dq_sm90_launch)
        else:
            names = ("block_sparse_bwd_dkv", "block_sparse_bwd_dq")
            launches = (bsa._bs_bwd_dkv_launch, bsa._bs_bwd_dq_launch)
        dk, dv, delta = launches[0](q, k, v, out, lse, dout, plan, sm)
        dq = launches[1](q, k, v, out, lse, dout, delta, plan, sm)
        torch.cuda.synchronize()
        ref_dq, ref_dk, ref_dv = bsa._bs_bwd_plain(q, k, v, out, lse, dout,
                                                   plan, sm)
        err_dkv = max(check_rel(f"{names[0]} d{n}, {label}", x, y, gtol,
                                checks)
                      for n, x, y in (("k", dk, ref_dk), ("v", dv, ref_dv)))
        err_dq = check_rel(f"{names[1]} dq, {label}", dq, ref_dq, gtol,
                           checks)
        return names, launches, delta, err_dkv, err_dq

    def one(label, layout, block, causal, dtype, b, t, h, d, timed):
        qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda",
                          dtype=torch.float32).to(dtype)
        q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
        plan = bsa._plan(layout, causal, block, bsa.TILE, q.device)
        sm = d ** -0.5
        tiles = bsa._hopper_tiles(dtype, d, bsa.TILE)
        # the route's plan: the Hopper pair's for bf16 and fp16 at head
        # dims 64 and 128 (every kernel on its Hopper body), else the
        # square one
        pair = bsa._plan(layout, causal, block, tiles, q.device)
        hopper = pair is not plan
        half = dtype == torch.float16
        # (name, launcher, twin) of the forward on the WMMA body (the
        # earlier kernel at bf16) and on the route's
        if plan.band is None:
            wmma = ("block_sparse_fwd", bsa._bs_fwd_launch,
                    bsa._bs_fwd_plain)
            fwd_name, launch, plain = ("block_sparse_fwd_sm90",
                                       bsa._bs_fwd_sm90_launch,
                                       bsa._bs_fwd_plain) if hopper else wmma
            fwd_name += "_fp16" if half else ""
        else:
            wmma = ("block_sparse_band_fwd", bsa._band_fwd_launch,
                    bsa._band_fwd_plain)
            fwd_name, launch, plain = ("block_sparse_band_fwd_sm90",
                                       bsa._band_fwd_sm90_launch,
                                       bsa._band_fwd_plain) if hopper else wmma
            fwd_name += "_fp16" if half else ""
        out, lse = launch(q, k, v, pair, sm)
        torch.cuda.synchronize()
        ref, ref_lse = plain(q, k, v, pair, sm)
        tol = {torch.bfloat16: TOL_BF16, torch.float16: TOL_F16}.get(
            dtype, TOL_F32)
        gtol = {torch.bfloat16: GRAD_TOL_BF16,
                torch.float16: GRAD_TOL_F16}.get(dtype, GRAD_TOL_F32)
        err_fwd = check(f"{fwd_name} out, {label}", out, ref, tol, checks)
        check(f"{fwd_name} log2-lse, {label}", lse, ref_lse, TOL_F32, checks)
        del ref, ref_lse
        # the WMMA bodies (the earlier kernels) take fp32 and bf16 only
        earlier = hopper and timed and not half
        if earlier:
            # the earlier forward (WMMA, 64 x 64 tiles) on the same
            # inputs, held to its own twin
            wmma_out, wmma_lse = wmma[1](q, k, v, plan, sm)
            torch.cuda.synchronize()
            wmma_ref, wmma_ref_lse = wmma[2](q, k, v, plan, sm)
            err_wmma = check(f"{wmma[0]} out, {label}", wmma_out,
                             wmma_ref, tol, checks)
            check(f"{wmma[0]} log2-lse, {label}", wmma_lse,
                  wmma_ref_lse, TOL_F32, checks)
            del wmma_out, wmma_lse, wmma_ref, wmma_ref_lse
        names, bwd_launches, delta, err_dkv, err_dq = backward(
            q, k, v, out, lse, dout, pair, sm, label, gtol, hopper)
        if earlier:
            # the earlier backward (WMMA, 64 x 64 tiles) on the same
            # inputs, held to its twin on the 64-row tables
            wmma_bwd = backward(q, k, v, out, lse, dout, plan, sm, label,
                                gtol, False)
        if not timed:
            return
        # the work of the visible (causal) scores only: 2 products of
        # 2*d flops per score forward (S, P.V); dK/dV recomputes S and dP
        # and adds dV, dK (4 products), dQ recomputes S and dP and adds
        # dQ (3 products); bytes each input read once, output written once
        nvis = b * visible_scores(layout, block, causal)
        el = q.element_size()
        row = b * t * h * d * el
        lse_b = b * h * t * 4
        f_bound, f_by = bound(4.0 * d * nvis, peaks["bf16"],
                              4 * row + lse_b, peaks)
        kv_bound, kv_by = bound(8.0 * d * nvis, peaks["bf16"],
                                7 * row + lse_b, peaks)
        q_bound, q_by = bound(6.0 * d * nvis, peaks["bf16"],
                              5 * row + 2 * lse_b, peaks)
        # SDPA with the expanded [T, T] boolean layout mask, broadcast
        # over batch and heads (the layout is one per head here)
        mask = torch.as_tensor(bsa.layout_to_dense_mask(layout[:1], t,
                                                        block)[0],
                               device="cuda")
        if causal:
            mask &= torch.ones((t, t), dtype=torch.bool, device="cuda").tril()
        qt_, kt_, vt_, dt_ = (x.transpose(1, 2).detach().clone()
                              for x in (q, k, v, dout))
        for x in (qt_, kt_, vt_):
            x.requires_grad_(True)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qt_, kt_, vt_,
                                                  attn_mask=mask[None, None])

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qt_, kt_, vt_), dt_)

        try:
            sdpa_f = time_ms(sdpa_fwd, iters=5, warmup=1)
            sdpa_fb = time_ms(sdpa_fwd_bwd, iters=5, warmup=1)
        except torch.cuda.OutOfMemoryError:
            sdpa_f = sdpa_fb = None
        del mask, qt_, kt_, vt_, dt_
        release()
        o_d, lse_d = fa.flash_attention_with_lse(q, k, v, causal=causal)
        lse_d = lse_d[..., 0].contiguous()
        dense = {"k1_fwd_ms": time_ms(lambda: fa.flash_attention_with_lse(
                     q, k, v, causal=causal), iters=5),
                 "k2_bwd_ms": time_ms(lambda: fa.flash_attention_backward(
                     q, k, v, o_d, lse_d, dout, None, sm, causal), iters=5)}
        del o_d, lse_d
        common = {"shape": label, "visible_scores": nvis,
                  "density": nvis / (b * h * (t * (t + 1) // 2 if causal
                                              else t * t)),
                  "sdpa_masked_fwd_ms": sdpa_f,
                  "sdpa_masked_fwd_bwd_ms": sdpa_fb, "dense": dense}
        fwd_flops = 4.0 * d * nvis
        # the table forward walks the forward table (dQ's)
        fwd_walk = walk_stats(pair, plan, "dq", b) if plan.band is None \
            else {}
        res[fwd_name][label] = rates(dict(
            max_abs_err=err_fwd, ms=time_ms(lambda: launch(q, k, v, pair,
                                                           sm)),
            plain_ms=time_ms(lambda: plain(q, k, v, pair, sm), iters=3,
                             warmup=1),
            bound_ms=f_bound, bound_by=f_by, library_ms=sdpa_f, **fwd_walk,
            **common), fwd_flops)
        if hopper:
            res[fwd_name][label]["ptxas"] = ptxas
        if earlier:
            res[wmma[0]][label] = rates(dict(
                max_abs_err=err_wmma,
                ms=time_ms(lambda: wmma[1](q, k, v, plan, sm)),
                plain_ms=time_ms(lambda: wmma[2](q, k, v, plan, sm),
                                 iters=3, warmup=1),
                bound_ms=f_bound, bound_by=f_by, library_ms=sdpa_f,
                body="WMMA, 64 x 64 tiles (the earlier kernel; the route "
                     "takes it for fp32)",
                **(walk_stats(plan, plan, "dq", b) if plan.band is None
                   else {}), **common), fwd_flops)

        def bwd_rows(bwd, p, extra):
            (dkv_name, dq_name), (dkv, dq_launch), dlt, e_dkv, e_dq = bwd
            twin_bwd = time_ms(lambda: bsa._bs_bwd_plain(
                q, k, v, out, lse, dout, p, sm), iters=2, warmup=1)
            res[dkv_name][label] = rates(dict(
                max_abs_err=e_dkv,
                ms=time_ms(lambda: dkv(q, k, v, out, lse, dout, p, sm)),
                plain_ms=twin_bwd, plain_is="the whole backward twin",
                bound_ms=kv_bound, bound_by=kv_by, library_ms=None,
                **walk_stats(p, plan, "dkv", b), **extra, **common),
                8.0 * d * nvis)
            res[dq_name][label] = rates(dict(
                max_abs_err=e_dq,
                ms=time_ms(lambda: dq_launch(q, k, v, out, lse, dout, dlt, p,
                                             sm)),
                plain_ms=twin_bwd, plain_is="the whole backward twin",
                bound_ms=q_bound, bound_by=q_by, library_ms=None,
                **walk_stats(p, plan, "dq", b), **extra, **common),
                6.0 * d * nvis)

        bwd_rows((names, bwd_launches, delta, err_dkv, err_dq), pair,
                 {"ptxas": ptxas} if hopper else {})
        if earlier:
            bwd_rows(wmma_bwd, plan, {
                "body": "WMMA, 64 x 64 tiles (the earlier K7-dkv / K7-dq; "
                        "the route takes it for fp32)"})

    h, d = SPARSE_H, SPARSE_D
    for pattern in ("bslongformer", "fixed", "bigbird"):
        layout = sparse_config(pattern).make_layout(16384)
        one(f"{pattern} bf16 causal B1 T16384 H16 D64 block 256", layout,
            SPARSE_BLOCK, True, torch.bfloat16, 1, 16384, h, d, True)
        release()
    # the fp16 forms at the fp16 path's shape: BSLongformer (K7-band) and
    # BigBird (K7-fwd) timed, Fixed checked; the 32k shapes stay bf16's
    for pattern, timed in (("bslongformer", True), ("bigbird", True),
                           ("fixed", False)):
        one(f"{pattern} fp16 causal B1 T16384 H16 D64 block 256",
            sparse_config(pattern).make_layout(16384), SPARSE_BLOCK, True,
            torch.float16, 1, 16384, h, d, timed)
        release()
    # the other shapes the sparse_attention and bert_sparse paths give
    # the kernels, checked, not timed: [2, 32768] (512 tiles per row;
    # Fixed's 32 global columns) and BertSparseSelfAttention's default
    # Fixed (block 128, bidirectional) at [1, 16384]
    for pattern in ("bslongformer", "fixed"):
        one(f"{pattern} bf16 causal B2 T32768 H16 D64 block 256",
            sparse_config(pattern).make_layout(32768), SPARSE_BLOCK, True,
            torch.bfloat16, 2, 32768, h, d, False)
        release()
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    for dtype in (torch.bfloat16, torch.float16):
        one(f"bert default fixed {str(dtype)[6:]} non-causal B1 T16384 H16 "
            "D64 block 128",
            sa.FixedSparsityConfig(num_heads=h).make_layout(16384), 128,
            False, dtype, 1, 16384, h, d, False)
        release()
    for pattern in ("bslongformer", "fixed", "bigbird"):
        layout = sparse_config(pattern, h=4, block=32).make_layout(2048)
        for dtype in (torch.float32, torch.bfloat16):
            one(f"{pattern} {str(dtype)[6:]} non-causal B2 T2048 H4 D64 "
                "block 32", layout, 32, False, dtype, 2, 2048, 4, 64, False)
    per_head = sa.VariableSparsityConfig(
        num_heads=4, block=32, different_layout_per_head=True,
        num_random_blocks=2, local_window_blocks=[2, 4],
        global_block_indices=[0]).make_layout(2048)
    for dtype in (torch.float32, torch.bfloat16):
        one(f"per-head variable {str(dtype)[6:]} causal B2 T2048 H4 D128 "
            "block 32", per_head, 32, True, dtype, 2, 2048, 4, 128, False)
    # the Hopper bodies at every block they take, at head dims 64 and
    # 128: K7-band and the backward on sliding and aligned bands, causal
    # and not, the backward also on BigBird and per-head layouts; T 448
    # (the last 128-row tile runs past T) or 8 blocks, 3 heads. At blocks
    # of 64 and under a 128-row tile straddles layout blocks, and
    # causally its lower half cannot see the first tile of its span
    for block in (16, 32, 64, 128, 256):
        t = 448 if 448 % block == 0 else 8 * block
        cases = band_layouts(3, t, block) + table_layouts(3, t, block)
        # fp16 at the smallest, the tile's and the largest block
        dtypes = (torch.bfloat16, torch.float16) if block in (16, 64, 256) \
            else (torch.bfloat16,)
        for i, (layout, causal) in enumerate(cases):
            for d in (64, 128):
                for dtype in dtypes:
                    one(f"layout {i} {'causal' if causal else 'full'} "
                        f"{str(dtype)[6:]} B2 T{t} H3 D{d} block {block}",
                        layout, block, causal, dtype, 2, t, 3, d, False)
    return res, checks


def band_layouts(h, t, block):
    """(layout, causal) pairs that K7-band takes: sliding bands
    (BSLongformer: unidirectional with its global column, causal;
    bidirectional without one, not causal) and aligned windows (Fixed
    with its global columns, causal and not)."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    sliding = sa.BSLongformerSparsityConfig
    return [(sliding(num_heads=h, block=block, num_sliding_window_blocks=3,
                     attention="unidirectional").make_layout(t), True),
            (sliding(num_heads=h, block=block, num_sliding_window_blocks=3,
                     global_block_indices=[]).make_layout(t), False)] + [
        (sa.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=4,
                                attention=attention).make_layout(t), causal)
        for attention, causal in (("unidirectional", True),
                                  ("bidirectional", False))]


def table_layouts(h, t, block):
    """(layout, causal) pairs that take the table forward: BigBird
    (bidirectional) and per-head Variable layouts with random blocks
    and a global column (causal)."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    return [(sa.BigBirdSparsityConfig(num_heads=h, block=block)
             .make_layout(t), False),
            (sa.VariableSparsityConfig(
                num_heads=h, block=block, different_layout_per_head=True,
                num_random_blocks=1, local_window_blocks=[1, 2],
                global_block_indices=[0]).make_layout(t), True)]


def sparse_attention_path(seed, card, dtype=None):
    """The bench leg (bench.py:370-470) through the port's entry point:
    SparseSelfAttention(config)(q, q, q, causal=True), forward and the
    backward of the output's sum, under BSLongformer and Fixed at
    [1, 16384] and [2, 32768] and BigBird at [1, 16384] (H16 D64 bf16,
    block 256), against dense flash attention (K1/K2) on the same q; in
    fp16 (`dtype`) the [1, 16384] configurations only.
    Launch counts are zeroed right before the path and read after one
    pass of each configuration. Then each is timed by CUDA events over
    10 passes after a warm-up, with the cache allocator warm, beside its
    peak memory and one pass timed right after `torch.cuda.empty_cache()`
    (that pass pays cudaMalloc again for every buffer). Returns the
    counts."""
    import torch
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    dtype = dtype or torch.bfloat16
    fp16 = dtype == torch.float16
    path = tuple(c for c in SPARSE_PATH if not fp16 or c[2] == 16384)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    qs = {(b, t): torch.randn((b, t, SPARSE_H, SPARSE_D), generator=gen,
                              device="cuda").to(dtype)
          for b, t in {(b, t) for _, b, t in path}}
    mods = {p: sa.SparseSelfAttention(sparse_config(p), max_seq_length=t)
            for p, _, t in path}

    def fwd_bwd(fn, q):
        x = q.detach().requires_grad_(True)
        out = fn(x)
        out.float().sum().backward()
        return out, x.grad

    def sparse_fn(pattern):
        return lambda x: mods[pattern](x, x, x, causal=True)

    def dense_fn(x):
        return fa.flash_attention(x, x, x, causal=True)

    reset_counts()
    for pattern, b, t in path:
        out, grad = fwd_bwd(sparse_fn(pattern), qs[(b, t)])
        torch.cuda.synchronize()
        if not (torch_isfinite(out) and torch_isfinite(grad)):
            raise AssertionError(f"sparse path {pattern} B{b} T{t}: "
                                 "non-finite output or gradient")
        del out, grad
    counts = read_counts()

    def timed(fn, q):
        release()
        torch.cuda.reset_peak_memory_stats()
        cold = time_ms(lambda: fwd_bwd(fn, q), iters=1, warmup=0)
        ms = time_ms(lambda: fwd_bwd(fn, q), iters=10, warmup=1)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30, cold

    rows = []
    dense = {}
    for pattern, b, t in path:
        if (b, t) not in dense:
            dense[(b, t)] = timed(dense_fn, qs[(b, t)])
        ms, peak, cold = timed(sparse_fn(pattern), qs[(b, t)])
        layout = mods[pattern].get_layout(t)
        nvis = b * visible_scores(layout, SPARSE_BLOCK, True)
        rows.append({"pattern": pattern, "batch": b, "seq": t,
                     "fwd_bwd_ms": ms, "peak_gib": peak,
                     "first_pass_after_empty_cache_ms": cold,
                     "dense_flash_fwd_bwd_ms": dense[(b, t)][0],
                     "dense_flash_peak_gib": dense[(b, t)][1],
                     "dense_flash_first_pass_after_empty_cache_ms":
                         dense[(b, t)][2],
                     "speedup_vs_dense_flash": dense[(b, t)][0] / ms,
                     "visible_scores": nvis,
                     "us_per_visible_block": ms * 1e3 / (
                         nvis / SPARSE_BLOCK ** 2)})
    emit({"phase": "sparse_attention_fp16" if fp16 else "sparse_attention",
          "card": card,
          "config": f"bench.py sparse_attention_16k: H16 D64 "
                    f"{'fp16' if fp16 else 'bf16'} block 256 causal, fwd + "
                    "bwd of sum(out)",
          "timing": "CUDA events, mean of 10 passes after 1 warm-up",
          "rows": rows, "launches": {k: counts[k] for k in SPARSE_KERNELS}})
    release()
    return counts


def bert_sparse(seed, card, dtype=None):
    """BertSparseSelfAttention(hidden_size=1024, num_attention_heads=16)
    (BERT-large's attention width; the default FixedSparsityConfig:
    block 128, 4 local blocks, 1 global, bidirectional) on
    [1, 16384, 1024] hidden states in `dtype` (bf16 by default; fp16),
    weights from the seed: forward and backward of the mean square of
    the output; the loss and every gradient finite."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import \
        BertSparseSelfAttention
    dtype = dtype or torch.bfloat16
    torch.manual_seed(seed)
    mod = BertSparseSelfAttention(1024, 16, dtype=dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((1, 16384, 1024), generator=gen,
                    device="cuda").to(dtype).requires_grad_(True)

    def step():
        mod.zero_grad()
        x.grad = None
        loss = mod(x).float().pow(2).mean()
        loss.backward()
        return loss

    bsa = _sparse()
    before = read_counts()
    loss = step()
    torch.cuda.synchronize()
    launched = {k: read_counts()[k] - before[k] for k in SPARSE_KERNELS}
    grads = [x.grad] + [p.grad for p in mod.parameters()]
    ok = torch_isfinite(loss) and all(torch_isfinite(g) for g in grads) \
        and all(launched[k] == 1 for k in SPARSE_KERNELS[1:])
    ms = time_ms(step, iters=10, warmup=0)
    plan = bsa._plan(mod.sparse_attn.get_layout(16384), False, 128,
                     bsa.TILE, x.device)
    emit({"phase": "bert_sparse", "card": card,
          "config": "BertSparseSelfAttention(1024, 16), default Fixed "
                    "(block 128, l4 g1, bidirectional), [1, 16384, 1024] "
                    f"{str(dtype)[6:]}",
          "band": list(plan.band[:2]) if plan.band
          else None, "loss": loss.item(), "fwd_bwd_ms": ms,
          "timing": "CUDA events, mean of 10 steps after 1",
          "launches": launched,
          "finite": ok})
    if not ok:
        raise AssertionError("bert_sparse: non-finite loss or gradient, "
                             f"or launches {launched} are not one each of "
                             "K7-band, K7-dkv and K7-dq")
    release()


def sparse_oracle(seed):
    """The kernel route (block_sparse_attention on the card: K7-band or
    K7-fwd, then K7-dkv and K7-dq) against the dense masked fallback
    (block_sparse_attention_dense_fallback: plain torch over the
    expanded [T, T] mask) at T 4096 (the fallback's fp32 scores at 16k
    would take ~17 GB), H16 D64 block 256 causal, for the three
    patterns, fp32 (K7-band, K7-dkv and K7-dq on the WMMA bodies) and
    bf16 (on the Hopper ones): outputs and dQ/dK/dV by relative L2.
    Launch counts are zeroed right before and returned."""
    import torch
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    bsa = _sparse()
    reset_counts()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t = SPARSE_ORACLE_T
    rows, ok = [], True
    for pattern in ("bslongformer", "fixed", "bigbird"):
        layout = sparse_config(pattern).make_layout(t)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (torch.randn((1, t, SPARSE_H, SPARSE_D),
                                         generator=gen, device="cuda")
                             .to(dtype) for _ in range(4))
            results = []
            for fn in (sa.block_sparse_attention,
                       bsa.block_sparse_attention_dense_fallback):
                xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
                out = fn(*xs, layout, SPARSE_BLOCK, causal=True)
                results.append([out] + list(torch.autograd.grad(out, xs,
                                                                dout)))
            tol = TOL_SPARSE_ORACLE[str(dtype)[6:]]
            errs = {n: rel_l2(a, b) for n, a, b in
                    zip(("out", "dq", "dk", "dv"), *results)}
            good = all(e <= tol for e in errs.values()) and \
                all(torch_isfinite(x) for x in results[0])
            ok = ok and good
            rows.append({"pattern": pattern, "dtype": str(dtype)[6:],
                         "rel_l2": errs, "tol": tol, "ok": good})
            del results
            release()
    counts = read_counts()
    emit({"phase": "sparse_oracle", "seq": t, "rows": rows, "ok": ok})
    if not ok:
        raise AssertionError("sparse kernel route disagrees with the dense "
                             "masked fallback")
    return counts


# ----------------------------------------------------------------------
# phases 18-20: K5 and sequence parallelism
# ----------------------------------------------------------------------
# the JAX package's ring leg (bench.py bench_ring_attention): [B, T, H, D]
SP_SHAPE_8K = (1, 8192, 4, 64)
SP_SHAPE_32K = (1, 32768, 16, 64)
# the emulated ring's rank count, and its K5 (and K2) launches per pass:
# rank r folds r + 1 blocks
SP_RANKS = 4
SP_FOLDS = SP_RANKS * (SP_RANKS + 1) // 2
# ring gradients against K2 on the whole sequence, by relative L2: the
# merge backward hands K2 a dO rounded to bf16 at every fold (the
# kernel's dO type), on top of GRAD_TOL_BF16's roundings
TOL_SP_GRAD = 1e-2
# the fallback ring body rounds its score product to bf16 (the JAX
# body's einsum does the same): against K1 by relative L2
TOL_SP_FALLBACK = 1e-2
# sp_training against training, step by step (same weights, batch and
# seed): K5 against an empty carry is K1's acc / l to fp32 rounding
TOL_SP_LOSS = 1e-2


def merge_bound(peaks, b, t, h, d, itemsize, causal):
    """K5's bound: K1's score work over the visible pairs; bytes of q, k,
    v read, prev_out read and out written in fp32, prev_lse read and
    lse, lse_n written."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4.0 * b * h * d * pairs
    nbytes = (3 * itemsize + 8) * b * t * h * d + 12 * b * h * t
    peak = peaks["bf16"] if itemsize == 2 else peaks["fp32"]
    return bound(flops, peak, nbytes, peaks)


def kernel_merge(peaks, gen):
    """Phase 18: K5 against its twin at the ring leg's 8k shape
    ([1, 8192, 4, 64], bf16 causal and full, fp32 causal) and at the
    sp_training shape ([11, 1024, 25, 64] bf16 causal, an empty carry),
    with a prior partial from K1 over a disjoint key block whose first
    rows are an empty partial: out, lse and lse_n. Timed at those shapes
    beside its bound, the twin and SDPA's forward (the yardstick, never
    called by the port), and at [1, 32768, 16, 64] bf16 causal against
    K1 on the same q (the difference is the merge's cost). Then the
    given-delta entry (K5's backward) of the route's kernel against its
    twin: K2's sweeps at the 8k shape, bf16, and at [2, 1024, 4, 64]
    fp32, timed at the 8k shape; K2-fused at the sp_training shape
    ([11, 1024, 25, 64] bf16 causal), launched twice and compared bit for
    bit, timed beside the sweeps on the same inputs. Returns (K5's
    timed_by_path, K2's given-delta entries, K2-fused's, checks)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    bf16, f32 = torch.bfloat16, torch.float32
    checks, out, k2, k2_fused = [], {}, {}, {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def inputs(shape, dtype, empty_carry=False):
        q, k, v = (randn(shape, dtype) for _ in range(3))
        b, t, h, d = shape
        if empty_carry:
            return q, k, v, torch.zeros(shape, device="cuda"), torch.full(
                (b, h, t), fa.NEG_INF, device="cuda")
        prev, prev_lse = fa.flash_attention_with_lse(
            q, randn(shape, dtype), randn(shape, dtype), causal=False)
        prev, prev_lse = prev.float(), prev_lse[..., 0].contiguous()
        prev[:, :7] = 0.0
        prev_lse[:, :, :7] = fa.NEG_INF
        return q, k, v, prev, prev_lse

    cases = (
        # (label, shape, dtype, causal, empty carry, timed as)
        ("bf16 causal [1, 8192, 4, 64] (ring leg)", SP_SHAPE_8K, bf16, True,
         False, "sequence_parallel"),
        ("bf16 causal [11, 1024, 25, 64] empty carry (sp_training)",
         (TRAIN_BATCH, TRAIN_SEQ, 25, 64), bf16, True, True, "sp_training"),
        ("bf16 full [1, 8192, 4, 64]", SP_SHAPE_8K, bf16, False, False,
         None),
        ("fp32 causal [1, 8192, 4, 64]", SP_SHAPE_8K, f32, True, False,
         None),
        ("fp32 full [2, 1024, 4, 128]", (2, 1024, 4, 128), f32, False,
         False, None),
    )
    for label, shape, dtype, causal, empty, timed in cases:
        q, k, v, prev, plse = inputs(shape, dtype, empty)
        sm = shape[-1] ** -0.5
        got = fa._flash_merge_launch(q, k, v, prev, plse, sm, causal)
        torch.cuda.synchronize()
        ref = fa._flash_merge_plain(q, k, v, prev, plse, sm, causal)
        tol = TOL_BF16 if dtype == bf16 else TOL_F32
        err = check(f"merge out, {label}", got[0], ref[0], tol, checks)
        check(f"merge lse, {label}", got[1], ref[1], TOL_F32, checks)
        check(f"merge lse_n, {label}", got[2], ref[2], TOL_F32, checks)
        if empty:
            k1_out, k1_lse = fa.flash_attention_with_lse(q, k, v,
                                                         causal=causal)
            check(f"merge out against K1, {label}", got[0], k1_out.float(),
                  TOL_BF16, checks)
            check(f"merge lse against K1, {label}", got[1], k1_lse[..., 0],
                  TOL_F32, checks)
        del got, ref
        if timed:
            b, t, h, d = shape
            bound_ms, bound_by = merge_bound(peaks, b, t, h, d,
                                             q.element_size(), causal)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            pairs = t * (t + 1) // 2 if causal else t * t
            out[timed] = rates(dict(
                max_abs_err=err,
                ms=time_ms(lambda: fa._flash_merge_launch(
                    q, k, v, prev, plse, sm, causal)),
                plain_ms=time_ms(lambda: fa._flash_merge_plain(
                    q, k, v, prev, plse, sm, causal), iters=1, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal)),
                k1_ms=time_ms(lambda: fa.flash_attention_with_lse(
                    q, k, v, causal=causal)),
                shape=label), 4.0 * b * h * d * pairs)
        del q, k, v, prev, plse
        release()

    # the long leg: K5 against K1 on the same q; the twin runs at T <= 8k
    b, t, h, d = SP_SHAPE_32K
    q, k, v, prev, plse = inputs(SP_SHAPE_32K, bf16)
    sm = d ** -0.5
    bound_ms, bound_by = merge_bound(peaks, b, t, h, d, 2, True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = time_ms(lambda: fa._flash_merge_launch(q, k, v, prev, plse, sm,
                                                True), iters=5)
    k1_ms = time_ms(lambda: fa.flash_attention_with_lse(q, k, v,
                                                        causal=True), iters=5)
    got = fa._flash_merge_launch(q, k, v, prev, plse, sm, True)
    torch.cuda.synchronize()
    if not torch_isfinite(got[0]):
        raise AssertionError("K5 at [1, 32768, 16, 64]: non-finite output")
    out["sequence_parallel_32k"] = rates(dict(
        max_abs_err="not measured (the twin runs at T <= 8192)",
        ms=ms, k1_ms=k1_ms, merge_cost_ms=ms - k1_ms,
        plain_ms="not measured (the twin runs at T <= 8192)",
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=5),
        shape="bf16 causal [1, 32768, 16, 64] (ring leg, 32k)"),
        4.0 * b * h * d * t * (t + 1) // 2)
    del q, k, v, prev, plse, got, qt, kt, vt
    release()

    # the given-delta entry of the route's kernel against its twin
    for label, shape, dtype, timed in (
            ("bf16 causal [1, 8192, 4, 64] given delta", SP_SHAPE_8K, bf16,
             "sequence_parallel"),
            ("fp32 causal [2, 1024, 4, 64] given delta", (2, 1024, 4, 64),
             f32, None),
            ("bf16 causal [11, 1024, 25, 64] given delta", (11, 1024, 25, 64),
             bf16, "sp_training")):
        b, t, h, d = shape
        q, k, v, dout = (randn(shape, dtype) for _ in range(4))
        _, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        lse = lse[..., 0].contiguous()
        delta, dlse = (torch.randn((b, h, t), generator=gen, device="cuda")
                       for _ in range(2))
        keep = delta.clone()
        sm = d ** -0.5

        def run():
            return fa.flash_attention_backward(q, k, v, None, lse, dout,
                                               dlse, sm, True, delta=delta)

        def sweeps():
            return fa._flash_bwd_launch(q, k, v, None, lse, dout, dlse, sm,
                                        True, delta=delta)

        got = run()
        torch.cuda.synchronize()
        if not torch.equal(delta, keep):
            raise AssertionError("the given-delta K2 wrote the caller's "
                                 "delta")
        fused = fa._fused_route(q)
        name = "flash bwd fused" if fused else "flash bwd"
        ref = fa._flash_bwd_twin(q, k, v, None, lse, dout, dlse, sm, True,
                                 delta=delta)
        tol = GRAD_TOL_BF16 if dtype == bf16 else GRAD_TOL_F32
        errs = [check_rel(f"{name} d{n}, {label}", x, y, tol, checks)
                for n, x, y in zip("qkv", got, ref)]
        if fused:
            same = all(torch.equal(x, y) for x, y in zip(got, run()))
            checks.append({"check": f"{name} repeats bit for bit, {label}",
                           "equal": same})
            if not same:
                raise AssertionError(f"K2-fused {label}: a second launch "
                                     "differs")
        if timed:
            pairs = t * (t + 1) // 2
            nbytes = 7 * b * t * h * d * q.element_size() + 12 * b * h * t
            bound_ms, bound_by = bound(10.0 * b * h * d * pairs,
                                       peaks["bf16"], nbytes, peaks)
            row = dict(
                max_abs_err=max(errs), ms=time_ms(run), graph_ms=graph_ms(run),
                plain_ms=time_ms(lambda: fa._flash_bwd_twin(
                    q, k, v, None, lse, dout, dlse, sm, True, delta=delta),
                    iters=1, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=sdpa_ms(q, k, v, dout, True)[2], shape=label)
            if fused:
                row.update(sweeps_ms=time_ms(sweeps),
                           sweeps_graph_ms=graph_ms(sweeps))
            (k2_fused if fused else k2)[timed] = rates(
                row, 10.0 * b * h * d * pairs)
        release()
    return out, k2, k2_fused, checks


def init_sp_group():
    """The one-rank NCCL process group of phases 19 and 20, with a
    `file://` rendezvous under build/ (git-ignored)."""
    import torch
    import deepspeed_tpu_torch as dst
    path = os.path.join(ROOT, "build", f"sp-rendezvous-{os.getpid()}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    torch.cuda.set_device(0)
    dst.init_distributed("nccl", init_method="file://" + path, rank=0,
                         world_size=1, verbose=False)
    return path


def emulated_ring(q, k, v, p):
    """P ranks' ring folds played in one process: rank r's chunk of q
    folds the K/V chunks r, r - 1, ..., 0 through flash_attention_merge
    (K5), its own chunk causal and the lower ones full (a higher rank's
    chunk is skipped, as on the ring); the chunks are slices of one k
    and one v, so autograd takes the place of the rotation."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    b, t, h, d = q.shape
    tl = t // p
    outs = []
    for r in range(p):
        o = torch.zeros((b, tl, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, tl, 1), fa.NEG_INF, device=q.device)
        for src in range(r, -1, -1):
            rows = slice(src * tl, (src + 1) * tl)
            o, lse = fa.flash_attention_merge(
                q[:, r * tl:(r + 1) * tl], k[:, rows], v[:, rows], o, lse,
                causal=src == r)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)


def sequence_parallel_path(seed, card):
    """Phase 19: the JAX package's ring leg (bench.py
    bench_ring_attention) through the port's entry points in the
    one-rank NCCL group: forward + backward of sum(out.float()) with
    q = k = v, causal, bf16: ring_attention at [1, 8192, 4, 64] with the
    flash body and with the fallback body, at [1, 32768, 16, 64] with the
    flash body, and ulysses_attention at [1, 32768, 16, 64]; each output
    held to K1 on the same q. Launch counts are zeroed right before the
    leg's passes and read after them; then each is timed (CUDA events).
    Then the emulated ring: SP_RANKS ranks' folds in one process at both
    shapes, outputs held to K1 on the whole sequence and dQ/dK/dV to K2,
    SP_FOLDS launches of K5 and of K2 per pass. Returns the leg's
    counts."""
    import torch
    from deepspeed_tpu_torch.ops.sequence import (ring_attention,
                                                  ulysses_attention)
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    qs = {shape: torch.randn(shape, generator=gen, device="cuda")
          .to(torch.bfloat16) for shape in (SP_SHAPE_8K, SP_SHAPE_32K)}

    def fwd_bwd(fn, q):
        x = q.detach().requires_grad_(True)
        out = fn(x)
        out.float().sum().backward()
        return out, x.grad

    legs = (
        ("ring flash", SP_SHAPE_8K, lambda x: ring_attention(
            x, x, x, causal=True, use_flash=True), TOL_BF16),
        ("ring fallback", SP_SHAPE_8K, lambda x: ring_attention(
            x, x, x, causal=True, use_flash=False), None),
        ("ring flash", SP_SHAPE_32K, lambda x: ring_attention(
            x, x, x, causal=True, use_flash=True), TOL_BF16),
        ("ulysses", SP_SHAPE_32K, lambda x: ulysses_attention(
            x, x, x, causal=True), TOL_BF16),
    )
    checks = []
    reset_counts()
    results = [fwd_bwd(fn, qs[shape]) for _, shape, fn, _ in legs]
    torch.cuda.synchronize()
    counts = read_counts()
    for (name, shape, _, tol), (out, grad) in zip(legs, results):
        label = f"{name} {list(shape)}"
        if not (torch_isfinite(out) and torch_isfinite(grad)):
            raise AssertionError(f"sequence_parallel {label}: non-finite "
                                 "output or gradient")
        ref = fa.flash_attention(qs[shape], qs[shape], qs[shape],
                                 causal=True)
        if tol is None:
            check_rel(f"{label} against K1", out, ref, TOL_SP_FALLBACK,
                      checks)
        else:
            check(f"{label} against K1", out, ref, tol, checks)
    del results
    release()
    rows = []
    for name, shape, fn, _ in legs:
        ms = time_ms(lambda: fwd_bwd(fn, qs[shape]), iters=5, warmup=2)
        rows.append({"leg": name, "shape": list(shape), "fwd_bwd_ms": ms,
                     "tokens_per_s": shape[1] / (ms / 1e3)})
    release()

    # the emulated ring against K1/K2 on the whole sequence
    emulated = []
    for shape in (SP_SHAPE_32K, SP_SHAPE_8K):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16).requires_grad_(True)
                   for _ in range(3))
        reset_counts()
        out = emulated_ring(q, k, v, SP_RANKS)
        grads = torch.autograd.grad(out.float().sum(), (q, k, v))
        torch.cuda.synchronize()
        n = read_counts()
        label = f"emulated {SP_RANKS}-rank ring {list(shape)}"
        if (n["flash_attention_merge"], n["flash_attention_bwd"]) != \
                (SP_FOLDS, SP_FOLDS):
            raise AssertionError(
                f"{label}: {n['flash_attention_merge']} K5 and "
                f"{n['flash_attention_bwd']} K2 launches, expected "
                f"{SP_FOLDS} each")
        ref = fa.flash_attention(q, k, v, causal=True)
        ref_grads = torch.autograd.grad(ref.float().sum(), (q, k, v))
        err = check(f"{label} out against K1", out, ref, TOL_BF16, checks)
        gerr = [check_rel(f"{label} d{x} against K2", a, b, TOL_SP_GRAD,
                          checks)
                for x, a, b in zip("qkv", grads, ref_grads)]

        def ring_pass():
            o = emulated_ring(q, k, v, SP_RANKS)
            torch.autograd.grad(o.float().sum(), (q, k, v))

        def dense_pass():
            o = fa.flash_attention(q, k, v, causal=True)
            torch.autograd.grad(o.float().sum(), (q, k, v))

        emulated.append({"shape": list(shape), "ranks": SP_RANKS,
                         "k5_launches": n["flash_attention_merge"],
                         "k2_launches": n["flash_attention_bwd"],
                         "max_abs_err_out": err, "max_abs_err_grads": gerr,
                         "fwd_bwd_ms": time_ms(ring_pass, iters=3),
                         "k1_k2_fwd_bwd_ms": time_ms(dense_pass, iters=3)})
        del q, k, v, out, grads, ref, ref_grads
        release()
    emit({"phase": "sequence_parallel", "card": card,
          "group": "one-rank NCCL (file:// rendezvous)",
          "config": "bench.py bench_ring_attention: causal bf16, q = k = v, "
                    "fwd + bwd of sum(out.float())",
          "timing": "CUDA events, mean of 5 passes after 2 warm-ups",
          "legs": rows, "emulated_ring": emulated, "checks": checks,
          "launches": {k: counts[k] for k in SEQUENCE_PARALLEL_KERNELS}})
    release()
    return counts


# ----------------------------------------------------------------------
# phases 22-24: BERT-large pretraining on the fused transformer layer
# ----------------------------------------------------------------------
# bench.py's bench_bert_large (bench.py:312-368): micro batch 16, gas 16,
# seq 128, bf16 (fp32 masters), AdamW lr 1e-4, both dropouts 0
BERT_BATCH, BERT_GAS, BERT_SEQ = 16, 16, 128
BERT_WARMUP, BERT_STEPS = 2, 3
# the steps after the timed ones on the same batch (the constant lr
# without warm-up raises the loss at the second step before it falls),
# and the plain route's steps beside the kernel route's
BERT_MORE_STEPS, BERT_PLAIN_STEPS = 3, 3
# the generator of the kernel checks at BERT's shapes, so that every
# earlier check keeps its inputs
BERT_SEED = 13
# launches of each kernel per micro batch on BERT-large (24 layers):
# attention once a layer (the backward K2-fused, T 128; K2's sweeps
# never), each post-LN bias + residual + LayerNorm twice, the
# intermediate bias + GeLU once
BERT_LAUNCHES_PER_MICRO = {
    "flash_attention_fwd": 24, "flash_attention_bwd_fused": 24,
    "flash_attention_bwd": 0,
    "fused_bias_residual_layernorm_fwd": 48,
    "fused_bias_residual_layernorm_bwd": 48,
    "fused_bias_gelu_fwd": 24, "fused_bias_gelu_bwd": 24}
BERT_KERNELS = tuple(k for k, v in BERT_LAUNCHES_PER_MICRO.items() if v)


def kernel_bert(peaks):
    """Phase 22: K1-fwd, K2-fused, K3-fwd, K3-bwd, K4-fwd and K4-bwd at
    BERT-large's shapes on the pretraining path (micro batch 16, seq 128,
    so 2,048 rows): non-causal bf16 attention [16, 128, 16, 64] (one
    128-row q tile over two 64-row K/V tiles) beside SDPA's non-causal
    forward and backward; the post-LN bias + residual + LayerNorm (y
    bf16, fp32 out, no sum output, so the sum written for the backward
    only) with the residual in bf16 (the carry into a layer's attention
    LayerNorm) and in fp32 (the attention LayerNorm's output into the
    MLP's), and its backward off that sum (fp32 dout, no sum cotangent,
    dx bf16); the erf-GeLU at N 2048, W 4096 beside F.gelu and
    aten.gelu_backward. Each against its twin; the backward kernels
    launched twice and compared bit for bit. Returns ({kernel: {path:
    row}}, checks)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    gen = torch.Generator(device="cuda")
    gen.manual_seed(BERT_SEED)
    checks, out = [], {k: {} for k in BERT_KERNELS}
    bf16, f32 = torch.bfloat16, torch.float32
    n_rows = BERT_BATCH * BERT_SEQ

    # K1-fwd and K2: q/k/v column slices of one qkv tensor
    b, t, h, d = BERT_BATCH, BERT_SEQ, 16, 64
    label = f"bf16 non-causal B{b} T{t} H{h} D{d} (BERT-large)"
    c = h * d
    qkv = torch.randn((b, t, 3 * c), generator=gen, device="cuda").to(bf16)
    q, k, v = (p.view(b, t, h, d) for p in qkv.split(c, dim=-1))
    sm = 1.0 / d ** 0.5
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=False)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa._flash_fwd_plain(q, k, v, sm, False)
    err = check(f"flash out, {label}", o, ref_o, TOL_BF16, checks)
    check(f"flash log2-lse, {label}", lse[..., 0], ref_lse, TOL_F32, checks)
    flops = 4.0 * b * h * d * t * t
    nbytes = 4 * b * t * h * d * 2 + b * h * t * 4
    bound_ms, bound_by = bound(flops, peaks["bf16"], nbytes, peaks)
    qt, kt, vt = (x.transpose(1, 2).detach().clone() for x in (q, k, v))
    out["flash_attention_fwd"]["bert"] = rates(dict(
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention_with_lse(q, k, v,
                                                       causal=False)),
        graph_ms=graph_ms(lambda: fa.flash_attention_with_lse(
            q, k, v, causal=False)),
        plain_ms=time_ms(lambda: fa._flash_fwd_plain(q, k, v, sm, False),
                         iters=3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=False)),
        # at this size back-to-back calls time the host: device times
        # from CUDA graphs, the kernel's and SDPA's
        library_device_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=False)),
        shape=label), flops)
    lse = lse[..., 0].contiguous()
    dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(bf16)

    def k2():
        return fa.flash_attention_backward(q, k, v, o, lse, dout, None, sm,
                                           False)

    def sweeps():
        return fa._flash_bwd_launch(q, k, v, o, lse, dout, None, sm, False)

    before = fa._flash_bwd_fused_launch.launches
    got = k2()
    torch.cuda.synchronize()
    if fa._flash_bwd_fused_launch.launches != before + 1:
        raise AssertionError(f"{label}: the backward did not take K2-fused")
    ref = fa._flash_bwd_fused_plain(q, k, v, o, lse, dout, None, sm, False)
    errs = [check_rel(f"flash bwd fused d{n}, {label}", x, y, GRAD_TOL_BF16,
                      checks) for n, x, y in zip("qkv", got, ref)]
    again = k2()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"K2-fused {label}: a second launch differs")
    flops = 10.0 * b * h * d * t * t
    nbytes = 8 * b * t * h * d * 2 + b * h * t * 4
    bound_ms, bound_by = bound(flops, peaks["bf16"], nbytes, peaks)
    lib_ms, lib_graph_ms = sdpa_ms(q, k, v, dout, False)[2:]
    out["flash_attention_bwd_fused"]["bert"] = rates(dict(
        max_abs_err=max(errs), ms=time_ms(k2), graph_ms=graph_ms(k2),
        plain_ms=time_ms(lambda: fa._flash_bwd_fused_plain(
            q, k, v, o, lse, dout, None, sm, False), iters=3, warmup=1),
        sweeps_ms=time_ms(sweeps), sweeps_graph_ms=graph_ms(sweeps),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=lib_ms, library_device_ms=lib_graph_ms,
        shape=label), flops)
    del qkv, q, k, v, o, lse, dout, got, again, ref, qt, kt, vt
    release()

    # K3-fwd and K3-bwd, the post-LN form, H 1024
    hh = 1024
    for res_dt, path in ((bf16, "bert"), (f32, "bert_fp32_residual")):
        label = (f"N{n_rows} H{hh} post-LN: y bf16, residual "
                 f"{'bf16' if res_dt == bf16 else 'fp32'}, out fp32, the "
                 "sum for the backward")
        y = torch.randn((n_rows, hh), generator=gen, device="cuda").to(bf16)
        res = torch.randn((n_rows, hh), generator=gen, device="cuda") \
            .to(res_dt)
        # the parameters as the bf16 engine holds them
        bias, gamma, beta = ((0.1 * torch.randn(
            (hh,), generator=gen, device="cuda")).to(bf16)
            for _ in range(3))
        gamma = (gamma.float() + 1.0).to(bf16)

        def k3():
            # what the autograd Function runs on the training path
            return fo._ln_forward(y, bias, res, gamma, beta, 1e-12, f32,
                                  res_dt, True)

        got_out, got_s = k3()
        torch.cuda.synchronize()
        ref_out, ref_s = fo._ln_fwd_math(y, bias, res, gamma, beta, 1e-12)
        err = check(f"ln out, {label}", got_out, ref_out, TOL_F32, checks)
        check(f"ln sum, {label}", got_s, ref_s.to(res_dt),
              TOL_BF16 if res_dt == bf16 else TOL_F32, checks)
        isz = res.element_size()
        # read y and the residual, write out (fp32) and the sum, the
        # three [H] vectors once (bf16)
        nbytes = n_rows * hh * (2 + isz + 4 + isz) + 3 * hh * 2
        bound_ms, bound_by = bound(9 * n_rows * hh, peaks["fp32"], nbytes,
                                   peaks)
        out["fused_bias_residual_layernorm_fwd"][path] = rates(dict(
            max_abs_err=err, ms=time_ms(k3), graph_ms=graph_ms(k3),
            plain_ms=time_ms(lambda: fo._ln_fwd_math(
                y, bias, res, gamma, beta, 1e-12)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            shape=label), 9 * n_rows * hh)
        # the backward off that sum: the cotangent of the fp32 output
        s = got_s
        d_out = torch.randn((n_rows, hh), generator=gen, device="cuda")
        label = (f"N{n_rows} H{hh} post-LN backward: s "
                 f"{'bf16' if res_dt == bf16 else 'fp32'}, dout fp32, no "
                 "dsum, dx bf16")

        def k3b():
            return fo.fused_bias_residual_layernorm_backward(
                s, gamma, d_out, None, eps=1e-12, dx_dtype=bf16)

        got = k3b()
        torch.cuda.synchronize()
        ds, dg, db = fo._ln_bwd_math(s, gamma, d_out, None, 1e-12)
        ref = (ds.to(bf16), ds.sum(0), dg.sum(0), db.sum(0))
        errs = [check_rel(f"ln bwd {name}, {label}", x, r_,
                          GRAD_TOL_BF16 if name == "dx" else
                          GRAD_TOL_F32 * 10, checks)
                for name, x, r_ in zip(("dx", "dbias", "dgamma", "dbeta"),
                                       got, ref)]
        again = k3b()
        if not all(torch.equal(x, y_) for x, y_ in zip(got, again)):
            raise AssertionError(f"ln bwd {label}: two launches differ")
        # read s and dout (fp32), write dx (bf16), gamma (bf16) and the
        # three sums once
        nbytes = n_rows * hh * (isz + 4 + 2) + hh * 2 + 3 * hh * 4
        bound_ms, bound_by = bound(22 * n_rows * hh, peaks["fp32"], nbytes,
                                   peaks)
        out["fused_bias_residual_layernorm_bwd"][
            "bert" if res_dt == bf16 else "bert_fp32_sum"] = rates(dict(
                max_abs_err=errs[0], ms=time_ms(k3b), graph_ms=graph_ms(k3b),
                plain_ms=time_ms(lambda: fo._ln_bwd_math(
                    s, gamma, d_out, None, 1e-12)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=label,
                plan=fo.ln_bwd_plan(n_rows, hh, fo._sm_count(0))._asdict()),
            22 * n_rows * hh)
        del y, res, s, d_out, got, again, ref, got_out, got_s

    # K4-fwd and K4-bwd, erf, W 4096
    w = 4096
    label = f"N{n_rows} W{w} bf16 erf (BERT-large intermediate)"
    x = torch.randn((n_rows, w), generator=gen, device="cuda").to(bf16)
    bias = (0.1 * torch.randn((w,), generator=gen, device="cuda")).to(bf16)

    def k4():
        return fo.fused_bias_gelu_with_sum(x, bias, approximate=False,
                                           out_dtype=bf16)

    got_out, got_s = k4()
    torch.cuda.synchronize()
    ref_out, ref_s = fo._gelu_fwd_math(x, bias, False)
    err = check(f"gelu out, {label}", got_out, ref_out.to(bf16), TOL_BF16,
                checks)
    check(f"gelu sum, {label}", got_s, ref_s.to(bf16), TOL_BF16, checks)
    # read x, write out and sum (bf16), the bias row once; the erf form:
    # ~10 fp32 operations and an erf (counted as one) per element
    nbytes = n_rows * w * (2 + 2 + 2) + w * 2
    bound_ms, bound_by = bound(11 * n_rows * w, peaks["fp32"], nbytes, peaks)
    out["fused_bias_gelu_fwd"]["bert"] = rates(dict(
        max_abs_err=err, ms=time_ms(k4), graph_ms=graph_ms(k4),
        plain_ms=time_ms(lambda: fo._gelu_fwd_math(x, bias, False)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shape=label,
        yardstick="F.gelu(x, approximate='none'), bf16 [N, W]",
        yardstick_ms=time_ms(lambda: F.gelu(x, approximate="none")),
        yardstick_graph_ms=graph_ms(lambda: F.gelu(x, approximate="none"))),
        11 * n_rows * w)
    s = got_s
    dout = torch.randn((n_rows, w), generator=gen, device="cuda").to(bf16)

    def k4b():
        return fo.fused_bias_gelu_backward(s, dout, approximate=False)

    dx, dbias = k4b()
    torch.cuda.synchronize()
    ref = fo._gelu_bwd_math(s, dout, False)
    err = check_rel(f"gelu bwd dx, {label}", dx, ref.to(bf16),
                    GRAD_TOL_BF16, checks)
    check_rel(f"gelu bwd dbias, {label}", dbias, ref.sum(0),
              GRAD_TOL_F32 * 10, checks)
    again = k4b()
    if not (torch.equal(dx, again[0]) and torch.equal(dbias, again[1])):
        raise AssertionError(f"gelu bwd {label}: two launches differ")
    nbytes = n_rows * w * (2 + 2 + 2) + w * 4
    bound_ms, bound_by = bound(19 * n_rows * w, peaks["fp32"], nbytes, peaks)
    out["fused_bias_gelu_bwd"]["bert"] = rates(dict(
        max_abs_err=err, ms=time_ms(k4b), graph_ms=graph_ms(k4b),
        plain_ms=time_ms(lambda: fo._gelu_bwd_math(s, dout, False)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shape=label,
        yardstick="aten.gelu_backward(dout, s, approximate='none'), bf16 "
                  "[N, W]",
        yardstick_ms=time_ms(lambda: torch.ops.aten.gelu_backward(
            dout, s, approximate="none")),
        yardstick_graph_ms=graph_ms(lambda: torch.ops.aten.gelu_backward(
            dout, s, approximate="none"))), 19 * n_rows * w)
    for by_path in out.values():
        for row in by_path.values():
            device_rates(row)
    return out, checks


def device_rates(row):
    """A BERT row's device-time shares: its bound over the kernel's
    CUDA-graph time, and that time over the library's (or the
    yardstick's) device time where there is one."""
    row["graph_share_of_bound"] = row["bound_ms"] / row["graph_ms"]
    lib = row.get("library_device_ms", row.get("yardstick_graph_ms"))
    if lib:
        row["graph_ratio_to_library"] = row["graph_ms"] / lib
    return row


def bert_batch(cfg, seed):
    """bench.py's bench_bert_large batch recipe (bench.py:331-339), one
    step's [gas, micro batch, seq] stack from `seed`."""
    import numpy as np
    r = np.random.default_rng(seed)
    shape = (BERT_GAS, BERT_BATCH, BERT_SEQ)
    ids = r.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = np.where(r.random(shape) < 0.15, ids, -100)
    return {"input_ids": ids,
            "masked_lm_labels": labels.astype(np.int32),
            "next_sentence_label": r.integers(
                0, 2, (BERT_GAS, BERT_BATCH)).astype(np.int32)}


def bert_ds_config():
    """bench.py's bench_bert_large ds_config."""
    return {"train_micro_batch_size_per_gpu": BERT_BATCH,
            "gradient_accumulation_steps": BERT_GAS,
            "bf16": {"enabled": True},
            "steps_per_print": 1000,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}}


def bert_model_config(**overrides):
    from deepspeed_tpu_torch.models.bert import bert_config
    kw = dict(max_position_embeddings=BERT_SEQ, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, bf16=True)
    kw.update(overrides)
    return bert_config("bert-large", **kw)


def bert_training(seed, card):
    """Phase 23: BERT-large pretraining (24 layers, hidden 1024, 16 heads
    of 64, intermediate 4096, vocab 30522) through initialize ->
    train_batch with bench_bert_large's settings (micro batch 16, gas
    16, seq 128, bf16 with fp32 masters, AdamW lr 1e-4, dropout 0) on one
    repeated batch of its recipe: 2 warm-up and 3 timed steps (step ms,
    samples/s, tokens/s, TFLOP/s as samples/s * 128 * 6 * n_params, the
    bench's formula; peak device memory; the launches per micro batch of
    each kernel, exactly BERT_LAUNCHES_PER_MICRO), BERT_MORE_STEPS more,
    a torch.profiler window over one step, one micro batch's host
    enqueue time against its whole time, then the plain-torch route
    (fused_ops "off", an all-ones mask: dense attention) from the same
    weights for BERT_PLAIN_STEPS steps on the same batch. Gates: finite
    losses; the last of the 8 below the first (the constant lr without
    warm-up raises the loss at the second step, on both routes, before it
    falls); each plain-route loss within TOL_TRAIN_LOSS of the kernel
    route's at the same step; the exact launch counts. Returns the launch
    counts of the 5 bench steps."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.bert import (BertForPreTrainingLM,
                                                 mlm_head_dtype)

    cfg = bert_model_config()
    host_batch = bert_batch(cfg, seed)
    t0 = time.perf_counter()
    model = BertForPreTrainingLM(cfg)
    params = model.init(seed)
    n_params = sum(p.numel() for p in params.values())
    engine, _, _, _ = dst.initialize(model=model, model_parameters=params,
                                     config=bert_ds_config())
    staged = engine.stage_batch(host_batch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(BERT_WARMUP):
        losses.append(engine.train_batch(batch=staged))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(BERT_STEPS):
        losses.append(engine.train_batch(batch=staged))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / BERT_STEPS
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for _ in range(BERT_MORE_STEPS):
        losses.append(engine.train_batch(batch=staged))
    loss_vals = [float(x) for x in torch.stack(losses).float().cpu()]
    micro = (BERT_WARMUP + BERT_STEPS) * BERT_GAS
    per_micro = {k: counts[k] / micro for k in BERT_LAUNCHES_PER_MICRO}
    profile = profile_steps(lambda: engine.train_batch(batch=staged), 1)
    # the host's time for one micro batch's loss and gradients: the
    # enqueue (no device wait), then the wait for the device
    micro_batch = {k: v[0] for k, v in staged.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.forward(micro_batch)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    micro_s = time.perf_counter() - t0
    del engine, model, staged, micro_batch
    release()

    plain = BertForPreTrainingLM(bert_model_config(fused_ops="off"))
    engine, _, _, _ = dst.initialize(model=plain, model_parameters=params,
                                     config=bert_ds_config())
    del params
    staged = engine.stage_batch(dict(
        host_batch, attention_mask=np.ones_like(host_batch["input_ids"])))
    plain_vals = [float(engine.train_batch(batch=staged))
                  for _ in range(BERT_PLAIN_STEPS)]
    gaps = [abs(a - b) / abs(b) for a, b in zip(plain_vals, loss_vals)]
    del engine, plain, staged

    samples_s = BERT_BATCH * BERT_GAS / step_s
    ok = all(np.isfinite(loss_vals)) and loss_vals[-1] < loss_vals[0]
    plain_ok = all(np.isfinite(plain_vals)) and max(gaps) <= TOL_TRAIN_LOSS
    exact = per_micro == {k: float(v)
                          for k, v in BERT_LAUNCHES_PER_MICRO.items()}
    emit({"phase": "bert_training", "model": "bert-large",
          "n_layer": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
          "heads": cfg.num_attention_heads,
          "intermediate": cfg.intermediate_size, "vocab": cfg.vocab_size,
          "n_params": n_params, "micro_batch": BERT_BATCH, "gas": BERT_GAS,
          "seq": BERT_SEQ, "dtype": "bf16 compute, fp32 master weights",
          "mlm_head_dtype": str(mlm_head_dtype(cfg, "cuda")),
          "zero_stage": 0, "setup_s": setup_s,
          "warmup_steps": BERT_WARMUP, "warmup_s": warm_s,
          "steps": BERT_STEPS, "step_ms": step_s * 1e3,
          "samples_per_s": samples_s,
          "tokens_per_s": samples_s * BERT_SEQ,
          "tflops": samples_s * BERT_SEQ * 6.0 * n_params / 1e12,
          "max_memory_allocated_gib": peak / 2 ** 30,
          "micro_batch_host_enqueue_ms": enqueue_s * 1e3,
          "micro_batch_ms": micro_s * 1e3,
          "losses": loss_vals, "loss_falls": ok,
          "plain_route_losses": plain_vals,
          "plain_route_rel_gap": gaps, "tol_plain_rel_gap": TOL_TRAIN_LOSS,
          "launches_per_micro_batch": per_micro,
          "expected_launches_per_micro_batch": BERT_LAUNCHES_PER_MICRO,
          "launches_exact": exact, "card": card})
    emit({"phase": "bert_training_profile", "step_ms": step_s * 1e3,
          **profile, "card": card})
    if not ok:
        raise AssertionError(f"bert_training losses {loss_vals}: not finite "
                             "or not falling on the repeated batch")
    if not plain_ok:
        raise AssertionError(f"bert_training: the plain route's losses "
                             f"{plain_vals} stray from {loss_vals}")
    if not exact:
        raise AssertionError(f"bert_training launches per micro batch "
                             f"{per_micro} != {BERT_LAUNCHES_PER_MICRO}")
    return counts


def bert_oracle(seed, n_layer=2):
    """Phase 24: two BERT-large-wide layers, bf16 parameters as the
    engine holds them, micro batch 16, seq 128: the loss and every
    gradient through the kernels (fused epilogues and flash: K1-K4
    forward and backward) against the plain-torch route (fused_ops
    "off", and an all-ones attention mask, so dense attention with an
    additive mask of zeros: the same function). Within TOL_TRAIN_LOSS /
    TOL_TRAIN_GRAD (relative L2), as training_oracle."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.bert import BertForPreTrainingLM

    cfg = bert_model_config(num_hidden_layers=n_layer)
    kernel = BertForPreTrainingLM(cfg)
    params = {k: v.to(torch.bfloat16) for k, v in kernel.init(seed).items()}
    plain = BertForPreTrainingLM(bert_model_config(
        num_hidden_layers=n_layer, fused_ops="off"))
    batch = {k: torch.as_tensor(v[0], device="cuda")
             for k, v in bert_batch(cfg, seed + 1).items()}
    plain_batch = dict(batch, attention_mask=torch.ones_like(
        batch["input_ids"]))
    reset_counts()
    results = []
    for model, b in ((kernel, batch), (plain, plain_batch)):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = model.loss_fn(p, b, deterministic=True)
        grads = torch.autograd.grad(loss, list(p.values()))
        results.append((float(loss.detach()), grads))
        if model is kernel:
            launched = read_counts()
    torch.cuda.synchronize()
    (lk, gk), (lp, gp) = results
    loss_err = abs(lk - lp) / abs(lp)
    errs = {name: rel_l2(a, b) for name, a, b in zip(params, gk, gp)}
    worst = max(errs, key=errs.get)
    finite = all(torch_isfinite(g) for g in gk)
    ok = finite and loss_err <= TOL_TRAIN_LOSS and \
        errs[worst] <= TOL_TRAIN_GRAD and \
        all(launched[k] > 0 for k in BERT_KERNELS)
    emit({"phase": "bert_oracle", "n_layer": n_layer, "batch": BERT_BATCH,
          "seq": BERT_SEQ, "loss_kernels": lk, "loss_plain": lp,
          "loss_rel_err": loss_err, "tol_loss": TOL_TRAIN_LOSS,
          "grads": len(errs), "worst_grad": worst,
          "worst_grad_rel_l2": errs[worst],
          "median_grad_rel_l2": float(np.median(list(errs.values()))),
          "tol_grad_rel_l2": TOL_TRAIN_GRAD,
          "kernel_route_launches": {k: launched[k] for k in BERT_KERNELS},
          "ok": ok})
    if not ok:
        raise AssertionError("BERT kernel-route loss/gradients disagree "
                             "with the plain-torch route")


# ----------------------------------------------------------------------
# fp16 (phases 25-30): the fp16 forms of K1-K4 at paths A's and B's
# shapes, the fp16 oracle at BERT-large width, path A (BERT-large fp16 +
# LAMB), path B (GPT-2 1.5B fp16 + progressive layer drop), path C (the
# engine's other optimizers and client objects at gpt2-1.5b width)
# ----------------------------------------------------------------------
# fp16 outputs against the twins: one rounding of the same fp32 result,
# up to 2 fp16 ulps (2^-10 relative) where the fp32 values straddle a
# rounding point; gradients by relative L2, the fp16 counterpart of
# GRAD_TOL_BF16 (fp16 keeps 3 more mantissa bits than bf16; the margin
# covers P and dS rounded inside attention)
TOL_F16 = dict(atol=2e-3, rtol=2e-3)
GRAD_TOL_F16 = 5e-3
# the fp16 kernel rows of the `kernels` line, by the bf16 row they
# share a source and a Pallas kernel with
FP16_KERNELS = {
    "flash_attention_fwd_fp16": "flash_attention_fwd",
    "flash_attention_bwd_fused_fp16": "flash_attention_bwd_fused",
    "flash_attention_bwd_fp16": "flash_attention_bwd",
    "fused_bias_residual_layernorm_fwd_fp16":
        "fused_bias_residual_layernorm_fwd",
    "fused_bias_residual_layernorm_bwd_fp16":
        "fused_bias_residual_layernorm_bwd",
    "fused_bias_gelu_fwd_fp16": "fused_bias_gelu_fwd",
    "fused_bias_gelu_bwd_fp16": "fused_bias_gelu_bwd",
    "block_sparse_fwd_sm90_fp16": "block_sparse_fwd_sm90",
    "block_sparse_band_fwd_sm90_fp16": "block_sparse_band_fwd_sm90",
    "block_sparse_bwd_dkv_sm90_fp16": "block_sparse_bwd_dkv_sm90",
    "block_sparse_bwd_dq_sm90_fp16": "block_sparse_bwd_dq_sm90",
}
# the fp16 paths: their launches are the fp16 forms'
FP16_PATHS = ("sparse_attention_fp16", "bert_fp16", "gpt2_fp16_pld",
              "engine_surface_fp16")
# a run ends once this many clean steps follow the last skipped one, or
# fails at the cap
FP16_CLEAN_STEPS = 8
FP16_STEP_CAP = {"bert_fp16": 64, "gpt2_fp16_pld": 64, "surface": 48}
# path C: gpt2-1.5b width, this many layers
SURFACE_N_LAYER = 4


def cold_graph_ms(fn, calls=10):
    """Device time per call of `fn` with the L2 cache flushed before each
    call: a CUDA graph of (zero a 256 MiB buffer, fn) pairs less one of
    the zeroing alone."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def both():
        flush.zero_()
        fn()

    ms = graph_ms(both, calls) - graph_ms(flush.zero_, calls)
    del flush
    return ms


def nonfinite_covered(got, ref):
    """(every position where the twin is non-finite is non-finite in the
    kernel's output, the two masks equal, the twin has any)."""
    import torch
    g, r = ~torch.isfinite(got.float()), ~torch.isfinite(ref.float())
    return bool((g | ~r).all()), bool(torch.equal(g, r)), bool(r.any())


def check_nonfinite(label, got, ref, checks):
    covered, equal, any_ref = nonfinite_covered(got, ref)
    checks.append({"check": f"non-finite where the twin's is, {label}",
                   "covered": covered, "masks_equal": equal,
                   "twin_has_nonfinite": any_ref})
    if not (covered and any_ref):
        raise AssertionError(f"{label}: an inf in the input did not "
                             "reach the kernel's output where it reaches "
                             "the twin's")


def kernel_fp16(peaks, gen):
    """The fp16 forms of K1-fwd, K2-fused, K2's sweeps, K3-fwd, K3-bwd,
    K4-fwd and K4-bwd at path A's shapes (BERT-large: attention [16,
    128, 16, 64] non-causal,
    N 2,048 rows of H 1,024 post-LN (an fp16 and then an fp32 residual,
    fp32 out), bias + erf-GeLU N 2,048 x 4,096) and path B's (gpt2-1.5b:
    attention [11, 1024, 25, 64] causal, N 11,264 x 1,600 all fp16,
    tanh-GeLU N 11,264 x 6,400), every vector fp16 as the engine holds
    the parameters. Each against its twin (TOL_F16, gradients
    GRAD_TOL_F16), then with an inf in the input (y, x, v) or the
    cotangent: non-finite wherever the twin is. Timed back to back
    (`ms`), from a CUDA graph (`graph_ms`), K3 also with the L2 cache
    flushed (`cold_graph_ms`); beside the bound, the plain twin, the bf16
    form at the same shape (graph) and the library call or yardstick:
    SDPA in fp16, `F.layer_norm` and `F.gelu` (graph)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    f16, bf16, f32 = torch.float16, torch.bfloat16, torch.float32
    checks = []
    # K7's fp16 forms are kernel_sparse's
    out = {k: {} for k, base in FP16_KERNELS.items()
           if not base.startswith("block_sparse")}

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")) \
            .to(dtype)

    # --- K1-fwd and K2 ---
    for path, (b, t, h, d, causal) in (("bert_fp16", (16, 128, 16, 64,
                                                      False)),
                                       ("gpt2_fp16_pld", (11, 1024, 25, 64,
                                                          True))):
        label = f"fp16 {'causal' if causal else 'non-causal'} B{b} T{t} " \
            f"H{h} D{d}"
        c = h * d
        qkv = randn((b, t, 3 * c), f16)
        q, k, v = (p.view(b, t, h, d) for p in qkv.split(c, dim=-1))
        sm = 1.0 / d ** 0.5
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = fa._flash_fwd_plain(q, k, v, sm, causal)
        err = check(f"flash fp16 out, {label}", o, ref, TOL_F16, checks)
        check(f"flash fp16 log2-lse, {label}", lse[..., 0], ref_lse,
              TOL_F32, checks)
        v_inf = v.clone()
        v_inf[0, 5, 0, 3] = float("inf")
        check_nonfinite(f"flash fp16 out, inf in v, {label}",
                        fa.flash_attention_with_lse(q, k, v_inf,
                                                    causal=causal)[0],
                        fa._flash_fwd_plain(q, k, v_inf, sm, causal)[0],
                        checks)
        lse2 = lse[..., 0].contiguous()
        dout = randn((b, t, h, d), f16)

        def fwd():
            return fa.flash_attention_with_lse(q, k, v, causal=causal)

        def bwd():
            return fa.flash_attention_backward(q, k, v, o, lse2, dout, None,
                                               sm, causal)

        def sweeps():
            return fa._flash_bwd_launch(q, k, v, o, lse2, dout, None, sm,
                                        causal)

        # the path's backward: K2-fused (T <= 1024), twice, bit for bit
        got = bwd()
        torch.cuda.synchronize()
        ref_g = fa._flash_bwd_fused_plain(q, k, v, o, lse2, dout, None, sm,
                                          causal)
        errs = [check_rel(f"flash fused fp16 bwd d{n}, {label}", x, y,
                          GRAD_TOL_F16, checks)
                for n, x, y in zip("qkv", got, ref_g)]
        if not all(torch.equal(x, y) for x, y in zip(got, bwd())):
            raise AssertionError(f"K2-fused {label}: a second launch "
                                 "differs")
        d_inf = dout.clone()
        d_inf[0, 7, 1, 2] = float("inf")
        for n, x, y in zip("qkv", fa.flash_attention_backward(
                q, k, v, o, lse2, d_inf, None, sm, causal),
                fa._flash_bwd_fused_plain(q, k, v, o, lse2, d_inf, None, sm,
                                          causal)):
            check_nonfinite(f"flash fused fp16 bwd d{n}, inf in dO, {label}",
                            x, y, checks)
        # K2's sweeps in fp16 (the route of T > 1024) on the same inputs
        got_s = sweeps()
        torch.cuda.synchronize()
        errs_s = [check_rel(f"flash fp16 bwd sweeps d{n}, {label}", x, y,
                            GRAD_TOL_F16, checks)
                  for n, x, y in zip("qkv", got_s, fa._flash_bwd_plain(
                      q, k, v, o, lse2, dout, None, sm, causal))]
        pairs = t * (t + 1) // 2 if causal else t * t
        qb, kb, vb, ob, db = (x.to(bf16) for x in (q, k, v, o, dout))
        lseb = fa.flash_attention_with_lse(qb, kb, vb, causal=causal)[1][
            ..., 0].contiguous()
        lib_fwd_ms, lib_fwd, lib_ms, lib_graph_ms = sdpa_ms(q, k, v, dout,
                                                            causal)
        flops = 4.0 * b * h * d * pairs
        nbytes = 4 * b * t * h * d * 2 + b * h * t * 4
        bound_ms, bound_by = bound(flops, peaks["bf16"], nbytes, peaks)
        out["flash_attention_fwd_fp16"][path] = rates(dict(
            max_abs_err=err, ms=time_ms(fwd), graph_ms=graph_ms(fwd),
            plain_ms=time_ms(lambda: fa._flash_fwd_plain(q, k, v, sm,
                                                         causal),
                             iters=3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_fwd_ms, library_graph_ms=lib_fwd,
            bf16_graph_ms=graph_ms(lambda: fa.flash_attention_with_lse(
                qb, kb, vb, causal=causal)),
            library_call="F.scaled_dot_product_attention (fp16)",
            shape=label), flops)
        flops = 10.0 * b * h * d * pairs
        nbytes = 8 * b * t * h * d * 2 + b * h * t * 4
        bound_ms, bound_by = bound(flops, peaks["bf16"], nbytes, peaks)
        sweeps_graph_ms = graph_ms(sweeps)
        out["flash_attention_bwd_fused_fp16"][path] = rates(dict(
            max_abs_err=max(errs), ms=time_ms(bwd), graph_ms=graph_ms(bwd),
            plain_ms=time_ms(lambda: fa._flash_bwd_fused_plain(
                q, k, v, o, lse2, dout, None, sm, causal), iters=3,
                warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms, library_graph_ms=lib_graph_ms,
            sweeps_ms=time_ms(sweeps), sweeps_graph_ms=sweeps_graph_ms,
            bf16_graph_ms=graph_ms(lambda: fa.flash_attention_backward(
                qb, kb, vb, ob, lseb, db, None, sm, causal)),
            library_call="F.scaled_dot_product_attention fwd+bwd less fwd "
                         "(fp16)", shape=label), flops)
        out["flash_attention_bwd_fp16"][path] = rates(dict(
            max_abs_err=max(errs_s), ms=time_ms(sweeps),
            graph_ms=sweeps_graph_ms,
            plain_ms=time_ms(lambda: fa._flash_bwd_plain(
                q, k, v, o, lse2, dout, None, sm, causal), iters=3,
                warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms, library_graph_ms=lib_graph_ms,
            library_call="F.scaled_dot_product_attention fwd+bwd less fwd "
                         "(fp16)", shape=label + " (the sweeps launched "
                         "directly: the path takes K2-fused)"), flops)
        del qkv, q, k, v, o, lse, ref, ref_lse, got, got_s, ref_g, qb, kb, vb
        release()

    # --- K3-fwd and K3-bwd ---
    ln_cases = (
        # (path, label, N, H, residual, out, sum dtypes, timed)
        ("bert_fp16", "post-LN fp16 residual", 2048, 1024, f16, f32, f16,
         True),
        ("bert_fp16_fp32_residual", "post-LN fp32 residual", 2048, 1024,
         f32, f32, f32, True),
        ("gpt2_fp16_pld", "all fp16", 11264, 1600, f16, f16, f16, True),
    )
    for path, form, n, h, r_dt, o_dt, s_dt, _ in ln_cases:
        label = f"fp16 y N{n} H{h} {form}"
        y = randn((n, h), f16, 2.0)
        res = randn((n, h), r_dt, 2.0)
        bias, beta = (randn((h,), f16, 0.1) for _ in range(2))
        gamma = (1.0 + 0.1 * torch.randn((h,), generator=gen,
                                         device="cuda")).to(f16)

        def fwd():
            return fo.fused_bias_residual_layernorm(
                y, bias, res, gamma, beta, eps=1e-5, out_dtype=o_dt,
                sum_dtype=s_dt)

        o, s = fwd()
        torch.cuda.synchronize()
        ro, rs = fo._ln_fwd_math(y, bias, res, gamma, beta, 1e-5)
        err = check(f"ln fp16 out, {label}", o, ro.to(o_dt),
                    TOL_F16 if o_dt == f16 else TOL_F32, checks)
        check(f"ln fp16 sum, {label}", s, rs.to(s_dt),
              TOL_F16 if s_dt == f16 else TOL_F32, checks)
        y_inf = y.clone()
        y_inf[3, 17] = float("inf")
        check_nonfinite(
            f"ln fp16 out, inf in y, {label}",
            fo.fused_bias_residual_layernorm(
                y_inf, bias, res, gamma, beta, eps=1e-5, out_dtype=o_dt,
                sum_dtype=s_dt)[0],
            fo._ln_fwd_math(y_inf, bias, res, gamma, beta, 1e-5)[0].to(o_dt),
            checks)
        item = 2
        nbytes = n * h * (2 + r_dt.itemsize + o_dt.itemsize +
                          s_dt.itemsize) + 3 * h * item
        bound_ms, bound_by = bound(10 * n * h, peaks["fp32"], nbytes, peaks)
        yb, rb = y.to(bf16), res.to(bf16 if r_dt == f16 else f32)
        vb = [x.to(bf16) for x in (bias, gamma, beta)]
        yard_y = y.clone()
        out["fused_bias_residual_layernorm_fwd_fp16"][path] = rates(dict(
            max_abs_err=err, ms=time_ms(fwd), graph_ms=graph_ms(fwd),
            cold_graph_ms=cold_graph_ms(fwd),
            plain_ms=time_ms(lambda: fo._ln_fwd_math(y, bias, res, gamma,
                                                     beta, 1e-5)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            yardstick="F.layer_norm of y alone (fp16)",
            yardstick_graph_ms=graph_ms(lambda: F.layer_norm(
                yard_y, (h,), gamma, beta, 1e-5)),
            bf16_graph_ms=graph_ms(lambda: fo.fused_bias_residual_layernorm(
                yb, vb[0], rb, vb[1], vb[2], eps=1e-5,
                out_dtype=bf16 if o_dt == f16 else f32,
                sum_dtype=bf16 if s_dt == f16 else f32)),
            shape=label), 10 * n * h)

        dout = randn((n, h), o_dt)
        dsum = randn((n, h), s_dt)

        def bwd():
            return fo.fused_bias_residual_layernorm_backward(
                s, gamma, dout, dsum, eps=1e-5, dx_dtype=f16)

        got = bwd()
        torch.cuda.synchronize()
        ds, dg, db = fo._ln_bwd_math(s, gamma, dout, dsum, 1e-5)
        ref = (ds.to(f16), ds.sum(0), dg.sum(0), db.sum(0))
        errs = [check_rel(f"ln fp16 bwd {name}, {label}", x, r,
                          GRAD_TOL_F16 if name == "dx" else GRAD_TOL_F32 * 10,
                          checks)
                for name, x, r in zip(("dx", "dbias", "dgamma", "dbeta"),
                                      got, ref)]
        d_inf = dout.clone()
        d_inf[9, 4] = float("inf")
        got_inf = fo.fused_bias_residual_layernorm_backward(
            s, gamma, d_inf, dsum, eps=1e-5, dx_dtype=f16)
        ref_inf = fo._ln_bwd_math(s, gamma, d_inf, dsum, 1e-5)
        check_nonfinite(f"ln fp16 bwd dx, inf in dout, {label}", got_inf[0],
                        ref_inf[0].to(f16), checks)
        check_nonfinite(f"ln fp16 bwd dgamma, inf in dout, {label}",
                        got_inf[2], ref_inf[1].sum(0), checks)
        nbytes = n * h * (s_dt.itemsize + o_dt.itemsize + s_dt.itemsize +
                          2) + h * 2 + 3 * h * 4
        bound_ms, bound_by = bound(22 * n * h, peaks["fp32"], nbytes, peaks)
        sb = s.to(bf16 if s_dt == f16 else f32)
        ob = dout.to(bf16 if o_dt == f16 else f32)
        sumb = dsum.to(sb.dtype)
        y16 = yard_y.clone().requires_grad_(True)
        g_lib = dout.to(f16)

        def lib_fwd():
            return F.layer_norm(y16, (h,), gamma, beta, 1e-5)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), (y16,), g_lib)

        out["fused_bias_residual_layernorm_bwd_fp16"][path] = rates(dict(
            max_abs_err=errs[0], ms=time_ms(bwd), graph_ms=graph_ms(bwd),
            cold_graph_ms=cold_graph_ms(bwd),
            plain_ms=time_ms(lambda: fo._ln_bwd_math(s, gamma, dout, dsum,
                                                     1e-5)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            yardstick="F.layer_norm backward of y alone (fp16; fwd+bwd "
                      "less fwd)",
            yardstick_graph_ms=graph_ms(lib_fwd_bwd) - graph_ms(lib_fwd),
            bf16_graph_ms=graph_ms(
                lambda: fo.fused_bias_residual_layernorm_backward(
                    sb, gamma.to(bf16), ob, sumb, eps=1e-5,
                    dx_dtype=bf16)),
            shape=label), 22 * n * h)
        del y, res, o, s, ro, rs, dout, dsum, got, ref, y16
        release()

    # --- K4-fwd and K4-bwd ---
    for path, n, w, approx in (("bert_fp16", 2048, 4096, False),
                               ("gpt2_fp16_pld", 11264, 6400, True)):
        label = f"fp16 N{n} W{w} {'tanh' if approx else 'erf'}"
        x = randn((n, w), f16, 2.0)
        bias = randn((w,), f16, 0.1)

        def fwd():
            return fo.fused_bias_gelu_with_sum(x, bias, approximate=approx)

        o, s = fwd()
        torch.cuda.synchronize()
        ro, _ = fo._gelu_fwd_math(x, bias, approx)
        err = check(f"gelu fp16 out, {label}", o, ro.to(f16), TOL_F16,
                    checks)
        x_inf = x.clone()
        x_inf[2, 9] = float("inf")
        check_nonfinite(f"gelu fp16 out, inf in x, {label}",
                        fo.fused_bias_gelu(x_inf, bias, approximate=approx),
                        fo._gelu_fwd_math(x_inf, bias, approx)[0].to(f16),
                        checks)
        nbytes = 3 * n * w * 2 + w * 2
        bound_ms, bound_by = bound(20 * n * w, peaks["fp32"], nbytes, peaks)
        xb, bb = x.to(bf16), bias.to(bf16)
        xl = x.clone()
        how = "tanh" if approx else "none"
        out["fused_bias_gelu_fwd_fp16"][path] = rates(dict(
            max_abs_err=err, ms=time_ms(fwd), graph_ms=graph_ms(fwd),
            plain_ms=time_ms(lambda: fo._gelu_fwd_math(x, bias, approx)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            yardstick=f"F.gelu(x, approximate={how!r}) of x alone (fp16)",
            yardstick_graph_ms=graph_ms(lambda: F.gelu(xl, approximate=how)),
            bf16_graph_ms=graph_ms(lambda: fo.fused_bias_gelu(
                xb, bb, approximate=approx)),
            shape=label), 20 * n * w)
        dout = randn((n, w), f16)

        def bwd():
            return fo.fused_bias_gelu_backward(s, dout, approximate=approx)

        got = bwd()
        torch.cuda.synchronize()
        rdx = fo._gelu_bwd_math(s, dout, approx)
        errs = [check_rel(f"gelu fp16 bwd dx, {label}", got[0], rdx.to(f16),
                          GRAD_TOL_F16, checks),
                check_rel(f"gelu fp16 bwd dbias, {label}", got[1],
                          rdx.sum(0), GRAD_TOL_F32 * 10, checks)]
        d_inf = dout.clone()
        d_inf[4, 1] = float("inf")
        got_inf = fo.fused_bias_gelu_backward(s, d_inf, approximate=approx)
        ref_inf = fo._gelu_bwd_math(s, d_inf, approx)
        check_nonfinite(f"gelu fp16 bwd dx, inf in dout, {label}",
                        got_inf[0], ref_inf.to(f16), checks)
        check_nonfinite(f"gelu fp16 bwd dbias, inf in dout, {label}",
                        got_inf[1], ref_inf.sum(0), checks)
        nbytes = 3 * n * w * 2 + w * 4
        bound_ms, bound_by = bound(25 * n * w, peaks["fp32"], nbytes, peaks)
        sb, db = s.to(bf16), dout.to(bf16)
        xg = x.clone().requires_grad_(True)

        def lib_fwd():
            return F.gelu(xg, approximate=how)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), (xg,), dout)

        out["fused_bias_gelu_bwd_fp16"][path] = rates(dict(
            max_abs_err=errs[0], ms=time_ms(bwd), graph_ms=graph_ms(bwd),
            plain_ms=time_ms(lambda: fo._gelu_bwd_math(s, dout, approx)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            yardstick=f"F.gelu(approximate={how!r}) backward of x alone "
                      "(fp16; fwd+bwd less fwd)",
            yardstick_graph_ms=graph_ms(lib_fwd_bwd) - graph_ms(lib_fwd),
            bf16_graph_ms=graph_ms(lambda: fo.fused_bias_gelu_backward(
                sb, db, approximate=approx)),
            shape=label), 25 * n * w)
        del x, o, s, ro, dout, got, rdx, xb, xg
        release()
    return out, checks


def param_checksum(engine):
    """One int64 device scalar over the bits of every parameter, master
    and optimizer-state tensor of the engine (no host read): equal
    before and after a step exactly when no bit moved, up to the
    vanishing chance of compensating changes."""
    import torch
    state = engine.state
    tensors = list(state.params.values()) + list(state.master or []) + \
        engine._state_tensors(state.opt_state)
    total = torch.zeros((), dtype=torch.int64, device="cuda")
    for i, t in enumerate(tensors):
        if t.dtype == torch.float16 or t.dtype == torch.bfloat16:
            v = t.view(torch.int16)
        elif t.dtype == torch.float32:
            v = t.view(torch.int32)
        else:
            v = t
        # position-weighted so that two swapped values still differ
        total += (v.reshape(-1).to(torch.int64) * (i + 1)).sum() + \
            v.reshape(-1)[::97].to(torch.int64).cumsum(0).sum()
    return total


def replay_scale(flags, init_scale, window=1000, shift=2, min_scale=1.0):
    """The JAX package's `update_loss_scale` (runtime/fp16/loss_scaler.py
    there) replayed on the host over the overflow flags: the scale after
    each step."""
    scale, good, hyst, out = float(init_scale), 0, shift, []
    for overflow in flags:
        if overflow:
            if hyst <= 1:
                scale, hyst = max(scale / 2.0, min_scale), shift
            else:
                hyst -= 1
            good = 0
        else:
            good += 1
            if good % window == 0:
                scale, hyst = scale * 2.0, shift
        out.append(scale)
    return out


def run_fp16_path(name, engine, staged, cap, card, expect_per_step=None,
                  tokens_per_step=None, extra=None, debug_sync=True):
    """Steps `engine` on the staged batch until FP16_CLEAN_STEPS clean
    steps follow the last skipped one (at most `cap`), reading the
    skipped count after each step. Records per step the loss, the scale
    and the bit checksum of every parameter, master and optimizer-state
    tensor; then the gates: finite losses after the last skip, the last
    clean loss below the first, every checksum unchanged across a
    skipped step, the scale trajectory equal to the JAX automaton
    replayed on the same overflow flags, and (`expect_per_step`) the
    exact launches of each fp16 kernel per step. Then a window of 3
    steps without reads (step ms), a profile of one step (idle share)
    and, with `debug_sync`, one step under
    torch.cuda.set_sync_debug_mode("error") (and, should anything in
    train_batch synchronize, the update alone under it). Returns the
    launch counts of the recorded steps and the emitted row."""
    import numpy as np
    import torch
    args = engine.dynamic_loss_scale_args() or {}
    init = engine.loss_scale()
    losses, scales, skipped, sums = [], [], [], [param_checksum(engine)]
    clean_run = 0
    reset_counts()
    t0 = time.perf_counter()
    while len(losses) < cap and clean_run < FP16_CLEAN_STEPS:
        losses.append(engine.train_batch(batch=staged).float())
        scales.append(engine.state.scale.loss_scale.clone())
        sums.append(param_checksum(engine))
        skipped.append(engine.skipped_steps)   # reads the device
        prev = skipped[-2] if len(skipped) > 1 else 0
        clean_run = clean_run + 1 if skipped[-1] == prev else 0
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    n = len(losses)
    flags = [skipped[i] > (skipped[i - 1] if i else 0) for i in range(n)]
    loss_vals = [float(x) for x in torch.stack(losses).cpu()]
    scale_vals = [float(x) for x in torch.stack(scales).cpu()]
    sum_vals = [int(x) for x in torch.stack(sums).cpu()]
    last_skip = max([i for i in range(n) if flags[i]], default=-1)
    clean = loss_vals[last_skip + 1:]
    unchanged = all(sum_vals[i + 1] == sum_vals[i] for i in range(n)
                    if flags[i])
    moved = all(sum_vals[i + 1] != sum_vals[i] for i in range(n)
                if not flags[i])
    jax_scales = replay_scale(flags, init, args.get("scale_window", 1000),
                              args.get("delayed_shift", 2),
                              args.get("min_scale", 1.0))
    per_step = {k: counts[k] / n
                for k in (expect_per_step or TRAINING_KERNELS)}
    exact = expect_per_step is None or per_step == {
        k: float(v) for k, v in expect_per_step.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        engine.train_batch(batch=staged)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated()
    profile = profile_steps(lambda: engine.train_batch(batch=staged), 1)
    sync_check = None
    if debug_sync:
        sync_check = sync_debug_step(engine, staged)
    row = dict(phase=name, steps=n, run_s=run_s, skipped_steps=sum(flags),
               last_skip=last_skip, losses=loss_vals,
               clean_losses=len(clean), scales=scale_vals,
               jax_automaton_scales=jax_scales,
               scales_match_jax_automaton=scale_vals == jax_scales,
               params_unchanged_across_skips=unchanged,
               params_moved_on_clean_steps=moved,
               step_ms=step_s * 1e3,
               tokens_per_s=tokens_per_step / step_s
               if tokens_per_step else None,
               max_memory_allocated_gib=peak / 2 ** 30,
               device_idle_share=profile.get("device_idle_share"),
               launches_per_step=per_step,
               expected_launches_per_step=expect_per_step,
               launches_exact=exact, sync_debug=sync_check, card=card,
               **(extra or {}))
    emit(row)
    emit({"phase": name + "_profile", "step_ms": step_s * 1e3, **profile,
          "card": card})
    ok = len(clean) >= FP16_CLEAN_STEPS and all(np.isfinite(clean)) and \
        clean[FP16_CLEAN_STEPS - 1] < clean[0]
    if not ok:
        raise AssertionError(f"{name}: no {FP16_CLEAN_STEPS} clean steps "
                             f"with finite, falling losses in {n}: "
                             f"{loss_vals} (skips {flags})")
    if not (unchanged and moved):
        raise AssertionError(f"{name}: a skipped step moved a bit, or a "
                             "clean one moved none")
    if scale_vals != jax_scales:
        raise AssertionError(f"{name}: scales {scale_vals} != the JAX "
                             f"automaton's {jax_scales}")
    if not exact:
        raise AssertionError(f"{name}: launches per step {per_step} != "
                             f"{expect_per_step}")
    if sync_check is not None and not sync_check["update_ok"]:
        raise AssertionError(f"{name}: the fp16 update synchronized: "
                             f"{sync_check}")
    return counts, row


def sync_debug_step(engine, staged):
    """One train_batch under torch.cuda.set_sync_debug_mode("error"); if
    anything in it synchronizes, its message, and then one step with
    only `_unscale_clip_and_update` (the unscale, the overflow vote, the
    masked update and the scale automaton) under the mode."""
    import torch
    result = {"train_batch_ok": True, "train_batch_error": None}
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        engine.train_batch(batch=staged)
    except RuntimeError as e:
        result.update(train_batch_ok=False,
                      train_batch_error=str(e).splitlines()[0][:300])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if result["train_batch_ok"]:
        result["update_ok"] = True
        return result
    update = engine._unscale_clip_and_update

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return update(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine._unscale_clip_and_update = guarded
    try:
        engine.train_batch(batch=staged)
        result["update_ok"] = True
    except RuntimeError as e:
        result.update(update_ok=False,
                      update_error=str(e).splitlines()[0][:300])
    finally:
        del engine._unscale_clip_and_update
    return result


def bert_fp16_ds_config():
    """bench_bert_large's ds_config with fp16 (loss_scale 0: dynamic,
    the JAX defaults: 2^32, window 1000, hysteresis 2, min 1) in place of
    bf16 and examples/ds_config_bert.json's optimizer block verbatim."""
    return {"train_micro_batch_size_per_gpu": BERT_BATCH,
            "gradient_accumulation_steps": BERT_GAS,
            "steps_per_print": 1000,
            "fp16": {"enabled": True, "loss_scale": 0},
            "optimizer": {"type": "Lamb",
                          "params": {"lr": 0.002, "max_coeff": 10.0,
                                     "min_coeff": 0.01,
                                     "weight_decay": 0.01}}}


def bert_fp16_lamb(seed, card):
    """Path A (phase 27): BERT-large pretraining (bench_bert_large: 24
    post-LN layers, hidden 1024, 16 heads, vocab 30,522, micro batch 16,
    gas 16, seq 128, dropout 0) in fp16 with LAMB through initialize ->
    train_batch on one repeated batch of its recipe, from the scale
    2^32 until 8 clean steps follow the last skip (`run_fp16_path`).
    Reports samples/s and TFLOP/s too. Returns the launch counts."""
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.bert import BertForPreTrainingLM

    cfg = bert_model_config(fp16=True, bf16=False)
    t0 = time.perf_counter()
    model = BertForPreTrainingLM(cfg)
    params = model.init(seed)
    n_params = sum(p.numel() for p in params.values())
    engine, _, _, _ = dst.initialize(model=model, model_parameters=params,
                                     config=bert_fp16_ds_config())
    del params
    staged = engine.stage_batch(bert_batch(cfg, seed))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counts, row = run_fp16_path(
        "bert_fp16", engine, staged, FP16_STEP_CAP["bert_fp16"], card,
        expect_per_step={k: v * BERT_GAS
                         for k, v in BERT_LAUNCHES_PER_MICRO.items()},
        tokens_per_step=BERT_BATCH * BERT_GAS * BERT_SEQ,
        extra={"model": "bert-large", "n_params": n_params,
               "setup_s": setup_s, "micro_batch": BERT_BATCH,
               "gas": BERT_GAS, "seq": BERT_SEQ,
               "dtype": "fp16 compute, fp32 masters and moments",
               "optimizer": "Lamb (examples/ds_config_bert.json)"})
    samples_s = BERT_BATCH * BERT_GAS / (row["step_ms"] / 1e3)
    emit({"phase": "bert_fp16_rates", "samples_per_s": samples_s,
          "tflops": samples_s * BERT_SEQ * 6.0 * n_params / 1e12,
          "card": card})
    del engine, model, staged
    return counts


def gpt2_fp16_launches(n_layer, pld):
    """Launches per gpt2 training step under full-block remat (forward
    and recompute): the boundary-fused carry runs K3-fwd for ln_1 and
    ln_2 of every block and ln_f; under PLD the plain carry runs it for
    ln_2 only (ln_1 and ln_f plain)."""
    return {"flash_attention_fwd": 2 * n_layer,
            "flash_attention_bwd_fused": n_layer,
            "fused_bias_residual_layernorm_fwd":
                2 * n_layer if pld else 4 * n_layer + 1,
            "fused_bias_residual_layernorm_bwd":
                n_layer if pld else 2 * n_layer + 1,
            "fused_bias_gelu_fwd": 2 * n_layer,
            "fused_bias_gelu_bwd": n_layer}


def gpt2_fp16_pld(seed, card):
    """Path B (phase 28): the training flagship (bench_gpt2_15b: gpt2-1.5b,
    micro batch 11, seq 1024, ZeRO-2, AdamW, full-block remat, dropout 0)
    in fp16 ({"enabled": true}: fp16 parameters, fp32 masters and
    moments, the dynamic scale from 2^32) with progressive layer drop
    (theta 0.5, gamma 0.001) through initialize -> train_batch on one
    repeated batch until 8 clean steps follow the last skip. Under PLD
    the stack keeps the plain carry, so K3-fwd runs its in-block form.
    Returns the launch counts."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM

    cfg = train_config(dtype=torch.float16, param_dtype=torch.float32)
    ds_config = flagship_ds_config(TRAIN_BATCH)
    del ds_config["bf16"]
    ds_config["fp16"] = {"enabled": True}
    ds_config["progressive_layer_drop"] = {"enabled": True, "theta": 0.5,
                                           "gamma": 0.001}
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg)
    engine, _, _, _ = dst.initialize(model=model,
                                     model_parameters=model.init(seed),
                                     config=ds_config)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    staged = engine.stage_batch({"input_ids": ids})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counts, row = run_fp16_path(
        "gpt2_fp16_pld", engine, staged, FP16_STEP_CAP["gpt2_fp16_pld"],
        card, expect_per_step=gpt2_fp16_launches(cfg.n_layer, pld=True),
        tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
        extra={"model": "gpt2-1.5b", "n_layer": cfg.n_layer,
               "setup_s": setup_s, "micro_batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "zero_stage": 2, "remat": "full block",
               "dtype": "fp16 parameters, fp32 masters and moments"})
    emit({"phase": "gpt2_fp16_pld_theta", "steps": engine.global_steps,
          "pld_theta": engine.pld_theta()})
    del engine, model, staged
    return counts


def surface_cases():
    """Path C's configurations: (name, ds_config extra, client
    optimizer, client scheduler), built fresh per case."""
    import torch
    from deepspeed_tpu_torch.ops.lamb import FusedLamb
    from deepspeed_tpu_torch.runtime import lr_schedules
    from deepspeed_tpu_torch.runtime.bf16_optimizer import adamw_bf16
    from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam
    return (
        ("sgd_momentum", {"optimizer": {"type": "SGD", "params": {
            "lr": 0.05, "momentum": 0.9}}}, None, None),
        ("onebit_adam", {"optimizer": {"type": "OneBitAdam", "params": {
            "lr": 1e-4, "weight_decay": 0.01, "freeze_step": 2}}}, None,
         None),
        ("client_fused_lamb", {}, FusedLamb(lr=2e-3, weight_decay=0.01),
         None),
        ("client_onebit_adam", {}, OnebitAdam(lr=1e-4, freeze_step=2), None),
        ("client_transform_and_scheduler", {},
         adamw_bf16(learning_rate=1e-4, weight_decay=0.01,
                    state_dtype=torch.float32),
         lr_schedules.WarmupLR(lr_schedules._OptimizerShim(lr=1e-4),
                               warmup_max_lr=1e-4, warmup_num_steps=10)),
        ("adamw_config_scheduler", {
            "optimizer": {"type": "AdamW", "params": {
                "lr": 1e-4, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_max_lr": 1e-4, "warmup_num_steps": 10}}}, None,
         None),
    )


def engine_surface_fp16(seed, card):
    """Path C (phase 29): at gpt2-1.5b width with SURFACE_N_LAYER layers,
    micro batch 11, seq 1024, fp16 from the scale 2^20: SGD with
    momentum, 1-bit Adam across freeze_step 2, the FusedLamb and
    OnebitAdam facades as client optimizers, a client transform
    (adamw_bf16 with fp32 moments) with a client WarmupLR scheduler, and
    AdamW with the config's WarmupLR; each until 8 clean steps follow
    its last skip, with run_fp16_path's gates (the sync check on the
    config scheduler's case: a client scheduler reads the overflow flag
    every step by design). Returns the launch counts over all cases."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM

    cfg = train_config(dtype=torch.float16, param_dtype=torch.float32,
                       n_layer=SURFACE_N_LAYER)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    total = None
    for name, extra, client, sched in surface_cases():
        ds_config = {"train_micro_batch_size_per_gpu": TRAIN_BATCH,
                     "steps_per_print": 1000,
                     "fp16": {"enabled": True, "initial_scale_power": 20},
                     **extra}
        model = GPT2ForCausalLM(cfg)
        engine, _, _, _ = dst.initialize(
            model=model, model_parameters=model.init(seed),
            optimizer=client, lr_scheduler=sched, config=ds_config)
        staged = engine.stage_batch({"input_ids": ids})
        counts, _ = run_fp16_path(
            f"surface_{name}", engine, staged, FP16_STEP_CAP["surface"],
            card, expect_per_step=gpt2_fp16_launches(cfg.n_layer, pld=False),
            tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
            extra={"n_layer": cfg.n_layer, "width": "gpt2-1.5b",
                   "optimizer": type(engine.optimizer_transform).__name__
                   if client is not None else extra["optimizer"]["type"],
                   "client_scheduler": sched is not None},
            debug_sync=name == "adamw_config_scheduler")
        total = counts if total is None else \
            {k: total[k] + v for k, v in counts.items()}
        del engine, model, staged
        release()
    return total


def bert_fp16_oracle(seed, n_layer=2):
    """Phase 26: two BERT-large-wide layers, micro batch 16, seq 128:
    one micro batch's loss and every gradient on the fp16 kernel route
    (fp16 parameters as the engine holds them; K1-K4's fp16 forms; the
    loss scaled by 2^10 before the backward and the gradients unscaled in
    fp32, as the engine does) against the fp32 twin route (fp32
    parameters, fused_ops "off", an all-ones mask: dense attention, the
    same function). Within TOL_TRAIN_LOSS / TOL_TRAIN_GRAD (relative
    L2), the bf16 oracles' bounds, which fp16's finer rounding meets."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.bert import BertForPreTrainingLM

    cfg = bert_model_config(num_hidden_layers=n_layer, fp16=True, bf16=False)
    kernel = BertForPreTrainingLM(cfg)
    params = kernel.init(seed)
    plain = BertForPreTrainingLM(bert_model_config(
        num_hidden_layers=n_layer, fused_ops="off", bf16=False))
    batch = {k: torch.as_tensor(v[0], device="cuda")
             for k, v in bert_batch(cfg, seed + 1).items()}
    plain_batch = dict(batch, attention_mask=torch.ones_like(
        batch["input_ids"]))
    scale = 2.0 ** 10
    reset_counts()
    results = []
    for model, b, dtype, s in ((kernel, batch, torch.float16, scale),
                               (plain, plain_batch, torch.float32, 1.0)):
        p = {k: v.to(dtype).requires_grad_(True) for k, v in params.items()}
        loss = model.loss_fn(p, b, deterministic=True)
        grads = torch.autograd.grad(loss * s, list(p.values()))
        results.append((float(loss.detach()),
                        [g.float() / s for g in grads]))
        if model is kernel:
            launched = read_counts()
    torch.cuda.synchronize()
    (lk, gk), (lp, gp) = results
    loss_err = abs(lk - lp) / abs(lp)
    errs = {name: rel_l2(a, b) for name, a, b in zip(params, gk, gp)}
    worst = max(errs, key=errs.get)
    finite = all(torch_isfinite(g) for g in gk)
    ok = finite and loss_err <= TOL_TRAIN_LOSS and \
        errs[worst] <= TOL_TRAIN_GRAD and \
        all(launched[k] > 0 for k in BERT_KERNELS)
    emit({"phase": "bert_fp16_oracle", "n_layer": n_layer,
          "batch": BERT_BATCH, "seq": BERT_SEQ, "loss_fp16_kernels": lk,
          "loss_fp32_plain": lp, "loss_rel_err": loss_err,
          "tol_loss": TOL_TRAIN_LOSS, "grads": len(errs),
          "worst_grad": worst, "worst_grad_rel_l2": errs[worst],
          "median_grad_rel_l2": float(np.median(list(errs.values()))),
          "tol_grad_rel_l2": TOL_TRAIN_GRAD, "loss_scale": scale,
          "kernel_route_launches": {k: launched[k] for k in BERT_KERNELS},
          "ok": ok})
    if not ok:
        raise AssertionError("BERT fp16 kernel-route loss/gradients "
                             "disagree with the fp32 plain route")


# the dense attention kernels (K1-fwd and K5, K2's sweeps, its delta
# pre-pass and given-delta shift), by kernel-name substring
ATTENTION_KERNELS = ("flash_fwd_kernel", "flash_bwd_", "delta_kernel")
# device-time groups of the profiles, by kernel-name substring
KERNEL_GROUPS = (
    ("port kernels: attention", ATTENTION_KERNELS),
    ("port kernels: epilogues", ("ln_fwd_kernel", "ln_bwd_kernel",
                                 "gelu_fwd_kernel", "gelu_bwd_kernel")),
    ("port kernels: MoE dispatch/combine", ("gather_rows_kernel",
                                            "combine_rows_kernel")),
    ("port kernels: int8 GEMM (K6)", ("qmm_kernel",)),
    ("port kernels: block-sparse attention (K7)", ("bs_fwd_kernel",
                                                   "band_fwd_kernel",
                                                   "bs_bwd_")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("casts and copies", ("copy_kernel",)),
    ("elementwise and reductions", ("elementwise", "reduce_kernel")),
)


def profile_steps(run, steps):
    """torch.profiler over one call of `run`, which takes `steps` steps:
    device busy time per step from the CUDA kernel records, the host
    wall time per step, the device's idle share, and the kernels that
    take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or busy_us <= 0:
        return {"device_time": "not measured (no CUDA kernel records)",
                "wall_ms_per_step": wall_s * 1e3 / steps}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    groups = {}
    for e in kernels:
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in e.key for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + \
            e.self_device_time_total / 1e3 / steps
    attention = {e.key[:60]: e.self_device_time_total / 1e3 / steps
                 for e in kernels
                 if any(k in e.key for k in ATTENTION_KERNELS)}
    return {
        "steps": steps,
        "wall_ms_per_step": wall_s * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "attention_device_ms_per_step": sum(attention.values()),
        "attention_device_ms_per_step_by_kernel": attention,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "device_ms_per_step_by_group": groups,
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": e.self_device_time_total / 1e3
                         / steps,
                         "launches_per_step": e.count / steps}
                        for e in top]}


def _moe_kernels():
    import importlib
    return importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")


def reset_counts():
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    fa.reset_launch_count()
    fo.reset_launch_counts()
    _moe_kernels().reset_launch_counts()
    _qmm().reset_launch_count()
    _sparse().reset_launch_counts()


def read_counts():
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    fd = _moe_kernels()
    bsa = _sparse()
    return {"moe_dispatch": fd.gather_rows.launches,
            "moe_combine": fd.combine_rows.launches,
            "flash_attention_fwd": fa.flash_attention_with_lse.launches,
            "flash_attention_bwd": fa.flash_attention_backward.launches,
            "flash_attention_bwd_fused":
                fa._flash_bwd_fused_launch.launches,
            "flash_attention_merge": fa.flash_attention_merge.launches,
            "fused_bias_residual_layernorm_fwd":
                fo.fused_bias_residual_layernorm.launches,
            "fused_bias_residual_layernorm_bwd":
                fo.fused_bias_residual_layernorm_backward.launches,
            "fused_bias_gelu_fwd": fo.fused_bias_gelu.launches,
            "fused_bias_gelu_bwd": fo.fused_bias_gelu_backward.launches,
            "quantized_matmul": _qmm().quantized_matmul.launches,
            "block_sparse_fwd_sm90": bsa._bs_fwd_sm90_launch.launches,
            "block_sparse_fwd": bsa._bs_fwd_launch.launches,
            "block_sparse_band_fwd_sm90": bsa._band_fwd_sm90_launch.launches,
            "block_sparse_band_fwd": bsa._band_fwd_launch.launches,
            "block_sparse_bwd_dkv": bsa._bs_bwd_dkv_launch.launches,
            "block_sparse_bwd_dq": bsa._bs_bwd_dq_launch.launches,
            "block_sparse_bwd_dkv_sm90":
                bsa._bs_bwd_dkv_sm90_launch.launches,
            "block_sparse_bwd_dq_sm90": bsa._bs_bwd_dq_sm90_launch.launches}


KERNELS_BF16 = (
    ("flash_attention_fwd",
     "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:262", kernel_flash),
    ("fused_bias_residual_layernorm_fwd",
     "deepspeed_tpu_torch/ops/csrc/fused_ln_fwd.cu",
     "deepspeed_tpu/ops/transformer/fused_ops.py:246", kernel_ln),
    ("fused_bias_gelu_fwd",
     "deepspeed_tpu_torch/ops/csrc/fused_gelu_fwd.cu",
     "deepspeed_tpu/ops/transformer/fused_ops.py:282", kernel_gelu),
    # K2-fused: the one-pass backward at T <= 1024 (every training path)
    ("flash_attention_bwd_fused",
     "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd_fused.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:606",
     kernel_flash_bwd_fused),
    # K2's sweeps: longer sequences (the ring leg), fp32, head dims 192/256
    ("flash_attention_bwd",
     "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:513",
     kernel_flash_bwd),
    ("fused_bias_residual_layernorm_bwd",
     "deepspeed_tpu_torch/ops/csrc/fused_ln_bwd.cu",
     "deepspeed_tpu/ops/transformer/fused_ops.py:254", kernel_ln_bwd),
    ("fused_bias_gelu_bwd",
     "deepspeed_tpu_torch/ops/csrc/fused_gelu_bwd.cu",
     "deepspeed_tpu/ops/transformer/fused_ops.py:288", kernel_gelu_bwd),
    # K8: one phase (kernel_moe) checks and times both gathers
    ("moe_dispatch", "deepspeed_tpu_torch/ops/csrc/moe_dispatch.cu",
     "deepspeed_tpu/moe/fused_dispatch.py:115", None),
    ("moe_combine", "deepspeed_tpu_torch/ops/csrc/moe_dispatch.cu",
     "deepspeed_tpu/moe/fused_dispatch.py:183", None),
    ("quantized_matmul", "deepspeed_tpu_torch/ops/csrc/quantized_matmul.cu",
     "deepspeed_tpu/ops/transformer/quantized_matmul.py:207", kernel_qmm),
    # K7: one phase (kernel_sparse) checks and times all of them.
    # K7-fwd: the Hopper body (bf16 at head dims 64 and 128, the sparse
    # path's) and the WMMA body (fp32)
    ("block_sparse_fwd_sm90",
     "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:160",
     None),
    ("block_sparse_fwd",
     "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:160",
     None),
    # K7-band: the Hopper body (bf16 at head dims 64 and 128, the sparse
    # path's) and the WMMA body (fp32)
    ("block_sparse_band_fwd_sm90",
     "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:552",
     None),
    ("block_sparse_band_fwd",
     "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:552",
     None),
    # K7-dkv and K7-dq: the Hopper sweeps (bf16 at head dims 64 and 128,
    # the sparse path's) and the WMMA bodies (fp32)
    ("block_sparse_bwd_dkv_sm90",
     "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:229",
     None),
    ("block_sparse_bwd_dq_sm90",
     "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:279",
     None),
    ("block_sparse_bwd_dkv",
     "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:229",
     None),
    ("block_sparse_bwd_dq",
     "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:279",
     None),
    # K5: the forward kernels' merge mode (packed twin :337); kernel_merge
    # checks and times it
    ("flash_attention_merge",
     "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:262", None),
)
KERNELS = KERNELS_BF16 + tuple(
    # the fp16 forms of K1-K4 (the same sources and Pallas kernels);
    # kernel_fp16 checks and times them
    (f16, next(k[1] for k in KERNELS_BF16 if k[0] == base),
     next(k[2] for k in KERNELS_BF16 if k[0] == base), None)
    for f16, base in FP16_KERNELS.items())
# the kernels each path runs: serving the forward ones, dense training
# K1-K4 (the backward K2-fused: every training path's T is one tile,
# <= 1024), MoE training K1-K4 and K8; the quantized paths add K6
SERVING_KERNELS = ("flash_attention_fwd", "fused_bias_residual_layernorm_fwd",
                   "fused_bias_gelu_fwd")
TRAINING_KERNELS = SERVING_KERNELS + (
    "flash_attention_bwd_fused", "fused_bias_residual_layernorm_bwd",
    "fused_bias_gelu_bwd")
# what the paths at T <= 1024 never launch: K2's sweeps
FUSED_ABSENT = ("flash_attention_bwd",)
MOE_KERNELS = TRAINING_KERNELS + ("moe_dispatch", "moe_combine")
QUANT_KERNELS = TRAINING_KERNELS + ("quantized_matmul",)
MOE_QUANT_KERNELS = MOE_KERNELS + ("quantized_matmul",)
SPARSE_KERNELS = ("block_sparse_fwd_sm90", "block_sparse_band_fwd_sm90",
                  "block_sparse_bwd_dkv_sm90", "block_sparse_bwd_dq_sm90")
# the sparse oracle's fp32 cases take K7's WMMA bodies
SPARSE_ORACLE_KERNELS = SPARSE_KERNELS + ("block_sparse_fwd",
                                          "block_sparse_band_fwd",
                                          "block_sparse_bwd_dkv",
                                          "block_sparse_bwd_dq")
# the ring leg: K5 and K2's sweeps (the flash ring at T 8192 and 32768),
# K1 and K2's sweeps (Ulysses); GPT-2 under the ring: training's kernels
# with K5 in K1's place (K2-fused through its given-delta entry)
SEQUENCE_PARALLEL_KERNELS = ("flash_attention_merge", "flash_attention_bwd",
                             "flash_attention_fwd")
SP_TRAINING_KERNELS = tuple(k for k in TRAINING_KERNELS
                            if k != "flash_attention_fwd") + \
    ("flash_attention_merge",)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, prompts and inputs")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import _build

    # 1: environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    emit({"phase": "env", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": name,
          "device_count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "peaks": peaks})

    # 2: build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.SOURCES}
    sm90 = {k: v for n in SM90_LIBS
            for k, v in sm90_ptxas(_build.build_log(n)).items()}
    emit({"phase": "build", "seconds": build_s,
          "seconds_by_source": dict(_build.compile_seconds),
          "dir": os.path.relpath(_build.BUILD_DIR, ROOT), "ptxas": ptxas,
          "sm90_kernels": sm90})
    spilled = [k for k, v in sm90.items() if "no spill" not in v]
    if spilled or len(sm90) != SM90_KERNELS:
        raise AssertionError(f"Hopper kernels spilling {spilled} (or not "
                             f"all {SM90_KERNELS} found: {sorted(sm90)})")

    # 3: kernels vs plain twins
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    results = {}
    for kname, _, _, fn in KERNELS:
        if fn is None:
            continue
        res, checks = fn(peaks, gen)
        results[kname] = res
        emit({"phase": "kernel", "name": kname, "checks": checks,
              "timed_by_path": res, "card": card})
    disp, comb, checks = kernel_moe(peaks, gen)
    results["moe_dispatch"], results["moe_combine"] = disp, comb
    emit({"phase": "kernel", "name": "moe_dispatch and moe_combine",
          "checks": checks, "timed_by_path": {"moe_dispatch": disp,
                                              "moe_combine": comb},
          "card": card})
    release()

    # 4-6: the serving path, with launch counts zeroed right before it
    serve_and_check(args.seed, card)
    serving = read_counts()
    emit({"phase": "launch_counts", "path": "serving", **serving})
    missing = [k for k in SERVING_KERNELS if serving[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving "
                             f"path: {missing}")
    release()

    def path_counts(path, counts, kernels, absent=()):
        emit({"phase": "launch_counts", "path": path, **counts})
        missing = [k for k in kernels if counts[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
        stray = [k for k in absent if counts[k] != 0]
        if stray:
            raise AssertionError(f"kernels launched on the {path} path "
                                 f"that it must not run: {stray}")
        release()
        return counts

    # 7: the training path (counts zeroed inside, right before its
    # steps), then 8: its oracle
    training, losses = train_and_check(args.seed, card)
    path_counts("training", training, TRAINING_KERNELS, FUSED_ABSENT)
    training_oracle(args.seed)
    release()

    # 9: the quantized training path, the same weights, batch and seed
    # as 7 with the quantized_compute block, held to 7's losses; then 10:
    # its oracle
    quant, quant_losses = train_and_check(args.seed, card, quantized=True)
    path_counts("quant_training", quant, QUANT_KERNELS, FUSED_ABSENT)
    gaps = [abs(a - b) for a, b in zip(quant_losses, losses)]
    emit({"phase": "quant_vs_unquantized_losses", "quant": quant_losses,
          "unquantized": losses, "abs_gap": gaps, "tol": TOL_QUANT_LOSS,
          "k6_launches_per_step": quant["quantized_matmul"] / len(losses),
          "ok": max(gaps) <= TOL_QUANT_LOSS})
    if not max(gaps) <= TOL_QUANT_LOSS:
        raise AssertionError(f"quant_training losses {quant_losses} stray "
                             f"more than {TOL_QUANT_LOSS} from {losses}")
    quant_oracle(args.seed)
    release()

    # 11: the MoE training path (counts zeroed inside, right before its
    # steps), then 12: its oracle, then 13: the quantized MoE path
    moe = path_counts("moe_training", moe_train_and_check(args.seed, card),
                      MOE_KERNELS, FUSED_ABSENT)
    moe_oracle(args.seed)
    release()
    moe_quant = path_counts(
        "moe_quant_training",
        moe_train_and_check(args.seed, card, quantized=True),
        MOE_QUANT_KERNELS, FUSED_ABSENT)

    # 14: the K7 kernels against their twins; 15: the sparse attention
    # path (counts zeroed inside, right before it); 16: BERT-large's
    # sparse self-attention block; 17: the oracle
    sparse_res, checks = kernel_sparse(peaks, gen)
    results.update(sparse_res)
    emit({"phase": "kernel_sparse", "checks": checks,
          "timed_by_path": sparse_res, "card": card})
    release()
    sparse = path_counts("sparse_attention",
                         sparse_attention_path(args.seed, card),
                         SPARSE_KERNELS)
    bert_sparse(args.seed, card)
    # 16b: the fp16 passes of the sparse path (the [1, 16384] shapes) and
    # of BERT-large's sparse self-attention block
    sparse16 = path_counts("sparse_attention_fp16",
                           sparse_attention_path(args.seed, card,
                                                 torch.float16),
                           SPARSE_KERNELS)
    bert_sparse(args.seed, card, torch.float16)
    sparse_oracle_counts = path_counts("sparse_oracle",
                                       sparse_oracle(args.seed),
                                       SPARSE_ORACLE_KERNELS)

    # 18: K5 and K2's given-delta entry against their twins; 19: the ring
    # leg in a one-rank NCCL group (counts zeroed inside, right before
    # it) and the emulated four-rank ring; 20: the training flagship
    # under the ring, held to 7's losses
    merge_res, k2_res, fused_res, checks = kernel_merge(peaks, gen)
    results["flash_attention_merge"] = merge_res
    results["flash_attention_bwd"].update(k2_res)
    results["flash_attention_bwd_fused"].update(fused_res)
    emit({"phase": "kernel_merge", "checks": checks,
          "timed_by_path": {"flash_attention_merge": merge_res,
                            "flash_attention_bwd": k2_res,
                            "flash_attention_bwd_fused": fused_res},
          "card": card})
    release()
    rendezvous = init_sp_group()
    try:
        sp_path = path_counts("sequence_parallel",
                              sequence_parallel_path(args.seed, card),
                              SEQUENCE_PARALLEL_KERNELS)
        sp_train, sp_losses = train_and_check(
            args.seed, card, steps=4, sequence_parallel="ring")
        path_counts("sp_training", sp_train, SP_TRAINING_KERNELS,
                    FUSED_ABSENT)
    finally:
        torch.distributed.destroy_process_group()
        if os.path.exists(rendezvous):
            os.remove(rendezvous)
    gaps = [abs(a - b) for a, b in zip(sp_losses, losses)]
    n_steps = len(sp_losses)
    k5_per_step = sp_train["flash_attention_merge"] / n_steps
    emit({"phase": "sp_vs_training_losses", "sp": sp_losses,
          "training": losses[:n_steps], "abs_gap": gaps, "tol": TOL_SP_LOSS,
          "k5_launches_per_step": k5_per_step,
          "n_layer": train_config().n_layer})
    if not max(gaps) <= TOL_SP_LOSS:
        raise AssertionError(f"sp_training losses {sp_losses} stray more "
                             f"than {TOL_SP_LOSS} from {losses}")
    if k5_per_step < train_config().n_layer:
        raise AssertionError(f"sp_training: {k5_per_step} K5 launches per "
                             "step, fewer than the layers")
    release()

    # 21: the training flagship saves, resumes and continues (counts
    # zeroed inside, right before its first step)
    ckpt = path_counts("checkpoint", checkpoint_and_check(args.seed, card),
                       TRAINING_KERNELS, FUSED_ABSENT)
    release()

    # 22: the kernels at BERT-large's shapes against their twins; 23:
    # BERT-large pretraining (counts zeroed inside, right before its
    # steps); 24: its oracle
    bert_res, checks = kernel_bert(peaks)
    for kname, by_path in bert_res.items():
        results[kname].update(by_path)
    emit({"phase": "kernel_bert", "checks": checks,
          "timed_by_path": bert_res, "card": card})
    release()
    bert = path_counts("bert_training", bert_training(args.seed, card),
                       BERT_KERNELS, FUSED_ABSENT)
    bert_oracle(args.seed)
    release()

    # 25: the fp16 forms of K1-K4 at paths A's and B's shapes against
    # their twins; 26: the fp16 oracle at BERT-large width; 27: path A,
    # BERT-large fp16 + LAMB; 28: path B, GPT-2 1.5B fp16 + progressive
    # layer drop; 29: path C, the engine's other optimizers and client
    # objects in fp16 (counts zeroed inside each, right before its steps)
    fp16_res, checks = kernel_fp16(peaks, gen)
    results.update(fp16_res)
    emit({"phase": "kernel_fp16", "checks": checks,
          "timed_by_path": fp16_res, "card": card})
    release()
    bert_fp16_oracle(args.seed)
    release()
    bert16 = path_counts("bert_fp16", bert_fp16_lamb(args.seed, card),
                         BERT_KERNELS, FUSED_ABSENT)
    gpt16 = path_counts("gpt2_fp16_pld", gpt2_fp16_pld(args.seed, card),
                        TRAINING_KERNELS, FUSED_ABSENT)
    surface16 = path_counts("engine_surface_fp16",
                            engine_surface_fp16(args.seed, card),
                            TRAINING_KERNELS, FUSED_ABSENT)

    rows = []
    counts_by_path = {"serving": serving, "training": training,
                      "quant_training": quant, "moe_training": moe,
                      "moe_quant_training": moe_quant,
                      "sparse_attention": sparse,
                      "sparse_attention_fp16": sparse16,
                      "sparse_oracle": sparse_oracle_counts,
                      "sequence_parallel": sp_path,
                      "sp_training": sp_train, "checkpoint": ckpt,
                      "bert_training": bert, "bert_fp16": bert16,
                      "gpt2_fp16_pld": gpt16,
                      "engine_surface_fp16": surface16}
    for kname, src_file, replaces, _ in KERNELS:
        # the row's numbers at the kernel's first timed shape (the
        # serving shape where the kernel serves, as in earlier runs);
        # every path's under "timed_by_path"
        by_path = results[kname]
        r = next(iter(by_path.values()))
        # an fp16 form's launches are the fp16 paths', a bf16 form's the
        # others'
        fp16 = kname in FP16_KERNELS
        counter = FP16_KERNELS.get(kname, kname)
        paths = {p: c[counter] for p, c in counts_by_path.items()
                 if (p in FP16_PATHS) == fp16}
        extra = {k: r[k] for k in ("library_call", "bf16_matmul_ms",
                                   "plain_is", "sdpa_masked_fwd_ms",
                                   "sdpa_masked_fwd_bwd_ms", "dense",
                                   "visible_scores", "density", "k1_ms",
                                   "kernel_ms", "tops", "tflops",
                                   "share_of_bound", "body", "ptxas",
                                   "walk", "yardstick", "yardstick_ms",
                                   "graph_ms", "cold_graph_ms",
                                   "bf16_graph_ms", "library_graph_ms",
                                   "yardstick_graph_ms")
                 if k in r}
        rows.append({"name": kname, "route": "cuda", "source": src_file,
                     "replaces": replaces,
                     "launches": sum(paths.values()),
                     "launches_by_path": paths,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"],
                     **extra, "timed_by_path": by_path})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
