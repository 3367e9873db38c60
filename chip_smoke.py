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
 13. quantized MoE training: phase 11 at 12 of its 24 layers with
     quantized experts and the quantized_compute block (K6 for
     c_attn/c_proj of every block, the dense blocks' MLPs and, grouped
     over the 8 experts, wi and wo);
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
 21. checkpoint: phase 7's flagship (8 of its 48 layers) saves, resumes
     and continues. Engine A takes 2 steps and a 4-step window without a
     save, saves the same state sync and async (the async writer copying
     to pinned host memory on its own CUDA stream), and takes 4 more
     steps while the writer runs; engine B, fresh from other weights,
     loads `latest` and takes those 4 steps on the same batches. Gates:
     the async call returns before its commit, `latest` names the tag
     with no staging dir left, the sync and async directories are
     byte-identical, every leaf B loaded equals the file's bytes, B's
     losses equal A's bit for bit, every training kernel launched.
     Printed: bytes written, the blocked ms of both calls, the two
     windows' ms and the stall, fetch, commit and load ms, peak device
     memory and host RSS during the save; the checkpoint directory lives
     under build/ and is removed at the end;
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
     plain-torch route (fused ops off, dense attention);
 25. kernel_fp16: the fp16 forms against their twins at the fp16 paths'
     shapes, each with an inf in an input reaching every output the
     twin's reaches and beside its bf16 form: K1-fwd, K2-fused, K2's
     sweeps, K3 and K4 at paths A's and B's; K8 and grouped K4 at D's,
     K6 with an fp16 output at E's (bit for bit, and past 65504 inf
     where the twin is), K5 and K2's given-delta entry on both routes at
     F's and the ring leg's;
 26. bert_fp16_oracle: phase 24 in fp16 (loss scaled by 2^10);
 27-29. fp16 paths A (BERT-large + LAMB, 8 of its 24 layers), B
     (gpt2-1.5b + progressive layer drop, 16 of its 48 layers) and C
     (gpt2-1.5b width at 4 layers: the engine's other optimizers and
     client objects), each until 8 clean steps follow the
     last skipped one (`run_fp16_path`: finite, falling losses, the JAX
     automaton's scales, no bit moved on a skip, exact launches, the
     update under set_sync_debug_mode("error"), step ms, a profile);
 30-31. fp16 paths D (gpt2-350m-moe8 at 12 of its 24 layers: K8,
     grouped K4) and E (D with quantized experts and the
     quantized_compute block: K6 with an fp16 output) from the scale
     2^16, through `run_fp16_path`;
 32. sequence_parallel_fp16: the ring leg in fp16 at [1, 8192, 4, 64]
     and the emulated four-rank ring (K5, K2's given-delta sweeps);
 33. fp16 path F: sp_training at 16 of its 48 layers in fp16 from the
     scale 2^16 (K5, K2-fused's given-delta entry), through
     `run_fp16_path`;
 34. path G (after 13): bench.py's bench_gpt2_350m (gpt2-350m, micro
     batch 16, seq 1024, bf16 with fp32 masters, ZeRO-0, AdamW) under
     remat_policy "dots_with_no_batch_dims_saveable" with async_dispatch
     on, fed through engine.prefetch (a PrefetchLoader on a side
     stream), its timed steps under set_sync_debug_mode("error"): step
     ms, tokens/s, peak memory, exact launches a step; the same steps fed
     directly give bit-equal losses; full-block remat's losses within
     1e-2, its step ms and peak memory beside; ABCorrectnessChecker
     against the fp32 ZeRO-0 shadow for 4 steps (loss_atol 0.05);
 35. path H (after 8): phase 7's cell at 4 layers (48 until PR 23)
     under remat_policy "save_fused_epilogues", beside the same 4 layers
     under full-block remat: its profile, losses within 1e-2 of full
     remat's, exact launches a step (K1-fwd 4, not 8; K3-fwd 9; K4-fwd
     8);
 36. the same under "save_only_these_names:attn_out,attn_lse": losses
     within 1e-2 of full remat's, exact launches (REMAT_RECOMPUTE: the
     JAX jaxpr's recompute, which tests/test_torch_remat_policies.py
     holds on the CPU);
 37. user_checkpoint (after 24): one gpt2-1.5b block applied 4 times
     through deepspeed_tpu_torch.checkpointing.checkpoint, without and
     with cpu_checkpointing: bit-equal gradients, the kept inputs pinned
     on the host, the device memory held for the backward lower by at
     least their bytes;
 38. bert_memory_flags: BERT-large's layer at 4 layers with and without
     normalize_invertible under fused ops: one more K1-fwd and K4-fwd a
     layer, no more K3-fwd (the JAX layer's jaxpr), losses within 1e-2;
 39. O1, zero_offload_real_step (bench.py:475-527) verbatim: gpt2-125m,
     micro batch 8, seq 1024, gas 4, dropout 0, bf16 with fp32
     parameters, full remat, ZeRO-2 + cpu_offload, AdamW lr 1e-4: the
     host's cores, RAM and CPU-Adam threads (printed after phase 1), 1
     warm-up and 3 timed steps (step ms, tokens/s, the split: the device
     half until the norm is on the host, the norm wait, the host chunk
     loop, D2H/H2D bytes and their device ms and GB/s), exact launches
     (K1-fwd 96, K2-fused 48, K3-fwd 196, K3-bwd 100, K4-fwd 96, K4-bwd
     48 a step), the pipeline on the device clock (chunk i+1's D2H and
     chunk i-1's H2D inside chunk i's host step) and the serial round
     trip's steps beside the pipelined ones in turns, a profile;
 40. O2, zero_offload_wire (bench.py:534-600): O1 at bf16_native, int8
     (8/8) and 1bit (1/8, warmup_steps 1), 4 steps each: wire_stats and
     step ms; int8 under 0.55x and 1-bit under 0.2x the native D2H
     bytes, H2D as the JAX package counts it, the last losses within
     5e-2 of bf16_native's;
 41. O3: bench_gpt2_15b's config with "cpu_offload": true at full width
     and depth (master_weights false is ignored with a warning): 1
     warm-up and 3 timed steps, step ms, tokens/s, peak device memory,
     host RSS, the split, exact launches;
 42. O3's A/B at 4 layers: against the device engine with fp32 masters
     on the same weights and batches, losses within 1e-2 over 4 steps,
     host masters within 5e-3 relative L2 of the device master;
 43. O4: the A/B's model in fp16 with cpu_offload from 2^32 until 8 clean
     steps follow the last skip: the first step skips, every skip keeps
     the host masters bit for bit, the scales are the JAX package's host
     automaton's;
 44. O5 (after 39): O1's engine saves and takes 2 steps; a fresh engine
     loads and takes the same 2: masters, moments and step bit-equal,
     losses bit-equal. Every offload path runs the native CPU-Adam;
 45. verify_rows (after 6): on a speculative engine's weights, a decode
     row against the same row inside a verify-shaped batch (4 slots x 5
     positions), bit for bit, op by op: the four projections, paged
     attention, K3-fwd, K4-fwd, and ln_f with the tied head as the
     engine runs it (one GEMM per position); the head as one GEMM over
     all positions is reported beside it, not gated;
 46. speculative_decode: gpt2-1.5b at full width and depth, random
     weights from --seed, the residual projections (c_proj, mlp_c_proj)
     of blocks 4..47 scaled by 0.2 (bench.py's bench_speculative_decode
     construction), a vanilla engine and a speculative engine (truncate:4
     draft, k 4, k_min 1, adaptive) serving the same 4 greedy requests
     (prompts 100-300, 64 new tokens): the streams equal token for
     token, drafted, accepted and rollbacks > 0, every spec_block under
     set_sync_debug_mode("error"); the acceptance rate, rounds, tokens/s
     of each engine and the draft/verify dispatch split;
 47. speculative_sampled: the same requests at temperature 0.8, top-k
     40, one round a fence: tokens in the vocabulary, accepted <=
     drafted, each slot's verified rounds equal to its live rounds;
 48. int8_serving: weight_bits 8 (block 128) against bf16 on phase 46's
     weights: verify_rows on the int8 engine, 16 teacher-forced decode
     steps with the logits within TOL_INT8_LOGITS (0.25) and the greedy
     tokens equal wherever the gap allows, then decode ms a step,
     tokens/s, projection bytes and peak memory of each engine;
 49. int8_speculative: int8 with speculative decoding, 32 new tokens a
     request: the stream equals the int8 engine's.
 50. monitor_training (path M, after 8): phase 7's training cell (at
     12 of its 48 layers since PR 23) with async_dispatch at
     steps_per_sync 4, wall_clock_breakdown and the
     monitor (JSONL and tensorboard sinks, the Perfetto trace, flight,
     numerics, the memory ledger, stall_timeout_sec 60) beside the same
     engine without them, windows of 4 steps in turns: losses bit for
     bit, the kernels' launches a step equal, no host read between
     fences (set_sync_debug_mode("error")) and one copy at a fence, the
     events' losses, the ledger's state bytes, the tfevents CRCs, a
     forward, backward and step span a step in the trace and `ds_trace
     summary` on it; the memory event against torch.cuda.memory_stats,
     MFU and tokens/s, and the overhead (median of the window ratios,
     the 3% contract recorded, not gated);
 51. monitor_faults (after 44): 4 layers of phase 7's cell with a 2 s
     stall timeout: a healthy stretch gives no stall, a host sleep one
     stall event and one flight dump, an exception out of train_batch
     one dump, a micro batch of 4096 rows torch.OutOfMemoryError and a
     dump classified oom with the ledger's hints, then a step;
 52. monitor_serving (after 49): phase 4's serving cell and phase 46's
     speculative cell with the monitor and the request tracker against
     the same serves without: tokens equal, no host read in a block, the
     tracker's p50/p99 within one histogram bucket of the requests'
     stamps, the KV ledger the pools' bytes, one trace track a slot;
 53. monitor_events (after 51): at 4 layers, the moe and router events
     of gpt2-350m-moe8, the quantized path's quantized_matmul event, O1's
     wire counters against its steps' bytes, a checkpoint's ckpt_commit
     and its ledger entries released, engine.prefetch's heartbeat
     terminal at exhaustion; every event held to the JAX engine's keys.
 54. flops_profile (after 8): phase 7's cell with the flops_profiler
     block (profile_step 2) for 3 steps: the losses bit for bit phase
     7's, the profile's kernel rows' calls equal to step 2's launches,
     its total flops within 1% of the analytic count (the matrix
     products and attention of the step under full remat), the top rows
     by estimated time;
 55. autotune (after 53): the launch plans of K3-fwd, K3-bwd, K4-fwd and
     K4-bwd searched at the flagship's rows (N 11,264; H 1,600, W 6,400)
     and the decode rows (N 4), bf16, into a temporary table: every
     candidate against the twin, each winner no slower than its
     default, a fresh process reloading the table (autotune_hit, the
     winning plan), a forged source hash falling back with one warning,
     the flash and quantized-matmul families' one tile pair each;
 56. elastic: ElasticSupervisor over gpt2-1.5b's width at 4 layers, seq
     1024, micro batch 2, gas 2, async checkpoints every 2 steps: run(3),
     two injected stalls, run(8); one in-place recovery from
     global_step2 with its replayed losses bit for bit, its ZeRO plan the
     memory ledger's state bytes, the event in the monitor's JSONL;
 57. env_report: `python -m deepspeed_tpu_torch.env_report` in a
     subprocess: every kernel source built, the card's name and power
     limit, nvcc's version.
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
Phases 45-49 run right after 6; the speculative and int8 paths' launch
counts (zeroed after each serve's warm-up, right before the timed
serve) must show K3-fwd and K4-fwd and no K6. Then the `kernels`
summary line, the card line, and as the last line
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


_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the script's seconds so far
    ("t_s"), where the run's time goes."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _START)
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
# head dims 64 and 128 (4), K7's four Hopper kernels in fp16 at head
# dims 64 and 128 (8), K5 in fp16 at head dims 64 and 128 (2) and K6
# with an fp16 output (1)
ATTN_KERNELS = 18 + 6 + 4 + 8 + 2 + 1
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
            q = re.search(r"qmm_kernelI(f|13__nv_bfloat16|6__half)E", ln)
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
                name = "qmm_kernel<" + {"f": "float", "6__half": "fp16"}.get(
                    q.group(1), "bf16") + ">"
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
    of 4 CTAs) and the MoE training shape (B16 T1024 H16 D64), timed;
    then at head dim 128, at a ragged last key block (T 192, 320), at a
    one-CTA cluster (T 64) and in fp16, causal and not, with an lse
    cotangent. Each case launched twice and compared bit for bit. Timed
    back to back (`ms`) and from CUDA graphs (`graph_ms`), beside the
    bound, the twin, K2's sweeps on the same inputs (`sweeps_ms`,
    `sweeps_graph_ms`) and SDPA's backward (`library_ms`,
    `library_graph_ms`); with the plan's CTAs a cluster, the clusters the
    card runs at once (the occupancy API) and the waves that makes."""
    import ctypes

    import torch
    from deepspeed_tpu_torch.ops import _build
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
            ctas = fa._FusedPlan.of(-(-t // 128), causal, d).ctas
            at_once = _build.function(
                "flash_attention_bwd_fused", "ds_flash_attn_bwd_fused_clusters",
                [ctypes.c_int] * 4)(ctas, d, 1 if dtype == bf16 else 2, 0)
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
                             "fwd", shape=label, cluster_ctas=ctas,
                clusters_at_once=at_once,
                waves=b * h / at_once if at_once > 0 else None), flops)
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


def qmm_row(peaks, checks, label, x, w, xq, wq, sx, sw, block, out_dt, err):
    """K6's timed row at one shape: the wrapper as the path calls it
    (`ms`, the per-call weight transpose included) and the launch alone
    on the transposed weights (`kernel_ms`, whose TOP/s and share of the
    bound the row reports) beside the bound, the twin, and the
    yardsticks torch._int_mm on the same padded int8 operands and the
    matmul of x and w in their dtype (`<dtype>_matmul_ms`)."""
    import torch
    qm = _qmm()
    g, m, kp = xq.shape
    n = wq.shape[-1]
    nb = kp // block
    # 2 operations per int8 product; read xq, wq, sx, sw once, write the
    # 16-bit output once
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
    matmul = {torch.bfloat16: "bf16", torch.float16: "fp16"}[x.dtype]
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: qm._qmm_launch(xq, wq, sx, sw, block, out_dt)),
        "kernel_ms": kernel_ms, "tops": flops / kernel_ms / 1e9,
        "share_of_bound": bound_ms / kernel_ms,
        "plain_ms": time_ms(lambda: qm._qmm_plain(xq, wq, sx, sw, block,
                                                  out_dt),
                            iters=3, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": int_mm_ms,
        "library_call": ("torch._int_mm on the padded int8 operands, no "
                         "per-block scales" + (f", {g} calls" if g > 1
                                               else "")),
        f"{matmul}_matmul_ms": time_ms(lambda: torch.matmul(xb, wb)),
        "shape": label}


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
        if timed:
            out[timed] = qmm_row(peaks, checks, label, x, w, xq, wq, sx, sw,
                                 block, out_dt, err)
        del x, w, wq, sw, xq, sx
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
# phases 45-49: speculative decoding and int8 weight-only serving
# ----------------------------------------------------------------------
# bench.py's bench_speculative_decode builds its flagship so that a
# truncate draft agrees with it on most steps but not all: the residual
# projections (c_proj, mlp_c_proj: kernel and bias) of every block past
# the draft's are scaled by a factor. Here at gpt2-1.5b: the draft is
# the first SPEC_DRAFT_LAYERS blocks, and blocks SPEC_DRAFT_LAYERS..47
# are damped by SPEC_DAMP.
SPEC_DRAFT_LAYERS = 4
SPEC_DAMP = 0.2
SPEC_K, SPEC_K_MIN = 4, 1
SPEC_NEW = 64
SPEC_PROMPTS = (100, 167, 233, 300)
SPEC_BLOCK = {"enabled": True, "draft_model": f"truncate:{SPEC_DRAFT_LAYERS}",
              "k": SPEC_K, "k_min": SPEC_K_MIN, "adaptive": True}
# the sampled run: temperature and top-k
SPEC_TEMPERATURE, SPEC_TOP_K = 0.8, 40
# int8 weight-only against bf16 on the same weights, teacher-forced
# decode logits: each weight moves by at most half its block's step
# (max-abs / 254, ~0.7% of a block's spread), which adds to the bf16
# roundings that the decode oracle's 8 ulps (TOL_LOGITS) cover, and the
# epilogue rounds each block's partial product and its scaled value to
# bf16 before the sum. The bound is 16 bf16 ulps at |x| in [2, 4); on
# an H100 80GB HBM3 at 700 W this phase measured 0.1094 in each of two
# runs over its 16 steps x 4 slots x 50,257 logits. Greedy tokens must agree wherever
# the bf16 engine's top-2 gap exceeds twice the bound (a gap the bound
# cannot close).
TOL_INT8_LOGITS = 2 * TOL_LOGITS
INT8_FORCED_STEPS = 16
INT8_BLOCK = 128


def spec_serving_config(weight_bits=32, speculative=None, new=SPEC_NEW):
    """Phase 4's serving settings with a ring of `new` tokens, the int8
    weights and the speculative block as asked."""
    block = {"max_slots": 4, "prefill_chunk": 128, "sync_every": 8,
             "max_new_tokens": new, "weight_bits": weight_bits,
             "weight_quant_block": INT8_BLOCK,
             "kv_cache": {"num_pages": 128, "page_size": 16}}
    if speculative is not None:
        block["speculative"] = dict(speculative)
    return {"inference": block}


def damped_flagship(seed, device="cuda", n_layer=None):
    """gpt2-1.5b at full width (depth cut only for a CPU rehearsal) with
    random weights from `seed`, the residual projections of blocks
    SPEC_DRAFT_LAYERS.. scaled by SPEC_DAMP (bench_speculative_decode's
    construction)."""
    from deepspeed_tpu_torch.models.gpt2 import (GPT2ForCausalLM,
                                                 gpt2_config)
    overrides = {} if n_layer is None else {"n_layer": n_layer}
    cfg = gpt2_config("gpt2-1.5b", **overrides)
    params = GPT2ForCausalLM(cfg, device=device).init(seed)
    for i in range(SPEC_DRAFT_LAYERS, cfg.n_layer):
        for mod in ("c_proj", "mlp_c_proj"):
            for leaf in ("kernel", "bias"):
                params[f"h.{i}.{mod}.{leaf}"].mul_(SPEC_DAMP)
    return cfg, params


def spec_prompts(seed, vocab):
    import numpy as np
    rng = np.random.RandomState(seed + 1)
    return [rng.randint(0, vocab, size=n).astype(np.int32)
            for n in SPEC_PROMPTS]


def serve_timed(engine, prompts, new, device, **req):
    """Warm up, zero the launch counts, then serve `prompts` through a
    ServingLoop: (the requests by rid, the loop, wall seconds). The
    counts read after it are the timed serve's alone."""
    from deepspeed_tpu_torch.inference import Request, ServingLoop
    engine.reset()
    ServingLoop(engine).serve([Request(rid="warm", tokens=prompts[0][:40],
                                       max_new_tokens=4)])
    engine.reset()
    sync(device)
    reset_counts()
    loop = ServingLoop(engine)
    t0 = time.perf_counter()
    done = loop.serve([Request(rid=i, tokens=p, max_new_tokens=new, **req)
                       for i, p in enumerate(prompts)])
    sync(device)
    wall = time.perf_counter() - t0
    return {r.rid: r for r in done}, loop, wall


def no_sync(fn, device):
    """`fn` run under torch.cuda.set_sync_debug_mode("error") on the
    card: any host read inside it raises."""
    import torch

    def run(*a, **k):
        if torch.device(device).type != "cuda":
            return fn(*a, **k)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def spec_totals(engine):
    sp = engine.fetch_state()["speculative"]
    out = {k: int(sp[k].sum()) for k in ("drafted", "accepted", "verified",
                                         "rollbacks")}
    out["rounds"] = sp["rounds"]
    return out


def verify_rows(engine, gen, k=SPEC_K):
    """A decode row against the same row inside a verify-shaped batch
    ([max_slots, k+1] rows), bit for bit, op by op of the step on the
    engine's layer-0 weights at its widths: the four projections (cuBLAS,
    or the int8 epilogue), paged attention (decode's kv_limit against
    verify's), K3-fwd's block form, K4-fwd, and ln_f with the tied head
    as the engine runs it (`_logits`, one GEMM per query position).
    "head_one_gemm" is the head as one GEMM over all k+1 positions, the
    phrasing `_logits` replaces: reported, not gated. Returns {op: the
    number of the k+1 positions whose bits differ}."""
    import torch
    from deepspeed_tpu_torch.inference.engine import (_project,
                                                      paged_attention)
    from deepspeed_tpu_torch.ops.transformer.fused_ops import (
        fused_bias_gelu, fused_bias_residual_layernorm)
    mc, dev = engine.model_config, engine.device
    s, c, h, d = engine.config.max_slots, mc.n_embd, mc.n_head, mc.head_dim
    w = engine._weights
    lp = w["layers"][0]
    block = engine.config.weight_quant_block

    def rnd(*shape, dtype=mc.dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) *
                scale).to(dtype)

    def differ(full, row_fn):
        return sum(not torch.equal(full[:, j:j + 1], row_fn(j))
                   for j in range(k + 1))

    out = {}
    for mod, width in (("c_attn", c), ("c_proj", c), ("c_fc", c),
                       ("mlp_c_proj", 4 * c)):
        x = rnd(s, k + 1, width)
        full = _project(mc, lp, mod, x, block)
        out[mod] = differ(full, lambda j: _project(
            mc, lp, mod, x[:, j:j + 1].contiguous(), block))
    tk = engine.cache.max_pages_per_slot * engine.cache.page_size
    q, kc, vc = rnd(s, k + 1, h, d), rnd(s, tk, h, d), rnd(s, tk, h, d)
    pos0 = torch.arange(s, device=dev) * 37 + 100
    steps = torch.arange(k + 1, device=dev)
    full = paged_attention(q, kc, vc, pos0[:, None] + steps, pos0 + k)
    out["paged_attention"] = differ(full, lambda j: paged_attention(
        q[:, j:j + 1].contiguous(), kc, vc, (pos0 + j)[:, None], pos0 + j))
    y, resid = rnd(s, k + 1, c), rnd(s, k + 1, c, dtype=torch.float32)
    args = (lp["c_proj.bias"], lp["ln_2.scale"], lp["ln_2.bias"])

    def k3(yy, rr):
        o, sm = fused_bias_residual_layernorm(
            yy, args[0], rr, args[1], args[2], eps=mc.layer_norm_epsilon,
            out_dtype=mc.dtype, sum_dtype=torch.float32)
        return torch.cat([o.float(), sm], dim=-1)
    out["k3_fwd"] = differ(k3(y, resid), lambda j: k3(
        y[:, j:j + 1].contiguous(), resid[:, j:j + 1].contiguous()))
    fc = rnd(s, k + 1, 4 * c)
    full = fused_bias_gelu(fc, lp["c_fc.bias"], approximate=True,
                           out_dtype=mc.dtype)
    out["k4_fwd"] = differ(full, lambda j: fused_bias_gelu(
        fc[:, j:j + 1].contiguous(), lp["c_fc.bias"], approximate=True,
        out_dtype=mc.dtype))
    mlp_y = rnd(s, k + 1, c)
    full = engine._logits(w, mc, resid, (mlp_y, lp["mlp_c_proj.bias"]))
    out["ln_f_and_head"] = differ(full, lambda j: engine._logits(
        w, mc, resid[:, j:j + 1].contiguous(),
        (mlp_y[:, j:j + 1].contiguous(), lp["mlp_c_proj.bias"])))
    hid = rnd(s, k + 1, c)
    head = w["wte_c"].t()
    full = torch.matmul(hid, head)
    out["head_one_gemm"] = differ(full, lambda j: torch.matmul(
        hid[:, j:j + 1].contiguous(), head))
    return out


def check_verify_rows(label, engine, gen, card):
    rows = verify_rows(engine, gen)
    gated = {op: n for op, n in rows.items() if op != "head_one_gemm"}
    ok = not any(gated.values())
    emit({"phase": "verify_rows", "engine": label,
          "positions": SPEC_K + 1, "slots": engine.config.max_slots,
          "differing_positions": rows, "ok": ok, "card": card})
    if not ok:
        raise AssertionError(f"{label}: a verify row's bits differ from the "
                             f"decode row's: {gated}")


def speculative_decode(seed, card, device="cuda", n_layer=None):
    """Phases 45-47: the verify rows (45), speculative serving at
    temperature 0 against vanilla serving on the damped gpt2-1.5b (46;
    the speculative path's launch counts zeroed after the warm-up,
    right before the timed serve)
    and the sampled run (47). Returns (the speculative path's counts,
    the weights, the vanilla requests)."""
    import torch
    from deepspeed_tpu_torch.inference import InferenceEngine
    t0 = time.perf_counter()
    cfg, params = damped_flagship(seed, device, n_layer)
    vanilla = InferenceEngine(cfg, params, spec_serving_config(),
                              device=device)
    spec = InferenceEngine(cfg, params,
                           spec_serving_config(speculative=SPEC_BLOCK),
                           device=device)
    sync(device)
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    check_verify_rows("bf16", spec, gen, card)
    prompts = spec_prompts(seed, cfg.vocab_size)

    van, _, van_s = serve_timed(vanilla, prompts, SPEC_NEW, device)
    spec.spec_block = no_sync(spec.spec_block, device)
    got, loop, spec_s = serve_timed(spec, prompts, SPEC_NEW, device)
    counts = read_counts()
    totals = spec_totals(spec)
    # decode alone (the requests prefilled first), a block of 8 steps or
    # rounds a fence
    decode_s = {}
    for name, eng, block in (("vanilla", vanilla, vanilla.decode_block),
                             ("speculative", spec, spec.spec_block)):
        eng.reset()
        for slot, p in enumerate(prompts):
            eng.start_request(slot, p, max_new=SPEC_NEW)
        sync(device)
        t0 = time.perf_counter()
        while eng.fetch_state()["active"].any():
            block(8)
        decode_s[name] = time.perf_counter() - t0
    equal = all(got[i].out_tokens.tolist() == van[i].out_tokens.tolist()
                for i in van)
    new_tokens = sum(len(r.out_tokens) for r in got.values())
    stats = loop.spec_stats
    row = {"phase": "speculative_decode", "model": "gpt2-1.5b",
           "n_layer": cfg.n_layer,
           "draft": SPEC_BLOCK["draft_model"], "damp": SPEC_DAMP,
           "damped_blocks": [SPEC_DRAFT_LAYERS, cfg.n_layer - 1],
           "k": SPEC_K, "k_min": SPEC_K_MIN, "adaptive": True,
           "requests": len(prompts), "prompt_tokens": list(SPEC_PROMPTS),
           "new_tokens_each": SPEC_NEW, "setup_s": setup_s,
           "streams_equal": equal, **totals,
           "acceptance_rate": totals["accepted"] / max(totals["drafted"], 1),
           "tokens_per_verify": new_tokens / max(totals["verified"], 1),
           "vanilla_wall_s": van_s, "speculative_wall_s": spec_s,
           "vanilla_tokens_per_s": new_tokens / van_s,
           "speculative_tokens_per_s": new_tokens / spec_s,
           "speedup": van_s / spec_s,
           "decode_only_s": decode_s,
           "decode_only_tokens_per_s": {
               k: new_tokens / v for k, v in decode_s.items()},
           "vanilla_decode_ms_per_step":
               decode_s["vanilla"] * 1e3 / SPEC_NEW,
           "draft_dispatch_s": stats["draft_dispatch_s"],
           "verify_dispatch_s": stats["verify_dispatch_s"],
           "fences": stats["fences"],
           "rollback_pages": stats["rollback_pages"],
           "spec_block_sync_debug": "error" if device == "cuda" else None,
           "card": card}
    emit(row)
    if not (equal and totals["drafted"] > 0 and totals["accepted"] > 0 and
            totals["rollbacks"] > 0):
        raise AssertionError(f"speculative_decode: streams equal {equal}, "
                             f"counters {totals}")

    # 47: temperature > 0 with top-k, one round a fence so that each
    # slot's live rounds are counted on the host
    import numpy as np
    spec.reset()
    for slot, p in enumerate(prompts):
        spec.start_request(slot, p, max_new=SPEC_NEW // 2,
                           temperature=SPEC_TEMPERATURE, top_k=SPEC_TOP_K)
    live = np.zeros(spec.config.max_slots, np.int64)
    snap = spec.fetch_state()
    t0 = time.perf_counter()
    while snap["active"].any():
        live += snap["active"]
        spec.spec_block(1)
        snap = spec.fetch_state()
    sampled_s = time.perf_counter() - t0
    sp = snap["speculative"]
    toks = snap["out_tokens"][:, :SPEC_NEW // 2]
    ok = (bool(((toks >= 0) & (toks < cfg.vocab_size)).all()) and
          list(snap["n_gen"]) == [SPEC_NEW // 2] * len(prompts) and
          bool((sp["accepted"] <= sp["drafted"]).all()) and
          np.array_equal(sp["verified"], live))
    emit({"phase": "speculative_sampled", "temperature": SPEC_TEMPERATURE,
          "top_k": SPEC_TOP_K, "new_tokens_each": SPEC_NEW // 2,
          "drafted": int(sp["drafted"].sum()),
          "accepted": int(sp["accepted"].sum()),
          "verified": sp["verified"].tolist(), "live_rounds": live.tolist(),
          "rollbacks": int(sp["rollbacks"].sum()),
          "acceptance_rate": int(sp["accepted"].sum()) /
          max(int(sp["drafted"].sum()), 1),
          "wall_s": sampled_s, "ok": ok, "card": card})
    if not ok:
        raise AssertionError("speculative_sampled: tokens, counters or "
                             "live rounds out of their contract")
    del spec, vanilla
    release()
    return counts, cfg, params


def projection_bytes(engine):
    """The bytes of the projection weights the engine reads a step
    (values, and scales where quantized)."""
    total = 0
    for lp in engine._weights["layers"]:
        for name, t in lp.items():
            if name.endswith(".kernel") or name.endswith(".kernel_scale"):
                total += t.numel() * t.element_size()
    return total


def int8_serving(seed, card, cfg, params, device="cuda"):
    """Phases 48-49: int8 weight-only serving against bf16 on phase 46's
    weights (the int8 path's launch counts zeroed after the warm-up,
    right before the timed serve), then int8 with speculative decoding against int8 alone.
    Returns the int8 path's counts."""
    import torch
    from deepspeed_tpu_torch.inference import InferenceEngine
    prompts = spec_prompts(seed, cfg.vocab_size)
    engines = {}
    on_card = torch.device(device).type == "cuda"
    for bits in (32, 8):
        before = torch.cuda.memory_allocated() if on_card else 0
        eng = InferenceEngine(cfg, params, spec_serving_config(bits),
                              device=device)
        sync(device)
        engines[bits] = (eng, torch.cuda.memory_allocated() - before
                         if on_card else None)
    e16, e8 = engines[32][0], engines[8][0]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    check_verify_rows("int8", e8, gen, card)

    # teacher-forced decode logits: both engines take the bf16 engine's
    # token at every step
    for eng in (e16, e8):
        eng.reset()
        for slot, p in enumerate(prompts):
            eng.start_request(slot, p, max_new=INT8_FORCED_STEPS)
    worst, checked, agree = 0.0, 0, 0
    for _ in range(INT8_FORCED_STEPS):
        l16 = e16.decode_once().float()
        l8 = e8.decode_once().float()
        e8._state["cur_token"] = e16._state["cur_token"].clone()
        worst = max(worst, float((l16 - l8).abs().max()))
        top2 = torch.topk(l16, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * TOL_INT8_LOGITS
        checked += int(clear.sum())
        agree += int((clear & (l16.argmax(-1) == l8.argmax(-1))).sum())
    sync(device)
    stats = {}
    for bits, (eng, load_bytes) in engines.items():
        eng.reset()
        sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for slot, p in enumerate(prompts):
            eng.start_request(slot, p, max_new=SPEC_NEW)
        sync(device)
        t0 = time.perf_counter()
        eng.decode_block(SPEC_NEW)
        sync(device)
        decode_s = time.perf_counter() - t0
        stats[bits] = {
            "decode_ms_per_step": decode_s * 1e3 / SPEC_NEW,
            "decode_tokens_per_s": len(prompts) * SPEC_NEW / decode_s,
            "projection_bytes": projection_bytes(eng),
            "engine_bytes_on_load": load_bytes,
            "peak_bytes_decoding": torch.cuda.max_memory_allocated()
            if on_card else None}
    # served: the int8 engine (phase 46 served the same requests on
    # bf16 with these settings: its vanilla_tokens_per_s)
    van8, _, wall = serve_timed(e8, prompts, SPEC_NEW, device)
    counts = read_counts()
    stats[8]["served_tokens_per_s"] = len(prompts) * SPEC_NEW / wall
    ok = worst <= TOL_INT8_LOGITS and agree == checked
    emit({"phase": "int8_serving", "block": INT8_BLOCK,
          "forced_steps": INT8_FORCED_STEPS,
          "max_abs_logit_diff": worst, "tol": TOL_INT8_LOGITS,
          "argmax_checked": checked, "argmax_agree": agree,
          "bf16": stats[32], "int8": stats[8], "ok": ok, "card": card})
    if not ok:
        raise AssertionError("int8 decode logits out of their bound against "
                             "bf16")
    del engines, e16, e8
    release()

    # 49: int8 with speculative decoding, half the new tokens: the
    # stream is the int8 engine's
    both = InferenceEngine(cfg, params,
                           spec_serving_config(8, speculative=SPEC_BLOCK),
                           device=device)
    both.spec_block = no_sync(both.spec_block, device)
    got, _, wall = serve_timed(both, prompts, SPEC_NEW // 2, device)
    equal = all(got[i].out_tokens.tolist() ==
                van8[i].out_tokens[:SPEC_NEW // 2].tolist() for i in van8)
    totals = spec_totals(both)
    emit({"phase": "int8_speculative", "new_tokens_each": SPEC_NEW // 2,
          "streams_equal": equal, **totals,
          "acceptance_rate": totals["accepted"] / max(totals["drafted"], 1),
          "tokens_per_s": len(prompts) * (SPEC_NEW // 2) / wall,
          "card": card})
    if not (equal and totals["accepted"] > 0):
        raise AssertionError(f"int8_speculative: streams equal {equal}, "
                             f"counters {totals}")
    del both
    release()
    return counts


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
                    sequence_parallel=None, remat_policy=None, n_layer=None,
                    phase=None):
    """Phase 7: the JAX package's training flagship (bench_gpt2_15b:
    gpt2-1.5b, micro batch 11, seq 1024, bf16 without master weights,
    ZeRO-2, AdamW, full-block remat, dropout 0) through initialize ->
    train_batch, on one fixed batch repeated, so the loss must fall.
    With `quantized` (phase `quant_training`) the ds_config carries the
    quantized_compute block, so every projection runs K6. With
    `sequence_parallel` (phase `sp_training`) the model attends through
    ring or Ulysses attention over the default process group. With
    `remat_policy` (path H) the blocks remat under that named policy;
    `n_layer` cuts the depth. Returns the launch counts of its steps and
    the losses."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM

    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    over = {} if n_layer is None else {"n_layer": n_layer}
    cfg = train_config(sequence_parallel=sequence_parallel,
                       remat_policy=remat_policy, **over)
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
    phase = phase or ("quant_training" if quantized else
                      "sp_training" if sequence_parallel else "training")
    emit({"phase": phase, "model": "gpt2-1.5b", "n_layer": cfg.n_layer,
          "n_embd": cfg.n_embd, "n_head": cfg.n_head,
          "vocab": cfg.vocab_size, "micro_batch": batch, "seq": seq,
          "dtype": "bf16 params and moments (master_weights false), "
                   "stochastic rounding",
          "zero_stage": 2,
          "remat": remat_policy or "full block",
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
# half its time limit, and to 8 with the offload phases (the save, load
# and resume paths are the same at any depth; the bytes scale with it)
CKPT_N_LAYER = 8


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
    kwargs = dict(n_positions=MOE_SEQ, dropout=0.0, dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16, remat=True, remat_policy=None,
                  moe=moe)
    kwargs.update(overrides)
    return gpt2_config("gpt2-350m", **kwargs)


def moe_train_and_check(seed, card, warmup=2, steps=6, quantized=False,
                        n_layer=None):
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

    cfg = moe_config(quantized_experts="on" if quantized else "off",
                     **({} if n_layer is None else {"n_layer": n_layer}))
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
# path A's depth (BERT-large's width, 24 layers in the cell): cut to 8
# with the offload phases to keep the run within its time limit (the
# skips, the scale automaton and LAMB's update are the same at any
# depth)
FP16_A_LAYERS = 8
# path B's depth (gpt2-1.5b's width, 48 layers in the cell): cut to 16
# for the same reason
FP16_B_LAYERS = 16
# the serving phases 45-49 (~85 s) made room by cutting, the same
# way, path F (gpt2-1.5b under the ring in fp16) to 16 of 48 layers,
# paths D and E and the quantized MoE path (gpt2-350m-moe8) to 12 of 24
# (6 MoE layers)
FP16_F_LAYERS = 16
MOE_CUT_LAYERS = 12


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
    "moe_dispatch_fp16": "moe_dispatch",
    "moe_combine_fp16": "moe_combine",
    "fused_bias_gelu_fwd_grouped_fp16": "fused_bias_gelu_fwd",
    "fused_bias_gelu_bwd_grouped_fp16": "fused_bias_gelu_bwd",
    "quantized_matmul_fp16": "quantized_matmul",
    "flash_attention_merge_fp16": "flash_attention_merge",
    "flash_attention_bwd_fused_delta_fp16": "flash_attention_bwd_fused",
    "flash_attention_bwd_delta_fp16": "flash_attention_bwd",
}
# the fp16 paths: their launches are the fp16 forms'
FP16_PATHS = ("sparse_attention_fp16", "bert_fp16", "gpt2_fp16_pld",
              "engine_surface_fp16", "moe_fp16", "moe_quant_fp16",
              "sequence_parallel_fp16", "sp_fp16", "offload_fp16")
# an fp16 row whose launches are counted apart from its bf16 row's
# counter (K4's grouped launches), and the paths of a row whose counter
# other fp16 forms share: K2's given-delta entry runs on the ring paths
# only, its other entries on the rest
FP16_COUNTERS = {
    "fused_bias_gelu_fwd_grouped_fp16": "fused_bias_gelu_fwd_grouped",
    "fused_bias_gelu_bwd_grouped_fp16": "fused_bias_gelu_bwd_grouped",
}
FP16_ROW_PATHS = {
    "flash_attention_bwd_fused_delta_fp16": ("sp_fp16",),
    "flash_attention_bwd_delta_fp16": ("sequence_parallel_fp16",),
    "flash_attention_bwd_fused_fp16": tuple(
        p for p in FP16_PATHS if p != "sp_fp16"),
    "flash_attention_bwd_fp16": tuple(
        p for p in FP16_PATHS if p != "sequence_parallel_fp16"),
}
# paths D, E and F start from the scale 2^16 (the JAX package's own
# fp16 leg starts low too)
FP16_SCALE_POWER = 16
# a run ends once this many clean steps follow the last skipped one, or
# fails at the cap
FP16_CLEAN_STEPS = 8
FP16_STEP_CAP = {"bert_fp16": 64, "gpt2_fp16_pld": 64, "surface": 48,
                 "moe_fp16": 40, "moe_quant_fp16": 40, "sp_fp16": 40}
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
    SDPA in fp16, `F.layer_norm` and `F.gelu` (graph). Then the forms of
    paths D, E and F: `kernel_fp16_moe`, `kernel_fp16_qmm`,
    `kernel_fp16_merge`."""
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
    kernel_fp16_moe(peaks, gen, out, checks)
    kernel_fp16_qmm(peaks, gen, out, checks)
    kernel_fp16_merge(peaks, gen, out, checks)
    return out, checks


# K8, grouped K4, K6 (fp16 out), K5 and K2's given delta in fp16: the
# forms the fp16 MoE, quantized MoE and ring paths (D, E, F) run.
# A 16-bit K8 combine row is one rounding of the twin's fp32 sum: one
# fp16 ulp (2^-10 relative; the atol covers fp16's subnormals)
TOL_K8_F16 = dict(atol=2 ** -24, rtol=2 ** -10)


def kernel_fp16_moe(peaks, gen, out, checks):
    """The fp16 forms of K8 and grouped K4 at gpt2-350m-moe8's shapes
    (path D): dispatch and combine at N 16,384 tokens, H 1024, 8 experts
    of capacity 5,120, top-2 with empty slots and drops; bias + tanh-GeLU
    over the experts' [8, 5,120, 4,096] rows with a bias [8, 4,096]
    (dbias [8, 4,096]). Each against its twin (dispatch exactly, combine
    within one fp16 ulp, K4 within TOL_F16 / GRAD_TOL_F16), a second
    launch bit for bit, an inf in the input reaching every output the
    twin's reaches, and an fp16 combine whose sum passes 65504 inf where
    the twin's is. Timed back to back and from a CUDA graph beside the
    bound, the twin, the bf16 form at the same shape and the yardstick
    (index_select; F.gelu)."""
    import importlib
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    fd = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")
    f16, bf16 = torch.float16, torch.bfloat16
    n, h, k = MOE_BATCH * MOE_SEQ, 1024, MOE_TOP_K
    routing, stats, src, dest, cap = moe_routing(gen, n, k, 1.0)
    ec = MOE_EXPERTS * cap
    occupied = int((src < n).sum())
    kept = int(routing["keep"].sum())
    label = f"fp16 k{k} N{n} H{h} E{MOE_EXPERTS} C{cap}"
    x = torch.randn((n, h), generator=gen, device="cuda").to(f16)
    ye = torch.randn((ec, h), generator=gen, device="cuda").to(f16)
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
    err = check(f"combine, {label}", y, fd._combine_rows_plain(ye, dest, cw),
                TOL_K8_F16, checks)
    same = torch.equal(y, fd.combine_rows(ye, dest, cw))
    checks.append({"check": f"combine repeats bit for bit, {label}",
                   "equal": same})
    if not same:
        raise AssertionError(f"combine {label}: a second launch differs")
    x_inf = x.clone()
    x_inf[int(src[src < n][0])] = float("inf")
    xe_inf = fd.gather_rows(x_inf, src)
    check_nonfinite(f"dispatch, inf in a token, {label}", xe_inf,
                    fd._gather_rows_plain(x_inf, src), checks)
    check_nonfinite(f"combine, inf in a slot, {label}",
                    fd.combine_rows(xe_inf, dest, cw),
                    fd._combine_rows_plain(xe_inf, dest, cw), checks)
    big = torch.full((ec, h), 40000.0, device="cuda", dtype=f16)
    ones = torch.ones_like(cw)
    check_nonfinite(f"combine past 65504, {label}",
                    fd.combine_rows(big, dest, ones),
                    fd._combine_rows_plain(big, dest, ones), checks)
    del x_inf, xe_inf, big
    d_bound, d_by = bound(0, peaks["bf16"], (occupied + ec) * h * 2 +
                          ec * 4, peaks)
    c_bound, c_by = bound(2 * kept * h, peaks["fp32"],
                          (kept + n) * h * 2 + n * k * 8, peaks)
    xp = torch.cat([x, x.new_zeros((1, h))])
    srcl = src.long()
    xb, yeb = x.to(bf16), ye.to(bf16)
    out["moe_dispatch_fp16"]["moe_fp16"] = dict(
        max_abs_err=0.0, ms=time_ms(lambda: fd.gather_rows(x, src)),
        graph_ms=graph_ms(lambda: fd.gather_rows(x, src)),
        plain_ms=time_ms(lambda: fd._gather_rows_plain(x, src)),
        bound_ms=d_bound, bound_by=d_by,
        library_ms=time_ms(lambda: xp.index_select(0, srcl)),
        library_graph_ms=graph_ms(lambda: xp.index_select(0, srcl)),
        library_call="index_select on the padded fp16 tokens",
        bf16_graph_ms=graph_ms(lambda: fd.gather_rows(xb, src)),
        shape=label)
    out["moe_combine_fp16"]["moe_fp16"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fd.combine_rows(ye, dest, cw)),
        graph_ms=graph_ms(lambda: fd.combine_rows(ye, dest, cw)),
        plain_ms=time_ms(lambda: fd._combine_rows_plain(ye, dest, cw)),
        bound_ms=c_bound, bound_by=c_by, library_ms=None,
        bf16_graph_ms=graph_ms(lambda: fd.combine_rows(yeb, dest, cw)),
        shape=label)
    del x, ye, xe, y, xp, xb, yeb
    release()

    # grouped K4 over the experts' rows
    w = 4 * h
    label = f"fp16 grouped G{MOE_EXPERTS} C{cap} W{w} tanh"
    x = torch.randn((MOE_EXPERTS, cap, w), generator=gen,
                    device="cuda").to(f16)
    bias = (0.1 * torch.randn((MOE_EXPERTS, w), generator=gen,
                              device="cuda")).to(f16)

    def fwd():
        return fo.fused_bias_gelu_with_sum(x, bias, approximate=True)

    o, s = fwd()
    torch.cuda.synchronize()
    ro, _ = fo._gelu_fwd_math(x, bias, True)
    err = check(f"grouped gelu out, {label}", o, ro.to(f16), TOL_F16,
                checks)
    again = fwd()
    if not (torch.equal(o, again[0]) and torch.equal(s, again[1])):
        raise AssertionError(f"grouped K4-fwd {label}: a second launch "
                             "differs")
    x_inf = x.clone()
    x_inf[3, 17, 9] = float("inf")
    check_nonfinite(f"grouped gelu out, inf in x, {label}",
                    fo.fused_bias_gelu(x_inf, bias, approximate=True),
                    fo._gelu_fwd_math(x_inf, bias, True)[0].to(f16), checks)
    del x_inf, again
    rows = MOE_EXPERTS * cap * w
    nbytes = 3 * rows * 2 + MOE_EXPERTS * w * 2
    bound_ms, bound_by = bound(20 * rows, peaks["fp32"], nbytes, peaks)
    xb, bb = x.to(bf16), bias.to(bf16)
    xl = x.clone()
    out["fused_bias_gelu_fwd_grouped_fp16"]["moe_fp16"] = rates(dict(
        max_abs_err=err, ms=time_ms(fwd), graph_ms=graph_ms(fwd),
        plain_ms=time_ms(lambda: fo._gelu_fwd_math(x, bias, True)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        yardstick="F.gelu(x, approximate='tanh') of x alone (fp16)",
        yardstick_graph_ms=graph_ms(lambda: F.gelu(xl, approximate="tanh")),
        bf16_graph_ms=graph_ms(lambda: fo.fused_bias_gelu(
            xb, bb, approximate=True)),
        shape=label), 20 * rows)
    del xb, bb, xl
    dout = torch.randn(x.shape, generator=gen, device="cuda").to(f16)

    def bwd():
        return fo.fused_bias_gelu_backward(s, dout, approximate=True,
                                           groups=MOE_EXPERTS)

    got = bwd()
    torch.cuda.synchronize()
    rdx = fo._gelu_bwd_math(s, dout, True)
    errs = [check_rel(f"grouped gelu bwd dx, {label}", got[0], rdx.to(f16),
                      GRAD_TOL_F16, checks),
            check_rel(f"grouped gelu bwd dbias, {label}", got[1],
                      rdx.sum(1), GRAD_TOL_F32 * 10, checks)]
    again = bwd()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"grouped K4-bwd {label}: a second launch "
                             "differs")
    d_inf = dout.clone()
    d_inf[5, 2, 1] = float("inf")
    got_inf = fo.fused_bias_gelu_backward(s, d_inf, approximate=True,
                                          groups=MOE_EXPERTS)
    ref_inf = fo._gelu_bwd_math(s, d_inf, True)
    check_nonfinite(f"grouped gelu bwd dx, inf in dout, {label}",
                    got_inf[0], ref_inf.to(f16), checks)
    check_nonfinite(f"grouped gelu bwd dbias, inf in dout, {label}",
                    got_inf[1], ref_inf.sum(1), checks)
    del got_inf, ref_inf, d_inf, again, rdx
    nbytes = 3 * rows * 2 + MOE_EXPERTS * w * 4
    bound_ms, bound_by = bound(25 * rows, peaks["fp32"], nbytes, peaks)
    sb, db = s.to(bf16), dout.to(bf16)
    xg = x.clone().requires_grad_(True)

    def lib_fwd():
        return F.gelu(xg, approximate="tanh")

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (xg,), dout)

    out["fused_bias_gelu_bwd_grouped_fp16"]["moe_fp16"] = rates(dict(
        max_abs_err=errs[0], ms=time_ms(bwd), graph_ms=graph_ms(bwd),
        plain_ms=time_ms(lambda: fo._gelu_bwd_math(s, dout, True)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        yardstick="F.gelu(approximate='tanh') backward of x alone (fp16; "
                  "fwd+bwd less fwd)",
        yardstick_graph_ms=graph_ms(lib_fwd_bwd) - graph_ms(lib_fwd),
        bf16_graph_ms=graph_ms(lambda: fo.fused_bias_gelu_backward(
            sb, db, approximate=True, groups=MOE_EXPERTS)),
        shape=label), 25 * rows)
    del x, bias, o, s, dout, got, sb, db, xg
    release()


def kernel_fp16_qmm(peaks, gen, out, checks):
    """K6 with an fp16 output at path E's shapes: gpt2-350m-moe8's four
    projections (M 16,384) and its experts' two grouped GEMMs (G 8, C
    5,120), bit for bit its twin; the bf16 output on the same operands in
    the same call; an output past 65504 inf where the twin's is. Timed
    (the wrapper as the path calls it, and the launch alone) beside the
    bound, the twin, the bf16-output form and the yardsticks
    torch._int_mm and the fp16 matmul."""
    import torch
    qm = _qmm()
    f16, bf16 = torch.float16, torch.bfloat16
    moe_m = MOE_BATCH * MOE_SEQ
    cases = (
        ("c_attn M16384 K1024 N3072", 1, moe_m, 1024, 3072, "c_attn"),
        ("c_proj M16384 K1024 N1024", 1, moe_m, 1024, 1024, "c_proj"),
        ("c_fc M16384 K1024 N4096", 1, moe_m, 1024, 4096, "c_fc"),
        ("mlp_c_proj M16384 K4096 N1024", 1, moe_m, 4096, 1024,
         "mlp_c_proj"),
        ("experts wi G8 C5120 K1024 N4096", MOE_EXPERTS, 5120, 1024, 4096,
         "wi"),
        ("experts wo G8 C5120 K4096 N1024", MOE_EXPERTS, 5120, 4096, 1024,
         "wo"),
    )
    for label, g, m, k, n, name in cases:
        label = "fp16 out " + label
        block = QUANT_BLOCK
        x = torch.randn((g, m, k), generator=gen, device="cuda").to(f16)
        w = (0.02 * torch.randn((g, k, n), generator=gen, device="cuda")) \
            .to(f16)
        wq, sw = qm.quantize_kernel_int8(w, block)
        xq, sx = qm.quantize_rows_int8(x)
        kp = wq.shape[-2]
        xq = torch.nn.functional.pad(xq, (0, kp - k)).contiguous()

        def run(dt=f16):
            return qm._qmm_launch(xq, wq, sx, sw, block, dt)

        got = run()
        torch.cuda.synchronize()
        ref = qm._qmm_plain(xq, wq, sx, sw, block, f16)
        err = check(f"qmm, {label}", got, ref, TOL_F16, checks)
        checks[-1]["exact"] = bool(torch.equal(got, ref))
        if not checks[-1]["exact"]:
            raise AssertionError(f"qmm, {label}: not bit for bit its twin")
        if not torch.equal(run(bf16), qm._qmm_plain(xq, wq, sx, sw, block,
                                                    bf16)):
            raise AssertionError(f"qmm bf16 out on the operands of {label}: "
                                 "not bit for bit its twin")
        big = sx * 1e5
        check_nonfinite(f"qmm past 65504, {label}",
                        qm._qmm_launch(xq, wq, big, sw, block, f16),
                        qm._qmm_plain(xq, wq, big, sw, block, f16), checks)
        del got, ref, big
        row = qmm_row(peaks, checks, label, x, w, xq, wq, sx, sw, block, f16,
                      err)
        row.update(graph_ms=graph_ms(run),
                   bf16_graph_ms=graph_ms(lambda: run(bf16)))
        out["quantized_matmul_fp16"][f"moe_quant_fp16:{name}"] = row
        del x, w, wq, sw, xq, sx
        release()


def kernel_fp16_merge(peaks, gen, out, checks):
    """K5 in fp16 at path F's shape ([11, 1024, 25, 64] causal, an empty
    carry: the ring over one rank) and the ring leg's ([1, 8192, 4, 64]
    causal, a carry from K1 over a disjoint block whose first rows are
    empty), and K2's given-delta entry in fp16 on both its routes there
    (K2-fused at T 1024, the sweeps at T 8192): each against its twin
    (out within TOL_F16, the lse within TOL_F32, gradients GRAD_TOL_F16),
    a second launch bit for bit, an inf in v (K5) or in dO (K2) reaching
    every output the twin's reaches. Timed back to back and from a CUDA
    graph beside the bound, the twin, the bf16 form on the same values
    and SDPA in fp16 (the forward; forward + backward less forward)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    f16, bf16 = torch.float16, torch.bfloat16
    shapes = (("sp_fp16", (TRAIN_BATCH, TRAIN_SEQ, 25, 64), True),
              ("sequence_parallel_fp16", SP_SHAPE_8K, False))
    for path, shape, empty in shapes:
        b, t, h, d = shape
        label = f"fp16 causal {list(shape)}" + \
            (" empty carry" if empty else "")
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(f16)
                   for _ in range(3))
        if empty:
            prev = torch.zeros(shape, device="cuda")
            plse = torch.full((b, h, t), fa.NEG_INF, device="cuda")
        else:
            k2, v2 = (torch.randn(shape, generator=gen, device="cuda")
                      .to(f16) for _ in range(2))
            prev, plse = fa.flash_attention_with_lse(q, k2, v2, causal=False)
            prev, plse = prev.float(), plse[..., 0].contiguous()
            prev[:, :7] = 0.0
            plse[:, :, :7] = fa.NEG_INF
            del k2, v2
        sm = d ** -0.5

        def merge(q=q, k=k, v=v):
            return fa._flash_merge_launch(q, k, v, prev, plse, sm, True)

        got = merge()
        torch.cuda.synchronize()
        ref = fa._flash_merge_plain(q, k, v, prev, plse, sm, True)
        err = check(f"merge out, {label}", got[0], ref[0], TOL_F16, checks)
        check(f"merge lse, {label}", got[1], ref[1], TOL_F32, checks)
        check(f"merge lse_n, {label}", got[2], ref[2], TOL_F32, checks)
        if not all(torch.equal(a, c) for a, c in zip(got, merge())):
            raise AssertionError(f"K5 {label}: a second launch differs")
        v_inf = v.clone()
        v_inf[0, 5, 0, 3] = float("inf")
        check_nonfinite(f"merge out, inf in v, {label}", merge(v=v_inf)[0],
                        fa._flash_merge_plain(q, k, v_inf, prev, plse, sm,
                                              True)[0], checks)
        del got, ref, v_inf
        bound_ms, bound_by = merge_bound(peaks, b, t, h, d, 2, True)
        qb, kb, vb = (x.to(bf16) for x in (q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = t * (t + 1) // 2

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        out["flash_attention_merge_fp16"][path] = rates(dict(
            max_abs_err=err, ms=time_ms(merge), graph_ms=graph_ms(merge),
            plain_ms=time_ms(lambda: fa._flash_merge_plain(
                q, k, v, prev, plse, sm, True), iters=1, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(sdpa), library_graph_ms=graph_ms(sdpa),
            library_call="F.scaled_dot_product_attention forward (fp16)",
            bf16_graph_ms=graph_ms(lambda: merge(qb, kb, vb)),
            shape=label), 4.0 * b * h * d * pairs)
        del qb, kb, vb, qt, kt, vt, prev, plse
        release()

        # K2's given-delta entry on the route this T takes
        label = f"fp16 causal {list(shape)} given delta"
        dout = torch.randn(shape, generator=gen, device="cuda").to(f16)
        _, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        lse = lse[..., 0].contiguous()
        delta, dlse = (torch.randn((b, h, t), generator=gen, device="cuda")
                       for _ in range(2))
        fused = fa._fused_route(q)
        row = "flash_attention_bwd_fused_delta_fp16" if fused else \
            "flash_attention_bwd_delta_fp16"
        name = "flash bwd fused" if fused else "flash bwd"

        def run(q=q, k=k, v=v, dout=dout):
            return fa.flash_attention_backward(q, k, v, None, lse, dout,
                                               dlse, sm, True, delta=delta)

        got = run()
        torch.cuda.synchronize()
        ref = fa._flash_bwd_twin(q, k, v, None, lse, dout, dlse, sm, True,
                                 delta=delta)
        errs = [check_rel(f"{name} d{n}, {label}", x, y, GRAD_TOL_F16,
                          checks) for n, x, y in zip("qkv", got, ref)]
        if not all(torch.equal(a, c) for a, c in zip(got, run())):
            raise AssertionError(f"{name} {label}: a second launch differs")
        d_inf = dout.clone()
        d_inf[0, 7, 1, 2] = float("inf")
        for n, x, y in zip("qkv", run(dout=d_inf), fa._flash_bwd_twin(
                q, k, v, None, lse, d_inf, dlse, sm, True, delta=delta)):
            check_nonfinite(f"{name} d{n}, inf in dO, {label}", x, y, checks)
        del got, ref, d_inf
        nbytes = 7 * b * t * h * d * 2 + 12 * b * h * t
        bound_ms, bound_by = bound(10.0 * b * h * d * pairs, peaks["bf16"],
                                   nbytes, peaks)
        qb, kb, vb, db = (x.to(bf16) for x in (q, k, v, dout))
        lib_fwd_ms, lib_fwd, lib_ms, lib_graph_ms = sdpa_ms(q, k, v, dout,
                                                            True)
        out[row][path] = rates(dict(
            max_abs_err=max(errs), ms=time_ms(run), graph_ms=graph_ms(run),
            plain_ms=time_ms(lambda: fa._flash_bwd_twin(
                q, k, v, None, lse, dout, dlse, sm, True, delta=delta),
                iters=1, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            library_graph_ms=lib_graph_ms,
            library_call="F.scaled_dot_product_attention fwd+bwd less fwd "
                         "(fp16)",
            bf16_graph_ms=graph_ms(lambda: run(qb, kb, vb, db)),
            shape=label), 10.0 * b * h * d * pairs)
        del q, k, v, dout, lse, delta, dlse, qb, kb, vb, db
        release()


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
    post-LN layers, here FP16_A_LAYERS, hidden 1024, 16 heads, vocab
    30,522, micro batch 16, gas 16, seq 128, dropout 0) in fp16 with LAMB through initialize ->
    train_batch on one repeated batch of its recipe, from the scale
    2^32 until 8 clean steps follow the last skip (`run_fp16_path`).
    Reports samples/s and TFLOP/s too. Returns the launch counts."""
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.bert import BertForPreTrainingLM

    cfg = bert_model_config(fp16=True, bf16=False,
                            num_hidden_layers=FP16_A_LAYERS)
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
        expect_per_step={k: v * BERT_GAS * FP16_A_LAYERS // 24
                         for k, v in BERT_LAUNCHES_PER_MICRO.items()},
        tokens_per_step=BERT_BATCH * BERT_GAS * BERT_SEQ,
        extra={"model": "bert-large", "n_layer": FP16_A_LAYERS,
               "n_params": n_params,
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
    """Path B (phase 28): the training flagship (bench_gpt2_15b: gpt2-1.5b
    at FP16_B_LAYERS of its 48 layers, micro batch 11, seq 1024, ZeRO-2,
    AdamW, full-block remat, dropout 0)
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

    cfg = train_config(dtype=torch.float16, param_dtype=torch.float32,
                       n_layer=FP16_B_LAYERS)
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


def moe_fp16_launches(n_layer, quantized):
    """Launches a step of the fp16 MoE GPT-2 (every other layer MoE,
    full-block remat: forward and recompute): dense blocks K3-fwd (c_proj
    + ln_2) and dense K4 twice, K3-bwd and K4-bwd once; MoE blocks K8's
    two gathers three times each (forward, recompute, backward), grouped
    K4 twice and once; every block K1-fwd twice and K2-fused once;
    quantized, K6 for every projection twice (the STE backward runs
    none): 4 a dense block, c_attn, c_proj and the experts' wi and wo a
    MoE block."""
    moe = n_layer // 2
    counts = {"flash_attention_fwd": 2 * n_layer,
              "flash_attention_bwd_fused": n_layer,
              "flash_attention_bwd": 0,
              "fused_bias_residual_layernorm_fwd": 2 * (n_layer - moe),
              "fused_bias_residual_layernorm_bwd": n_layer - moe,
              "fused_bias_gelu_fwd": 2 * n_layer,
              "fused_bias_gelu_bwd": n_layer,
              "fused_bias_gelu_fwd_grouped": 2 * moe,
              "fused_bias_gelu_bwd_grouped": moe,
              "moe_dispatch": 3 * moe, "moe_combine": 3 * moe,
              "quantized_matmul": 8 * n_layer if quantized else 0}
    return counts


def moe_fp16(seed, card, quantized=False):
    """Path D (phase 30, `moe_fp16`): gpt2-350m-moe8 at full width
    and MOE_CUT_LAYERS of its 24 layers (n_embd 1024, 8 experts, top-2,
    capacity 1.25, every other layer) through initialize -> train_batch with moe_ds_config()'s
    block and fp16 ({"enabled": true, "initial_scale_power": 16}: fp16
    parameters, fp32 masters and moments) in place of bf16, ZeRO-0,
    AdamW, full-block remat, on one repeated batch until 8 clean steps
    follow the last skip (`run_fp16_path`'s gates, exact launches of
    `moe_fp16_launches`). With `quantized`, path E (phase 31,
    `moe_quant_fp16`): quantized experts and the quantized_compute block,
    as `moe_quant_training` has them, so every projection runs K6 with
    an fp16 output. Returns the launch counts."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM

    name = "moe_quant_fp16" if quantized else "moe_fp16"
    cfg = moe_config(quantized_experts="on" if quantized else "off",
                     dtype=torch.float16, param_dtype=torch.float32,
                     n_layer=MOE_CUT_LAYERS)
    ds_config = moe_ds_config()
    del ds_config["bf16"]
    ds_config["fp16"] = {"enabled": True,
                         "initial_scale_power": FP16_SCALE_POWER}
    if quantized:
        ds_config["quantized_compute"] = dict(QUANT_BLOCK_CONFIG)
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg)
    engine, _, _, _ = dst.initialize(model=model,
                                     model_parameters=model.init(seed),
                                     config=ds_config)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, MOE_BATCH, MOE_SEQ)).astype(np.int32)
    staged = engine.stage_batch({"input_ids": ids})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counts, _ = run_fp16_path(
        name, engine, staged, FP16_STEP_CAP[name], card,
        expect_per_step=moe_fp16_launches(cfg.n_layer, quantized),
        tokens_per_step=MOE_BATCH * MOE_SEQ,
        extra={"model": "gpt2-350m-moe8", "n_layer": cfg.n_layer,
               "n_embd": cfg.n_embd, "moe_layers": cfg.moe_cells,
               "setup_s": setup_s, "micro_batch": MOE_BATCH,
               "seq": MOE_SEQ, "zero_stage": 0, "remat": "full block",
               "initial_scale_power": FP16_SCALE_POWER,
               "quantized_compute": ds_config.get("quantized_compute"),
               "dtype": "fp16 parameters, fp32 masters and moments"})
    del engine, model, staged
    return counts


def sequence_parallel_fp16_path(seed, card):
    """Phase 32 (`sequence_parallel_fp16`): the ring leg in fp16 in the
    one-rank NCCL group, forward + backward of sum(out.float()) with
    q = k = v causal at [1, 8192, 4, 64]: ring_attention's flash body
    (K5, then K2's given-delta sweeps) held to K1 in fp16, then four
    ranks' folds played in one process (`emulated_ring`: 10 K5 and 10
    K2 given-delta launches) held to K1 / K2 on the whole sequence.
    Launch counts are zeroed right before the passes and read after.
    Returns them."""
    import torch
    from deepspeed_tpu_torch.ops.sequence import ring_attention
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    f16 = torch.float16
    q = torch.randn(SP_SHAPE_8K, generator=gen, device="cuda").to(f16)
    qs, ks, vs = (torch.randn(SP_SHAPE_8K, generator=gen, device="cuda")
                  .to(f16).requires_grad_(True) for _ in range(3))
    checks = []
    reset_counts()
    x = q.detach().requires_grad_(True)
    out = ring_attention(x, x, x, causal=True, use_flash=True)
    out.float().sum().backward()
    emulated = emulated_ring(qs, ks, vs, SP_RANKS)
    grads = torch.autograd.grad(emulated.float().sum(), (qs, ks, vs))
    torch.cuda.synchronize()
    counts = read_counts()
    if not (torch_isfinite(out) and torch_isfinite(x.grad)):
        raise AssertionError("sequence_parallel_fp16: non-finite output or "
                             "gradient")
    check("ring flash fp16 [1, 8192, 4, 64] against K1", out,
          fa.flash_attention(q, q, q, causal=True), TOL_F16, checks)
    ref = fa.flash_attention(qs, ks, vs, causal=True)
    ref_grads = torch.autograd.grad(ref.float().sum(), (qs, ks, vs))
    check(f"emulated {SP_RANKS}-rank ring fp16 out against K1", emulated,
          ref, TOL_F16, checks)
    for n, a, b in zip("qkv", grads, ref_grads):
        check_rel(f"emulated ring fp16 d{n} against K2", a, b, TOL_SP_GRAD,
                  checks)
    emit({"phase": "sequence_parallel_fp16", "card": card,
          "group": "one-rank NCCL (file:// rendezvous)",
          "config": "bench.py bench_ring_attention in fp16: causal, "
                    "q = k = v, fwd + bwd of sum(out.float()), and the "
                    f"emulated {SP_RANKS}-rank ring",
          "checks": checks,
          "launches": {k: counts[k] for k in SEQUENCE_PARALLEL_KERNELS}})
    del q, x, out, qs, ks, vs, emulated, grads, ref, ref_grads
    release()
    return counts


def sp_fp16(seed, card):
    """Path F (phase 33, `sp_fp16`): sp_training (the training flagship's
    gpt2-1.5b at FP16_F_LAYERS of its 48 layers, micro batch 11, seq 1024, ZeRO-2, AdamW, full-block remat,
    with sequence_parallel="ring" over the one-rank group) in fp16 with
    fp32 masters from the scale 2^16, until 8 clean steps follow the
    last skip (`run_fp16_path`'s gates): every layer's attention is K5
    (no K1) and its backward K2-fused's given-delta entry. Returns the
    launch counts."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM

    cfg = train_config(dtype=torch.float16, param_dtype=torch.float32,
                       sequence_parallel="ring", n_layer=FP16_F_LAYERS)
    ds_config = flagship_ds_config(TRAIN_BATCH)
    del ds_config["bf16"]
    ds_config["fp16"] = {"enabled": True,
                         "initial_scale_power": FP16_SCALE_POWER}
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
    expect = gpt2_fp16_launches(cfg.n_layer, pld=False)
    expect["flash_attention_merge"] = expect.pop("flash_attention_fwd")
    expect.update(flash_attention_fwd=0, flash_attention_bwd=0)
    counts, _ = run_fp16_path(
        "sp_fp16", engine, staged, FP16_STEP_CAP["sp_fp16"], card,
        expect_per_step=expect, tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
        extra={"model": "gpt2-1.5b", "n_layer": cfg.n_layer,
               "sequence_parallel": "ring (one-rank NCCL group)",
               "setup_s": setup_s, "micro_batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "zero_stage": 2, "remat": "full block",
               "initial_scale_power": FP16_SCALE_POWER,
               "dtype": "fp16 parameters, fp32 masters and moments"})
    del engine, model, staged
    return counts


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


# ----------------------------------------------------------------------
# phases 34-38: selective remat, the prefetch loader, user checkpointing
# ----------------------------------------------------------------------
# the forward kernels that a fused dense GPT-2 block's backward launches
# again under each remat policy, per layer. The JAX package's rematted
# grad jaxpr decides: tests/test_torch_remat_policies.py holds the port's
# recompute to it on the CPU and holds this table to the port's
REMAT_RECOMPUTE = {
    None: {"flash_attention_fwd": 1, "fused_bias_residual_layernorm_fwd": 2,
           "fused_bias_gelu_fwd": 1},
    "dots_with_no_batch_dims_saveable": {
        "flash_attention_fwd": 1, "fused_bias_residual_layernorm_fwd": 2,
        "fused_bias_gelu_fwd": 1},
    "save_only_these_names:attn_out,attn_lse": {
        "flash_attention_fwd": 0, "fused_bias_residual_layernorm_fwd": 2,
        "fused_bias_gelu_fwd": 1},
    "save_fused_epilogues": {
        "flash_attention_fwd": 0, "fused_bias_residual_layernorm_fwd": 0,
        "fused_bias_gelu_fwd": 1},
}


def gpt2_step_launches(policy, n_layer):
    """Each kernel's launches in one fused dense GPT-2 training step (gas
    1, T <= 1024): the forward (K1-fwd and K4-fwd once a layer, K3-fwd
    twice a layer and once for ln_f), the backward (K2-fused, K3-bwd and
    K4-bwd likewise), and what `policy`'s recompute launches again."""
    again = REMAT_RECOMPUTE[policy]
    n = n_layer
    return {"flash_attention_fwd": n + again["flash_attention_fwd"] * n,
            "flash_attention_bwd_fused": n, "flash_attention_bwd": 0,
            "fused_bias_residual_layernorm_fwd":
                2 * n + 1 + again["fused_bias_residual_layernorm_fwd"] * n,
            "fused_bias_residual_layernorm_bwd": 2 * n + 1,
            "fused_bias_gelu_fwd": n + again["fused_bias_gelu_fwd"] * n,
            "fused_bias_gelu_bwd": n}


def exact_launches(path, counts, steps, policy, n_layer):
    """Gate: `counts` over `steps` steps equal gpt2_step_launches."""
    want = gpt2_step_launches(policy, n_layer)
    got = {k: counts[k] / steps for k in want}
    ok = got == {k: float(v) for k, v in want.items()}
    emit({"phase": "exact_launches", "path": path, "remat_policy": policy,
          "n_layer": n_layer, "launches_per_step": got, "expected": want,
          "ok": ok})
    if not ok:
        raise AssertionError(f"{path}: launches per step {got} != {want}")


# phase 36: the attention names alone, at the flagship's width
ATTN_NAMES = "save_only_these_names:attn_out,attn_lse"
ATTN_NAMES_LAYERS = 4
# paths H and 36 run at this depth, beside full remat at the same depth
# (H ran the flagship's 48 layers until PR 23: cut to fit phases 54-57)
REMAT_CUT_LAYERS = ATTN_NAMES_LAYERS

# path G: bench.py's bench_gpt2_350m (bench.py:254-268) verbatim
SEL_BATCH, SEL_SEQ = 16, 1024
SEL_POLICY = "dots_with_no_batch_dims_saveable"
# ABCorrectnessChecker's loss tolerance on path G: the checker's default
# (bf16 primaries drift by rounding)
AB_LOSS_ATOL = 0.05
AB_STEPS = 4


def selective_config(remat_policy=SEL_POLICY):
    import torch
    from deepspeed_tpu_torch.models.gpt2 import gpt2_config
    return gpt2_config("gpt2-350m", n_positions=SEL_SEQ, dropout=0.0,
                       dtype=torch.bfloat16, remat=True,
                       remat_policy=remat_policy)


def selective_ds_config(steps_per_sync):
    """bench_gpt2_350m's ds_config with the async_dispatch block on."""
    return {"train_micro_batch_size_per_gpu": SEL_BATCH,
            "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 0},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-4, "weight_decay": 0.01}},
            "async_dispatch": {"enabled": True,
                               "steps_per_sync": steps_per_sync}}


def _timed_steps(engine, feed, warmup, steps, sync_error=False):
    """(losses, warm-up seconds, seconds a timed step); the timed steps
    run under set_sync_debug_mode("error") when `sync_error`."""
    import torch
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(feed())
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(feed())
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return losses, warm_s, step_s


def gpt2_350m_selective(seed, card, warmup=2, steps=6):
    """Phase 34, path G: bench_gpt2_350m (gpt2-350m, micro batch 16, seq
    1024, bf16 with fp32 masters, ZeRO-0, AdamW lr 1e-4 wd 0.01,
    remat_policy dots_with_no_batch_dims_saveable) with async_dispatch
    on, one repeated batch fed through engine.prefetch; the timed steps
    run under set_sync_debug_mode("error") (a fence falls inside them).
    Then a second engine on the same weights takes the same batches
    directly (bit-equal losses), the same config under full-block remat
    (losses within TOL_TRAIN_LOSS; its step ms and peak memory beside
    G's), and ABCorrectnessChecker on G's config for AB_STEPS steps
    (loss_atol AB_LOSS_ATOL); a profile of 2 steps under each policy.
    Returns the launch counts of the prefetch run."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.runtime.correctness import ABCorrectnessChecker

    n = warmup + steps
    cfg = selective_config()
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SEL_BATCH, SEL_SEQ)).astype(np.int32)
    params = GPT2ForCausalLM(cfg).init(seed)

    def engine_for(policy, steps_per_sync=steps):
        model = GPT2ForCausalLM(selective_config(policy))
        return dst.initialize(model=model, model_parameters=params,
                              config=selective_ds_config(steps_per_sync))[0]

    # G: through engine.prefetch
    engine = engine_for(SEL_POLICY)
    fences = []
    real_fence = engine._sync_fence
    engine._sync_fence = lambda: (fences.append(engine._host_steps),
                                  real_fence())
    loader = engine.prefetch(({"input_ids": ids} for _ in range(n)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, warm_s, step_s = _timed_steps(
        engine, lambda: engine.train_batch(data_iter=loader), warmup, steps,
        sync_error=True)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    loader.close()
    fed = torch.stack(losses).float().cpu()
    staged = engine.stage_batch({"input_ids": ids[None]})
    profile = profile_steps(
        lambda: [engine.train_batch(batch=staged) for _ in range(2)], 2)
    del engine, loader, losses, staged
    release()

    # the same steps fed directly
    engine = engine_for(SEL_POLICY)
    staged = engine.stage_batch({"input_ids": ids[None]})
    direct = torch.stack([engine.train_batch(batch=staged)
                          for _ in range(n)]).float().cpu()
    del engine, staged
    release()

    # full-block remat, the same config and steps
    engine = engine_for(None)
    staged = engine.stage_batch({"input_ids": ids[None]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    full, full_warm_s, full_step_s = _timed_steps(
        engine, lambda: engine.train_batch(batch=staged), warmup, steps)
    full_peak = torch.cuda.max_memory_allocated()
    full = torch.stack(full).float().cpu()
    full_profile = profile_steps(
        lambda: [engine.train_batch(batch=staged) for _ in range(2)], 2)
    del engine, staged
    release()

    # the A/B checker: G's engine beside its fp32 ZeRO-0 shadow
    checker = ABCorrectnessChecker(
        GPT2ForCausalLM(cfg), params, selective_ds_config(steps),
        interval=1, loss_atol=AB_LOSS_ATOL)
    ab_error = None
    try:
        for _ in range(AB_STEPS):
            checker.train_batch(batch={"input_ids": ids[None]})
    except AssertionError as e:
        ab_error = str(e)
    report = checker.report()
    del checker, params
    release()

    vals = [float(x) for x in fed]
    gaps = [abs(a - b) for a, b in zip(vals, full.tolist())]
    ok = all(np.isfinite(vals)) and vals[-1] < vals[0]
    bit_equal = torch.equal(fed, direct)
    emit({"phase": "gpt2_350m_selective", "path": "G", "model": "gpt2-350m",
          "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
          "micro_batch": SEL_BATCH, "seq": SEL_SEQ,
          "dtype": "bf16 compute, fp32 master weights", "zero_stage": 0,
          "remat_policy": SEL_POLICY, "async_dispatch": True,
          "fed_by": "engine.prefetch (PrefetchLoader, depth 2)",
          "fences_at_steps": fences, "warmup_steps": warmup,
          "warmup_s": warm_s, "steps": steps, "step_ms": step_s * 1e3,
          "tokens_per_s": SEL_BATCH * SEL_SEQ / step_s,
          "max_memory_allocated_gib": peak / 2 ** 30,
          "sync_debug_mode": "error over the timed steps",
          "launches_per_step": {k: v / n for k, v in counts.items()},
          "losses": vals, "loss_falls": ok,
          "direct_feed_losses": direct.tolist(),
          "direct_feed_bit_equal": bit_equal,
          "full_remat": {"step_ms": full_step_s * 1e3,
                         "tokens_per_s": SEL_BATCH * SEL_SEQ / full_step_s,
                         "max_memory_allocated_gib": full_peak / 2 ** 30,
                         "losses": full.tolist(), "abs_gap": gaps,
                         "tol": TOL_TRAIN_LOSS},
          "ab_checker": dict(report, loss_atol=AB_LOSS_ATOL, error=ab_error),
          "card": card})
    emit({"phase": "gpt2_350m_selective_profile", "step_ms": step_s * 1e3,
          **profile, "card": card})
    emit({"phase": "gpt2_350m_full_remat_profile",
          "step_ms": full_step_s * 1e3, **full_profile, "card": card})
    if not ok:
        raise AssertionError(f"path G losses {vals}: not finite or not "
                             "falling on the repeated batch")
    if not bit_equal:
        raise AssertionError(f"path G: prefetch-fed losses {vals} differ "
                             f"from the direct feed's {direct.tolist()}")
    if not max(gaps) <= TOL_TRAIN_LOSS:
        raise AssertionError(f"path G: losses {vals} stray more than "
                             f"{TOL_TRAIN_LOSS} from full remat's "
                             f"{full.tolist()}")
    if ab_error is not None or report["checks"] != AB_STEPS:
        raise AssertionError(f"path G: the A/B checker failed: {ab_error}")
    exact_launches("gpt2_350m_selective", counts, n, SEL_POLICY, cfg.n_layer)
    return counts


# phase 37: the user checkpoint chain (one gpt2-1.5b block applied
# UC_CHAIN times)
UC_CHAIN = 4


def user_checkpoint(seed, card):
    """Phase 37: one gpt2-1.5b block at full width (fused path: K1, K3,
    K4 and their backward kernels) applied UC_CHAIN times to a
    [11, 1024, 1600] bf16 input through
    deepspeed_tpu_torch.checkpointing.checkpoint, without and with
    cpu_checkpointing. Gates: the gradients (input and every parameter)
    bit-equal; with cpu_checkpointing the kept inputs are UC_CHAIN
    pinned host tensors, and the device memory the forward leaves for
    the backward is lower by at least their bytes. Returns the launch
    counts of both runs."""
    import torch
    from deepspeed_tpu_torch import checkpointing as ck
    from deepspeed_tpu_torch.models.gpt2 import GPT2Block

    cfg = train_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    with torch.device("cuda"):
        block = GPT2Block(cfg)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("kernel"):
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()
    x0 = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.n_embd), generator=gen,
                     device="cuda", dtype=torch.bfloat16)
    params = list(block.parameters())

    def run(offload):
        ck.configure(None, checkpoint_in_cpu=offload)
        x = x0.clone().requires_grad_(True)
        release()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        h = x * 1.0
        for _ in range(UC_CHAIN):
            h = ck.checkpoint(block, h)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        out_bytes = h.numel() * h.element_size()
        held = torch.cuda.memory_allocated() - base - out_bytes
        staged = ck.host_staged_inputs()
        info = {"held_for_backward_bytes": held,
                "host_inputs": len(staged),
                "host_bytes": sum(t.numel() * t.element_size()
                                  for t in staged),
                "host_pinned": all(t.is_pinned() for t in staged)}
        del staged
        t0 = time.perf_counter()
        grads = torch.autograd.grad(h.float().sum(), [x] + params)
        torch.cuda.synchronize()
        info.update(forward_ms=fwd_s * 1e3,
                    backward_ms=(time.perf_counter() - t0) * 1e3,
                    peak_bytes=torch.cuda.max_memory_allocated() - base)
        return info, grads

    reset_counts()
    try:
        plain, g_plain = run(False)
        offload, g_off = run(True)
    finally:
        ck.configure(None)
    counts = read_counts()
    same = all(torch.equal(a, b) for a, b in zip(g_plain, g_off))
    saved = offload["host_bytes"]
    lower = plain["held_for_backward_bytes"] - \
        offload["held_for_backward_bytes"]
    ok = same and offload["host_pinned"] and \
        offload["host_inputs"] == UC_CHAIN and saved > 0 and lower >= saved
    emit({"phase": "user_checkpoint", "block": "gpt2-1.5b GPT2Block",
          "input": [TRAIN_BATCH, TRAIN_SEQ, cfg.n_embd], "dtype": "bf16",
          "chain": UC_CHAIN, "without_cpu_checkpointing": plain,
          "with_cpu_checkpointing": offload,
          "device_bytes_saved": lower, "grads_bit_equal": same,
          "launches": counts, "ok": ok, "card": card})
    if not ok:
        raise AssertionError(f"user_checkpoint: grads equal {same}, "
                             f"{offload}, saved {lower} of {saved} bytes")
    del block, x0, params, g_plain, g_off
    return counts


BERT_FLAGS_LAYERS = 4


def bert_memory_flags(seed, card, steps=3):
    """Phase 38: BERT-large's fused layer at BERT_FLAGS_LAYERS layers
    (micro batch 16, seq 128, gas 1) with and without
    normalize_invertible under fused ops (the per-fusion
    save_fused_epilogues policy, as the JAX layer): the flag's steps
    launch, beyond the plain ones, exactly one K1-fwd and one K4-fwd a
    layer (the JAX layer's jaxpr: its flash outputs carry no names, its
    GeLU output is not kept) and no K3-fwd; the losses agree within
    TOL_TRAIN_LOSS. Returns the flag run's launch counts."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.bert import BertForPreTrainingLM

    n = BERT_FLAGS_LAYERS
    ds = dict(bert_ds_config(), gradient_accumulation_steps=1)
    runs = {}
    for flag in (False, True):
        cfg = bert_model_config(num_hidden_layers=n,
                                normalize_invertible=flag)
        model = BertForPreTrainingLM(cfg)
        engine, _, _, _ = dst.initialize(model=model,
                                         model_parameters=model.init(seed),
                                         config=ds)
        staged = engine.stage_batch({k: v[:1] for k, v in
                                     bert_batch(cfg, seed).items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, _, step_s = _timed_steps(
            engine, lambda: engine.train_batch(batch=staged), 1, steps)
        runs[flag] = (read_counts(), [float(x) for x in
                                      torch.stack(losses).float().cpu()],
                      step_s, torch.cuda.max_memory_allocated())
        del engine, model, staged
        release()
    (c0, l0, s0, p0), (c1, l1, s1, p1) = runs[False], runs[True]
    per = steps + 1
    extra = {k: (c1[k] - c0[k]) / per for k in BERT_LAUNCHES_PER_MICRO}
    want = {k: float(n) if k in ("flash_attention_fwd", "fused_bias_gelu_fwd")
            else 0.0 for k in BERT_LAUNCHES_PER_MICRO}
    gaps = [abs(a - b) for a, b in zip(l1, l0)]
    ok = extra == want and all(np.isfinite(l1)) and \
        max(gaps) <= TOL_TRAIN_LOSS
    emit({"phase": "bert_memory_flags", "model": "bert-large",
          "n_layer": n, "flag": "normalize_invertible", "fused_ops": "auto",
          "policy": "save_fused_epilogues", "micro_batch": BERT_BATCH,
          "seq": BERT_SEQ,
          "launches_per_step": {k: c1[k] / per
                                for k in BERT_LAUNCHES_PER_MICRO},
          "extra_launches_per_step": extra, "expected_extra": want,
          "losses": l1, "plain_losses": l0, "losses_bit_equal": l1 == l0,
          "step_ms": s1 * 1e3, "plain_step_ms": s0 * 1e3,
          "max_memory_allocated_gib": p1 / 2 ** 30,
          "plain_max_memory_allocated_gib": p0 / 2 ** 30, "ok": ok,
          "card": card})
    if not ok:
        raise AssertionError(f"bert_memory_flags: extra launches {extra} "
                             f"(expected {want}), losses {l1} vs {l0}")
    return c1


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
            "fused_bias_gelu_fwd_grouped": fo.fused_bias_gelu.grouped_launches,
            "fused_bias_gelu_bwd_grouped":
                fo.fused_bias_gelu_backward.grouped_launches,
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


# ----------------------------------------------------------------------
# phases 39-44: ZeRO-Offload (O1-O5)
# ----------------------------------------------------------------------
# O1: bench.py's zero_offload_real_step (bench.py:475-527) verbatim
OFF_BATCH, OFF_SEQ, OFF_GAS, OFF_LAYERS = 8, 1024, 4, 12
OFF_TIMED = 3
# O2: bench.py's zero_offload_wire settings (bench.py:534-600)
OFF_WIRES = (("bf16_native", {}),
             ("int8", {"grad_bits": 8, "param_bits": 8}),
             ("1bit", {"grad_bits": 1, "param_bits": 8, "warmup_steps": 1}))
OFF_WIRE_STEPS = 4
# the wire's losses against bf16_native's at the same step (the same
# weights and batches; int8 and 1-bit gradients move each update by up
# to a quantization step, which shows in the loss by the 4th step)
TOL_WIRE_LOSS = 5e-2
# the wire's D2H bytes against the native wire's: int8 is n + 4 bytes a
# 4096-element block (0.5001x), 1 bit n / 8 + the scales (0.0626x)
WIRE_D2H_RATIO = {"int8": 0.55, "1bit": 0.2}
# O3: the flagship with cpu_offload; its A/B against the device engine
# with fp32 masters at this many layers, and O4 (fp16) at the same
OFF_AB_LAYERS = 4
OFF_AB_STEPS = 4
# the A/B: the same AdamW on the host (CPU-Adam) and on the card (the
# engine's fused update); both keep fp32 masters and round the same bf16
# parameters, so the losses differ by the update's float roundoff only,
# carried through 4 steps, and the masters by lr-sized steps' roundoff
TOL_OFF_AB_LOSS = 1e-2
TOL_OFF_AB_MASTER = 5e-3
OFF_FP16_CAP = 40
# an interior chunk's copies count as hidden when they end before the
# host's step on that chunk does; the event clock's jitter (ms)
OFF_CLOCK_SLACK = 0.05


def host_line():
    """The host's cores, RAM and CPU-Adam threads: the offload paths'
    time depends on them."""
    from deepspeed_tpu_torch.ops.adam.cpu_adam import ds_num_threads
    free = subprocess.run(["free", "-g"], capture_output=True, text=True)
    row = {"phase": "offload_host", "nproc": os.cpu_count(),
           "affinity_cpus": len(os.sched_getaffinity(0)),
           "free_g": free.stdout.strip().splitlines(),
           "ds_num_threads": ds_num_threads()}
    emit(row)
    return row


def offload_ds_config(wire=None, micro=OFF_BATCH, gas=OFF_GAS):
    """zero_offload_real_step's ds_config (bench.py:497-504), with the
    offload_wire block when given."""
    zero = {"stage": 2, "cpu_offload": True}
    if wire:
        zero["offload_wire"] = dict(wire)
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas, "steps_per_print": 1000,
            "bf16": {"enabled": True}, "zero_optimization": zero,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}}


def offload_125m(seed, wire=None):
    """gpt2-125m, bf16 compute with fp32 parameters, full remat, dropout
    0, through initialize with offload_ds_config. Returns (engine, cfg,
    setup seconds)."""
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM, gpt2_config
    cfg = gpt2_config("gpt2-125m", n_positions=OFF_SEQ, dropout=0.0,
                      dtype=torch.bfloat16, param_dtype=torch.float32,
                      remat=True)
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg)
    engine, _, _, _ = dst.initialize(model=model,
                                     model_parameters=model.init(seed),
                                     config=offload_ds_config(wire))
    torch.cuda.synchronize()
    if not engine._host_adam.native:
        raise AssertionError("offload: CPU-Adam is not the native library")
    return engine, cfg, time.perf_counter() - t0


def offload_batch(cfg, i, gas=OFF_GAS, micro=OFF_BATCH, seq=OFF_SEQ):
    """bench.py's make_batch(i): [gas, micro, seq] ids from seed i."""
    import numpy as np
    return {"input_ids": np.random.default_rng(i).integers(
        0, cfg.vocab_size, (gas, micro, seq)).astype(np.int32)}


def offload_step(engine, batch):
    """One synced train_batch: (loss, the step's split): step ms, the
    device half (until the norm is on the host), the norm wait, the host
    chunk loop, CPU-Adam's share of it, the copies' device ms and rates."""
    import torch
    t0 = time.perf_counter()
    loss = engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tm = dict(engine.offload_timing)
    ws = engine.wire_stats
    split = {"step_ms": (t1 - t0) * 1e3,
             "device_half_ms": (tm["norm_at"] - t0) * 1e3,
             "norm_wait_ms": tm["norm_wait_ms"],
             "host_loop_ms": tm["host_loop_ms"],
             "after_loop_ms": (t1 - tm["done_at"]) * 1e3,
             "chunks": tm["chunks"], "ring": tm["ring"],
             "d2h_bytes": ws["d2h_bytes"], "h2d_bytes": ws["h2d_bytes"]}
    if tm["ring"] > 0:
        copies = engine.offload_copy_ms()
        split.update(host_chunks_ms=tm["host_chunks_ms"],
                     copy_wait_ms=tm["copy_wait_ms"], **copies,
                     d2h_gb_per_s=ws["d2h_bytes"] / copies["d2h_ms"] / 1e6,
                     h2d_gb_per_s=ws["h2d_bytes"] / copies["h2d_ms"] / 1e6)
    return float(loss), split


def overlap_gate(trace):
    """From offload_trace: for each interior chunk i, whether chunk
    i+1's D2H and chunk i-1's H2D ran inside chunk i's window (after the
    host's step on chunk i-1 ended, ended before its step on chunk i
    did): the copies the host step hid."""
    host = trace["host"]
    rows = []
    for i in range(1, len(host) - 1):
        lo, hi = host[i - 1][1], host[i][1]
        d, h = trace["d2h"][i + 1], trace["h2d"][i - 1]
        rows.append({
            "chunk": i, "window_ms": [lo, hi],
            "d2h_next_ms": list(d), "h2d_prev_ms": list(h),
            "d2h_hidden": d[0] >= lo - OFF_CLOCK_SLACK and d[1] <= hi,
            "h2d_hidden": h[0] >= lo - OFF_CLOCK_SLACK and h[1] <= hi})
    hidden = sum(r["d2h_hidden"] and r["h2d_hidden"] for r in rows)
    return {"interior_chunks": len(rows), "hidden": hidden,
            "all_hidden": hidden == len(rows), "worst": rows[:3] + [
                r for r in rows if not (r["d2h_hidden"] and
                                        r["h2d_hidden"])][:3]}


def zero_offload_real_step(seed, card):
    """O1 (phase 39): bench.py's zero_offload_real_step verbatim, 1
    warm-up and OFF_TIMED timed steps, exact launches, a profile, the
    pipeline's overlap on the device clock, and the serial round trip's
    step beside the pipelined one. Returns (counts, engine, cfg, the
    losses), the engine for O5."""
    import torch
    engine, cfg, setup_s = offload_125m(seed)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, splits = [], []
    for i in range(1 + OFF_TIMED):
        loss, split = offload_step(engine, offload_batch(cfg, i))
        losses.append(loss)
        splits.append(split)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    exact_launches("zero_offload_real_step", counts,
                   (1 + OFF_TIMED) * OFF_GAS, None, OFF_LAYERS)
    timed = splits[1:]
    step_ms = sum(s["step_ms"] for s in timed) / len(timed)
    tokens = OFF_BATCH * OFF_SEQ * OFF_GAS
    n = engine._host_master.size
    # the traced step: the copies against the host steps on the device
    # clock; then the serial round trip (blocking copies) beside the
    # pipelined one, in turns
    engine._offload_trace = True
    _, traced = offload_step(engine, offload_batch(cfg, 10))
    gate = overlap_gate(engine.offload_trace())
    engine._offload_trace = False
    turns = []
    for ring in (0, 2, 2, 0):
        engine._offload_ring = ring
        turns.append(offload_step(engine, offload_batch(cfg, 11))[1])
    engine._offload_ring = 2
    serial = [t["step_ms"] for t in turns if t["ring"] == 0]
    piped = [t["step_ms"] for t in turns if t["ring"] == 2]
    profile = profile_steps(
        lambda: engine.train_batch(batch=offload_batch(cfg, 12)), 1)
    row = {"phase": "zero_offload_real_step", "model": "gpt2-125m",
           "params": n, "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
           "micro_batch": OFF_BATCH, "seq": OFF_SEQ, "gas": OFF_GAS,
           "dtype": "bf16 compute, fp32 masters and moments on the host",
           "native_cpu_adam": engine._host_adam.native,
           "chunks": len(engine._offload_bounds_cached),
           "setup_s": setup_s, "warmup_steps": 1, "steps": OFF_TIMED,
           "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "split_by_step": timed,
           "max_memory_allocated_gib": peak / 2 ** 30,
           "losses": losses,
           "launches_per_step": {k: v / (1 + OFF_TIMED)
                                 for k, v in counts.items() if v},
           "overlap": gate, "traced_step": traced,
           "serial_vs_pipelined_step_ms": {"serial": serial,
                                           "pipelined": piped},
           "serial_vs_pipelined_host_loop_ms": {
               "serial": [t["host_loop_ms"] for t in turns
                          if t["ring"] == 0],
               "pipelined": [t["host_loop_ms"] for t in turns
                             if t["ring"] == 2]},
           "card": card}
    emit(row)
    emit({"phase": "zero_offload_real_step_profile", **profile,
          "card": card})
    import numpy as np
    if not all(np.isfinite(losses)):
        raise AssertionError(f"O1 losses {losses}: not finite")
    if not gate["all_hidden"] and min(piped) > min(serial):
        raise AssertionError(f"O1: the pipeline hid no copies ({gate}) "
                             f"and is not faster than the serial round "
                             f"trip ({piped} ms against {serial})")
    return counts, engine, cfg, losses


def zero_offload_wire(seed, card):
    """O2 (phase 40): O1's config at each of bench.py's wire settings,
    OFF_WIRE_STEPS steps on the same batches; the wire_stats, step ms,
    and the gates: int8 and 1-bit D2H bytes under their ratios of the
    native wire's, H2D as the JAX package counts it, losses finite and
    within TOL_WIRE_LOSS of bf16_native's after the last step. Returns
    the launch counts over the three engines."""
    import numpy as np
    total, rows, native_loss = None, {}, None
    for name, wire in OFF_WIRES:
        engine, cfg, _ = offload_125m(seed, wire)
        reset_counts()
        losses, splits = [], []
        for i in range(OFF_WIRE_STEPS):
            loss, split = offload_step(engine, offload_batch(cfg, i))
            losses.append(loss)
            splits.append(split)
        counts = read_counts()
        total = counts if total is None else \
            {k: total[k] + v for k, v in counts.items()}
        ws = dict(engine.wire_stats)
        bounds = engine._offload_bounds_cached
        h2d = sum((hi - lo) + 4 * -(-(hi - lo) // 4096) for lo, hi in bounds) \
            if wire.get("param_bits") == 8 else 2 * engine._host_master.size
        rows[name] = {"wire": wire, "wire_stats": ws, "losses": losses,
                      "step_ms": [s["step_ms"] for s in splits],
                      "split_last": splits[-1],
                      "d2h_ratio": ws["d2h_bytes"] / ws["d2h_bytes_native"],
                      "h2d_expected": h2d}
        if name == "bf16_native":
            native_loss = losses
        del engine
        release()
    gaps = {k: abs(r["losses"][-1] - native_loss[-1]) for k, r in
            rows.items()}
    ok = {"finite": all(np.isfinite(r["losses"]).all()
                        for r in rows.values()),
          "d2h_ratios": all(rows[k]["d2h_ratio"] < v
                            for k, v in WIRE_D2H_RATIO.items()),
          "h2d_as_jax": all(r["wire_stats"]["h2d_bytes"] == r["h2d_expected"]
                            for r in rows.values()),
          "losses_within": max(gaps.values()) <= TOL_WIRE_LOSS,
          "past_warmup": not any(r["wire_stats"]["warmup"]
                                 for r in rows.values())}
    emit({"phase": "zero_offload_wire", "settings": rows,
          "last_loss_gap_to_native": gaps, "tol": TOL_WIRE_LOSS,
          "gates": ok, "card": card})
    if not all(ok.values()):
        raise AssertionError(f"O2 gates failed: {ok}")
    return total


def offload_flagship_config(n_layer=None, fp16=False):
    """bench_gpt2_15b's ds_config (bench.py:242-250) with "cpu_offload":
    true in its ZeRO-2 block; fp16 in place of bf16 for O4."""
    ds = flagship_ds_config(TRAIN_BATCH)
    ds["zero_optimization"] = {"stage": 2, "cpu_offload": True}
    if fp16:
        del ds["bf16"]
        ds["fp16"] = {"enabled": True, "loss_scale": 0,
                      "initial_scale_power": 32}
    return ds


def offload_flagship(seed, card):
    """O3 (phase 41): the flagship with cpu_offload at full width and
    depth, 1 warm-up and OFF_TIMED timed steps: step ms, tokens/s, peak
    device memory, host RSS, the split. Returns the launch counts."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    cfg = train_config()
    rss0 = _rss_bytes()
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg)
    engine, _, _, _ = dst.initialize(model=model,
                                     model_parameters=model.init(seed),
                                     config=offload_flagship_config())
    del model
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if not engine._host_adam.native:
        raise AssertionError("O3: CPU-Adam is not the native library")
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    staged = engine.stage_batch({"input_ids": ids})
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, splits = [], []
    for _ in range(1 + OFF_TIMED):
        loss, split = offload_step(engine, staged)
        losses.append(loss)
        splits.append(split)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rss = _rss_bytes()
    exact_launches("offload_flagship", counts, 1 + OFF_TIMED, None,
                   cfg.n_layer)
    timed = splits[1:]
    step_ms = sum(s["step_ms"] for s in timed) / len(timed)
    n = engine._host_master.size
    emit({"phase": "offload_flagship", "model": "gpt2-1.5b",
          "params": n, "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
          "micro_batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "dtype": "bf16 compute; fp32 masters and moments on the host "
                   "(master_weights false is ignored with cpu_offload)",
          "native_cpu_adam": engine._host_adam.native,
          "chunks": len(engine._offload_bounds_cached),
          "setup_s": setup_s, "steps": OFF_TIMED, "step_ms": step_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
          "split_by_step": timed, "losses": losses,
          "max_memory_allocated_gib": peak / 2 ** 30,
          "host_rss_gib": rss / 2 ** 30,
          "host_rss_growth_gib": (rss - rss0) / 2 ** 30,
          "host_state_gib": 3 * n * 4 / 2 ** 30,
          "card": card})
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"O3 losses {losses}: not finite or falling")
    del engine, staged
    release()
    return counts


def offload_ab(seed, card):
    """O3's A/B (phase 42): at OFF_AB_LAYERS layers of the flagship's
    width, the offload engine against the device engine with fp32
    masters (bf16 master_weights true) on the same weights and batches:
    losses within TOL_OFF_AB_LOSS over OFF_AB_STEPS steps, the host
    masters within TOL_OFF_AB_MASTER relative L2 of the device master."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    cfg = train_config(n_layer=OFF_AB_LAYERS)
    ids = np.random.default_rng(seed + 5).integers(
        0, cfg.vocab_size, (OFF_AB_STEPS, 1, TRAIN_BATCH, TRAIN_SEQ)).astype(
        np.int32)
    out = {}
    for kind in ("offload", "device"):
        ds = offload_flagship_config()
        if kind == "device":
            ds["zero_optimization"] = {"stage": 2}
            ds["bf16"] = {"enabled": True, "master_weights": True}
        model = GPT2ForCausalLM(cfg)
        engine, _, _, _ = dst.initialize(model=model,
                                         model_parameters=model.init(seed),
                                         config=ds)
        losses = [float(engine.train_batch(batch={"input_ids": x}))
                  for x in ids]
        if kind == "offload":
            order = engine._offload_order
            master = engine._host_master.copy()
        else:
            fp32 = engine.fp32_params
            master = torch.cat([fp32[n].reshape(-1) for n in order]).cpu() \
                .numpy()
        out[kind] = (losses, master)
        del engine, model
        release()
    gaps = [abs(a - b) for a, b in zip(out["offload"][0], out["device"][0])]
    rel = float(np.linalg.norm(out["offload"][1] - out["device"][1]) /
                np.linalg.norm(out["device"][1]))
    ok = max(gaps) <= TOL_OFF_AB_LOSS and rel <= TOL_OFF_AB_MASTER
    emit({"phase": "offload_ab", "n_layer": OFF_AB_LAYERS,
          "losses_offload": out["offload"][0],
          "losses_device_fp32_masters": out["device"][0], "abs_gap": gaps,
          "tol_loss": TOL_OFF_AB_LOSS, "master_rel_l2": rel,
          "tol_master": TOL_OFF_AB_MASTER, "ok": ok, "card": card})
    if not ok:
        raise AssertionError(f"O3 A/B: loss gaps {gaps}, master rel L2 "
                             f"{rel}")


def offload_fp16(seed, card):
    """O4 (phase 43): the A/B's model in fp16 with cpu_offload from the
    scale 2^32, until FP16_CLEAN_STEPS clean steps follow the last skip:
    each skipped step leaves the host masters bit for bit, the scale
    follows the JAX package's host automaton (its DynamicLossScaler,
    replayed on the same overflow flags). Returns the launch counts."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler
    cfg = train_config(dtype=torch.float16, param_dtype=torch.float32,
                       n_layer=OFF_AB_LAYERS)
    model = GPT2ForCausalLM(cfg)
    engine, _, _, _ = dst.initialize(
        model=model, model_parameters=model.init(seed),
        config=offload_flagship_config(fp16=True))
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    staged = engine.stage_batch({"input_ids": ids})
    replay = CreateLossScaler(
        dtype_fp16=True, static_loss_scale=0, dynamic_scaling=True,
        dynamic_loss_args=engine.dynamic_loss_scale_args())
    init = engine._host_scaler.cur_scale
    reset_counts()
    losses, scales, flags, replayed, kept = [], [], [], [], []
    clean = 0
    while len(losses) < OFF_FP16_CAP and clean < FP16_CLEAN_STEPS:
        before = engine._host_master.copy()
        skipped = engine.skipped_steps
        losses.append(float(engine.train_batch(batch=staged)))
        flag = engine.skipped_steps > skipped
        flags.append(flag)
        scales.append(engine._host_scaler.cur_scale)
        replay.update_scale(flag)
        replayed.append(replay.cur_scale)
        if flag:
            kept.append(bool(np.array_equal(before, engine._host_master)))
        clean = 0 if flag else clean + 1
    counts = read_counts()
    last_skip = max([i for i, f in enumerate(flags) if f], default=-1)
    after = losses[last_skip + 1:]
    ok = {"skipped_first": bool(flags and flags[0]),
          "masters_kept_on_skips": all(kept),
          "scales_match_jax_automaton": scales == replayed,
          "clean_steps_after_last_skip": len(after) >= FP16_CLEAN_STEPS,
          "finite_after": bool(np.isfinite(after).all()),
          "native_cpu_adam": engine._host_adam.native}
    emit({"phase": "offload_fp16", "n_layer": OFF_AB_LAYERS,
          "initial_scale": init, "steps": len(losses),
          "skipped": sum(flags), "losses": losses, "scales": scales,
          "jax_automaton_scales": replayed, "gates": ok, "card": card})
    del engine, model, staged
    release()
    if not all(ok.values()):
        raise AssertionError(f"O4 gates failed: {ok}")
    return counts


def offload_checkpoint(engine, cfg, seed, card):
    """O5 (phase 44): O1's engine saves (sync) and takes 2 more steps; a
    fresh engine from other weights loads the save and takes the same 2
    steps. Gates: host_master, both moments and the step bit-equal after
    the load, the losses bit-equal to the unbroken run's. Returns the
    launch counts of both engines' steps."""
    import shutil
    import tempfile
    import numpy as np
    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="offload_ckpt_", dir=parent)
    try:
        reset_counts()
        t0 = time.perf_counter()
        engine.save_checkpoint(root, tag="o5", async_save=False)
        save_s = time.perf_counter() - t0
        saved = {"master": engine._host_master.copy(),
                 "exp_avg": engine._host_adam.exp_avg.copy(),
                 "exp_avg_sq": engine._host_adam.exp_avg_sq.copy(),
                 "step": engine._host_adam.step_count}
        batches = [offload_batch(cfg, 20 + i) for i in range(2)]
        la = [float(engine.train_batch(batch=b)) for b in batches]
        fresh, _, _ = offload_125m(seed + 1)
        t0 = time.perf_counter()
        fresh.load_checkpoint(root, tag="o5")
        load_s = time.perf_counter() - t0
        same = {"host_master": np.array_equal(fresh._host_master,
                                              saved["master"]),
                "exp_avg": np.array_equal(fresh._host_adam.exp_avg,
                                          saved["exp_avg"]),
                "exp_avg_sq": np.array_equal(fresh._host_adam.exp_avg_sq,
                                             saved["exp_avg_sq"]),
                "step": fresh._host_adam.step_count == saved["step"]}
        lb = [float(fresh.train_batch(batch=b)) for b in batches]
        counts = read_counts()
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(root) for f in fs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = dict(same, losses_bit_equal=la == lb)
    emit({"phase": "offload_checkpoint", "bytes": nbytes, "save_s": save_s,
          "load_s": load_s, "losses_unbroken": la, "losses_resumed": lb,
          "gates": ok, "card": card})
    del fresh
    if not all(ok.values()):
        raise AssertionError(f"O5 gates failed: {ok}")
    return counts


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
# the speculative and int8 serving paths: the engine's epilogues only
# (paged attention and the int8 epilogue are plain torch)
SPEC_KERNELS = ("fused_bias_residual_layernorm_fwd", "fused_bias_gelu_fwd")
TRAINING_KERNELS = SERVING_KERNELS + (
    "flash_attention_bwd_fused", "fused_bias_residual_layernorm_bwd",
    "fused_bias_gelu_bwd")
# what the paths at T <= 1024 never launch: K2's sweeps
FUSED_ABSENT = ("flash_attention_bwd",)
MOE_KERNELS = TRAINING_KERNELS + ("moe_dispatch", "moe_combine")
QUANT_KERNELS = TRAINING_KERNELS + ("quantized_matmul",)
MOE_QUANT_KERNELS = MOE_KERNELS + ("quantized_matmul",)
# the fp16 MoE paths name K4's grouped launches too
MOE_FP16_KERNELS = MOE_KERNELS + ("fused_bias_gelu_fwd_grouped",
                                  "fused_bias_gelu_bwd_grouped")
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


# ----------------------------------------------------------------------
# phases 50-53: the monitor (deepspeed_tpu_torch/monitor/)
# ----------------------------------------------------------------------
# path M: the training cell with the monitor; warm-up of one window, then
# MON_WINDOWS windows of MON_SYNC steps (a fence closes each window)
MON_SYNC = 4
MON_WINDOWS = 3
# the JAX package's overhead contract (bench.py bench_monitor_overhead):
# recorded, not gated
MON_OVERHEAD_CONTRACT = 0.03
# the kernels whose launches a monitored step must equal an unmonitored
# step's
MON_GATED_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_fused",
                     "fused_bias_residual_layernorm_fwd",
                     "fused_bias_residual_layernorm_bwd",
                     "fused_bias_gelu_fwd", "fused_bias_gelu_bwd")
# monitor_faults and monitor_events: the depth their models are cut to
MON_CUT_LAYERS = 4
# path M's depth: 12 of the cell's 48 layers (PR 23, to fit phases 54-57
# in the run's time; M compares its engines with each other)
MON_TRAIN_LAYERS = 12
MON_STALL_SEC = 2.0
# the micro batch (rows of 1024 tokens) no card holds at 4 layers of
# gpt2-1.5b's width: its activations alone pass 80 GB
MON_OOM_ROWS = 4096
# the tracker's percentiles against the requests' own stamps: one
# histogram bucket (2^(1/3)) with bench.py's 1.45x jitter band
MON_BUCKET_BAND = 1.45
# the JAX engine's event key sets (deepspeed_tpu/runtime/engine.py,
# monitor/__init__.py, inference/scheduler.py; tests/
# test_torch_monitor_*.py hold the port's events to the JAX package's
# on the CPU), beside the keys every event carries
MON_BASE_KEYS = {"v", "ts", "kind", "step"}
MON_EVENT_KEYS = {
    "overlap": {"enabled", "sites", "issue_distance"},
    "quantized_matmul": {"applied", "mode", "block", "stochastic_rounding",
                         "active"},
    "moe": {"num_experts", "top_k", "capacity_factor", "aux_loss_weight",
            "every_n_layers", "jitter_eps", "fused_dispatch",
            "expert_axis"},
    "router": {"num_experts", "expert_load", "load_max", "drop_fraction",
               "aux_loss", "window_steps"},
    "ckpt_commit": {"tag", "dir", "wall_ms", "global_steps"},
    "stall": {"fence_age_sec", "timeout_sec", "heartbeat_age_sec",
              "terminal_subsystems", "consecutive_fires"},
    "numerics": {"grad_norm", "grad_absmax", "grad_nonfinite",
                 "act_absmax", "act_mean", "act_nonfinite", "window_steps",
                 "first_nonfinite"},
    "memory": {"schema", "hbm", "host", "top_buffers", "peak"},
    "speculative": {"rounds", "drafted_tokens", "accepted_tokens",
                    "acceptance_rate", "tokens_per_verify",
                    "rollback_events", "rollback_pages", "mean_k",
                    "draft_dispatch_ms", "verify_dispatch_ms"},
}


def monitor_block(out, **extra):
    """Path M's monitor block: the JSONL and tensorboard sinks, the
    Perfetto trace, the flight recorder, numerics and the memory ledger,
    the stall watchdog at 60 s."""
    block = {"enabled": True, "output_path": out,
             "sinks": ["jsonl", "tensorboard"],
             "stall_timeout_sec": 60,
             "trace": {"enabled": True}, "flight": {"enabled": True},
             "numerics": {"enabled": True}, "memory": {"enabled": True}}
    block.update(extra)
    return block


def read_events(out):
    with open(os.path.join(out, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_keys(label, event, checks):
    """An event's keys against the JAX engine's set for its kind."""
    want = MON_EVENT_KEYS[event["kind"]] | MON_BASE_KEYS
    got = set(event)
    checks.append({"check": f"{label}: {event['kind']} keys", "ok":
                   got == want, "missing": sorted(want - got),
                   "extra": sorted(got - want)})


class HostReads:
    """Counts the tensor methods that read the device on the host
    (.item, .cpu, .tolist, .numpy) while installed."""

    NAMES = ("item", "cpu", "tolist", "numpy")

    def __init__(self):
        self.calls = []
        self._orig = {}

    def __enter__(self):
        import torch
        for name in self.NAMES:
            orig = self._orig[name] = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, _name=name, **k):
                self.calls.append(_name)
                return _orig(t, *a, **k)
            setattr(torch.Tensor, name, counted)
        return self

    def __exit__(self, *exc):
        import torch
        for name, orig in self._orig.items():
            setattr(torch.Tensor, name, orig)
        return False


def guarded_fences(engine, reads, device):
    """Wrap `engine._sync_fence`: the steps between fences run under
    set_sync_debug_mode("error") on the card (any host read raises), the
    fence itself under "default"; each fence records the host reads
    since the last one and its own. Returns the list of (between,
    inside) read lists."""
    import torch
    fences = []
    real = engine._sync_fence
    cuda = torch.device(device).type == "cuda"

    def fence():
        between = list(reads.calls)
        del reads.calls[:]
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
        try:
            real()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
        fences.append((between, list(reads.calls)))
        del reads.calls[:]
    engine._sync_fence = fence
    return fences


def monitor_training(seed, card, device="cuda", n_layer=None, out=None):
    """Phase 50, path M: the training cell (bench_gpt2_15b verbatim) with
    async_dispatch at steps_per_sync 4, wall_clock_breakdown and the
    monitor (monitor_block), beside the same engine without it: one
    window of warm-up, then MON_WINDOWS windows of MON_SYNC steps, the
    two engines in turns (off, on; then on, off; ...) on the same
    batches. Gates: the losses bit for bit; K1-fwd, K2-fused, K3-fwd,
    K3-bwd, K4-fwd and K4-bwd launched as often a step; no host read
    between fences (set_sync_debug_mode("error") and the tensor read
    methods counted) and one copy at each fence; every `metrics`
    event's loss the mean of its window's step losses; the ledger's
    params and optimizer-state bytes the state's tensor bytes; the
    tfevents file read back with its CRCs; the Perfetto trace with a
    forward, backward and step span a step, and `ds_trace summary` on
    it; numerics finite. Reports the `memory` event against
    torch.cuda.memory_stats, MFU and tokens/s beside the script's own
    clock, and the overhead as the median of the paired window ratios.
    Returns the monitored engine's launch counts."""
    import contextlib
    import io
    import shutil
    import tempfile
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.monitor import trace_cli
    from deepspeed_tpu_torch.monitor.tfevents import read_tfevents

    out = out or tempfile.mkdtemp(prefix="ds_monitor_m_")
    over = {} if n_layer is None else {"n_layer": n_layer}
    cfg = train_config(**over)
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    checks = []
    t0 = time.perf_counter()

    def build(on):
        ds = flagship_ds_config(batch)
        ds["async_dispatch"] = {"steps_per_sync": MON_SYNC}
        if on:
            ds["wall_clock_breakdown"] = True
            ds["monitor"] = monitor_block(out)
        model = GPT2ForCausalLM(cfg, device=device)
        engine, _, _, _ = dst.initialize(model=model,
                                         model_parameters=model.init(seed),
                                         config=ds)
        return engine

    engines = {"off": build(False), "on": build(True)}
    rng = np.random.default_rng(seed)
    n_steps = MON_SYNC * (1 + MON_WINDOWS)
    staged = [engines["off"].stage_batch({"input_ids": rng.integers(
        0, cfg.vocab_size, (1, batch, seq)).astype(np.int32)})
              for _ in range(n_steps)]
    sync(device)
    setup_s = time.perf_counter() - t0
    losses = {"off": [], "on": []}
    counts = {k: {} for k in engines}
    window_ms = {"off": [], "on": []}
    reads = HostReads()
    fences = {k: guarded_fences(e, reads, device)
              for k, e in engines.items()}
    cuda = torch.device(device).type == "cuda"

    def window(name, w):
        eng = engines[name]
        reset_counts()
        sync(device)
        t0 = time.perf_counter()
        with reads:
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            try:
                for i in range(w * MON_SYNC, (w + 1) * MON_SYNC):
                    losses[name].append(eng.train_batch(batch=staged[i]))
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
        sync(device)
        if w > 0:
            window_ms[name].append((time.perf_counter() - t0) * 1e3)
            for k, v in read_counts().items():
                counts[name][k] = counts[name].get(k, 0) + v

    for name in ("off", "on"):
        window(name, 0)
    for w in range(1, 1 + MON_WINDOWS):
        for name in (("off", "on") if w % 2 else ("on", "off")):
            window(name, w)
    run_s = time.perf_counter() - t0

    on = engines["on"]
    vals = {k: torch.stack(v).float().cpu() for k, v in losses.items()}
    bit_equal = bool(torch.equal(vals["on"], vals["off"]))
    checks.append({"check": "losses bit for bit, monitor on and off",
                   "ok": bit_equal})
    steps = MON_SYNC * MON_WINDOWS
    per_step = {k: {n: counts[k].get(n, 0) / steps for n in
                    MON_GATED_KERNELS} for k in counts}
    checks.append({"check": "launches a step, monitor on and off",
                   "ok": per_step["on"] == per_step["off"],
                   "on": per_step["on"], "off": per_step["off"]})
    between = [len(b) for b, _ in fences["on"]]
    inside = [sorted(f) for _, f in fences["on"]]
    checks.append({"check": "no host read between fences, one copy at a "
                   "fence", "ok": all(n == 0 for n in between) and
                   len(inside) == 1 + MON_WINDOWS and
                   all(f == ["cpu", "numpy"] for f in inside),
                   "between": between, "at_fences": inside})
    st = on.state
    params_bytes = sum(p.numel() * p.element_size()
                       for p in st.params.values())
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in on._state_tensors(st.opt_state))
    ts = on.tput_timer.avg_samples_per_sec()
    own_tps = batch * seq * MON_SYNC / (np.median(window_ms["on"]) / 1e3)
    stats = torch.cuda.memory_stats() if cuda else {}
    on.shutdown()
    engines["off"].shutdown()

    events = read_events(out)
    metrics = [e for e in events if e["kind"] == "metrics"]
    host_vals = vals["on"].tolist()
    means = [round(sum(host_vals[i * MON_SYNC:(i + 1) * MON_SYNC])
                   / MON_SYNC, 6) for i in range(1 + MON_WINDOWS)]
    checks.append({"check": "each metrics event's loss the mean of its "
                   "window's steps", "ok": [e["loss"] for e in metrics] ==
                   means, "events": [e["loss"] for e in metrics],
                   "means": means})
    mem = [e for e in events if e["kind"] == "memory"]
    cats = mem[-1]["hbm"]["categories"]
    checks.append({"check": "ledger params and opt_state bytes are the "
                   "state's tensor bytes",
                   "ok": cats.get("params") == params_bytes and
                   cats.get("opt_state") == opt_bytes,
                   "ledger": {k: cats.get(k) for k in ("params",
                                                       "opt_state")},
                   "state": {"params": params_bytes, "opt_state": opt_bytes}})
    numerics = [e for e in events if e["kind"] == "numerics"]
    finite = all(np.isfinite(v) for e in numerics
                 for key in ("grad_norm", "grad_absmax")
                 for v in e[key].values())
    checks.append({"check": "numerics group stats finite",
                   "ok": bool(numerics) and finite,
                   "groups": list(numerics[-1]["grad_norm"])
                   if numerics else None})
    for e in (numerics[-1], mem[-1]):
        check_keys("monitor_training", e, checks)
    tb_dir = os.path.join(out, "tb")
    tb = [os.path.join(tb_dir, f) for f in os.listdir(tb_dir)]
    records = [r for f in tb for r in read_tfevents(f)]
    tb_loss = [r["scalars"]["monitor/metrics/loss"] for r in records
               if "monitor/metrics/loss" in r.get("scalars", {})]
    checks.append({"check": "tfevents read back with their CRCs",
                   "ok": len(tb_loss) == len(metrics), "records":
                   len(records)})
    trace_path = os.path.join(out, "trace_rank0.json")
    with open(trace_path) as f:
        trace = json.load(f)
    spans = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "host_span":
            spans[ev["name"]] = spans.get(ev["name"], 0) + 1
    checks.append({"check": "one forward, backward and step span a step",
                   "ok": all(spans.get(k) == n_steps for k in
                             ("forward", "backward", "step")),
                   "spans": spans, "steps": n_steps})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trace_cli.main(["summary", trace_path])
    summary = buf.getvalue().splitlines()
    checks.append({"check": "ds_trace summary", "ok": rc in (0, None) and
                   any("host/step" in ln for ln in summary)})
    ratios = [a / b for a, b in zip(window_ms["on"], window_ms["off"])]
    overhead = float(np.median(ratios)) - 1.0
    hbm = mem[-1]["hbm"]
    emit({"phase": "monitor_training", "model": "gpt2-1.5b",
          "n_layer": cfg.n_layer, "micro_batch": batch, "seq": seq,
          "steps_per_sync": MON_SYNC, "warmup_steps": MON_SYNC,
          "steps": steps, "setup_s": setup_s, "run_s": run_s,
          "window_ms": window_ms, "window_ratios_on_off": ratios,
          "overhead": overhead, "overhead_contract": MON_OVERHEAD_CONTRACT,
          "regressed": overhead > MON_OVERHEAD_CONTRACT,
          "metrics_last": {k: metrics[-1].get(k) for k in (
              "loss", "mfu", "tokens_per_sec_per_chip", "tokens_per_sec",
              "samples_per_sec", "window_steps", "spans")},
          "script_tokens_per_s": own_tps,
          "throughput_timer_samples_per_s": ts,
          "memory_event": {"categories": hbm["categories"],
                           "ledger_bytes": hbm["ledger_bytes"],
                           "measured_in_use": hbm["measured_in_use"],
                           "measured_peak": hbm["measured_peak"],
                           "residual_bytes": hbm["residual_bytes"],
                           "peak": mem[-1]["peak"]},
          "torch_memory_stats": {
              "allocated_current": stats.get("allocated_bytes.all.current"),
              "allocated_peak": stats.get("allocated_bytes.all.peak"),
              "reserved_current": stats.get("reserved_bytes.all.current")},
          "events": sorted({e["kind"] for e in events}),
          "ds_trace_summary": summary[:12],
          "checks": checks, "card": card})
    bad = [c["check"] for c in checks if not c["ok"]]
    shutil.rmtree(out, ignore_errors=True)
    if bad:
        raise AssertionError(f"monitor_training: {bad}")
    return counts["on"]


def monitor_faults(seed, card, device="cuda", n_layer=MON_CUT_LAYERS,
                   oom_rows=MON_OOM_ROWS):
    """Phase 51: the flight recorder and the watchdog on the training
    cell at MON_CUT_LAYERS layers (a fence every step, stall_timeout_sec
    MON_STALL_SEC): a healthy stretch of steps longer than the timeout
    gives no `stall` event and no dump; a host sleep past the timeout
    with no fence gives one of each; an exception out of train_batch
    gives one dump; a micro batch the card cannot hold raises
    torch.OutOfMemoryError and leaves a dump classified `oom` with the
    ledger's hints, after which the engine steps again."""
    import tempfile
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.monitor.flight import list_flight_dumps

    out = tempfile.mkdtemp(prefix="ds_monitor_faults_")
    cfg = train_config(n_layer=n_layer)
    ds = flagship_ds_config(TRAIN_BATCH)
    ds["async_dispatch"] = {"steps_per_sync": 1}
    ds["monitor"] = {"enabled": True, "output_path": out,
                     "stall_timeout_sec": MON_STALL_SEC}
    model = GPT2ForCausalLM(cfg, device=device)
    engine, _, _, _ = dst.initialize(model=model,
                                     model_parameters=model.init(seed),
                                     config=ds)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    staged = engine.stage_batch({"input_ids": ids})
    checks = []

    def stalls():
        return [e for e in read_events(out) if e["kind"] == "stall"]

    t0 = time.perf_counter()
    healthy = 0
    while time.perf_counter() - t0 < 1.5 * MON_STALL_SEC or healthy < 2:
        engine.train_batch(batch=staged)
        healthy += 1
    checks.append({"check": "a healthy stretch: no stall, no dump",
                   "ok": stalls() == [] and list_flight_dumps(out) == [],
                   "steps": healthy,
                   "seconds": time.perf_counter() - t0})
    time.sleep(MON_STALL_SEC + 1.5)
    dumps = list_flight_dumps(out)
    stall_dump = {}
    if dumps:
        with open(dumps[-1]) as f:
            stall_dump = json.load(f)
    st = stalls()
    checks.append({"check": "a stall: one stall event, one dump",
                   "ok": len(st) == 1 and len(dumps) == 1 and
                   stall_dump.get("reason") == "stall",
                   "stall": st[-1] if st else None})
    if st:
        check_keys("monitor_faults", st[-1], checks)
    engine.train_batch(batch=staged)    # a fence ends the episode
    try:
        engine.train_batch(batch={"input_ids": ids[:, :1].repeat(2, 0)})
        raised = None
    except ValueError as e:
        raised = repr(e)
    dumps = list_flight_dumps(out)
    with open(dumps[-1]) as f:
        crash = json.load(f)
    checks.append({"check": "an exception out of train_batch: one dump",
                   "ok": raised is not None and len(dumps) == 2 and
                   crash["reason"] == "exception", "error": raised})
    big = np.zeros((1, oom_rows, TRAIN_SEQ), np.int32)
    oom_type = None
    try:
        engine.train_batch(batch={"input_ids": big})
    except torch.OutOfMemoryError as e:
        oom_type = type(e).__name__
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    dumps = list_flight_dumps(out)
    with open(dumps[-1]) as f:
        oom = json.load(f)
    forensics = oom.get("extra", {}).get("oom", {})
    loss = float(engine.train_batch(batch=staged))
    checks.append({"check": "an OOM: torch.OutOfMemoryError, a dump "
                   "classified oom with the ledger's hints, then a step",
                   "ok": oom_type is not None and len(dumps) == 3 and
                   oom["reason"] == "oom" and bool(forensics.get("hints"))
                   and bool(np.isfinite(loss)),
                   "hints": forensics.get("hints"),
                   "top_buffers": (forensics.get("top_buffers") or [])[:3],
                   "loss_after": loss})
    engine.shutdown()
    emit({"phase": "monitor_faults", "model": "gpt2-1.5b",
          "n_layer": cfg.n_layer, "stall_timeout_sec": MON_STALL_SEC,
          "oom_rows": oom_rows, "checks": checks, "card": card})
    bad = [c["check"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"monitor_faults: {bad}")


def pick(vals, p):
    return vals[min(int(p * len(vals)), len(vals) - 1)]


def tracker_agrees(tracker, done):
    """The tracker's p50/p99 TTFT and per-token latency against the
    requests' own stamps (bench.py bench_serving_observability): within
    MON_BUCKET_BAND."""
    ttft = sorted((q.first_token_at - q.admitted_at) * 1e3 for q in done)
    tok = []
    for q in done:
        n = max(len(q.out_tokens), 1)
        live = q.live_at if q.live_at is not None else q.admitted_at
        tok += [(q.finished_at - live) * 1e3 / n] * n
    tok.sort()
    rows = {}
    for name, hist, vals in (("ttft", tracker.hist_ttft_ms, ttft),
                             ("token", tracker.hist_token_ms, tok)):
        for p in (0.5, 0.99):
            rep, exact = hist.percentile(p), pick(vals, p)
            rows[f"{name}_p{int(p * 100)}"] = {
                "tracker_ms": rep, "requests_ms": exact,
                "ok": rep is not None and exact > 0 and
                1 / MON_BUCKET_BAND <= rep / exact <= MON_BUCKET_BAND}
    return rows


def monitored_serve(engine, prompts, new, device, reads):
    """Warm the engine up without the loop (the tracker sees loop
    requests only), then serve `prompts` through a ServingLoop with
    every decode and speculative block counted for host reads."""
    from deepspeed_tpu_torch.inference import Request, ServingLoop
    engine.start_request(0, prompts[0][:40], max_new=4)
    engine.decode_block(4)
    engine.fetch_state()
    engine.reset()
    sync(device)
    blocks = []
    for attr in ("decode_block", "spec_block"):
        if not hasattr(engine, attr):
            continue
        real = no_sync(getattr(engine, attr), device)

        def counted(*a, _real=real, **k):
            with reads:
                out = _real(*a, **k)
            blocks.append(len(reads.calls))
            del reads.calls[:]
            return out
        setattr(engine, attr, counted)
    done = ServingLoop(engine).serve(
        [Request(rid=i, tokens=p, max_new_tokens=new)
         for i, p in enumerate(prompts)])
    return {q.rid: q for q in done}, blocks


def monitor_serving(seed, card, spec_cfg, spec_params, device="cuda",
                    n_layer=None):
    """Phase 52: the serving cell (gpt2-1.5b, phase 4's settings, 4
    greedy requests) with the monitor and inference.observability on,
    beside the same serve without them; then phase 46's speculative
    cell (spec_cfg, spec_params) the same way. Gates: the tokens equal
    the unmonitored serve's; no host read in a decode or speculative
    block; the tracker's p50/p99 TTFT and per-token latency within one
    histogram bucket of the requests' own stamps; the `kv_cache` and
    `kv_cache_draft` ledger bytes the pools' tensor bytes; one Perfetto
    track per slot; the `speculative` events' keys the JAX engine's."""
    import shutil
    import tempfile
    import numpy as np
    from deepspeed_tpu_torch.inference import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import (GPT2ForCausalLM,
                                                 gpt2_config)

    checks = []
    rows = {}
    reads = HostReads()
    overrides = {} if n_layer is None else {"n_layer": n_layer}
    cfg = gpt2_config("gpt2-1.5b", **overrides)
    params = GPT2ForCausalLM(cfg, device=device).init(seed)
    plain_cfg = {"inference": {"max_slots": 4, "prefill_chunk": 128,
                               "sync_every": 8, "max_new_tokens": 32,
                               "kv_cache": {"num_pages": 128,
                                            "page_size": 16}}}
    rng = np.random.RandomState(seed)
    plain_prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                     for n in (100, 167, 233, 300)]
    cells = (("serving", cfg, params, plain_cfg, plain_prompts, 32),
             ("speculative", spec_cfg, spec_params,
              spec_serving_config(speculative=SPEC_BLOCK),
              spec_prompts(seed, spec_cfg.vocab_size), SPEC_NEW))
    for name, mcfg, weights, icfg, prompts, new in cells:
        out = tempfile.mkdtemp(prefix=f"ds_monitor_{name}_")
        t0 = time.perf_counter()
        off = InferenceEngine(mcfg, weights, icfg, device=device)
        ref, _ = monitored_serve(off, prompts, new, device, reads)
        del off
        release()
        on = InferenceEngine(
            mcfg, weights, dict(icfg, monitor={
                "enabled": True, "output_path": out,
                "trace": {"enabled": True}}), device=device)
        got, blocks = monitored_serve(on, prompts, new, device, reads)
        serve_s = time.perf_counter() - t0
        equal = all(got[i].out_tokens.tolist() == ref[i].out_tokens.tolist()
                    for i in ref)
        checks.append({"check": f"{name}: tokens equal the unmonitored "
                       "serve's", "ok": equal and len(got) == len(ref)})
        checks.append({"check": f"{name}: no host read in a block",
                       "ok": bool(blocks) and max(blocks) == 0,
                       "blocks": len(blocks)})
        agree = tracker_agrees(on.tracker, list(got.values()))
        checks.append({"check": f"{name}: tracker percentiles within one "
                       "bucket", "ok": all(r["ok"] for r in agree.values()),
                       **agree})
        st = on._state
        pools = {"kv_cache": sum(st[k].numel() * st[k].element_size()
                                 for k in ("k_pool", "v_pool"))}
        if on.speculative_enabled:
            sp = on._spec_state
            pools["kv_cache_draft"] = sum(
                t.numel() * t.element_size() for key, t in sp.items()
                if key in ("dk_pool", "dv_pool"))
        ledger = on.monitor.ledger.totals()["hbm"]
        checks.append({"check": f"{name}: KV ledger bytes are the pools'",
                       "ok": all(ledger.get(k) == v
                                 for k, v in pools.items()),
                       "ledger": {k: ledger.get(k) for k in pools},
                       "pools": pools})
        on.monitor.close()
        with open(os.path.join(out, "trace_rank0.json")) as f:
            trace = json.load(f)
        tracks = sorted(e["args"]["name"] for e in trace["traceEvents"]
                        if e.get("ph") == "M" and
                        e["args"]["name"].startswith("serve/slot"))
        checks.append({"check": f"{name}: one Perfetto track a slot",
                       "ok": tracks == [f"serve/slot{s}" for s in range(4)],
                       "tracks": tracks})
        events = read_events(out)
        for e in events:
            if e["kind"] == "speculative":
                check_keys(name, e, checks)
                break
        if on.speculative_enabled:
            checks.append({"check": f"{name}: speculative events",
                           "ok": any(e["kind"] == "speculative"
                                     for e in events)})
        slo = [e for e in events if e["kind"] == "serving_slo"][-1]
        rows[name] = {"serve_s": serve_s, "requests": len(got),
                      "kinds": sorted({e["kind"] for e in events}),
                      "ttft_p50_ms": slo["ttft_p50_ms"],
                      "ttft_p99_ms": slo["ttft_p99_ms"],
                      "token_p50_ms": slo["token_p50_ms"],
                      "token_p99_ms": slo["token_p99_ms"],
                      "tracker_speculative": on.tracker.snapshot().get(
                          "speculative")}
        del on
        release()
        shutil.rmtree(out, ignore_errors=True)
    emit({"phase": "monitor_serving", "model": "gpt2-1.5b",
          "n_layer": cfg.n_layer, "cells": rows, "checks": checks,
          "card": card})
    bad = [c["check"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"monitor_serving: {bad}")


def monitor_events(seed, card, device="cuda", n_layer=MON_CUT_LAYERS):
    """Phase 53, at MON_CUT_LAYERS layers each: the events of the paths
    that only some configurations run, each held to the JAX engine's key
    set, and their counters: gpt2-350m-moe8 (the `moe` event and the
    `router` events at its fences), the quantized path (the
    `quantized_matmul` event), O1's offload (the `metrics` events' wire
    counters against the bytes the offload step reports), a checkpoint
    save (`ckpt_commit`; the snapshot's ledger entries registered, then
    released), and engine.prefetch (its heartbeat terminal once the
    source is exhausted)."""
    import shutil
    import tempfile
    import numpy as np
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM, gpt2_config

    checks = []
    rows = {}

    def engine_for(cfg, ds, out):
        ds = dict(ds, monitor={"enabled": True, "output_path": out})
        model = GPT2ForCausalLM(cfg, device=device)
        return dst.initialize(model=model, model_parameters=model.init(seed),
                              config=ds)[0]

    # gpt2-350m-moe8: the moe event, the router at two fences
    out = tempfile.mkdtemp(prefix="ds_monitor_moe_")
    cfg = moe_config(n_layer=n_layer)
    ds = moe_ds_config()
    ds["async_dispatch"] = {"steps_per_sync": 2}
    eng = engine_for(cfg, ds, out)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, MOE_BATCH, MOE_SEQ)).astype(np.int32)
    staged = eng.stage_batch({"input_ids": ids})
    for _ in range(4):
        eng.train_batch(batch=staged)
    eng.shutdown()
    events = read_events(out)
    moe = [e for e in events if e["kind"] == "moe"]
    router = [e for e in events if e["kind"] == "router"]
    for e in moe[:1] + router[:1]:
        check_keys("moe", e, checks)
    checks.append({"check": "moe: one moe event, a router event a fence",
                   "ok": len(moe) == 1 and len(router) == 2 and all(
                       r["num_experts"] == MOE_EXPERTS and
                       np.isfinite(r["aux_loss"]) and
                       0 <= r["drop_fraction"] <= 1 for r in router)})
    rows["moe"] = {"router": router[-1] if router else None}
    del eng
    release()
    shutil.rmtree(out, ignore_errors=True)

    # the quantized path's event; this engine also saves a checkpoint
    # and feeds on engine.prefetch
    out = tempfile.mkdtemp(prefix="ds_monitor_quant_")
    cfg = train_config(n_layer=n_layer)
    ds = flagship_ds_config(TRAIN_BATCH)
    ds["quantized_compute"] = dict(QUANT_BLOCK_CONFIG)
    ds["async_dispatch"] = {"steps_per_sync": 2}
    eng = engine_for(cfg, ds, out)
    rng = np.random.default_rng(seed)
    micro = [{"input_ids": rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
        for _ in range(2)]
    loader = eng.prefetch(iter(micro))
    for _ in range(2):
        eng.train_batch(data_iter=loader)
    try:
        next(loader)
        exhausted = False
    except StopIteration:
        exhausted = True
    terminal = "prefetch" in eng.monitor._heartbeat_state()[1]
    checks.append({"check": "prefetch: heartbeat terminal at exhaustion",
                   "ok": exhausted and terminal})
    ckpt_dir = tempfile.mkdtemp(prefix="ds_monitor_ckpt_")
    eng.save_checkpoint(ckpt_dir, tag="t", async_save=True)
    during = eng.monitor.ledger.category_breakdown("ckpt_snapshot")
    eng.wait_for_checkpoint()
    after = eng.monitor.ledger.category_breakdown("ckpt_snapshot")
    checks.append({"check": "checkpoint: snapshot entries registered, "
                   "then released", "ok": sum(during.values()) > 0 and
                   after == {}, "during": during})
    eng.shutdown()
    events = read_events(out)
    for kind in ("quantized_matmul", "ckpt_commit"):
        got = [e for e in events if e["kind"] == kind]
        checks.append({"check": f"{kind}: one event", "ok": len(got) == 1})
        for e in got[:1]:
            check_keys(kind, e, checks)
    qm = [e for e in events if e["kind"] == "quantized_matmul"]
    checks.append({"check": "quantized_matmul: applied and active",
                   "ok": bool(qm) and qm[0]["applied"] and qm[0]["active"]})
    rows["quantized"] = {"event": qm[0] if qm else None}
    del eng
    release()
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # O1's offload: the fences' wire counters against the step's bytes
    import torch
    out = tempfile.mkdtemp(prefix="ds_monitor_offload_")
    cfg = gpt2_config("gpt2-125m", n_positions=OFF_SEQ, dropout=0.0,
                      dtype=torch.bfloat16, param_dtype=torch.float32,
                      remat=True, n_layer=n_layer)
    ds = offload_ds_config(micro=OFF_BATCH, gas=OFF_GAS)
    ds["steps_per_print"] = 2
    eng = engine_for(cfg, ds, out)
    d2h = h2d = 0
    for i in range(2):
        eng.train_batch(batch=offload_batch(cfg, i, gas=OFF_GAS,
                                            micro=OFF_BATCH, seq=OFF_SEQ))
        d2h += eng.wire_stats["d2h_bytes"]
        h2d += eng.wire_stats["h2d_bytes"]
    eng.shutdown()
    events = read_events(out)
    wire = [e for e in events if e["kind"] == "metrics"][-1]["wire"]
    checks.append({"check": "offload: the wire counters are the steps' "
                   "bytes", "ok": wire["d2h_bytes"] == d2h and
                   wire["h2d_bytes"] == h2d, "wire": wire,
                   "steps": {"d2h_bytes": d2h, "h2d_bytes": h2d}})
    mem = [e for e in events if e["kind"] == "memory"][-1]
    checks.append({"check": "offload: host_master and host_opt_state on "
                   "the ledger's host side",
                   "ok": {"host_master", "host_opt_state"} <=
                   set(mem["host"]["categories"]),
                   "host": mem["host"]["categories"]})
    rows["offload"] = {"wire": wire}
    del eng
    release()
    shutil.rmtree(out, ignore_errors=True)
    emit({"phase": "monitor_events", "n_layer": n_layer, "rows": rows,
          "checks": checks, "card": card})
    bad = [c["check"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"monitor_events: {bad}")


# ----------------------------------------------------------------------
# phases 54-57: the tools on the card — the flops profiler, the kernel
# autotuner, elasticity at world size 1, env_report
# ----------------------------------------------------------------------
# the kernel rows of a profile, by the launch counters' names
PROFILE_ROWS = {"K1-fwd": "flash_attention_fwd",
                "K2-fused": "flash_attention_bwd_fused",
                "K3-fwd": "fused_bias_residual_layernorm_fwd",
                "K3-bwd": "fused_bias_residual_layernorm_bwd",
                "K4-fwd": "fused_bias_gelu_fwd",
                "K4-bwd": "fused_bias_gelu_bwd"}
PROFILE_MATMULS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
                   "aten.matmul")
# the profile's total flops against the analytic count: the count covers
# the matrix products and attention; the rest of the profile is K3's and
# K4's per-element arithmetic (~0.2% of the step at gpt2-1.5b's widths;
# torch's formulas give the elementwise aten ops no flops)
TOL_PROFILE_FLOPS = 0.01


def flagship_flops(cfg, batch, seq):
    """The analytic flops of one flagship step under full-block remat:
    (matrix products, attention). Matrix products: tokens x (88 L H^2 +
    8 V H): each block's 12 H^2 of projections run forward (2 flops a
    MAC), backward (4) and again in the recompute (2), but for the
    block's last projection, whose output no backward needs (torch's
    non-reentrant checkpoint stops recomputing once the saved tensors
    are back: -8 H^2); the tied head's 2 V H forward, recomputed (the
    chunked loss is checkpointed) and 4 V H backward. Attention: per
    layer K1-fwd twice (forward, recompute), 4 B nh d pairs each, and
    K2-fused once, 10 B nh d pairs; pairs = T (T + 1) / 2 (causal)."""
    n_l, h, v = cfg.n_layer, cfg.n_embd, cfg.vocab_size
    tokens = batch * seq
    mm = tokens * (88 * n_l * h * h + 8 * v * h)
    pairs = seq * (seq + 1) // 2
    per_pair = batch * cfg.n_head * (h // cfg.n_head) * pairs
    attn = n_l * (2 * 4 + 10) * per_pair
    return mm, attn


def flops_profile_flagship(seed, card, ref_losses, steps=3):
    """Phase 54: the training cell (bench_gpt2_15b verbatim, phase 7's
    weights and batch) with `"flops_profiler": {"enabled": true,
    "profile_step": 2}` for `steps` steps. Gates: the losses bit for bit
    phase 7's first ones (the profile counts the real step); one
    profile, at step 2; its kernel rows' calls equal the launches
    counted over step 2 (zeroed right before it) and the exact per-step
    launches; its total flops within TOL_PROFILE_FLOPS of the analytic
    count (`flagship_flops`). Prints the top rows by est_us. Returns
    the launch counts of step 2."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.profiling.flops_profiler import profiler as fp

    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    cfg = train_config()
    ds = flagship_ds_config(batch)
    ds["flops_profiler"] = {"enabled": True, "profile_step": 2,
                            "top_modules": 8}
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg)
    engine, _, _, _ = dst.initialize(model=model,
                                     model_parameters=model.init(seed),
                                     config=ds)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, batch, seq)).astype(np.int32)
    staged = engine.stage_batch({"input_ids": ids})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, step_ms, counts = [], [], None
    for i in range(steps):
        if i == 1:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(engine.train_batch(batch=staged))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            counts = read_counts()
    loss_vals = [float(x) for x in torch.stack(losses).float().cpu()]
    prof = engine.last_flops_profile
    checks = [{"check": "losses bit for bit phase 7's",
               "ok": loss_vals == ref_losses[:steps], "losses": loss_vals,
               "training": ref_losses[:steps]},
              {"check": "one profile, at step 2", "ok": prof is not None}]
    if prof is None:
        raise AssertionError("flops_profile: no profile at step 2")
    rows = {r["name"]: r for r in prof.rows}
    calls = {k: rows[k]["calls"] if k in rows else 0 for k in PROFILE_ROWS}
    want = gpt2_step_launches(None, cfg.n_layer)
    checks.append({"check": "kernel rows' calls = the step's launches",
                   "ok": all(calls[k] == counts[c] == want[c]
                             for k, c in PROFILE_ROWS.items()),
                   "calls": calls,
                   "launches": {k: counts[c] for k, c in PROFILE_ROWS.items()},
                   "expected": {k: want[c] for k, c in PROFILE_ROWS.items()}})
    mm, attn = flagship_flops(cfg, batch, seq)
    got_mm = sum(r["flops"] for r in prof.rows
                 if r["name"] in PROFILE_MATMULS)
    got_attn = sum(rows[k]["flops"] for k in ("K1-fwd", "K2-fused")
                   if k in rows)
    total = prof.total_flops
    rel = abs(total - (mm + attn)) / (mm + attn)
    checks.append({"check": "total flops against the analytic count",
                   "ok": rel <= TOL_PROFILE_FLOPS, "total": total,
                   "analytic": mm + attn, "rel_gap": rel,
                   "tol": TOL_PROFILE_FLOPS,
                   "matmul": got_mm, "analytic_matmul": mm,
                   "matmul_exact": got_mm == mm,
                   "attention": got_attn, "analytic_attention": attn})
    top = fp._compact(prof.rows, 8)
    emit({"phase": "flops_profile", "model": "gpt2-1.5b",
          "n_layer": cfg.n_layer, "micro_batch": batch, "seq": seq,
          "profile_step": 2, "setup_s": setup_s, "step_ms": step_ms,
          "total_flops": total, "total_bytes": prof.total_bytes,
          "total_transcendentals": prof.total_transcendentals,
          "total_params": prof.total_params, "rows": len(prof.rows),
          "kernel_rows": {k: {f: rows[k][f] for f in (
              "calls", "flops", "bytes", "est_us", "time_pct")}
              for k in PROFILE_ROWS if k in rows},
          "top_by_est_us": top,
          "formula": "tokens (88 L H^2 + 8 V H) + L (2 x 4 + 10) B nh d "
                     "T (T + 1) / 2",
          "checks": checks, "card": card})
    for r in top:
        print(f"  flops_profile top: {r['op']:<28} {r['kind']:<6} calls "
              f"{r['calls']:>5} est {r['est_us']:.1f} us "
              f"({r['time_pct']}%)", flush=True)
    bad = [c["check"] for c in checks if not c["ok"]]
    del engine, model, staged
    if bad:
        raise AssertionError(f"flops_profile: {bad}")
    return counts


# the autotune phase's shapes: the flagship's rows (N 11,264 of H 1,600
# and W 6,400) and the serving decode step's (N 4), in bf16
TUNE_ROWS = ((TRAIN_BATCH * TRAIN_SEQ, 1600), (4, 1600))


class _EventLog:
    """A stand-in monitor: records the autotuner's events."""

    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append(dict(fields, kind=kind))


def _row_inputs(family, direction, n, h, gen):
    """(launch(plan) -> outputs, twin outputs, tolerances) of one row
    kernel at [n, h] (K4: W = h) on the flagship path's dtypes: bf16
    rows, bf16 vectors (master-less bf16 parameters), the tanh GeLU."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    bf16 = torch.bfloat16

    def rn(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen,
                                            device="cuda")).to(bf16)
    if family == "fused_ln" and direction == "fwd":
        y, res = rn(n, h), rn(n, h)
        bias, gamma, beta = rn(h, scale=0.1), rn(h, scale=0.1, shift=1.0), \
            rn(h, scale=0.1)
        ref = fo._ln_fwd_math(y, bias, res, gamma, beta, 1e-5)
        return (lambda plan: fo._ln_fwd_launch(
            y, bias, res, gamma, beta, 1e-5, bf16, bf16, True, tuned=plan),
            tuple(r.to(bf16) for r in ref), "rounding")
    if family == "fused_ln":
        s, dout, dsum = rn(n, h, scale=2.0), rn(n, h), rn(n, h)
        gamma = rn(h, scale=0.1, shift=1.0)
        ds, dg, db = fo._ln_bwd_math(s, gamma, dout, dsum, 1e-5)
        return (lambda plan: fo._ln_bwd_launch(s, gamma, dout, dsum, 1e-5,
                                               bf16, tuned=plan),
                (ds.to(bf16), ds.sum(0), dg.sum(0), db.sum(0)), "grad")
    x, bias = rn(n, h), rn(h, scale=0.1)
    if direction == "fwd":
        ref = fo._gelu_fwd_math(x, bias, True)
        return (lambda plan: fo._gelu_fwd_launch(x, bias, True, bf16, bf16,
                                                 tuned=plan),
                tuple(r.to(bf16) for r in ref), "rounding")
    dout = rn(n, h)
    d = fo._gelu_bwd_math(x, dout, True)
    return (lambda plan: fo._gelu_bwd_launch(x, dout, True, bf16,
                                             tuned=plan),
            (d.to(bf16), d.sum(0)), "grad")


def autotune_phase(seed, card):
    """Phase 55: `search` over the launch plans of K3-fwd, K3-bwd, K4-fwd
    and K4-bwd at the flagship's shapes and the decode shape, in bf16,
    into a temporary table (no table at the default path before or
    after: every bit-for-bit gate of this script runs on the default
    plans). Gates: every candidate's output held against the twin (bf16
    within one rounding; gradients by relative L2 1e-2) and repeated
    bit for bit; each winner's time <= its default's; a fresh process
    reloads the table, its wrapper call emits `autotune_hit` and
    launches the winning plan; an entry with a forged source hash falls
    back to the default plan with one warning. The flash_fwd and
    quantized_matmul families search their one instantiated tile pair
    and report it."""
    import logging
    import shutil
    import tempfile
    import torch
    from deepspeed_tpu_torch.ops import autotune
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    from deepspeed_tpu_torch.utils.logging import logger

    default_path = os.path.join(_build.BUILD_DIR, autotune.TABLE_BASENAME)
    tmp = tempfile.mkdtemp(prefix="ds_autotune_")
    table = os.path.join(tmp, "autotune_table.json")
    checks = [{"check": "no table at the default path before",
               "ok": not os.path.exists(default_path)}]
    log = _EventLog()
    autotune.reset()
    autotune.configure(enabled=True, table_path=table, monitor=log)
    sms = fo._sm_count(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 55)
    families, winners = [], {}
    t0 = time.perf_counter()
    try:
        for n, h in TUNE_ROWS:
            for family, width in (("fused_ln", h), ("fused_gelu", 4 * h)):
                for direction in ("fwd", "bwd"):
                    launch, ref, kind = _row_inputs(family, direction, n,
                                                    width, gen)
                    default, cands = autotune.row_search_space(
                        family, direction, n, width, sms)
                    worst = 0.0
                    for plan in [default] + [c for c in cands
                                             if c != default]:
                        got = launch(plan)
                        again = launch(plan)
                        torch.cuda.synchronize()
                        if not all(torch.equal(a, b)
                                   for a, b in zip(got, again)):
                            raise AssertionError(
                                f"autotune {family} {direction} {plan}: "
                                "two launches differ")
                        for a, b in zip(got, ref):
                            if kind == "rounding":
                                abs_err, ratio = max_err(a, b, atol=1e-2,
                                                         rtol=1e-2)
                                ok = ratio <= 1.0
                            else:
                                abs_err = rel_l2(a, b)
                                ok = abs_err <= 1e-2
                            worst = max(worst, abs_err)
                            if not ok:
                                raise AssertionError(
                                    f"autotune {family} {direction} n {n} "
                                    f"w {width} plan {plan}: error "
                                    f"{abs_err} against the twin")
                        del got, again
                    res = autotune.search_row_plan(
                        family, direction, n, width, torch.bfloat16,
                        lambda plan: (lambda: launch(plan)), sms,
                        warmup=2, reps=5, inner=10)
                    key = f"{family}_{direction}_n{n}_w{width}"
                    winners[key] = (family, direction, n, width,
                                    res["params"])
                    families.append({
                        "family": family, "direction": direction, "n": n,
                        "width": width, "candidates": res["candidates_tried"],
                        "default": default, "winner": res["params"],
                        "default_us": res["default_us"],
                        "winner_us": res["best_us"],
                        "speedup": res["speedup_vs_default"],
                        "max_err_vs_twin": worst,
                        "err_kind": "max abs (bf16 outputs)"
                        if kind == "rounding" else "relative L2"})
                    checks.append({"check": f"{key}: winner <= default",
                                   "ok": res["best_us"] <= res["default_us"]})
                    release()
        # the tile families: one instantiated pair each
        b, t, nh, d = TRAIN_BATCH, TRAIN_SEQ, 25, 64
        q, k, v = (torch.randn((b, t, nh, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        tiles = autotune.flash_tile_candidates(torch.bfloat16, d)
        flash = autotune.search(
            "flash_fwd", autotune.flash_shape_class(t, d, True, False),
            torch.bfloat16, tiles, tiles[0],
            build=lambda p: (lambda: fa._flash_forward(q, k, v, 0.125,
                                                       True)),
            warmup=2, reps=3, inner=5)
        qm = _qmm()
        m, kk, nn = TRAIN_BATCH * TRAIN_SEQ, 1600, 4800
        x = torch.randn((1, m, kk), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (0.02 * torch.randn((1, kk, nn), generator=gen, device="cuda")) \
            .to(torch.bfloat16)
        wq, sw = qm.quantize_kernel_int8(w, QUANT_BLOCK)
        xq, sx = qm.quantize_rows_int8(x)
        xq = torch.nn.functional.pad(xq, (0, wq.shape[-2] - kk)).contiguous()
        qtiles = autotune.qmm_tile_candidates()
        qmm = autotune.search(
            "quantized_matmul", autotune.qmm_shape_class(m, kk, nn),
            torch.bfloat16, qtiles, qtiles[0],
            build=lambda p: (lambda: qm._qmm_launch(
                xq, wq, sx, sw, QUANT_BLOCK, torch.bfloat16)),
            warmup=2, reps=3, inner=5)
        for name, res, cand in (("flash_fwd", flash, tiles),
                                ("quantized_matmul", qmm, qtiles)):
            families.append({"family": name, "searched": cand,
                             "candidates": res["candidates_tried"],
                             "winner": res["params"],
                             "default_us": res["default_us"],
                             "winner_us": res["best_us"],
                             "speedup": res["speedup_vs_default"]})
            checks.append({"check": f"{name}: the one instantiated tile "
                           "pair, speedup 1.0",
                           "ok": res["candidates_tried"] == 1 and
                           res["speedup_vs_default"] == 1.0})
        del q, k, v, x, w, wq, sw, xq, sx
        search_s = time.perf_counter() - t0
        searches = [e for e in log.events if e["kind"] == "autotune_search"]
        checks.append({"check": "one autotune_search event a search",
                       "ok": len(searches) == len(families)})

        # a fresh process reloads the table: its K3-fwd wrapper call at
        # the flagship's rows emits autotune_hit and launches the winner
        n, h = TUNE_ROWS[0]
        win = winners[f"fused_ln_fwd_n{n}_w{h}"][4]
        script = (
            "import json, torch\n"
            "from deepspeed_tpu_torch.ops import autotune\n"
            "from deepspeed_tpu_torch.ops.transformer import fused_ops as fo\n"
            "events, plans = [], []\n"
            "class Log:\n"
            "    def event(self, kind, **f):\n"
            "        events.append(dict(f, kind=kind))\n"
            "plan = fo.ln_fwd_plan\n"
            "def spy(*a):\n"
            "    plans.append(a[4] if len(a) > 4 else None)\n"
            "    return plan(*a)\n"
            "fo.ln_fwd_plan = spy\n"
            f"autotune.configure(table_path={table!r}, monitor=Log())\n"
            "bf = torch.bfloat16\n"
            f"y = torch.randn(({n}, {h}), device='cuda').to(bf)\n"
            f"v = torch.ones(({h},), device='cuda', dtype=bf)\n"
            "out, s = fo.fused_bias_residual_layernorm(y, v, y, v, v)\n"
            "torch.cuda.synchronize()\n"
            "print(json.dumps({'events': events, 'plans': plans,\n"
            "                  'finite': bool(torch.isfinite(out).all())}))\n")
        t1 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, cwd=ROOT,
                             timeout=300)
        reload_s = time.perf_counter() - t1
        if run.returncode != 0:
            raise AssertionError(f"autotune reload process failed:\n"
                                 f"{run.stderr[-3000:]}")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        hits = [e for e in got["events"] if e["kind"] == "autotune_hit"]
        tuned = [list(map(list, p)) if p else None for p in got["plans"]]
        checks.append({"check": "a fresh process: autotune_hit and the "
                       "winning plan", "ok": len(hits) == 1 and
                       hits[0]["params"] == win and
                       tuned == [[list(kv) for kv in sorted(win.items())]]
                       and got["finite"], "hits": hits, "plans": tuned,
                       "winner": win, "reload_s": reload_s})

        # a forged source hash: the default plan and one warning
        with open(table) as f:
            doc = json.load(f)
        for entry in doc["entries"].values():
            entry["source_hash"] = "forged"
        with open(table, "w") as f:
            json.dump(doc, f)
        warned = []

        class Warned(logging.Handler):
            def emit(self, record):
                warned.append(record.getMessage())
        handler = Warned(level=logging.WARNING)
        logger.addHandler(handler)
        autotune.reset()
        autotune.configure(table_path=table)
        try:
            plans = [autotune.row_plan("fused_ln", n, h, "fwd",
                                       torch.bfloat16) for _ in range(3)]
            y = torch.randn((n, h), generator=gen, device="cuda").to(
                torch.bfloat16)
            vec = torch.ones((h,), device="cuda", dtype=torch.bfloat16)
            out = fo.fused_bias_residual_layernorm(y, vec, y, vec, vec)[0]
            default_out = fo._ln_fwd_launch(
                y, vec, y, vec, vec, 1e-5, torch.bfloat16, torch.bfloat16,
                True, tuned=autotune.row_search_space(
                    "fused_ln", "fwd", n, h, sms)[0])[0]
            same = bool(torch.equal(out, default_out))
        finally:
            logger.removeHandler(handler)
        stale = [m for m in warned if "different kernel source" in m]
        checks.append({"check": "a forged source hash: the default plan "
                       "and one warning", "ok": plans == [None] * 3 and
                       len(stale) == 1 and same, "warnings": stale})
    finally:
        autotune.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    checks.append({"check": "no table at the default path after",
                   "ok": not os.path.exists(default_path)})
    emit({"phase": "autotune", "dtype": "bf16", "sms": sms,
          "families": families, "search_s": search_s, "checks": checks,
          "card": card})
    for f in families:
        print(f"  autotune {f['family']} {f.get('direction', '')} "
              f"n {f.get('n', '-')} w {f.get('width', '-')}: default "
              f"{f['default_us']} us, winner {f['winner_us']} us "
              f"{f['winner']}", flush=True)
    bad = [c["check"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"autotune: {bad}")


# phase 56: the supervisor on gpt2-1.5b's width at ELASTIC_LAYERS layers
ELASTIC_LAYERS = 4
ELASTIC_BLOCK = {"enabled": True, "max_train_batch_size": 4,
                 "micro_batch_sizes": [2], "version": 0.1,
                 "runtime": {"enabled": True, "hosts": 1,
                             "checkpoint_interval": 2,
                             "drain_timeout_sec": 10, "escalate_after": 2}}
# the recovery event's keys (deepspeed_tpu/elasticity/runtime.py)
ELASTIC_EVENT_KEYS = {"cause", "lost_hosts", "world_before", "world_after",
                      "micro_batch", "gradient_accumulation_steps",
                      "resumed_from_tag", "resumed_step", "replayed_steps",
                      "detect_to_resume_sec", "zero_plan_bytes"}


def elastic_phase(seed, card, device="cuda", n_layer=ELASTIC_LAYERS):
    """Phase 56: `ElasticSupervisor` drives gpt2-1.5b's width at
    `n_layer` layers, seq 1024, bf16 master-less, ZeRO-2, AdamW, the
    elasticity block ELASTIC_BLOCK (micro batch 2, gas 2 at world size
    1), async checkpoints into a temporary dir, the monitor on: run(3),
    two injected stalls, run(8). Gates: exactly one recovery, cause
    stall_escalated, world_after 1, resumed from global_step2, at least
    one replayed step and every replayed loss bit for bit; the event's
    zero_plan bytes equal to the memory ledger's state bytes (the
    optimizer's 0-d step count aside); the recovery event in the
    monitor's JSONL with the JAX keys. Prints detect-to-resume ms.
    Returns the launch counts of the whole run."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from deepspeed_tpu_torch.elasticity import runtime as ert
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from deepspeed_tpu_torch.monitor import memory as mem

    tmp = tempfile.mkdtemp(prefix="ds_elastic_")
    out = os.path.join(tmp, "monitor")
    cfg = train_config(n_layer=n_layer)
    seq = TRAIN_SEQ
    ds = {"steps_per_print": 1000,
          "bf16": {"enabled": True, "master_weights": False},
          "zero_optimization": {"stage": 2},
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-4, "weight_decay": 0.01}},
          "checkpoint": {"async_save": True},
          "monitor": monitor_block(out),
          "elasticity": json.loads(json.dumps(ELASTIC_BLOCK))}

    def factory():
        model = GPT2ForCausalLM(cfg, device=device)
        return model, model.init(seed)

    def batch_fn(step, spec):
        ids = np.random.default_rng(seed * 1000 + step).integers(
            0, cfg.vocab_size, (spec.gas, spec.rows, seq)).astype(np.int32)
        return {"input_ids": ids}

    checks = []
    t0 = time.perf_counter()
    sup = ert.ElasticSupervisor(ds, factory, batch_fn,
                                save_dir=os.path.join(tmp, "ckpt"),
                                device=device)
    try:
        reset_counts()
        sup.run(3)
        sup.injector.inject_stall()
        sup.injector.inject_stall()
        rep = sup.run(8)
        sync(device)
        counts = read_counts()
        engine = sup.engine
        led = engine.monitor.ledger.totals()["hbm"]
        st = engine.state
        scalars = sum(t.numel() * t.element_size()
                      for t in engine._state_tensors(st.opt_state)
                      if t.dim() == 0)
        measured = {"params": led.get(mem.CAT_PARAMS, 0),
                    "master": led.get(mem.CAT_MASTER, 0),
                    "opt_state": led.get(mem.CAT_OPT, 0) - scalars,
                    "grads": led.get(mem.CAT_GRADS, 0)}
        replayed = {s: list(p) for s, p in sup.replayed_losses.items()}
    finally:
        sup.close()
    run_s = time.perf_counter() - t0
    recs = rep["recoveries"]
    rec = recs[0] if recs else {}
    checks.append({"check": "exactly one recovery, an escalated stall",
                   "ok": len(recs) == 1 and
                   rec.get("cause") == ert.STALL_ESCALATED})
    checks.append({"check": "world_after 1, resumed from global_step2",
                   "ok": rec.get("world_after") == 1 and
                   rec.get("resumed_from_tag") == "global_step2"})
    checks.append({"check": "replayed steps bit for bit",
                   "ok": rec.get("replayed_steps", 0) >= 1 and
                   len(replayed) == rec.get("replayed_steps") and
                   all(a == b for a, b in replayed.values()),
                   "replayed": replayed})
    checks.append({"check": "zero_plan bytes = the ledger's state bytes",
                   "ok": rec.get("zero_plan_bytes") == measured,
                   "plan": rec.get("zero_plan_bytes"), "ledger": measured})
    events = read_events(out)
    mon = [e for e in events if e["kind"] == "recovery"]
    checks.append({"check": "the recovery event in the monitor, the JAX "
                   "keys", "ok": len(mon) == 1 and
                   ELASTIC_EVENT_KEYS | MON_BASE_KEYS <= set(mon[0]),
                   "keys": sorted(mon[0]) if mon else None})
    losses = [rep["losses"][s] for s in sorted(rep["losses"])]
    checks.append({"check": "losses finite", "ok": bool(
        np.all(np.isfinite(losses))) and rep["steps"] == 8})
    emit({"phase": "elastic", "model": "gpt2-1.5b", "n_layer": cfg.n_layer,
          "seq": seq, "elasticity": ELASTIC_BLOCK,
          "world_size": rep["world_size"], "micro_batch": rep["micro_batch"],
          "gradient_accumulation_steps":
              rep["gradient_accumulation_steps"],
          "recovery": rec,
          "detect_to_resume_ms": rec.get("detect_to_resume_sec", 0) * 1e3,
          "losses": losses, "run_s": run_s, "checks": checks, "card": card})
    shutil.rmtree(tmp, ignore_errors=True)
    bad = [c["check"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"elastic: {bad}")
    return counts


def env_report_phase(card):
    """Phase 57: `python -m deepspeed_tpu_torch.env_report` in a
    subprocess: exit 0; every `.cu` under ops/csrc/ reported built and
    compatible; the card's name and power limit as nvidia-smi gives
    them; nvcc's version."""
    from deepspeed_tpu_torch.ops import _build
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m",
                          "deepspeed_tpu_torch.env_report"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    report_s = time.perf_counter() - t0
    lines = run.stdout.splitlines()
    name, _, limit = card.partition(",")
    sources = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    rows = {src: [ln for ln in lines if f"ops/csrc/{src}" in ln]
            for src in sources}
    nvcc = [ln for ln in lines if ln.startswith("nvcc .")]
    checks = [
        {"check": "exit 0", "ok": run.returncode == 0},
        {"check": "every .cu built and compatible",
         "ok": all(len(r) == 1 and r[0].count("[OKAY]") == 2
                   for r in rows.values()), "sources": sources},
        {"check": "the card's name and power limit",
         "ok": any(name.strip() in ln for ln in lines) and
         any(limit.strip() in ln for ln in lines)},
        {"check": "nvcc's version", "ok": len(nvcc) == 1 and
         "release" in nvcc[0], "nvcc": nvcc},
    ]
    emit({"phase": "env_report", "report_s": report_s,
          "lines": [ln for ln in lines if "ops/csrc/" in ln or
                    ln.startswith(("nvcc", "target", "device", "power",
                                   "torch"))],
          "stderr": run.stderr[-2000:], "checks": checks, "card": card})
    bad = [c["check"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"env_report: {bad}")


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
    # the host's cores, RAM and CPU-Adam's threads (builds the host
    # library from csrc/adam/cpu_adam.cpp)
    host_line()

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

    # 45-47: speculative decoding on the damped gpt2-1.5b, its verify
    # rows, the temperature-0 stream against vanilla (counts zeroed in
    # serve_timed after the warm-up, right before the timed speculative
    # serve) and the sampled run; 48-49: int8 weight-only serving on the
    # same weights (counts zeroed the same way before the timed int8
    # serve) and int8 with speculation.
    # Both paths run K3-fwd and K4-fwd, and never K6 (the epilogue is
    # plain torch)
    spec_counts, spec_cfg, spec_params = speculative_decode(args.seed, card)
    speculative = path_counts("speculative", spec_counts, SPEC_KERNELS,
                              ("quantized_matmul",))
    int8 = path_counts("int8_serving",
                       int8_serving(args.seed, card, spec_cfg, spec_params),
                       SPEC_KERNELS, ("quantized_matmul",))
    # 52: the serving cell and phase 46's speculative cell with the
    # monitor and the request tracker
    monitor_serving(args.seed, card, spec_cfg, spec_params)
    del spec_params
    release()

    # 7: the training path (counts zeroed inside, right before its
    # steps), then 8: its oracle
    training, losses = train_and_check(args.seed, card)
    path_counts("training", training, TRAINING_KERNELS, FUSED_ABSENT)
    exact_launches("training", training, len(losses), None,
                   train_config().n_layer)
    training_oracle(args.seed)
    release()

    # 54: the training cell again with the flops_profiler block, held to
    # 7's losses (counts zeroed inside, right before its profiled step)
    profiled = path_counts("flops_profile",
                           flops_profile_flagship(args.seed, card, losses),
                           TRAINING_KERNELS, FUSED_ABSENT)
    release()

    # 50, path M: the training cell with the monitor beside it without
    # (counts zeroed inside, before each of its windows), at
    # MON_TRAIN_LAYERS of its 48 layers
    monitored = path_counts("monitor_training",
                            monitor_training(args.seed, card,
                                             n_layer=MON_TRAIN_LAYERS),
                            TRAINING_KERNELS, FUSED_ABSENT)
    release()

    # 35, path H, and 36: the flagship's width at REMAT_CUT_LAYERS
    # layers (H at 48 until PR 23) under save_fused_epilogues and under
    # save_only_these_names:attn_out,attn_lse, each held to full-block
    # remat at the same depth, weights and batch, and to its exact
    # launches (counts zeroed inside each, right before its steps)
    cut = dict(warmup=1, steps=3, n_layer=REMAT_CUT_LAYERS)
    remat_ref, ref_losses = train_and_check(
        args.seed, card, phase="training_remat_reference", **cut)
    path_counts("training_remat_reference", remat_ref, TRAINING_KERNELS,
                FUSED_ABSENT)
    exact_launches("training_remat_reference", remat_ref, len(ref_losses),
                   None, REMAT_CUT_LAYERS)
    by_policy = {}
    for policy, path in (("save_fused_epilogues", "training_per_fusion"),
                         (ATTN_NAMES, "training_attn_names")):
        counts, pol_losses = train_and_check(
            args.seed, card, remat_policy=policy, phase=path, **cut)
        by_policy[path] = path_counts(path, counts, TRAINING_KERNELS,
                                      FUSED_ABSENT)
        exact_launches(path, counts, len(pol_losses), policy,
                       REMAT_CUT_LAYERS)
        gaps = [abs(a - b) for a, b in zip(pol_losses, ref_losses)]
        emit({"phase": f"{path}_vs_full_remat_losses", "policy": policy,
              "losses": pol_losses, "full_remat": ref_losses,
              "abs_gap": gaps, "tol": TOL_TRAIN_LOSS,
              "n_layer": REMAT_CUT_LAYERS, "ok": max(gaps) <= TOL_TRAIN_LOSS})
        if not max(gaps) <= TOL_TRAIN_LOSS:
            raise AssertionError(f"{path} losses {pol_losses} stray more "
                                 f"than {TOL_TRAIN_LOSS} from full remat's "
                                 f"{ref_losses}")
    per_fusion = by_policy["training_per_fusion"]
    attn_names = by_policy["training_attn_names"]
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
        moe_train_and_check(args.seed, card, quantized=True,
                            n_layer=MOE_CUT_LAYERS),
        MOE_QUANT_KERNELS, FUSED_ABSENT)

    # 34, path G: gpt2-350m under dots_with_no_batch_dims_saveable, fed
    # by engine.prefetch (counts zeroed inside, right before its steps)
    selective = path_counts("gpt2_350m_selective",
                            gpt2_350m_selective(args.seed, card),
                            TRAINING_KERNELS, FUSED_ABSENT)

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

    # 37: the user checkpoint chain, without and with cpu_checkpointing;
    # 38: BERT-large's memory flags under fused ops (counts zeroed inside
    # each, right before its runs)
    user_ck = path_counts("user_checkpoint", user_checkpoint(args.seed, card),
                          TRAINING_KERNELS, FUSED_ABSENT)
    release()
    bert_flags = path_counts("bert_memory_flags",
                             bert_memory_flags(args.seed, card),
                             BERT_KERNELS, FUSED_ABSENT)

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
    release()

    # 30: path D, gpt2-350m-moe8 in fp16 (K8, grouped K4); 31: path E,
    # D with quantized experts and the quantized_compute block (K6 with
    # an fp16 output); 32: the ring leg in fp16 in the one-rank group
    # (K5, K2's given-delta sweeps); 33: path F, sp_training in fp16
    # (K5, K2-fused's given-delta entry); counts zeroed inside each,
    # right before its steps or passes
    moe16 = path_counts("moe_fp16", moe_fp16(args.seed, card),
                        MOE_FP16_KERNELS, FUSED_ABSENT)
    moe_quant16 = path_counts(
        "moe_quant_fp16", moe_fp16(args.seed, card, quantized=True),
        MOE_FP16_KERNELS + ("quantized_matmul",), FUSED_ABSENT)
    rendezvous = init_sp_group()
    try:
        ring16 = path_counts("sequence_parallel_fp16",
                             sequence_parallel_fp16_path(args.seed, card),
                             ("flash_attention_merge", "flash_attention_bwd"))
        sp16 = path_counts("sp_fp16", sp_fp16(args.seed, card),
                           SP_TRAINING_KERNELS, FUSED_ABSENT)
    finally:
        torch.distributed.destroy_process_group()
        if os.path.exists(rendezvous):
            os.remove(rendezvous)

    # 39-44: ZeRO-Offload: O1 zero_offload_real_step (then O5: its
    # engine saves and a fresh one resumes), O2 the three wires, O3 the
    # flagship with cpu_offload and its A/B against fp32 masters on the
    # card, O4 fp16 from 2^32 (counts zeroed inside each, right before
    # its steps)
    o1, o1_engine, o1_cfg, _ = zero_offload_real_step(args.seed, card)
    off_real = path_counts("zero_offload_real_step", o1, TRAINING_KERNELS,
                           FUSED_ABSENT)
    off_ckpt = path_counts("offload_checkpoint",
                           offload_checkpoint(o1_engine, o1_cfg, args.seed,
                                              card),
                           TRAINING_KERNELS, FUSED_ABSENT)
    del o1_engine
    release()
    off_wire = path_counts("zero_offload_wire",
                           zero_offload_wire(args.seed, card),
                           TRAINING_KERNELS, FUSED_ABSENT)
    off_flag = path_counts("offload_flagship",
                           offload_flagship(args.seed, card),
                           TRAINING_KERNELS, FUSED_ABSENT)
    offload_ab(args.seed, card)
    release()
    off16 = path_counts("offload_fp16", offload_fp16(args.seed, card),
                        TRAINING_KERNELS, FUSED_ABSENT)
    release()

    # 51: the watchdog, the flight recorder and OOM forensics; 53: the
    # events of the MoE, quantized, offload, checkpoint and prefetch paths
    monitor_faults(args.seed, card)
    release()
    monitor_events(args.seed, card)
    release()

    # 55: the autotuner over K3's and K4's launch plans (a temporary
    # table, removed after); 56: the elastic supervisor at world size 1
    # (counts zeroed inside, right before its first run); 57: env_report
    autotune_phase(args.seed, card)
    release()
    elastic = path_counts("elastic", elastic_phase(args.seed, card),
                          TRAINING_KERNELS, FUSED_ABSENT)
    release()
    env_report_phase(card)

    rows = []
    counts_by_path = {"serving": serving, "speculative": speculative,
                      "int8_serving": int8, "training": training,
                      "quant_training": quant, "moe_training": moe,
                      "moe_quant_training": moe_quant,
                      "sparse_attention": sparse,
                      "sparse_attention_fp16": sparse16,
                      "sparse_oracle": sparse_oracle_counts,
                      "sequence_parallel": sp_path,
                      "sp_training": sp_train, "checkpoint": ckpt,
                      "bert_training": bert, "bert_fp16": bert16,
                      "gpt2_fp16_pld": gpt16,
                      "engine_surface_fp16": surface16,
                      "moe_fp16": moe16, "moe_quant_fp16": moe_quant16,
                      "sequence_parallel_fp16": ring16, "sp_fp16": sp16,
                      "training_remat_reference": remat_ref,
                      "training_per_fusion": per_fusion,
                      "training_attn_names": attn_names,
                      "gpt2_350m_selective": selective,
                      "user_checkpoint": user_ck,
                      "bert_memory_flags": bert_flags,
                      "zero_offload_real_step": off_real,
                      "offload_checkpoint": off_ckpt,
                      "zero_offload_wire": off_wire,
                      "offload_flagship": off_flag,
                      "offload_fp16": off16,
                      "monitor_training": monitored,
                      "flops_profile": profiled, "elastic": elastic}
    for kname, src_file, replaces, _ in KERNELS:
        # the row's numbers at the kernel's first timed shape (the
        # serving shape where the kernel serves, as in earlier runs);
        # every path's under "timed_by_path"
        by_path = results[kname]
        r = next(iter(by_path.values()))
        # an fp16 form's launches are the fp16 paths' (or its rows'
        # paths'), a bf16 form's the others'
        fp16 = kname in FP16_KERNELS
        counter = FP16_COUNTERS.get(kname, FP16_KERNELS.get(kname, kname))
        row_paths = FP16_ROW_PATHS.get(kname, FP16_PATHS)
        paths = {p: c[counter] for p, c in counts_by_path.items()
                 if (p in row_paths if fp16 else p not in FP16_PATHS)}
        extra = {k: r[k] for k in ("library_call", "bf16_matmul_ms",
                                   "fp16_matmul_ms",
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
