#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run, on one card

Phases, each printing one JSON line:
  1. environment: card name and power limit (nvidia-smi), torch/CUDA
     versions; TF32 is switched off for matmuls and cuDNN;
  2. build: the kernels compiled from ops/csrc/ into build/torch_kernels/;
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
     must be > 0 after phase 5.
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
# fp32 CUDA-core FLOP/s, HBM bytes/s. Matched against the card's name.
PEAKS = (
    ("H100 PCIe", dict(bf16=756e12, fp32=51e12, hbm=2.0e12)),
    ("H100 NVL", dict(bf16=835e12, fp32=60e12, hbm=3.9e12)),
    ("H200", dict(bf16=989e12, fp32=67e12, hbm=4.8e12)),
    ("H100", dict(bf16=989e12, fp32=67e12, hbm=3.35e12)),
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

ROOT = os.path.dirname(os.path.abspath(__file__))


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


def max_err(got, ref, atol, rtol):
    """(max abs error, max error / (atol + rtol*|ref|)); the check
    passes when the second is <= 1."""
    import torch
    g, r = got.float(), ref.float()
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


def kernel_flash(peaks, gen):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    checks, out = [], {}

    def qkv_views(b, t, h, d, dtype):
        # the model's layout: q/k/v are column slices of one qkv tensor
        c = h * d
        qkv = torch.randn((b, t, 3 * c), generator=gen, device="cuda",
                          dtype=torch.float32).to(dtype)
        return [p.view(b, t, h, d) for p in qkv.split(c, dim=-1)]

    cases = (
        # (label, B, T, H, D, dtype, causal, flagship)
        ("bf16 causal B4 T1024 H25 D64", 4, 1024, 25, 64,
         torch.bfloat16, True, True),
        ("bf16 causal B1 T384 H25 D64 (oracle shape)", 1, 384, 25, 64,
         torch.bfloat16, True, False),
        ("fp32 non-causal B4 T256 H25 D64", 4, 256, 25, 64,
         torch.float32, False, False),
    )
    for label, b, t, h, d, dtype, causal, flagship in cases:
        q, k, v = qkv_views(b, t, h, d, dtype)
        sm = 1.0 / d ** 0.5
        got, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = fa._flash_fwd_plain(q, k, v, sm, causal)
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        err = check(f"flash out, {label}", got, ref, tol, checks)
        check(f"flash log2-lse, {label}", lse[..., 0], ref_lse, TOL_F32,
              checks)
        if flagship:
            itemsize = q.element_size()
            pairs = t * (t + 1) // 2 if causal else t * t
            flops = 4.0 * b * h * d * pairs
            nbytes = 4 * b * t * h * d * itemsize + b * h * t * 4
            peak = peaks["bf16"] if dtype == torch.bfloat16 \
                else peaks["fp32"]
            bound_ms, bound_by = bound(flops, peak, nbytes, peaks)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out = dict(
                max_abs_err=err,
                ms=time_ms(lambda: fa.flash_attention_with_lse(
                    q, k, v, causal=causal)),
                plain_ms=time_ms(lambda: fa._flash_fwd_plain(
                    q, k, v, sm, causal), iters=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal)),
                shape=label)
    return out, checks


def kernel_ln(peaks, gen):
    import torch
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    checks, out = [], {}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (
        # (label, N, out dtype, sum dtype or None for the ln_f form)
        ("N4096 H1600 bf16 out+sum", 4096, bf16, bf16),
        ("N4096 H1600 ln_f form (fp32 out, no sum)", 4096, f32, None),
        ("N4 H1600 bf16 (decode shape)", 4, bf16, bf16),
        ("N128 H1600 bf16 (prefill chunk shape)", 128, bf16, bf16),
    )
    h = 1600
    for label, n, out_dt, sum_dt in cases:
        y = torch.randn((n, h), generator=gen, device="cuda").to(bf16)
        res = torch.randn((n, h), generator=gen, device="cuda").to(bf16)
        bias, gamma, beta = (0.1 * torch.randn(
            (h,), generator=gen, device="cuda") for _ in range(3))
        gamma = gamma + 1.0
        ret_sum = sum_dt is not None

        def run():
            return fo.fused_bias_residual_layernorm(
                y, bias, res, gamma, beta, eps=1e-5, out_dtype=out_dt,
                sum_dtype=sum_dt, return_sum=ret_sum)

        got = run()
        torch.cuda.synchronize()
        ref_out, ref_s = fo._ln_fwd_math(y, bias, res, gamma, beta, 1e-5)
        tol = TOL_BF16 if out_dt == bf16 else TOL_F32
        if ret_sum:
            err = check(f"ln out, {label}", got[0], ref_out.to(out_dt), tol,
                        checks)
            check(f"ln sum, {label}", got[1], ref_s.to(sum_dt), TOL_BF16,
                  checks)
        else:
            err = check(f"ln out, {label}", got, ref_out, tol, checks)
        if n == 4096 and ret_sum:
            # read y and residual, write out and sum (bf16), the [H]
            # vectors once; fp32 arithmetic: 2 adds, square and 2
            # accumulates, subtract, 2 multiplies and an add per element
            nbytes = n * h * (2 + 2 + 2 + 2) + 3 * h * 4
            bound_ms, bound_by = bound(9 * n * h, peaks["fp32"], nbytes,
                                       peaks)
            out = dict(
                max_abs_err=err, ms=time_ms(run),
                plain_ms=time_ms(lambda: fo._ln_fwd_math(
                    y, bias, res, gamma, beta, 1e-5)),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, shape=label)
    return out, checks


def kernel_gelu(peaks, gen):
    import torch
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    checks, out = [], {}
    bf16 = torch.bfloat16
    w = 6400
    cases = (("N4096 W6400 bf16 tanh", 4096, True),
             ("N4096 W6400 bf16 erf", 4096, False),
             ("N4 W6400 bf16 tanh (decode shape)", 4, True))
    for label, n, approx in cases:
        x = torch.randn((n, w), generator=gen, device="cuda").to(bf16)
        bias = 0.1 * torch.randn((w,), generator=gen, device="cuda")

        def run():
            return fo.fused_bias_gelu_with_sum(x, bias, approximate=approx,
                                               out_dtype=bf16)

        got_out, got_s = run()
        torch.cuda.synchronize()
        ref_out, ref_s = fo._gelu_fwd_math(x, bias, approx)
        err = check(f"gelu out, {label}", got_out, ref_out.to(bf16),
                    TOL_BF16, checks)
        check(f"gelu sum, {label}", got_s, ref_s.to(bf16), TOL_BF16, checks)
        if n == 4096 and approx:
            # read x, write out and sum (bf16), the bias row once; fp32
            # arithmetic of the tanh form: 10 operations and a tanh
            # (counted as one) per element
            nbytes = n * w * (2 + 2 + 2) + w * 4
            bound_ms, bound_by = bound(11 * n * w, peaks["fp32"], nbytes,
                                       peaks)
            out = dict(
                max_abs_err=err, ms=time_ms(run),
                plain_ms=time_ms(lambda: fo._gelu_fwd_math(x, bias, approx)),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, shape=label)
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
    profile = profile_decode(engine) if device == "cuda" else None
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


def profile_decode(engine, steps=8):
    """torch.profiler over `steps` decode steps (4 slots, the full
    stack): device busy time per step from the CUDA kernel records,
    the host wall time per step, the device's idle share, and the
    kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode_block(steps)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or busy_us <= 0:
        return {"device_time": "not measured (no CUDA kernel records)",
                "wall_ms_per_step": wall_s * 1e3 / steps}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_s * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": e.self_device_time_total / 1e3
                         / steps,
                         "launches_per_step": e.count / steps}
                        for e in top]}


def reset_counts():
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    fa.reset_launch_count()
    fo.reset_launch_counts()


def read_counts():
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    return {"flash_attention_fwd": fa.flash_attention_with_lse.launches,
            "fused_bias_residual_layernorm_fwd":
                fo.fused_bias_residual_layernorm.launches,
            "fused_bias_gelu_fwd": fo.fused_bias_gelu.launches}


KERNELS = (
    ("flash_attention_fwd",
     "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:262", kernel_flash),
    ("fused_bias_residual_layernorm_fwd",
     "deepspeed_tpu_torch/ops/csrc/fused_ln_fwd.cu",
     "deepspeed_tpu/ops/transformer/fused_ops.py:246", kernel_ln),
    ("fused_bias_gelu_fwd",
     "deepspeed_tpu_torch/ops/csrc/fused_gelu_fwd.cu",
     "deepspeed_tpu/ops/transformer/fused_ops.py:282", kernel_gelu),
)


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
    emit({"phase": "build", "seconds": build_s,
          "dir": os.path.relpath(_build.BUILD_DIR, ROOT), "ptxas": ptxas})

    # 3: kernels vs plain twins
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    results = {}
    for kname, _, _, fn in KERNELS:
        res, checks = fn(peaks, gen)
        results[kname] = res
        emit({"phase": "kernel", "name": kname, "checks": checks,
              **res, "card": card})

    # 4-6: the main path, with launch counts zeroed right before it
    serve_and_check(args.seed, card)
    counts = read_counts()
    emit({"phase": "launch_counts", **counts})
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    rows = []
    for kname, src, replaces, _ in KERNELS:
        r = results[kname]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[kname],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
