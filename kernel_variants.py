#!/usr/bin/env python3
"""Where the dense attention kernels' time goes, on one NVIDIA GPU.

    python3 kernel_variants.py forward     # K1-fwd with parts switched off
    python3 kernel_variants.py backward    # K2's sweeps and delta pre-pass
    python3 kernel_variants.py order       # the grid order's L2 budget

Each variant is a copy of deepspeed_tpu_torch/ops/csrc/ with a few text
substitutions (a product, the softmax or a whole sweep switched off, or
a constant changed), built with the same nvcc flags as ops/_build.py
into build/kernel_variants/ (git-ignored), all variants in parallel. The
script times each one's library, through the port's own wrapper, at the
main path's bf16 shapes with CUDA events (mean of 20 calls after 3), and
torch's scaled_dot_product_attention beside them as the yardstick. A
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
NO_MASK = (H, "      if (walk.partial(q0, 64, k0, kN))\n        hide(s,",
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
    "order": (None, {
        f"{lib}_{name}": (lib, [budget(v)] if v else [])
        for lib in ("flash_attention_fwd", "flash_attention_bwd")
        for name, v in (("32MB", None), ("8MB", "8ll << 20"),
                        ("tile_major", "1ll << 50"), ("head_major", "1"))}),
}
SHAPES = (((11, 1024, 25, 64), True), ((11, 1024, 25, 64), False),
          ((1, 8192, 4, 64), True), ((4, 1024, 16, 128), True))


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
    cases, sdpa = [], {}
    for shape, causal in SHAPES:
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
            else:
                ms = cs.time_ms(lambda: fa._flash_bwd_launch(
                    q, k, v, out, lse, dout, None, sm, causal))
            rows[f"{list(shape)} causal={causal}"] = ms
        _build.function = original
        print(json.dumps({"variant": n, "library": lib, "ms": rows}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
