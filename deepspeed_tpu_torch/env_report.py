"""`ds_report` for the port — the environment and kernel-build report
(port of deepspeed_tpu/env_report.py: the same three sections).

  * `op_report`: every hand-written kernel source of `ops/_build.py`
    (`ops/csrc/*.cu`, each built by `nvcc` for `sm_90a` into its own
    library at first use), whether its library is in the build cache
    (`build/torch_kernels/`, named by the source's hash) and where,
    `nvcc` and its version, and the host CPU-Adam library built by
    `g++` from `csrc/adam/cpu_adam.cpp`;
  * `feature_report`: the port's runtime features;
  * `debug_report`: torch, CUDA, the card's name, capability and power
    limit (`nvidia-smi`), or that there is no card.

Run as `python -m deepspeed_tpu_torch.env_report`. It builds nothing and
never launches a kernel: a source whose library is not cached is
reported as not built (the first kernel call, or `_build.build_all()`,
builds it).
"""

import os
import shutil
import subprocess

GREEN = "\033[92m"
RED = "\033[91m"
YELLOW = "\033[93m"
END = "\033[0m"
SUCCESS = f"{GREEN}[OKAY]{END}"
WARNING = f"{YELLOW}[WARNING]{END}"
FAIL = f"{RED}[FAIL]{END}"


def nvcc_version():
    """(path, version line) of the nvcc the kernels build with, or
    (None, reason)."""
    from deepspeed_tpu_torch.ops import _build
    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        return None, str(e)
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return nvcc, f"unreadable ({e})"
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return nvcc, (lines[-1].strip() if lines else out.strip())


def kernel_builds():
    """One row per kernel source: {name, source, built, library}. A
    library is built when its hash-named file is in the build cache."""
    from deepspeed_tpu_torch.ops import _build
    rows = []
    for name in _build.SOURCES:
        src, lib = _build._lib_path(name)
        rows.append({"name": name,
                     "source": os.path.relpath(src, _build.REPO_ROOT),
                     "built": os.path.exists(lib),
                     "library": os.path.relpath(lib, _build.REPO_ROOT)})
    return rows


def host_builds():
    """The host C++ libraries (CPU-Adam), as `kernel_builds` rows."""
    from deepspeed_tpu_torch.ops import _build
    rows = []
    for name in _build.HOST_SOURCES:
        src, lib = _build._host_lib_path(name)
        rows.append({"name": name,
                     "source": os.path.relpath(src, _build.REPO_ROOT),
                     "built": os.path.exists(lib),
                     "library": os.path.relpath(lib, _build.REPO_ROOT)})
    return rows


def card():
    """(name, power limit) of the first card from nvidia-smi, or None
    when there is no card."""
    import torch
    if not torch.cuda.is_available():
        return None
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return torch.cuda.get_device_name(0), "unknown (no nvidia-smi)"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return torch.cuda.get_device_name(0), f"unreadable ({e})"
    if not out:
        return torch.cuda.get_device_name(0), "unreadable"
    name, _, limit = out[0].partition(",")
    return name.strip(), limit.strip()


def op_report():
    from deepspeed_tpu_torch.ops import _build
    import torch
    max_dots = 26
    print("-" * 64)
    print("DeepSpeed-TPU (PyTorch/CUDA port) kernel report")
    print("-" * 64)
    print("CUDA kernels compile with nvcc for sm_90a on first use into "
          f"{os.path.relpath(_build.BUILD_DIR, _build.REPO_ROOT)}/, "
          "cached by source hash")
    flags = " ".join(_build.NVCC_FLAGS)
    print(f"nvcc flags: {flags}")
    path, version = nvcc_version()
    print(f"nvcc {'.' * 22} {path or FAIL} {version}")
    sm90 = "sm_90a" in flags
    if torch.cuda.is_available():
        cap = torch.cuda.get_device_capability(0)
        compatible = sm90 and cap == (9, 0)
        print(f"target {'.' * 20} sm_90a; the card is sm_{cap[0]}{cap[1]} "
              f"{SUCCESS if compatible else FAIL}")
    else:
        compatible = False
        print(f"target {'.' * 20} sm_90a; no card (torch.cuda."
              f"is_available() is False) {WARNING}")
    print("-" * 64)
    print("op name", "." * (max_dots - 7), "installed", "..", "compatible")
    print("-" * 64)
    for row in kernel_builds():
        installed = SUCCESS if row["built"] else "[NO]"
        print(row["name"], "." * max(1, max_dots - len(row["name"])),
              installed, "..", SUCCESS if compatible else FAIL,
              f"{row['source']} -> {row['library']}")
    print("-" * 64)
    print("host libraries (g++ " + " ".join(_build.host_cxx_flags()) + "):")
    gxx = shutil.which("g++")
    for row in host_builds():
        installed = SUCCESS if row["built"] else "[NO]"
        print(row["name"], "." * max(1, max_dots - len(row["name"])),
              installed, "..", SUCCESS if gxx else FAIL,
              f"{row['source']} -> {row['library']}")
    print("-" * 64)


def debug_report():
    import torch
    report = [("torch version", torch.__version__),
              ("torch cuda version", torch.version.cuda)]
    got = card()
    if got is None:
        report.append(("device", "no card: torch.cuda.is_available() is "
                                 "False (the CPU runs the kernels' "
                                 "plain twins)"))
    else:
        name, limit = got
        cap = torch.cuda.get_device_capability(0)
        gib = torch.cuda.get_device_properties(0).total_memory / 1024 ** 3
        report += [("device count", torch.cuda.device_count()),
                   ("device name", name),
                   ("device capability", f"sm_{cap[0]}{cap[1]}"),
                   ("power limit", limit),
                   ("device memory", f"{gib:.2f} GiB")]
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.version import __version__
    report.append(("deepspeed_tpu_torch version",
                   f"{deepspeed_tpu_torch.__version__} (DeepSpeed "
                   f"{__version__})"))
    report.append(("deepspeed_tpu_torch install path",
                   os.path.dirname(deepspeed_tpu_torch.__file__)))
    print("DeepSpeed-TPU (PyTorch/CUDA port) general environment info:")
    for name, value in report:
        print(f"{name} {'.' * max(1, 34 - len(name))} {value}")


def feature_report():
    """The port's runtime features, each probed by importing it."""
    probes = (
        ("monitor", "deepspeed_tpu_torch.monitor", "Monitor",
         "metrics, sinks, spans, watchdog, flight, numerics, ledger "
         "(monitor block)"),
        ("flops profiler", "deepspeed_tpu_torch.profiling.flops_profiler",
         "FlopsProfiler", "aten ops and the kernels' own counts "
         "(flops_profiler block)"),
        ("kernel autotuner", "deepspeed_tpu_torch.ops.autotune", "search",
         "launch plans of K3/K4 (autotune block)"),
        ("elastic runtime", "deepspeed_tpu_torch.elasticity.runtime",
         "ElasticSupervisor", "recover in place at world size 1 "
         "(elasticity.runtime)"),
        ("inference engine", "deepspeed_tpu_torch.inference",
         "InferenceEngine", "paged KV, speculative, int8 weights"),
        ("mixture of experts", "deepspeed_tpu_torch.moe", "MoEMLP",
         "K8 dispatch/combine (moe block)"),
        ("sparse attention", "deepspeed_tpu_torch.ops.sparse_attention",
         "SparseSelfAttention", "K7 (sparse_attention block)"),
        ("ZeRO-Offload", "deepspeed_tpu_torch.ops.adam.cpu_adam",
         "DeepSpeedCPUAdam", "host CPU-Adam (zero_optimization."
         "cpu_offload)"),
        ("comm/compute overlap", "deepspeed_tpu_torch.ops.overlap",
         "SITES", "overlap block"),
    )
    import importlib
    print("-" * 64)
    print("runtime feature report")
    print("-" * 64)
    for label, module, attr, what in probes:
        try:
            getattr(importlib.import_module(module), attr)
            value = f"{SUCCESS} {what}"
        except Exception as e:  # the failure text is the report row
            value = f"{FAIL} {e}"
        print(f"{label} {'.' * max(1, 28 - len(label))} {value}")
    from deepspeed_tpu_torch.ops import autotune
    print(f"autotune table {'.' * 13} {autotune.table_path()}")
    print("-" * 64)


def main():
    op_report()
    feature_report()
    debug_report()


cli_main = main

if __name__ == "__main__":
    main()
