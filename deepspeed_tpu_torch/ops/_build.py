"""Build the port's CUDA kernels at first use and load them with ctypes.

The counterpart of the JAX package's `op_builder/` convention (native
code compiled on first use, cached by content): each source under
`ops/csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, and loaded with `ctypes`.
No source includes PyTorch's headers: a file that does takes minutes
to compile, while these take seconds, and the build counts against
the time of every fresh run on the card. The first call builds every
source at once, one `nvcc` per source, all started together.

Libraries land in `build/torch_kernels/` at the repository root (git
ignores `build/`), named by a hash of the source, the shared headers
(`ops/csrc/*.cuh`) and the flags, so an edited source or header
rebuilds and an unchanged one loads from the cache.

Each C entry point returns `cudaGetLastError()` after its launch;
`check()` turns a non-zero code into a RuntimeError, so a launch the
card refused (too many threads, too much shared memory) raises at the
call instead of passing silently.

No fast-math flag: the kernels use the accurate `tanhf`/`erff`/`exp2f`
so they hold the plain twins to float roundoff.

Host C++ (`host_library`): ZeRO-Offload's CPU-Adam is the repository's
`csrc/adam/cpu_adam.cpp`, compiled by `g++` with the flags the JAX
package's `op_builder/builder.py` uses (`-O3 -std=c++17 -shared -fPIC
-fopenmp`, and `-march=native` on x86_64), so both packages run the same
machine code on one host. The library lands in `build/torch_kernels/`
too, named by a hash of the source, the flags and the host CPU's
feature flags (a `-march=native` library is the host's own). A failed
compile raises with g++'s output.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
# the host C++ sources, by library name
HOST_SOURCES = {"cpu_adam": os.path.join(REPO_ROOT, "csrc", "adam",
                                         "cpu_adam.cpp")}

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the kernel sources, by library name
SOURCES = ("flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_fused", "fused_ln_fwd",
           "fused_ln_bwd", "fused_gelu_fwd", "fused_gelu_bwd",
           "moe_dispatch", "quantized_matmul", "block_sparse_attention")

_lock = threading.Lock()
_libs = {}
_fns = {}
# seconds each source's nvcc took in the last build that compiled it
compile_seconds = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME unset and no nvcc on PATH): the "
            "port's CUDA kernels are compiled at first use on the card's "
            "machine")
    return found


def _lib_path(name):
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    # the source and every shared header under csrc/ (a source may
    # include any of them)
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all():
    """Compile every missing library in parallel; returns {name: path}.
    A failed compile raises with nvcc's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, procs = {}, {}
    start = time.perf_counter()
    for name in SOURCES:
        src, out = _lib_path(name)
        paths[name] = out
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            log = open(out + ".log", "w")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    waiting = dict(procs)
    while waiting:
        for name in [n for n, p in waiting.items() if p[0].poll() is not None]:
            compile_seconds[name] = time.perf_counter() - start
            del waiting[name]
        time.sleep(0.05)
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        msgs = []
        for name in failed:
            with open(paths[name] + ".log") as f:
                msgs.append(f"--- {name} ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n" +
                           "\n".join(msgs))
    return paths


def build_log(name):
    """nvcc's output (ptxas register/shared-memory report) for `name`."""
    _, out = _lib_path(name)
    try:
        with open(out + ".log") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def library(name):
    """The loaded ctypes library `name`, building all sources on first
    use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                _libs[n] = ctypes.CDLL(p)
            lib = _libs[name]
        return lib


def function(lib_name, fn_name, argtypes):
    """The C entry point `fn_name` of library `lib_name`, with its
    argument types declared once (restype: the int CUDA error code)."""
    key = (lib_name, fn_name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[key] = fn
    return fn


def check(err, what):
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(tensor):
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch
    return ctypes.c_void_p(
        torch.cuda.current_stream(tensor.device).cuda_stream)


def host_cxx_flags():
    """g++'s flags for the host libraries (op_builder/builder.py's)."""
    flags = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp"]
    if os.uname().machine in ("x86_64", "amd64"):
        flags.append("-march=native")
    return flags


def _host_lib_path(name):
    src = HOST_SOURCES[name]
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(host_cxx_flags()).encode())
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
        h.update(flags.encode())
    except OSError:
        import platform
        h.update(platform.processor().encode())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def host_library(name):
    """The loaded ctypes library of the host source `name` (a key of
    HOST_SOURCES), compiled by g++ on first use. Raises when g++ is
    missing or fails."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src, out = _host_lib_path(name)
        if not os.path.exists(out):
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"{name}: no g++ on PATH to compile {src}")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            start = time.perf_counter()
            run = subprocess.run([gxx, *host_cxx_flags(), src, "-o", tmp],
                                 capture_output=True, text=True)
            if run.returncode != 0:
                raise RuntimeError(f"g++ failed for {name}:\n"
                                   f"{(run.stdout + run.stderr)[-4000:]}")
            os.replace(tmp, out)
            compile_seconds[name] = time.perf_counter() - start
        lib = _libs[name] = ctypes.CDLL(out)
        return lib
