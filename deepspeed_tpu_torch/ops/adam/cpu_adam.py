"""DeepSpeedCPUAdam: host-side AdamW over flat fp32 buffers (port of
deepspeed_tpu/ops/adam/cpu_adam.py).

The optimizer half of ZeRO-Offload: the fp32 master parameters and both
moments live in host RAM, and each step consumes the device's gradients
and produces the updated parameters, optionally cast to bf16 in the same
pass (round to nearest even, as `csrc/adam/cpu_adam.cpp` rounds).

The step is the repository's native library, `csrc/adam/cpu_adam.cpp`,
which the port compiles itself (`ops/_build.py` `host_library`: g++
with the JAX package's flags, so both packages run the same machine
code) and calls through ctypes. ctypes releases the GIL for the length
of each call, so a caller's other threads, and the CUDA copies it has
queued, go on while a chunk steps. Buffers are numpy arrays or CPU torch
tensors (pinned or not), C-contiguous, updated in place.

There is no silent fallback: a failed compile or load raises. The plain
twin (torch ops, the math of the JAX package's numpy fallback) runs only
when the caller asks for it, with `use_native=False`, or when
DS_BUILD_CPU_ADAM=0 (the JAX package's switch), which a warning names.
"""

import ctypes
import itertools
import os

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

_id_counter = itertools.count()
BUILD_VAR = "DS_BUILD_CPU_ADAM"

_F32P = ctypes.POINTER(ctypes.c_float)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_declared = []


def _declare(lib):
    """ctypes signatures of the C entry points (op_builder/cpu_adam.py's
    declarations)."""
    i, i64, f = ctypes.c_int, ctypes.c_int64, ctypes.c_float
    sigs = {
        "ds_adam_create": ([i, f, f, f, f, f, i], i),
        "ds_adam_destroy": ([i], i),
        "ds_adam_step": ([i, i64, _F32P, _F32P, _F32P, _F32P, f], i64),
        "ds_adam_step_copy_bf16": (
            [i, i64, _F32P, _F32P, _F32P, _F32P, _U16P, f], i64),
        "ds_adam_step_chunk": (
            [i, i64, i64, _F32P, _F32P, _F32P, _F32P, _U16P, f], i64),
        "ds_adam_step_chunk_q8": (
            [i, i64, i64, _F32P, _I8P, _F32P, i64, _F32P, _F32P, _U16P, f],
            i64),
        "ds_adam_step_chunk_q1": (
            [i, i64, i64, _F32P, _U8P, _F32P, i64, _F32P, _F32P, _U16P, f],
            i64),
        "ds_adam_get_step": ([i], i),
        "ds_adam_set_step": ([i, i64], i),
        "ds_num_threads": ([], i),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res


def native_disabled():
    """True when DS_BUILD_CPU_ADAM turns the native library off."""
    return os.environ.get(BUILD_VAR, "1") in ("0", "false", "False")


def load_native():
    """The native CPU-Adam library (built on first use). Raises when the
    build or the load fails."""
    from deepspeed_tpu_torch.ops import _build
    lib = _build.host_library("cpu_adam")
    if lib not in _declared:
        _declare(lib)
        _declared.append(lib)
    return lib


def ds_num_threads():
    """OpenMP threads the native step runs on."""
    return int(load_native().ds_num_threads())


def _ptr(x, ctype):
    """ctypes pointer to a C-contiguous numpy array or CPU tensor."""
    if isinstance(x, torch.Tensor):
        assert x.device.type == "cpu" and x.is_contiguous(), \
            "CPU-Adam buffers must be contiguous CPU tensors"
        return ctypes.cast(x.data_ptr(), ctype)
    assert x.flags["C_CONTIGUOUS"], "CPU-Adam buffers must be C-contiguous"
    return x.ctypes.data_as(ctype)


def _opt_ptr(x, ctype):
    return ctypes.cast(None, ctype) if x is None else _ptr(x, ctype)


def _torch(x):
    """A tensor sharing `x`'s memory."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(x)


def _dtype_of(x):
    return x.dtype if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.empty(0, x.dtype)).dtype


def _size(x):
    return x.numel() if isinstance(x, torch.Tensor) else x.size


class DeepSpeedCPUAdam:
    """Flat-buffer host AdamW (the API of the JAX package's class)."""

    def __init__(self, num_elements, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adamw_mode=True, use_native=True):
        self.opt_id = next(_id_counter)
        self.num_elements = int(num_elements)
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0
        self.exp_avg = np.zeros(self.num_elements, np.float32)
        self.exp_avg_sq = np.zeros(self.num_elements, np.float32)
        self._lib = None
        if use_native and native_disabled():
            logger.warning(f"{BUILD_VAR}=0: DeepSpeedCPUAdam runs its plain "
                           "torch twin, not the native csrc/adam library")
        elif use_native:
            self._lib = load_native()
            self._lib.ds_adam_create(
                self.opt_id, float(lr), float(betas[0]), float(betas[1]),
                float(eps), float(weight_decay), int(adamw_mode))

    @property
    def native(self):
        return self._lib is not None

    def _check(self, params, grads, n, grad_dtype):
        assert _dtype_of(params) == torch.float32
        assert _dtype_of(grads) == grad_dtype
        assert _size(params) == n

    def step(self, params, grads, lr=None, params_bf16_out=None):
        """In-place AdamW over the whole flat fp32 `params` given fp32
        `grads`; `params_bf16_out` (uint16 storage of bf16) also receives
        the downcast parameters in the same pass."""
        self._check(params, grads, self.num_elements, torch.float32)
        assert _size(grads) == self.num_elements
        lr_eff = -1.0 if lr is None else float(lr)
        if self._lib is not None:
            args = (self.opt_id, self.num_elements, _ptr(params, _F32P),
                    _ptr(grads, _F32P), _ptr(self.exp_avg, _F32P),
                    _ptr(self.exp_avg_sq, _F32P))
            if params_bf16_out is not None:
                step = self._lib.ds_adam_step_copy_bf16(
                    *args, _ptr(params_bf16_out, _U16P), lr_eff)
            else:
                step = self._lib.ds_adam_step(*args, lr_eff)
            self.step_count = int(step)
            return params
        self.step_count += 1
        return self.step_chunk(0, self.num_elements, params, grads, lr=lr,
                               params_bf16_out=params_bf16_out)

    def begin_step(self):
        """Open a chunked optimizer step: advance the bias-correction
        step once; the step_chunk calls that follow share it."""
        self.step_count += 1
        if self._lib is not None:
            self._lib.ds_adam_set_step(self.opt_id, self.step_count)

    def _begun(self, what):
        assert self.step_count >= 1, \
            f"{what} requires begin_step() first (step 0 would divide by " \
            "a zero bias correction)"

    def step_chunk(self, lo, hi, params, grads, lr=None,
                   params_bf16_out=None):
        """AdamW over elements [lo, hi) at the step begin_step opened.
        `params`/`grads` are the chunk's arrays (hi - lo elements); the
        moments are sliced here."""
        self._begun("step_chunk")
        self._check(params, grads, hi - lo, torch.float32)
        assert _size(grads) == hi - lo
        if self._lib is not None:
            self._lib.ds_adam_step_chunk(
                self.opt_id, self.step_count, hi - lo, _ptr(params, _F32P),
                _ptr(grads, _F32P), _ptr(self.exp_avg[lo:hi], _F32P),
                _ptr(self.exp_avg_sq[lo:hi], _F32P),
                _opt_ptr(params_bf16_out, _U16P),
                -1.0 if lr is None else float(lr))
            return params
        self._twin(lo, hi, _torch(params), _torch(grads), lr,
                   params_bf16_out)
        return params

    def step_chunk_q8(self, lo, hi, params, qgrads, scales, block,
                      lr=None, params_bf16_out=None):
        """step_chunk with int8 gradients and one fp32 scale per `block`
        elements (the compressed offload wire). The chunk starts on a
        block boundary; scales[i // block] covers chunk element i."""
        self._begun("step_chunk_q8")
        self._check(params, qgrads, hi - lo, torch.int8)
        assert _dtype_of(scales) == torch.float32
        assert _size(scales) * block >= hi - lo
        if self._lib is not None:
            self._lib.ds_adam_step_chunk_q8(
                self.opt_id, self.step_count, hi - lo, _ptr(params, _F32P),
                _ptr(qgrads, _I8P), _ptr(scales, _F32P), block,
                _ptr(self.exp_avg[lo:hi], _F32P),
                _ptr(self.exp_avg_sq[lo:hi], _F32P),
                _opt_ptr(params_bf16_out, _U16P),
                -1.0 if lr is None else float(lr))
            return params
        g = _torch(qgrads).to(torch.float32) * torch.repeat_interleave(
            _torch(scales), block)[:hi - lo]
        self._twin(lo, hi, _torch(params), g, lr, params_bf16_out)
        return params

    def step_chunk_q1(self, lo, hi, params, packed, scales, block,
                      lr=None, params_bf16_out=None):
        """step_chunk with 1-bit gradients: sign bits packed LSB first,
        8 to a byte (runtime/fp16/onebit_adam.py's `pack_signs`), one
        fp32 scale per `block` elements; g = +-scale."""
        self._begun("step_chunk_q1")
        n = hi - lo
        assert _dtype_of(params) == torch.float32 and _size(params) == n
        assert _dtype_of(packed) == torch.uint8
        assert _size(packed) >= -(-n // 8)
        assert _dtype_of(scales) == torch.float32
        assert _size(scales) * block >= n
        if self._lib is not None:
            self._lib.ds_adam_step_chunk_q1(
                self.opt_id, self.step_count, n, _ptr(params, _F32P),
                _ptr(packed, _U8P), _ptr(scales, _F32P), block,
                _ptr(self.exp_avg[lo:hi], _F32P),
                _ptr(self.exp_avg_sq[lo:hi], _F32P),
                _opt_ptr(params_bf16_out, _U16P),
                -1.0 if lr is None else float(lr))
            return params
        weights = 1 << torch.arange(8, dtype=torch.uint8)
        bits = (_torch(packed)[:, None] & weights) > 0
        g = torch.where(bits.reshape(-1)[:n], 1.0, -1.0) * \
            torch.repeat_interleave(_torch(scales), block)[:n]
        self._twin(lo, hi, _torch(params), g, lr, params_bf16_out)
        return params

    def _twin(self, lo, hi, p, g, lr, bf16_out):
        """The plain twin of the native chunk step in torch ops, in place
        on `p` and the moments. Its scalars are computed in fp32 as
        cpu_adam.cpp computes them (1 - beta1 in fp64 would differ from
        the library's 1.0f - beta1 by up to 5e-5 relative at
        beta2 = 0.999)."""
        f32 = np.float32
        lr_v = f32(self.lr if lr is None else lr)
        b1, b2 = f32(self.betas[0]), f32(self.betas[1])
        wd, eps = f32(self.weight_decay), f32(self.eps)
        m = torch.from_numpy(self.exp_avg[lo:hi])
        v = torch.from_numpy(self.exp_avg_sq[lo:hi])
        if not self.adamw_mode and wd:
            g = g + float(wd) * p
        m.mul_(float(b1)).add_(float(f32(1) - b1) * g)
        v.mul_(float(b2)).add_(float(f32(1) - b2) * g * g)
        step = f32(self.step_count)
        bias1 = f32(1) - f32(np.power(b1, step))
        bias2 = f32(1) - f32(np.power(b2, step))
        step_size = float(lr_v / bias1)
        inv_sqrt_bias2 = float(f32(1) / np.sqrt(bias2))
        update = step_size * (m / (torch.sqrt(v) * inv_sqrt_bias2 +
                                   float(eps)))
        if self.adamw_mode and wd:
            update = update + float(lr_v * wd) * p
        p.sub_(update)
        if bf16_out is not None:
            _torch(bf16_out).view(torch.bfloat16).copy_(p)

    def state_dict(self):
        return {"exp_avg": self.exp_avg, "exp_avg_sq": self.exp_avg_sq,
                "step": self.step_count}

    def load_state_dict(self, sd):
        self.exp_avg[:] = np.asarray(sd["exp_avg"])
        self.exp_avg_sq[:] = np.asarray(sd["exp_avg_sq"])
        self.step_count = int(np.asarray(sd["step"]))
        if self._lib is not None:
            self._lib.ds_adam_set_step(self.opt_id, self.step_count)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            try:
                lib.ds_adam_destroy(self.opt_id)
            except (AttributeError, TypeError):
                # interpreter teardown: ctypes may already be gone
                pass
