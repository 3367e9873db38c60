"""Fused non-attention epilogues, forward half: bias + residual +
LayerNorm (kernel K3-fwd) and bias + GeLU (kernel K4-fwd).

Port of deepspeed_tpu/ops/transformer/fused_ops.py. The Pallas forward
kernels `_ln_fwd_kernel` / `_gelu_fwd_kernel` become the hand-written
CUDA kernels in `ops/csrc/fused_ln_fwd.cu` / `fused_gelu_fwd.cu`; the
shared math (`_ln_stats`, `_ln_fwd_math`, `_gelu_fwd_math`) stays here
as their plain PyTorch twins. The backward halves (K3-bwd, K4-bwd) and
the autograd wiring come with the training slice; this slice runs
inference only.

Dispatch: a wrapper takes the plain twin for tensors on the CPU and
launches the kernel for tensors on CUDA. There is no fallback from a
CUDA tensor to the twin. Each wrapper counts its kernel launches in a
plain integer (`fused_bias_residual_layernorm.launches`,
`fused_bias_gelu.launches`), so a run can show that its main path went
through the kernels.
"""

import ctypes

import torch

_SQRT_2 = 1.4142135623730951
_SQRT_2_OVER_PI = 0.7978845608028654   # sqrt(2/pi), the tanh-gelu const
_GELU_C = 0.044715

# dtype codes and argument types of the kernels' C interfaces
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_GELU_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
    [ctypes.c_void_p]


def resolve_fused_ops(mode, dropout_inactive=True, device=None):
    """`fused_ops` config value -> bool. "auto" enables the fused path
    on CUDA (where the kernels run) when dropout does not sit inside the
    chain: the JAX package's backend-keyed "auto" (fused on the
    accelerator, plain elsewhere), so CPU numerics stay on the unfused
    path by default. "on" forces it on any device (the plain twins on
    the CPU) and refuses dropout loudly; "off" disables."""
    if mode in ("off", False, 0, None):
        return False
    if mode in ("on", True, 1):
        if not dropout_inactive:
            raise ValueError(
                "fused_ops='on' requires inactive dropout (deterministic "
                "or rate 0): dropout sits between the bias add and the "
                "residual, which the fused chain cannot express; use "
                "'auto' to fall back automatically")
        return True
    if mode == "auto":
        dev = torch.device(device) if device is not None else None
        return bool(dropout_inactive) and dev is not None and \
            dev.type == "cuda"
    raise ValueError(
        f"fused_ops={mode!r}: expected 'auto', 'on' or 'off'")


# ----------------------------------------------------------------------
# plain twins (the kernels compute the same formulas)
# ----------------------------------------------------------------------
def _ln_stats(s):
    """fp32 row mean / variance over the last axis with flax
    LayerNorm's fast-variance formula (E[x^2] - E[x]^2, clamped)."""
    mu = s.mean(dim=-1, keepdim=True)
    mu2 = (s * s).mean(dim=-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    return mu, var


def _ln_fwd_math(y, bias, residual, gamma, beta, eps):
    """fp32 chain: s = (y + bias) + residual; out = LN(s)*gamma+beta."""
    f32 = torch.float32
    s = (y.to(f32) + bias.to(f32)) + residual.to(f32)
    mu, var = _ln_stats(s)
    rstd = torch.rsqrt(var + eps)
    out = (s - mu) * rstd * gamma.to(f32) + beta.to(f32)
    return out, s


def _gelu_fwd_math(x, bias, approximate):
    """fp32 s = x + bias; out = gelu(s), erf exact or tanh approximate,
    with jax.nn.gelu's association (s * cdf)."""
    s = x.to(torch.float32) + bias.to(torch.float32)
    if approximate:
        cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI *
                                      (s + _GELU_C * (s * s * s))))
        out = s * cdf
    else:
        out = s * (torch.erf(s / _SQRT_2) + 1.0) / 2.0
    return out, s


# ----------------------------------------------------------------------
# kernel launchers
# ----------------------------------------------------------------------
def _check_rows(name, t, width):
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    if t.shape[-1] != width:
        raise ValueError(f"{name}: last dim {t.shape[-1]} != {width}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _vector(t, width, device):
    """[H] parameter vector as the kernels take it: fp32, contiguous,
    on the rows' device."""
    if t.shape != (width,):
        raise ValueError(f"vector shape {tuple(t.shape)} != ({width},)")
    if t.device != device:
        raise ValueError(f"vector on {t.device}, rows on {device}")
    return t.to(torch.float32).contiguous()


def _ln_fwd_launch(y, bias, residual, gamma, beta, eps, out_dtype,
                   sum_dtype, return_sum):
    from deepspeed_tpu_torch.ops import _build
    h = y.shape[-1]
    if residual.shape != y.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != "
                         f"y shape {tuple(y.shape)}")
    if residual.device != y.device:
        raise ValueError("y and residual must be on one device")
    _check_rows("y", y, h)
    _check_rows("residual", residual, h)
    for dt in (out_dtype, sum_dtype):
        if dt not in _DTYPE_CODE:
            raise TypeError(f"output dtype {dt} not supported")
    bias, gamma, beta = (_vector(v, h, y.device)
                         for v in (bias, gamma, beta))
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    s = torch.empty(y.shape, dtype=sum_dtype, device=y.device) \
        if return_sum else None
    n = y.numel() // h if h else 0
    fn = _build.function("fused_ln_fwd", "ds_fused_ln_fwd", _LN_ARGTYPES)
    err = fn(y.data_ptr(), bias.data_ptr(), residual.data_ptr(),
             gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
             s.data_ptr() if s is not None else None, n, h,
             _DTYPE_CODE[y.dtype], _DTYPE_CODE[residual.dtype],
             _DTYPE_CODE[out_dtype], _DTYPE_CODE[sum_dtype], float(eps),
             y.device.index or 0, _build.stream_ptr(y))
    _build.check(err, "fused_bias_residual_layernorm kernel")
    fused_bias_residual_layernorm.launches += 1
    return out, s


def _gelu_fwd_launch(x, bias, approximate, out_dtype, sum_dtype):
    from deepspeed_tpu_torch.ops import _build
    w = x.shape[-1]
    _check_rows("x", x, w)
    for dt in (out_dtype, sum_dtype):
        if dt not in _DTYPE_CODE:
            raise TypeError(f"output dtype {dt} not supported")
    bias = _vector(bias, w, x.device)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    s = torch.empty(x.shape, dtype=sum_dtype, device=x.device)
    n = x.numel() // w if w else 0
    fn = _build.function("fused_gelu_fwd", "ds_fused_gelu_fwd",
                         _GELU_ARGTYPES)
    err = fn(x.data_ptr(), bias.data_ptr(), out.data_ptr(), s.data_ptr(),
             n, w, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
             _DTYPE_CODE[sum_dtype], int(bool(approximate)),
             x.device.index or 0, _build.stream_ptr(x))
    _build.check(err, "fused_bias_gelu kernel")
    fused_bias_gelu.launches += 1
    return out, s


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------
def fused_bias_residual_layernorm(y, bias, residual, gamma, beta, *,
                                  eps=1e-5, out_dtype=None,
                                  sum_dtype=None, return_sum=True):
    """out, resid_sum = LN((y + bias) + residual) * gamma + beta.

    `y` is a bias-less matmul output [..., H]; `bias`/`gamma`/`beta`
    are [H]; `residual` is the incoming stream [..., H]. The chain runs
    in fp32 and writes `out` (out_dtype, default y.dtype: it feeds the
    next matmul) and `resid_sum` (sum_dtype, default residual.dtype:
    the pre-LN residual stream). return_sum=False (the ln_f form)
    returns `out` alone and never writes the sum.

    CUDA tensors launch kernel K3-fwd; CPU tensors take the plain twin.
    """
    out_dtype = out_dtype if out_dtype is not None else y.dtype
    sum_dtype = sum_dtype if sum_dtype is not None else residual.dtype
    if y.is_cuda:
        out, s = _ln_fwd_launch(y, bias, residual, gamma, beta, eps,
                                out_dtype, sum_dtype, return_sum)
    else:
        out_f, s_f = _ln_fwd_math(y, bias, residual, gamma, beta,
                                  float(eps))
        out = out_f.to(out_dtype)
        s = s_f.to(sum_dtype) if return_sum else None
    return (out, s) if return_sum else out


fused_bias_residual_layernorm.launches = 0


def fused_bias_gelu(x, bias, *, approximate=False, out_dtype=None):
    """gelu(x + bias) as one launch; exact-erf by default, and
    `approximate=True` for the tanh form GPT-2 uses. Returns the output
    (out_dtype, default x.dtype); the kernel also writes the bias+input
    sum in x.dtype, the backward's only residual, which
    `fused_bias_gelu_with_sum` returns.

    CUDA tensors launch kernel K4-fwd; CPU tensors take the plain twin.
    """
    return fused_bias_gelu_with_sum(x, bias, approximate=approximate,
                                    out_dtype=out_dtype)[0]


def fused_bias_gelu_with_sum(x, bias, *, approximate=False,
                             out_dtype=None):
    """(gelu(x + bias), x + bias): both outputs of the forward."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if x.is_cuda:
        return _gelu_fwd_launch(x, bias, bool(approximate), out_dtype,
                                x.dtype)
    out_f, s_f = _gelu_fwd_math(x, bias, bool(approximate))
    return out_f.to(out_dtype), s_f.to(x.dtype)


fused_bias_gelu.launches = 0


def reset_launch_counts():
    """Zero both launch counters."""
    fused_bias_residual_layernorm.launches = 0
    fused_bias_gelu.launches = 0
