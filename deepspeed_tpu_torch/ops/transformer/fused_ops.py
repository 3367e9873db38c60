"""Fused non-attention epilogues: bias + residual + LayerNorm (kernels
K3-fwd, K3-bwd) and bias + GeLU (kernels K4-fwd, K4-bwd).

Port of deepspeed_tpu/ops/transformer/fused_ops.py. The Pallas kernels
`_ln_fwd_kernel` / `_ln_bwd_kernel` / `_gelu_fwd_kernel` /
`_gelu_bwd_kernel` become the hand-written CUDA kernels in
`ops/csrc/fused_{ln,gelu}_{fwd,bwd}.cu`; the shared math (`_ln_stats`,
`_ln_fwd_math`, `_ln_bwd_math`, `_gelu_fwd_math`, `_gelu_bwd_math`)
stays here as their plain PyTorch twins. Two `torch.autograd.Function`s
carry the JAX package's custom-VJP contracts (`_ln_apply`,
`_ln_apply_out`, `_gelu_apply`): the backward saves only the forward's
sum (and gamma), recomputes the row statistics, returns each cotangent
in its operand's dtype, and the ln_f form (`return_sum=False`) has no
sum cotangent at all.

Dispatch: a wrapper takes the plain twin for tensors on the CPU and
launches the kernel for tensors on CUDA. There is no fallback from a
CUDA tensor to the twin. Each wrapper counts its kernel launches in a
plain integer (`fused_bias_residual_layernorm.launches`,
`fused_bias_gelu.launches`, and `.launches` of the two `*_backward`
wrappers), so a run can show that its main path went through the
kernels.
"""

import ctypes

import torch

_SQRT_2 = 1.4142135623730951
_SQRT_2_OVER_PI = 0.7978845608028654   # sqrt(2/pi), the tanh-gelu const
_GELU_C = 0.044715
_INV_SQRT_2PI = 0.3989422804014327     # 1/sqrt(2*pi)

# dtype codes and argument types of the kernels' C interfaces
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_GELU_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
    [ctypes.c_void_p]
_LN_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_GELU_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
    [ctypes.c_void_p]
_GRID_ARGTYPES = [ctypes.c_int, ctypes.c_int]


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


def _ln_bwd_math(s, gamma, d_out, d_sum, eps):
    """One-pass LN backward off the saved sum `s` (mu/rstd recomputed
    with the forward's fast variance). Returns (ds, d_gamma_rows,
    d_beta_rows) in fp32, where ds is the shared cotangent of y, bias
    (row-summed by the caller) and residual."""
    s = s.to(torch.float32)
    d_out = d_out.to(torch.float32)
    mu, var = _ln_stats(s)
    rstd = torch.rsqrt(var + eps)
    xhat = (s - mu) * rstd
    dxhat = d_out * gamma.to(torch.float32)
    mean_dxhat = dxhat.mean(dim=-1, keepdim=True)
    mean_dxhat_x = (dxhat * xhat).mean(dim=-1, keepdim=True)
    ds = rstd * (dxhat - mean_dxhat - xhat * mean_dxhat_x)
    if d_sum is not None:
        ds = ds + d_sum.to(torch.float32)
    return ds, d_out * xhat, d_out


def _gelu_bwd_math(s, d_out, approximate):
    """fp32 d gelu(s)/ds * d_out off the saved sum, in the JAX
    package's association."""
    s = s.to(torch.float32)
    d_out = d_out.to(torch.float32)
    if approximate:
        inner = _SQRT_2_OVER_PI * (s + _GELU_C * s * s * s)
        t = torch.tanh(inner)
        dinner = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * s * s)
        grad = 0.5 * (1.0 + t) + 0.5 * s * (1.0 - t * t) * dinner
    else:
        grad = 0.5 * (1.0 + torch.erf(s / _SQRT_2)) + \
            s * torch.exp(-0.5 * s * s) * _INV_SQRT_2PI
    return d_out * grad


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


def _ln_bwd_launch(s2, gamma, dout2, dsum2, eps, dx_dtype):
    from deepspeed_tpu_torch.ops import _build
    n, h = s2.shape
    _check_rows("s", s2, h)
    _check_rows("dout", dout2, h)
    if dout2.shape != s2.shape:
        raise ValueError(f"dout shape {tuple(dout2.shape)} != s shape "
                         f"{tuple(s2.shape)}")
    if dsum2 is not None:
        _check_rows("dsum", dsum2, h)
        if dsum2.shape != s2.shape:
            raise ValueError(f"dsum shape {tuple(dsum2.shape)} != s shape "
                             f"{tuple(s2.shape)}")
    if dx_dtype not in _DTYPE_CODE:
        raise TypeError(f"dx dtype {dx_dtype} not supported")
    if 5 * h * 4 > 227 * 1024:
        raise ValueError(f"fused LN backward kernel: H={h} exceeds the "
                         "shared memory of one CTA")
    gamma = _vector(gamma, h, s2.device)
    dev = s2.device.index or 0
    grid = _build.function("fused_ln_bwd", "ds_partials_grid",
                           _GRID_ARGTYPES)(n, dev)
    dx = torch.empty((n, h), dtype=dx_dtype, device=s2.device)
    sums = torch.empty((3, h), dtype=torch.float32, device=s2.device)
    work = torch.empty((max(grid, 1), 3, h), dtype=torch.float32,
                       device=s2.device)
    fn = _build.function("fused_ln_bwd", "ds_fused_ln_bwd",
                         _LN_BWD_ARGTYPES)
    err = fn(s2.data_ptr(), gamma.data_ptr(), dout2.data_ptr(),
             dsum2.data_ptr() if dsum2 is not None else None,
             dx.data_ptr(), sums.data_ptr(), work.data_ptr(), n, h,
             _DTYPE_CODE[s2.dtype], _DTYPE_CODE[dout2.dtype],
             _DTYPE_CODE[dsum2.dtype] if dsum2 is not None else 0,
             _DTYPE_CODE[dx_dtype], float(eps), dev, _build.stream_ptr(s2))
    _build.check(err, "fused_bias_residual_layernorm backward kernel")
    fused_bias_residual_layernorm_backward.launches += 1
    return dx, sums[0], sums[1], sums[2]


def _gelu_bwd_launch(s2, dout2, approximate, dx_dtype):
    from deepspeed_tpu_torch.ops import _build
    n, w = s2.shape
    _check_rows("s", s2, w)
    _check_rows("dout", dout2, w)
    if dout2.shape != s2.shape:
        raise ValueError(f"dout shape {tuple(dout2.shape)} != s shape "
                         f"{tuple(s2.shape)}")
    if dx_dtype not in _DTYPE_CODE:
        raise TypeError(f"dx dtype {dx_dtype} not supported")
    if w * 4 > 227 * 1024:
        raise ValueError(f"fused GeLU backward kernel: W={w} exceeds the "
                         "shared memory of one CTA")
    dev = s2.device.index or 0
    grid = _build.function("fused_gelu_bwd", "ds_partials_grid",
                           _GRID_ARGTYPES)(n, dev)
    dx = torch.empty((n, w), dtype=dx_dtype, device=s2.device)
    dbias = torch.empty((w,), dtype=torch.float32, device=s2.device)
    work = torch.empty((max(grid, 1), w), dtype=torch.float32,
                       device=s2.device)
    fn = _build.function("fused_gelu_bwd", "ds_fused_gelu_bwd",
                         _GELU_BWD_ARGTYPES)
    err = fn(s2.data_ptr(), dout2.data_ptr(), dx.data_ptr(),
             dbias.data_ptr(), work.data_ptr(), n, w,
             _DTYPE_CODE[s2.dtype], _DTYPE_CODE[dout2.dtype],
             _DTYPE_CODE[dx_dtype], int(bool(approximate)), dev,
             _build.stream_ptr(s2))
    _build.check(err, "fused_bias_gelu backward kernel")
    fused_bias_gelu_backward.launches += 1
    return dx, dbias


# ----------------------------------------------------------------------
# forward and backward wrappers
# ----------------------------------------------------------------------
def _flat_rows(x):
    return x.reshape(-1, x.shape[-1])


def _ln_forward(y, bias, residual, gamma, beta, eps, out_dtype, sum_dtype,
                want_sum):
    if y.is_cuda:
        return _ln_fwd_launch(y, bias, residual, gamma, beta, eps,
                              out_dtype, sum_dtype, want_sum)
    out_f, s_f = _ln_fwd_math(y, bias, residual, gamma, beta, float(eps))
    return out_f.to(out_dtype), (s_f.to(sum_dtype) if want_sum else None)


def _gelu_forward(x, bias, approximate, out_dtype):
    if x.is_cuda:
        return _gelu_fwd_launch(x, bias, approximate, out_dtype, x.dtype)
    out_f, s_f = _gelu_fwd_math(x, bias, approximate)
    return out_f.to(out_dtype), s_f.to(x.dtype)


def fused_bias_residual_layernorm_backward(s, gamma, d_out, d_sum=None, *,
                                           eps=1e-5, dx_dtype=None):
    """Backward of the bias + residual + LayerNorm chain off the
    forward's saved sum `s` [..., H]: (dx [..., H] in dx_dtype, default
    s.dtype; dbias, dgamma, dbeta [H] fp32, summed over every row).
    `d_sum` is the sum output's own cotangent, None on the ln_f form.
    CUDA tensors launch kernel K3-bwd; CPU tensors take the plain twin."""
    dx_dtype = dx_dtype if dx_dtype is not None else s.dtype
    s2 = _flat_rows(s)
    dout2 = _flat_rows(d_out).contiguous()
    dsum2 = None if d_sum is None else _flat_rows(d_sum).contiguous()
    if s.is_cuda:
        dx2, dbias, dgamma, dbeta = _ln_bwd_launch(
            s2.contiguous(), gamma, dout2, dsum2, eps, dx_dtype)
    else:
        ds, dg_rows, dbeta_rows = _ln_bwd_math(s2, gamma, dout2, dsum2,
                                               float(eps))
        dx2 = ds.to(dx_dtype)
        dbias, dgamma, dbeta = (r.sum(dim=0)
                                for r in (ds, dg_rows, dbeta_rows))
    return dx2.reshape(s.shape), dbias, dgamma, dbeta


fused_bias_residual_layernorm_backward.launches = 0


def fused_bias_gelu_backward(s, d_out, *, approximate=False, dx_dtype=None):
    """Backward of gelu(x + bias) off the forward's saved sum `s`
    [..., W]: (dx [..., W] in dx_dtype, default s.dtype; dbias [W] fp32,
    the sum of dx over every row). CUDA tensors launch kernel K4-bwd;
    CPU tensors take the plain twin."""
    dx_dtype = dx_dtype if dx_dtype is not None else s.dtype
    s2 = _flat_rows(s)
    dout2 = _flat_rows(d_out).contiguous()
    if s.is_cuda:
        dx2, dbias = _gelu_bwd_launch(s2.contiguous(), dout2,
                                      bool(approximate), dx_dtype)
    else:
        d = _gelu_bwd_math(s2, dout2, bool(approximate))
        dx2, dbias = d.to(dx_dtype), d.sum(dim=0)
    return dx2.reshape(s.shape), dbias


fused_bias_gelu_backward.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """The JAX package's `_ln_apply` (return_sum=True: outputs out and
    the sum) and `_ln_apply_out` (return_sum=False, the ln_f form: out
    alone, so no sum cotangent exists). Saves the sum and gamma only."""

    @staticmethod
    def forward(ctx, y, bias, residual, gamma, beta, eps, out_dtype,
                sum_dtype, return_sum):
        out, s = _ln_forward(y, bias, residual, gamma, beta, eps,
                             out_dtype, sum_dtype, True)
        ctx.save_for_backward(s, gamma)
        ctx.eps, ctx.return_sum = eps, return_sum
        ctx.dtypes = (y.dtype, bias.dtype, residual.dtype, gamma.dtype,
                      beta.dtype)
        ctx.set_materialize_grads(False)
        if return_sum:
            return out, s
        return out

    @staticmethod
    def backward(ctx, d_out, d_sum=None):
        s, gamma = ctx.saved_tensors
        y_dt, bias_dt, res_dt, gamma_dt, beta_dt = ctx.dtypes
        if d_out is None:
            d_out = torch.zeros(s.shape, dtype=torch.float32,
                                device=s.device)
        dx, dbias, dgamma, dbeta = fused_bias_residual_layernorm_backward(
            s, gamma, d_out, d_sum, eps=ctx.eps, dx_dtype=y_dt)
        # y, bias (row-summed) and residual share the chain cotangent;
        # the residual's goes through the sum's dtype, as in the JAX VJP
        d_res = dx.to(s.dtype).to(res_dt)
        return (dx, dbias.to(bias_dt), d_res, dgamma.to(gamma_dt),
                dbeta.to(beta_dt), None, None, None, None)


class _FusedGelu(torch.autograd.Function):
    """The JAX package's `_gelu_apply`: saves the sum s = x + bias only."""

    @staticmethod
    def forward(ctx, x, bias, approximate, out_dtype):
        out, s = _gelu_forward(x, bias, approximate, out_dtype)
        ctx.save_for_backward(s)
        ctx.approximate = approximate
        ctx.dtypes = (x.dtype, bias.dtype)
        ctx.mark_non_differentiable(s)
        return out, s

    @staticmethod
    def backward(ctx, d_out, _d_sum):
        (s,) = ctx.saved_tensors
        x_dt, bias_dt = ctx.dtypes
        dx, dbias = fused_bias_gelu_backward(
            s, d_out, approximate=ctx.approximate, dx_dtype=x_dt)
        return dx, dbias.to(bias_dt), None, None


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    returns `out` alone; without gradients it never writes the sum.

    Differentiable in y, bias, residual, gamma and beta. CUDA tensors
    launch kernel K3-fwd (and K3-bwd in the backward); CPU tensors take
    the plain twins.
    """
    out_dtype = out_dtype if out_dtype is not None else y.dtype
    sum_dtype = sum_dtype if sum_dtype is not None else residual.dtype
    if _needs_grad(y, bias, residual, gamma, beta):
        return _FusedLayerNorm.apply(y, bias, residual, gamma, beta,
                                     float(eps), out_dtype, sum_dtype,
                                     return_sum)
    out, s = _ln_forward(y, bias, residual, gamma, beta, eps, out_dtype,
                         sum_dtype, return_sum)
    return (out, s) if return_sum else out


fused_bias_residual_layernorm.launches = 0


def fused_bias_gelu(x, bias, *, approximate=False, out_dtype=None):
    """gelu(x + bias) as one launch; exact-erf by default, and
    `approximate=True` for the tanh form GPT-2 uses. Returns the output
    (out_dtype, default x.dtype); the kernel also writes the bias+input
    sum in x.dtype, the backward's only residual, which
    `fused_bias_gelu_with_sum` returns.

    Differentiable in x and bias. CUDA tensors launch kernel K4-fwd
    (and K4-bwd in the backward); CPU tensors take the plain twins.
    """
    return fused_bias_gelu_with_sum(x, bias, approximate=approximate,
                                    out_dtype=out_dtype)[0]


def fused_bias_gelu_with_sum(x, bias, *, approximate=False,
                             out_dtype=None):
    """(gelu(x + bias), x + bias): both outputs of the forward (the sum
    carries no gradient)."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if _needs_grad(x, bias):
        return _FusedGelu.apply(x, bias, bool(approximate), out_dtype)
    return _gelu_forward(x, bias, bool(approximate), out_dtype)


fused_bias_gelu.launches = 0


def reset_launch_counts():
    """Zero the four launch counters (K3/K4, forward and backward)."""
    fused_bias_residual_layernorm.launches = 0
    fused_bias_gelu.launches = 0
    fused_bias_residual_layernorm_backward.launches = 0
    fused_bias_gelu_backward.launches = 0
