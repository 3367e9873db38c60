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

Bias + GeLU also takes a grouped bias [G, W] (the expert form,
`moe/experts.py`: the JAX package vmaps the kernel over the expert
dimension): the rows split into G equal groups, group g adds bias row
g, and the backward's dbias is [G, W]. One launch covers all groups
(and, in the backward, dbias); G = 1 is the dense form, bit for bit.
The K4 kernels' tiling is a plain function, `gelu_plan`; K3-fwd's (row
groups of warps, persistent CTAs) `ln_fwd_plan`, and K3-bwd's (the same
rows, dbias/dgamma/dbeta folded in the same launch) `ln_bwd_plan`. The
kernels read the [H] and [G, W] vectors in their own dtype (fp32 or
bf16): a wrapper casts or copies none of them, so one call is one
launch.

fp16: each kernel has an fp16 form, instantiated only for the dtypes the
fp16 paths give it (`_check_fp16_form`, `LN_FWD_FP16_FORMS`,
`LN_BWD_FP16_FORMS`): K3-fwd with y fp16 and (residual, out, sum) all
fp16, or fp16/fp32/fp16, or fp32 throughout; K3-bwd with dx fp16 and
(s, dout) fp16/fp16, fp16/fp32 or fp32/fp32, one vector a lane (H up to
3584); K4-fwd and K4-bwd all fp16, dense or grouped (the MoE experts: a
per-expert bias, a per-group fp32 dbias); the vectors fp16 or fp32. No
launch mixes bf16 and fp16. K3-bwd in fp16 above H 3584 (on no model's
path) raises naming ROADMAP Queue 2 item 6.

Dispatch: a wrapper takes the plain twin for tensors on the CPU and
launches the kernel for tensors on CUDA. There is no fallback from a
CUDA tensor to the twin. Each wrapper counts its kernel launches in a
plain integer (`fused_bias_residual_layernorm.launches`,
`fused_bias_gelu.launches`, and `.launches` of the two `*_backward`
wrappers), so a run can show that its main path went through the
kernels; K4's two wrappers also count their grouped launches apart
(`.grouped_launches`, a part of `.launches`).
"""

import collections
import ctypes
import functools
import math

import torch

from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import named_outputs

# names of the kernels' outputs that the named remat policies keep
# (runtime/activation_checkpointing/checkpointing.py); save_fused_epilogues
# keeps all but FUSED_GELU_OUT: 4H wide, one transcendental pass from the
# kept sum
FUSED_LN_OUT = "fused_ln_out"
FUSED_LN_SUM = "fused_ln_sum"
FUSED_GELU_SUM = "fused_gelu_sum"
FUSED_GELU_OUT = "fused_gelu_out"
FUSED_EPILOGUE_SAVE_NAMES = (FUSED_LN_OUT, FUSED_LN_SUM, FUSED_GELU_SUM)

_SQRT_2 = 1.4142135623730951
_SQRT_2_OVER_PI = 0.7978845608028654   # sqrt(2/pi), the tanh-gelu const
_GELU_C = 0.044715
_INV_SQRT_2PI = 0.3989422804014327     # 1/sqrt(2*pi)

# dtype codes and argument types of the kernels' C interfaces
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the fp16 forms of K3 that are instantiated: (residual, out, sum) of
# K3-fwd and (s, dout) of K3-bwd, with y and dx fp16. GPT-2 gives the
# all-fp16 forms; BERT's post-LN layer an fp16 residual, then an fp32
# one, with fp32 out (GPT-2's ln_f fp32 out too)
_F16, _F32 = torch.float16, torch.float32
LN_FWD_FP16_FORMS = ((_F16, _F16, _F16), (_F16, _F32, _F16),
                     (_F32, _F32, _F32))
LN_BWD_FP16_FORMS = ((_F16, _F16), (_F16, _F32), (_F32, _F32))
_LN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + \
    [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_GELU_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + \
    [ctypes.c_void_p]
_LN_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
    [ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_GELU_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + \
    [ctypes.c_void_p]

# K4's tiling (ops/csrc/gelu_rows.cuh): a CTA of 4 warps owns a strip of
# 256 columns (8 a lane) and every ctas_per_group-th block of 16 rows of
# one group; the grid is sized to one wave of 2 CTAs per SM (the
# kernels' launch bounds)
_GELU_STRIP = 256
_GELU_BLOCK_ROWS = 16
_GELU_CTAS_PER_SM = 2
GeluPlan = collections.namedtuple(
    "GeluPlan", "vec strips ctas_per_group block_rows grid work_rows "
    "counters")

# K3-fwd's layout (ops/csrc/fused_ln_fwd.cu): a row group of the fewest
# warps whose lanes cover the row's 8-column vectors (one a lane, up to
# 20 warps: H 5120); CTAs of up to 8 warps of whole row groups (a group
# of more warps alone), a wave of up to 28 warps an SM (as many as fit
# at 72 registers a lane; the kernel's C entry cuts the grid further
# where an instantiation takes more)
_LN_FWD_MAX_WARPS = 20
_LN_FWD_CTA_WARPS = 8
_LN_FWD_SM_WARPS = 28
LnFwdPlan = collections.namedtuple(
    "LnFwdPlan", "vec warps_per_row groups threads grid")

# K3-bwd's layout (ops/csrc/fused_ln_bwd.cu): a row group of warps per
# row, each lane 8 columns of `vpt` vectors of every row it sees; CTAs
# of up to 14 warps at one vector a lane (7 at four: their lanes take
# 255 registers) holding row groups of the same width, one CTA per SM,
# each row group taking one row at a time
_LN_BWD_MAX_WARPS = 14
LnBwdPlan = collections.namedtuple(
    "LnBwdPlan", "vec vpt warps_per_row groups threads grid fold "
    "fold_groups work_rows counters")


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


def _grouped(x, groups):
    """[..., W] rows as [G, rows / G, W]."""
    return x.reshape(groups, -1, x.shape[-1])


def _gelu_fwd_math(x, bias, approximate):
    """fp32 s = x + bias; out = gelu(s), erf exact or tanh approximate,
    with jax.nn.gelu's association (s * cdf). A bias [G, W] adds its row
    g to the g-th of G equal groups of rows."""
    if bias.dim() == 2:
        out, s = _gelu_fwd_math(_grouped(x, bias.shape[0]), bias[:, None],
                                approximate)
        return out.reshape(x.shape), s.reshape(x.shape)
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
def _check_fp16_form(kernel, lead, lead_dtype, others, all_fp16=False):
    """The instantiations a launch can take: with `lead` (the kernel's
    leading row tensor) fp16, the fp16 form (`others` fp16 or fp32, or
    with `all_fp16` the row tensors all fp16); else no operand may be
    fp16. `others`: [(name, dtype, row)]. TypeError names the operand."""
    half = torch.float16
    if lead_dtype == half:
        for name, dt, row in others:
            if dt == torch.bfloat16 or (all_fp16 and row and dt != half):
                raise TypeError(
                    f"{kernel}: {name} dtype {dt} with {lead} float16 (the "
                    "fp16 form takes " +
                    ("float16 rows" if all_fp16 and row else
                     "float16 or float32") + ")")
        return
    for name, dt, _ in others:
        if dt == half:
            raise TypeError(f"{kernel}: {name} dtype float16 with {lead} "
                            f"{lead_dtype} (no launch mixes float16 with "
                            "another 16-bit type or fp32 rows)")


def _check_rows(name, t, width):
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32, bfloat16 or float16)")
    if t.shape[-1] != width:
        raise ValueError(f"{name}: last dim {t.shape[-1]} != {width}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_vector(t, width, device, groups=None):
    want = (width,) if groups is None else (groups, width)
    if tuple(t.shape) != want:
        raise ValueError(f"vector shape {tuple(t.shape)} != {want}")
    if t.device != device:
        raise ValueError(f"vector on {t.device}, rows on {device}")


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
    # the kernel reads each vector in its own dtype: no cast, no copy
    for name, v in (("bias", bias), ("gamma", gamma), ("beta", beta)):
        _check_vector(v, h, y.device)
        if v.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} dtype {v.dtype} not supported "
                            "(float32, bfloat16 or float16)")
        if h > 1 and v.stride(0) != 1:
            raise ValueError(f"{name}: must be contiguous")
    _check_fp16_form("K3-fwd", "y", y.dtype, [
        ("residual", residual.dtype, True), ("out", out_dtype, True),
        ("sum", sum_dtype, True), ("bias", bias.dtype, False),
        ("gamma", gamma.dtype, False), ("beta", beta.dtype, False)])
    if y.dtype == torch.float16 and \
            (residual.dtype, out_dtype, sum_dtype) not in LN_FWD_FP16_FORMS:
        raise TypeError(
            f"K3-fwd: fp16 y with (residual, out, sum) dtypes "
            f"{(residual.dtype, out_dtype, sum_dtype)}: the fp16 forms are "
            f"{LN_FWD_FP16_FORMS}")
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    s = torch.empty(y.shape, dtype=sum_dtype, device=y.device) \
        if return_sum else None
    n = y.numel() // h if h else 0
    dev = y.device.index or 0
    # out and s are fresh allocations, aligned
    plan = ln_fwd_plan(n, h, _sm_count(dev),
                       _aligned(y, residual, bias, gamma, beta))
    fn = _build.function("fused_ln_fwd", "ds_fused_ln_fwd", _LN_ARGTYPES)
    err = fn(y.data_ptr(), residual.data_ptr(), bias.data_ptr(),
             gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
             s.data_ptr() if s is not None else None, n, h,
             _DTYPE_CODE[y.dtype], _DTYPE_CODE[residual.dtype],
             _DTYPE_CODE[bias.dtype], _DTYPE_CODE[gamma.dtype],
             _DTYPE_CODE[beta.dtype], _DTYPE_CODE[out_dtype],
             _DTYPE_CODE[sum_dtype], float(eps), plan.vec,
             plan.warps_per_row, plan.groups, plan.grid, dev,
             _build.stream_ptr(y))
    _build.check(err, "fused_bias_residual_layernorm kernel")
    fused_bias_residual_layernorm.launches += 1
    return out, s


def _bias_groups(bias, n):
    """The group count G of a bias [W] (1) or [G, W], checked against
    the n rows it adds to."""
    if bias.dim() == 1:
        return 1
    groups = bias.shape[0]
    if bias.dim() != 2 or groups < 1 or n % groups:
        raise ValueError(f"grouped bias {tuple(bias.shape)}: {n} rows do "
                         "not split into that many equal groups")
    return groups


@functools.lru_cache(maxsize=256)
def gelu_plan(n, w, groups, sms, aligned=True):
    """K4's launch plan for n rows of width w in `groups` equal groups on
    a card of `sms` SMs: grid (groups * ctas_per_group, strips), a CTA
    per strip of 256 columns and per group, where CTA j of a group takes
    the group's blocks of `block_rows` rows j, j + ctas_per_group, ...
    (the last block cut at the group's end). `vec` is 8 (16-byte
    accesses) where W is a multiple of 8 and every pointer is 16-byte
    `aligned`, else 1 (scalar accesses that stop at W). K4-bwd's
    workspace has `work_rows` rows of W fp32 partial sums, one per CTA
    row, and `counters` int32 counters, one per (group, strip). Cached:
    the decode path asks for the same plan 48 times a step."""
    rows = n // groups if groups > 0 else 0
    strips = -(-w // _GELU_STRIP)
    vec = 8 if aligned and w % 8 == 0 else 1
    cpg = 0
    if rows > 0 and w > 0:
        # one wave of CTAs over the card; each at least one block
        target = max(1, sms * _GELU_CTAS_PER_SM // (groups * strips))
        cpg = min(target, -(-rows // _GELU_BLOCK_ROWS))
    return GeluPlan(vec, strips, cpg, _GELU_BLOCK_ROWS,
                    (groups * cpg, strips), groups * cpg, groups * strips)


@functools.lru_cache(maxsize=256)
def ln_fwd_plan(n, h, sms, aligned=True):
    """K3-fwd's launch plan for n rows of width h on a card of `sms` SMs.

    A row belongs to a row group of `warps_per_row` warps, the fewest
    whose lanes cover the row's ceil(h / 8) vectors: lane i of the group
    owns the 8 columns 8i .. 8i + 7 of every row the group sees. A CTA
    holds `groups` row groups (as many as fit 8 warps, at least one, and
    at most ceil(n / sms), so that few rows spread over the SMs),
    `threads` threads; the grid, at most the CTAs of 28 warps an SM (the
    warps that fit at the paths' 70 registers a lane with bf16 outputs;
    the C entry cuts it to the CTAs the card holds at once), gives row
    group k (CTA k // groups, group k % groups) the rows k,
    k + grid * groups, ... `vec` is 8 (16-byte accesses) where h is a
    multiple of 8 and every input's pointer (y, the residual and the
    three vectors) is 16-byte `aligned`, else 1 (scalar accesses that
    stop at h). Raises ValueError past the widest row (h > 5120).
    Cached: a step asks for the same plan on every layer."""
    vec = 8 if aligned and h % 8 == 0 else 1
    wpr = max(1, -(-h // (8 * 32)))
    if wpr > _LN_FWD_MAX_WARPS:
        raise ValueError(f"fused LN forward kernel: H={h} exceeds the "
                         f"{32 * _LN_FWD_MAX_WARPS * 8} columns of its "
                         "widest row")
    groups = max(1, min(_LN_FWD_CTA_WARPS // wpr, -(-n // sms)))
    per_sm = max(1, _LN_FWD_SM_WARPS // (groups * wpr))
    grid = min(sms * per_sm, -(-n // groups)) if n > 0 else 0
    return LnFwdPlan(vec, wpr, groups, 32 * wpr * groups, grid)


@functools.lru_cache(maxsize=256)
def ln_bwd_plan(n, h, sms, aligned=True):
    """K3-bwd's launch plan for n rows of width h on a card of `sms` SMs.

    A row belongs to a row group of `warps_per_row` warps: lane i of the
    group owns the 8-column vectors i + j * 32 * warps_per_row (j <
    `vpt`) of every row the group sees, so the fewest warps whose lanes
    cover the row's ceil(h / 8) vectors (1 vector a lane up to h = 3584,
    else 4). A CTA holds `groups` row groups (as many as fit 14 warps at
    one vector a lane, else 7; none idle), `threads` threads; the grid, one CTA per SM at most,
    gives row group k (CTA k // groups, group k % groups) the rows k,
    k + grid * groups, ... `vec` is 8 (16-byte accesses) where h is a
    multiple of 8 and every pointer is 16-byte `aligned`, else 1. The
    CTAs' partial rows [3, h] are folded in `fold_groups` groups of
    `fold` consecutive CTAs (the last a remainder) and then the group
    rows in order (with one group, straight into the sums): the
    workspace holds `work_rows` rows, the int32 counters `counters` (one
    per fold group and one for the groups). Raises ValueError past the
    widest row (h > 7168)."""
    vec = 8 if aligned and h % 8 == 0 else 1
    nvec = -(-h // 8)
    vpt = 1 if nvec <= 32 * _LN_BWD_MAX_WARPS else 4
    warps = _LN_BWD_MAX_WARPS if vpt == 1 else _LN_BWD_MAX_WARPS // 2
    wpr = max(1, -(-nvec // (32 * vpt)))
    if wpr > warps:
        raise ValueError(f"fused LN backward kernel: H={h} exceeds the "
                         f"{32 * warps * vpt * 8} columns of its widest "
                         "row")
    groups = max(1, min(warps // wpr, n))
    grid = min(sms, -(-n // groups))
    fold = math.isqrt(grid - 1) + 1 if grid > 0 else 1
    fold_groups = -(-grid // fold)
    return LnBwdPlan(vec, vpt, wpr, groups, 32 * wpr * groups, grid, fold,
                     fold_groups,
                     grid + (fold_groups if fold_groups > 1 else 0),
                     fold_groups + 1)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _gelu_fwd_launch(x, bias, approximate, out_dtype, sum_dtype):
    from deepspeed_tpu_torch.ops import _build
    w = x.shape[-1]
    _check_rows("x", x, w)
    for dt in (out_dtype, sum_dtype):
        if dt not in _DTYPE_CODE:
            raise TypeError(f"output dtype {dt} not supported")
    n = x.numel() // w if w else 0
    groups = _bias_groups(bias, n)
    _check_vector(bias, w, x.device, None if bias.dim() == 1 else groups)
    if bias.dtype not in _DTYPE_CODE:
        raise TypeError(f"bias dtype {bias.dtype} not supported "
                        "(float32, bfloat16 or float16)")
    _check_fp16_form("K4-fwd", "x", x.dtype, [
        ("out", out_dtype, True), ("sum", sum_dtype, True),
        ("bias", bias.dtype, False)], all_fp16=True)
    bias = bias.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    s = torch.empty(x.shape, dtype=sum_dtype, device=x.device)
    dev = x.device.index or 0
    # out and s are fresh allocations, aligned
    plan = gelu_plan(n, w, groups, _sm_count(dev), _aligned(x, bias))
    fn = _build.function("fused_gelu_fwd", "ds_fused_gelu_fwd",
                         _GELU_ARGTYPES)
    err = fn(x.data_ptr(), bias.data_ptr(), out.data_ptr(), s.data_ptr(),
             n, w, groups, plan.ctas_per_group, plan.strips, plan.vec,
             _DTYPE_CODE[x.dtype], _DTYPE_CODE[bias.dtype],
             _DTYPE_CODE[out_dtype], _DTYPE_CODE[sum_dtype],
             int(bool(approximate)), dev, _build.stream_ptr(x))
    _build.check(err, "fused_bias_gelu kernel")
    fused_bias_gelu.launches += 1
    fused_bias_gelu.grouped_launches += int(groups > 1)
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
        if dsum2.dtype != s2.dtype:
            raise TypeError(f"dsum dtype {dsum2.dtype} != s dtype "
                            f"{s2.dtype}: the kernel reads dsum in s's dtype")
    if dx_dtype not in _DTYPE_CODE:
        raise TypeError(f"dx dtype {dx_dtype} not supported")
    _check_vector(gamma, h, s2.device)
    if gamma.dtype not in _DTYPE_CODE:
        raise TypeError(f"gamma dtype {gamma.dtype} not supported "
                        "(float32, bfloat16 or float16)")
    _check_fp16_form("K3-bwd", "dx", dx_dtype, [
        ("s", s2.dtype, True), ("dout", dout2.dtype, True),
        ("gamma", gamma.dtype, False)])
    if dx_dtype == torch.float16 and \
            (s2.dtype, dout2.dtype) not in LN_BWD_FP16_FORMS:
        raise TypeError(f"K3-bwd: fp16 dx with (s, dout) dtypes "
                        f"{(s2.dtype, dout2.dtype)}: the fp16 forms are "
                        f"{LN_BWD_FP16_FORMS}")
    gamma = gamma.contiguous()
    dev = s2.device.index or 0
    rows = [s2, dout2, gamma] + ([dsum2] if dsum2 is not None else [])
    plan = ln_bwd_plan(n, h, _sm_count(dev), _aligned(*rows))
    if dx_dtype == torch.float16 and plan.vpt != 1:
        raise NotImplementedError(
            f"K3-bwd: fp16 at H {h} (4 vectors a lane, above H 3584) is "
            "not in the port yet: ROADMAP Queue 2 item 6")
    dx = torch.empty((n, h), dtype=dx_dtype, device=s2.device)
    sums = torch.empty((3, h), dtype=torch.float32, device=s2.device)
    work = torch.empty((max(plan.work_rows, 1), 3, h), dtype=torch.float32,
                       device=s2.device)
    counters = torch.zeros((plan.counters,), dtype=torch.int32,
                           device=s2.device)
    fn = _build.function("fused_ln_bwd", "ds_fused_ln_bwd",
                         _LN_BWD_ARGTYPES)
    err = fn(s2.data_ptr(), gamma.data_ptr(), dout2.data_ptr(),
             dsum2.data_ptr() if dsum2 is not None else None,
             dx.data_ptr(), sums.data_ptr(), work.data_ptr(),
             counters.data_ptr(), n, h, _DTYPE_CODE[s2.dtype],
             _DTYPE_CODE[gamma.dtype], _DTYPE_CODE[dout2.dtype],
             _DTYPE_CODE[dx_dtype], float(eps), plan.vec, plan.vpt,
             plan.warps_per_row, plan.groups, plan.grid, plan.fold, dev,
             _build.stream_ptr(s2))
    _build.check(err, "fused_bias_residual_layernorm backward kernel")
    fused_bias_residual_layernorm_backward.launches += 1
    return dx, sums[0], sums[1], sums[2]


def _gelu_bwd_launch(s2, dout2, approximate, dx_dtype, groups=None):
    from deepspeed_tpu_torch.ops import _build
    n, w = s2.shape
    _check_rows("s", s2, w)
    _check_rows("dout", dout2, w)
    if dout2.shape != s2.shape:
        raise ValueError(f"dout shape {tuple(dout2.shape)} != s shape "
                         f"{tuple(s2.shape)}")
    if dx_dtype not in _DTYPE_CODE:
        raise TypeError(f"dx dtype {dx_dtype} not supported")
    grouped, groups = groups is not None, groups or 1
    if n % groups:
        raise ValueError(f"{n} rows do not split into {groups} equal groups")
    _check_fp16_form("K4-bwd", "dx", dx_dtype, [
        ("s", s2.dtype, True), ("dout", dout2.dtype, True)], all_fp16=True)
    dev = s2.device.index or 0
    dx = torch.empty((n, w), dtype=dx_dtype, device=s2.device)
    dbias = torch.empty((groups, w), dtype=torch.float32, device=s2.device)
    plan = gelu_plan(n, w, groups, _sm_count(dev), _aligned(s2, dout2))
    work = torch.empty((max(plan.work_rows, 1), w), dtype=torch.float32,
                       device=s2.device)
    counters = torch.zeros((max(plan.counters, 1),), dtype=torch.int32,
                           device=s2.device)
    fn = _build.function("fused_gelu_bwd", "ds_fused_gelu_bwd",
                         _GELU_BWD_ARGTYPES)
    err = fn(s2.data_ptr(), dout2.data_ptr(), dx.data_ptr(),
             dbias.data_ptr(), work.data_ptr(), counters.data_ptr(), n, w,
             groups, plan.ctas_per_group, plan.strips, plan.vec,
             _DTYPE_CODE[s2.dtype], _DTYPE_CODE[dout2.dtype],
             _DTYPE_CODE[dx_dtype], int(bool(approximate)), dev,
             _build.stream_ptr(s2))
    _build.check(err, "fused_bias_gelu backward kernel")
    fused_bias_gelu_backward.launches += 1
    fused_bias_gelu_backward.grouped_launches += int(groups > 1)
    return dx, (dbias if grouped else dbias[0])


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


def fused_bias_gelu_backward(s, d_out, *, approximate=False, dx_dtype=None,
                             groups=None):
    """Backward of gelu(x + bias) off the forward's saved sum `s`
    [..., W]: (dx [..., W] in dx_dtype, default s.dtype; dbias [W] fp32,
    the sum of dx over every row). With `groups` G (the grouped bias
    [G, W]) dbias is [G, W], each row the sum over one of G equal groups
    of rows. CUDA tensors launch kernel K4-bwd; CPU tensors take the
    plain twin."""
    dx_dtype = dx_dtype if dx_dtype is not None else s.dtype
    s2 = _flat_rows(s)
    dout2 = _flat_rows(d_out).contiguous()
    if s.is_cuda:
        dx2, dbias = _gelu_bwd_launch(s2.contiguous(), dout2,
                                      bool(approximate), dx_dtype, groups)
    else:
        d = _gelu_bwd_math(s2, dout2, bool(approximate))
        dx2 = d.to(dx_dtype)
        dbias = d.sum(dim=0) if groups is None else \
            _grouped(d, groups).sum(dim=1)
    return dx2.reshape(s.shape), dbias


fused_bias_gelu_backward.launches = 0
fused_bias_gelu_backward.grouped_launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """The JAX package's `_ln_apply` (return_sum=True: outputs out and
    the sum) and `_ln_apply_out` (return_sum=False, the ln_f form: out
    alone, so no sum cotangent exists). Saves the sum and gamma only."""

    @staticmethod
    def forward(ctx, y, bias, residual, gamma, beta, eps, out_dtype,
                sum_dtype, return_sum):
        # named (FUSED_LN_OUT, FUSED_LN_SUM) for the remat policies, the
        # ln_f form too: a remat recompute that keeps both launches nothing
        out, s = named_outputs(
            (FUSED_LN_OUT, FUSED_LN_SUM),
            lambda: _ln_forward(y, bias, residual, gamma, beta, eps,
                                out_dtype, sum_dtype, True))
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
        # the sum is named first, as in the JAX package; a recompute that
        # keeps only the sum runs the kernel again for the output
        s, out = named_outputs(
            (FUSED_GELU_SUM, FUSED_GELU_OUT),
            lambda: _gelu_forward(x, bias, approximate, out_dtype)[::-1])
        ctx.save_for_backward(s)
        ctx.approximate = approximate
        ctx.groups = bias.shape[0] if bias.dim() == 2 else None
        ctx.dtypes = (x.dtype, bias.dtype)
        ctx.mark_non_differentiable(s)
        return out, s

    @staticmethod
    def backward(ctx, d_out, _d_sum):
        (s,) = ctx.saved_tensors
        x_dt, bias_dt = ctx.dtypes
        dx, dbias = fused_bias_gelu_backward(
            s, d_out, approximate=ctx.approximate, dx_dtype=x_dt,
            groups=ctx.groups)
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
    `approximate=True` for the tanh form GPT-2 uses. `bias` is [W], or
    [G, W] for G equal groups of rows (the experts' form, one launch for
    all of them). Returns the output
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
fused_bias_gelu.grouped_launches = 0


def reset_launch_counts():
    """Zero the launch counters (K3/K4, forward and backward, and K4's
    grouped ones)."""
    fused_bias_residual_layernorm.launches = 0
    fused_bias_gelu.launches = 0
    fused_bias_residual_layernorm_backward.launches = 0
    fused_bias_gelu_backward.launches = 0
    fused_bias_gelu.grouped_launches = 0
    fused_bias_gelu_backward.grouped_launches = 0
