"""Flash attention: forward (kernel K1-fwd) and backward (kernel K2).

Port of deepspeed_tpu/ops/transformer/flash_attention.py. The Pallas
forward kernels `_fwd_kernel` / `_fwd_kernel_packed` become the
hand-written CUDA kernel `ops/csrc/flash_attention_fwd.cu`, and the
backward kernels (`_bwd_dkv_kernel`, `_bwd_dq_kernel`,
`_bwd_fused_kernel` and their packed twins) become
`ops/csrc/flash_attention_bwd.cu`. The plain PyTorch twins
`_flash_fwd_plain` / `_flash_bwd_plain` below run the same 64x64 tiled
algorithms (log2 space, -1e30 masking, causal tiles above the diagonal
skipped) and are what CPU tensors take. A `torch.autograd.Function`
joins the two halves, so `flash_attention` and
`flash_attention_with_lse` are differentiable in every output (the lse
cotangent enters the backward as a shift of delta, as in the JAX
package). The ring-merge mode (K5) comes with a later slice.

Layout: [B, T, H, D] at every public function, as in the JAX package.
The lse is returned as [B, H, T, 1] in LOG2 space (m + log2(l) over
log2(e)-scaled scores), the convention the backward and the ring merge
consume.

Head packing (two d=64 heads per grid step) was a device for the TPU's
128-wide matrix unit; it computes the same function, so every
`head_packing` value routes to the one kernel here.
`_resolve_head_packing` keeps the JAX package's validation ("packed"
with d != 64 raises).
"""

import ctypes

import numpy as np
import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# the CUDA kernel's tile: 64 query rows x 64 key rows per step
KERNEL_BLOCK = 64
_KERNEL_HEAD_DIMS = (64, 128)
_DEFAULT_BLOCK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
    [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + \
    [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]


def dropout(x, rate, generator):
    """flax nn.Dropout: keep each element with probability 1 - rate,
    scaled by 1 / (1 - rate), from `generator`'s uniform draws (a
    torch.Generator on x's device; the draws are torch's, not JAX's)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def dense_attention(q, k, v, mask=None, causal=False, sm_scale=None,
                    dropout_rate=0.0, dropout_gen=None):
    """Dense attention over [B, T, H, D]: the reference path for the
    flash kernel and the route where flash does not apply. fp32
    softmax. The score product comes out in the input dtype and is then
    widened, as the JAX einsum does. `mask` is additive, broadcastable
    to [B, H, Tq, Tk], and applies after the causal mask. With a
    `dropout_gen` and a rate > 0, dropout applies to the probabilities
    (the JAX package's attention dropout)."""
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores * sm_scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        tri = torch.ones((t_q, t_k), dtype=torch.bool,
                         device=q.device).tril()
        scores = torch.where(tri[None, None], scores,
                             torch.tensor(NEG_INF, dtype=torch.float32,
                                          device=q.device))
    if mask is not None:
        scores = scores + mask.to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    if dropout_gen is not None and dropout_rate > 0.0:
        probs = dropout(probs, dropout_rate, dropout_gen)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _fit_block(block, t):
    """Largest power-of-two shrink of `block` (floor 128) that divides
    t, after clamping to t."""
    block = min(block, t)
    while block > 128 and t % block:
        block //= 2
    return block


def flash_attention_usable(q, no_dropout: bool,
                           block_q=None, block_k=None):
    """The routing gate, identical to the JAX package's: [B, T, H, D]
    with T a multiple of 128 that the block sizes divide, D a multiple
    of 64, and no dropout. The model takes flash exactly where the JAX
    package does and `dense_attention` elsewhere."""
    if not no_dropout:
        return False
    if q.ndim != 4:
        return False
    t, d = q.shape[1], q.shape[3]
    block_q = _fit_block(block_q or _DEFAULT_BLOCK, t)
    block_k = _fit_block(block_k or _DEFAULT_BLOCK, t)
    return t % block_q == 0 and t % block_k == 0 and d % 64 == 0 and \
        t >= 128 and t % 128 == 0


def _resolve_head_packing(head_packing, d):
    """Head-packing mode -> bool, validated as in the JAX package. The
    value selects nothing on this device: packed and unpacked compute
    the same function, and both run the one kernel."""
    if head_packing in ("off", False, 0):
        return False
    if head_packing in ("packed", True, 1):
        if d != 64:
            raise ValueError(
                f"head_packing='packed' requires head_dim 64 (got {d}): "
                "packing pairs two 64-wide heads into one K=128 "
                "contraction")
        return True
    if head_packing in ("auto", None):
        return d == 64
    raise ValueError(
        f"head_packing={head_packing!r}: expected 'auto', 'packed' or "
        "'off'")


# ----------------------------------------------------------------------
# plain twins: the kernels' tiled algorithms in PyTorch
# ----------------------------------------------------------------------
def _flash_fwd_plain(q, k, v, sm_scale, causal, block=KERNEL_BLOCK):
    """(out [B,T,H,D] in q.dtype, lse [B,H,T] fp32 log2 space) by the
    kernel's algorithm: per q tile, walk the k tiles (causal: up to the
    diagonal) carrying the running max m, sum l and fp32 accumulator;
    scores are fp32 products scaled by sm_scale*log2(e) with masked
    entries at -1e30; the P·V product takes p in v's dtype."""
    b, t, h, d = q.shape
    f32 = torch.float32
    scale = float(sm_scale * LOG2E)
    qh = q.permute(0, 2, 1, 3)                    # [B, H, T, D]
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=f32, device=q.device)
    nblk = t // block
    for qi in range(nblk):
        rows = slice(qi * block, (qi + 1) * block)
        qt = qh[:, :, rows].to(f32)
        m = torch.full((b, h, block, 1), NEG_INF, dtype=f32,
                       device=q.device)
        l = torch.zeros((b, h, block, 1), dtype=f32, device=q.device)
        acc = torch.zeros((b, h, block, d), dtype=f32, device=q.device)
        for ki in range(qi + 1 if causal else nblk):
            cols = slice(ki * block, (ki + 1) * block)
            s = torch.matmul(qt, kh[:, :, cols].to(f32).transpose(-1, -2))
            s = s * scale
            if causal:
                qpos = torch.arange(qi * block, (qi + 1) * block,
                                    device=q.device)
                kpos = torch.arange(ki * block, (ki + 1) * block,
                                    device=q.device)
                s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            alpha = torch.exp2(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = torch.matmul(p.to(v.dtype).to(f32), vh[:, :, cols].to(f32))
            acc = acc * alpha + pv
            m = m_new
        out[:, :, rows] = (acc / l).to(q.dtype)
        lse[:, :, rows] = (m + torch.log2(l))[..., 0]
    return out.permute(0, 2, 1, 3), lse


def _flash_bwd_plain(q, k, v, out, lse, g, dlse, sm_scale, causal,
                     block=KERNEL_BLOCK):
    """(dq, dk, dv) [B,T,H,D] in the input dtype by the kernel's
    algorithm: delta = rowsum(dO * O) - log2(e) * dlse; per (q tile,
    k tile) pair at or below the diagonal, P = exp2(S - lse) from the
    log2(e)-scaled scores (masked at -1e30), dP = dO V^T,
    dS = P (dP - delta) sm_scale; dV += P^T dO with P in dO's dtype,
    dK += dS^T Q and dQ += dS K with dS in q's dtype, fp32 sums. `lse`
    and `dlse` (or None) are [B, H, T] fp32."""
    b, t, h, d = q.shape
    f32 = torch.float32
    scale = float(sm_scale * LOG2E)
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3).to(f32) for x in (q, k, v, g))
    delta = (g.to(f32) * out.to(f32)).sum(dim=-1).permute(0, 2, 1)
    if dlse is not None:
        delta = delta - LOG2E * dlse.to(f32)
    dq = torch.zeros((b, h, t, d), dtype=f32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    nblk = t // block
    for qi in range(nblk):
        rows = slice(qi * block, (qi + 1) * block)
        qt, gt = qh[:, :, rows], gh[:, :, rows]
        lse_t = lse[:, :, rows, None].to(f32)
        delta_t = delta[:, :, rows, None]
        for ki in range(qi + 1 if causal else nblk):
            cols = slice(ki * block, (ki + 1) * block)
            kt, vt = kh[:, :, cols], vh[:, :, cols]
            s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
            if causal:
                qpos = torch.arange(qi * block, (qi + 1) * block,
                                    device=q.device)
                kpos = torch.arange(ki * block, (ki + 1) * block,
                                    device=q.device)
                s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
            p = torch.exp2(s - lse_t)
            dp = torch.matmul(gt, vt.transpose(-1, -2))
            ds = p * (dp - delta_t) * sm_scale
            p_c = p.to(g.dtype).to(f32)
            ds_c = ds.to(q.dtype).to(f32)
            dv[:, :, cols] += torch.matmul(p_c.transpose(-1, -2), gt)
            dk[:, :, cols] += torch.matmul(ds_c.transpose(-1, -2), qt)
            dq[:, :, rows] += torch.matmul(ds_c, kt)
    return tuple(x.to(dtype).permute(0, 2, 1, 3)
                 for x, dtype in ((dq, q.dtype), (dk, k.dtype),
                                  (dv, v.dtype)))


# ----------------------------------------------------------------------
# kernel launchers
# ----------------------------------------------------------------------
def _kernel_readable(x):
    """Whether the kernels' 16-byte row loads can read the [B, T, H, D]
    tensor x in place: a contiguous head dim and 16-byte aligned base and
    (b, t, h) strides."""
    itemsize = x.element_size()
    return x.stride(3) == 1 and not x.data_ptr() % 16 and not any(
        (x.stride(i) * itemsize) % 16 for i in range(3))


def _check_kernel_operand(name, x, like):
    """`like`'s shape, dtype and device, and readable in place."""
    if x.shape != like.shape:
        raise ValueError(f"{name} shape {tuple(x.shape)} != "
                         f"q shape {tuple(like.shape)}")
    if x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"{name}: q, k, v (and out, dout) must share "
                         "dtype and device")
    if not _kernel_readable(x):
        raise ValueError(f"{name}: head dim must be contiguous, base and "
                         "(b, t, h) strides 16-byte aligned for the "
                         "kernel's loads")


def _check_kernel_shape(q):
    b, t, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {d} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    if t % KERNEL_BLOCK:
        raise ValueError(f"flash kernel: T={t} is no multiple of "
                         f"{KERNEL_BLOCK}")
    if b * h > 65535:
        raise ValueError(f"flash kernel: B*H={b * h} exceeds 65535")


def _strides(*tensors):
    vals = [x.stride(i) for x in tensors for i in range(3)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _flash_fwd_launch(q, k, v, sm_scale, causal):
    from deepspeed_tpu_torch.ops import _build
    b, t, h, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, x, q)
    _check_kernel_shape(q)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_fwd", "ds_flash_attn_fwd",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, t, h, d, _strides(q, k, v),
             float(sm_scale * LOG2E), int(bool(causal)),
             _DTYPE_CODE[q.dtype], q.device.index or 0,
             _build.stream_ptr(q))
    _build.check(err, "flash_attention kernel")
    flash_attention_with_lse.launches += 1
    return out, lse


def _flash_bwd_launch(q, k, v, out, lse, g, dlse, sm_scale, causal):
    from deepspeed_tpu_torch.ops import _build
    b, t, h, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", g)):
        _check_kernel_operand(name, x, q)
    _check_kernel_shape(q)
    for name, x in (("lse", lse), ("dlse", dlse)):
        if x is not None and (x.shape != (b, h, t) or
                              x.dtype != torch.float32 or
                              not x.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous fp32 "
                             f"[{b}, {h}, {t}] tensor")
    dq, dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd", "ds_flash_attn_bwd",
                         _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             g.data_ptr(), lse.data_ptr(),
             dlse.data_ptr() if dlse is not None else None,
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             b, t, h, d, _strides(q, k, v, out, g),
             float(sm_scale * LOG2E), float(sm_scale), int(bool(causal)),
             _DTYPE_CODE[q.dtype], q.device.index or 0,
             _build.stream_ptr(q))
    _build.check(err, "flash_attention backward kernel")
    flash_attention_backward.launches += 1
    return dq, dk, dv


def flash_attention_backward(q, k, v, out, lse, dout, dlse=None,
                             sm_scale=None, causal=True):
    """(dq, dk, dv) of flash attention from the forward's (out, lse)
    (lse [B, H, T] fp32 in log2 space, as `_flash_fwd_launch` and
    `_flash_fwd_plain` write it), the output cotangent `dout` and an
    optional lse cotangent `dlse` [B, H, T]. CUDA tensors launch kernel
    K2; CPU tensors take the plain twin."""
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    if dlse is not None:
        dlse = dlse.to(torch.float32).contiguous()
    if q.is_cuda:
        if not _kernel_readable(dout):
            dout = dout.contiguous()
        return _flash_bwd_launch(q, k, v, out, lse, dout, dlse,
                                 float(sm_scale), causal)
    return _flash_bwd_plain(q, k, v, out, lse, dout, dlse, float(sm_scale),
                            causal)


flash_attention_backward.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(out, lse [B, H, T]) = flash attention of (q, k, v): the forward
    kernel (or twin), and the backward kernel (or twin) off the saved
    (q, k, v, out, lse) — the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        out, lse = _flash_forward(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, g_out, g_lse, ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------
def _normalize_flash_args(q, k, v, causal, sm_scale, head_packing):
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _resolve_head_packing(head_packing, q.shape[-1])
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    return float(sm_scale), bool(causal)


def _flash_forward(q, k, v, sm_scale, causal):
    if q.is_cuda:
        return _flash_fwd_launch(q, k, v, sm_scale, causal)
    if q.shape[1] % KERNEL_BLOCK:
        raise ValueError(f"flash attention: T={q.shape[1]} is no "
                         f"multiple of {KERNEL_BLOCK}")
    return _flash_fwd_plain(q, k, v, sm_scale, causal)


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None,
                             head_packing="auto"):
    """Flash attention returning (out [B,T,H,D], lse [B,H,T,1]), lse in
    LOG2 space, differentiable in both. CUDA tensors launch kernels
    K1-fwd (and K2 in the backward); CPU tensors take the plain twins
    (T must be a multiple of 64 on either)."""
    sm_scale, causal = _normalize_flash_args(q, k, v, causal, sm_scale,
                                             head_packing)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, sm_scale, causal)
    else:
        out, lse = _flash_forward(q, k, v, sm_scale, causal)
    return out, lse[..., None]


flash_attention_with_lse.launches = 0


def flash_attention(q, k, v, causal=True, sm_scale=None,
                    head_packing="auto"):
    """Flash attention over [B, T, H, D] tensors; returns [B, T, H, D]."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    sm_scale=sm_scale,
                                    head_packing=head_packing)[0]


def reset_launch_count():
    """Zero the forward (K1) and backward (K2) launch counters."""
    flash_attention_with_lse.launches = 0
    flash_attention_backward.launches = 0
