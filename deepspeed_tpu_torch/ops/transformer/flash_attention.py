"""Flash attention, forward half (kernel K1-fwd).

Port of deepspeed_tpu/ops/transformer/flash_attention.py. The Pallas
forward kernels `_fwd_kernel` and `_fwd_kernel_packed` become one
hand-written CUDA kernel, `ops/csrc/flash_attention_fwd.cu`; the plain
PyTorch twin `_flash_fwd_plain` below runs the same tiled online
softmax (log2 space, -1e30 masking, causal tiles above the diagonal
skipped) and is what CPU tensors take. The backward (K2) and the
ring-merge mode (K5) come with later slices.

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


def dense_attention(q, k, v, causal=False, sm_scale=None):
    """Dense attention over [B, T, H, D]: the reference path for the
    flash kernel and the route where flash does not apply. fp32
    softmax. The score product comes out in the input dtype and is then
    widened, as the JAX einsum does."""
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
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


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
# plain twin: the kernel's tiled online softmax in PyTorch
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


# ----------------------------------------------------------------------
# kernel launcher
# ----------------------------------------------------------------------
def _flash_fwd_launch(q, k, v, sm_scale, causal):
    from deepspeed_tpu_torch.ops import _build
    b, t, h, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != "
                             f"q shape {tuple(q.shape)}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("q, k, v must share dtype and device")
        if x.stride(3) != 1:
            raise ValueError(f"{name}: head dim must be contiguous")
        itemsize = x.element_size()
        if x.data_ptr() % 16 or any((x.stride(i) * itemsize) % 16
                                    for i in range(3)):
            raise ValueError(f"{name}: base and (b, t, h) strides must be "
                             "16-byte aligned for the kernel's loads")
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
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    fn = _build.function("flash_attention_fwd", "ds_flash_attn_fwd",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, t, h, d, strides,
             float(sm_scale * LOG2E), int(bool(causal)),
             _DTYPE_CODE[q.dtype], q.device.index or 0,
             _build.stream_ptr(q))
    _build.check(err, "flash_attention kernel")
    flash_attention_with_lse.launches += 1
    return out, lse


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


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None,
                             head_packing="auto"):
    """Flash attention returning (out [B,T,H,D], lse [B,H,T,1]), lse in
    LOG2 space. CUDA tensors launch kernel K1-fwd; CPU tensors take the
    plain twin (T must be a multiple of 64 on either)."""
    sm_scale, causal = _normalize_flash_args(q, k, v, causal, sm_scale,
                                             head_packing)
    if q.is_cuda:
        out, lse = _flash_fwd_launch(q, k, v, sm_scale, causal)
    else:
        if q.shape[1] % KERNEL_BLOCK:
            raise ValueError(f"flash attention: T={q.shape[1]} is no "
                             f"multiple of {KERNEL_BLOCK}")
        out, lse = _flash_fwd_plain(q, k, v, sm_scale, causal)
    return out, lse[..., None]


flash_attention_with_lse.launches = 0


def flash_attention(q, k, v, causal=True, sm_scale=None,
                    head_packing="auto"):
    """Flash attention over [B, T, H, D] tensors; returns [B, T, H, D]."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    sm_scale=sm_scale,
                                    head_packing=head_packing)[0]


def reset_launch_count():
    flash_attention_with_lse.launches = 0
