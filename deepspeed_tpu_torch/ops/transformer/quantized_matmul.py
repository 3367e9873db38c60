"""Quantized-compute GEMMs: int8 x int8 products with the per-block
dequant in the GEMM epilogue (kernel K6), and the straight-through
training family built on them.

Port of deepspeed_tpu/ops/transformer/quantized_matmul.py: the training
half, and the weight-only serving epilogue `int8_matmul` (an XLA einsum
in the JAX package, plain torch here on every device). The scale layout
is the JAX package's:

    weights:      one fp32 scale per (K-block, output column)
                  -> scales [.., nb, N], nb = ceil(K / block)
    activations:  one fp32 scale per row (per token) -> [.., rows, 1]

The Pallas kernel `_qmm_kernel` becomes the hand-written CUDA kernel in
`ops/csrc/quantized_matmul.cu`; its plain twin `_qmm_plain` stays here.
`quantized_matmul` quantizes the activations per row and runs the
product: on CUDA tensors it launches K6 or raises, on CPU tensors it
takes the twin. The quantizers and the K padding stay plain torch, as
the JAX package left them to XLA; the padding of M and N of the TPU
launcher becomes masking inside the kernel. One call covers G groups
(weights [G, Kp, N]): the experts' vmap of the JAX package is one
grouped launch here, the group the kernel grid's third axis. The output
is fp32, bf16 or fp16 (the fp16 engine's projections): the row scale
applies in fp32 and the result rounds once, so an fp16 value past 65504
is inf, as JAX's `astype` makes it, and the loss scaler sees the
overflow.

`quantized_dense` is the training entry point: the forward quantizes
the CURRENT weights per (K-block, column) and the input per row, the
backward is straight-through in the compute dtype (dx = g @ W_eff^T
with W_eff re-quantized from the saved raw weight, dW = x^T g).

Stochastic rounding is floor(v + u) with u uniform from a
torch.Generator seeded by the caller (the engine's per-step "quant"
seed, per layer and projection): the weights draw from stream 0 of the
seed, the activations from stream 1, and the backward (and a remat
recompute) rebuilds the same generators, so it sees the forward's
noise without saving it. The bits are torch's, not jax.random's: the
two packages round alike in distribution only.

Dispatch and launch counting as in fused_ops: `quantized_matmul.launches`
counts K6 launches (reset with `reset_launch_count()`).
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.utils.rng import stream_generator

# default quantization block along the contraction dim, the JAX
# package's; the kernel takes multiples of 128
DEFAULT_QUANT_BLOCK = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_QMM_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
    [ctypes.c_void_p]
# the blocks the kernel takes: the JAX package's rule for its int8 tiles
# (the CUDA kernel's 128-byte K stages divide them)
_KERNEL_BLOCK_MULTIPLE = 128


def resolve_quantized_compute(mode, device=None):
    """`quantized_compute` value -> bool. "auto" enables the int8 path
    on CUDA (where K6 runs), the port's counterpart of the JAX
    package's TPU-only "auto": CPU numerics stay unquantized by
    default. "on" forces it anywhere (the plain twin on the CPU); "off"
    disables."""
    if mode in ("off", False, 0, None):
        return False
    if mode in ("on", True, 1):
        return True
    if mode == "auto":
        return device is not None and torch.device(device).type == "cuda"
    raise ValueError(
        f"quantized_compute={mode!r}: expected 'auto', 'on' or 'off'")


# ----------------------------------------------------------------------
# quantizers: scale = maxabs / 127 per (K-block, column) or per row,
# zero-scale blocks clamp to 1
# ----------------------------------------------------------------------
def quantize_kernel_int8_np(w, block):
    """[.., K, N] fp kernel -> (q int8 [.., K, N], scales fp32
    [.., nb, N]), K zero-padded conceptually to nb*block. Numpy, for
    quantize-once-at-load users; the scales are the raw max-abs / 127
    (zero for an all-zero block)."""
    w = np.asarray(w, np.float32)
    k = w.shape[-2]
    nb = -(-k // block)
    pad = nb * block - k
    if pad:
        wp = np.concatenate(
            [w, np.zeros(w.shape[:-2] + (pad, w.shape[-1]), np.float32)],
            axis=-2)
    else:
        wp = w
    blocks = wp.reshape(wp.shape[:-2] + (nb, block, wp.shape[-1]))
    s = (np.abs(blocks).max(axis=-2) / 127.0).astype(np.float32)
    safe = np.where(s > 0, s, 1.0).astype(np.float32)
    q = np.clip(np.rint(blocks / safe[..., None, :]), -127, 127)
    q = q.astype(np.int8).reshape(wp.shape)[..., :k, :]
    return q, s


def _round(v, gen):
    """Round half to even (torch.round, as jnp.rint), or unbiased
    stochastic floor(v + u) with u ~ U[0, 1) from `gen`."""
    if gen is None:
        return torch.round(v)
    u = torch.rand(v.shape, generator=gen, device=v.device,
                   dtype=torch.float32)
    return torch.floor(v + u)


def quantize_kernel_int8(w, block, gen=None, values_dtype=torch.int8):
    """Traced twin of `quantize_kernel_int8_np`: [.., K, N] -> (q
    [.., nb*block, N] in `values_dtype`, scales fp32 [.., nb, N]). K is
    really padded (the product contracts over nb*block rows) and the
    scales are the clamped ones the product uses (1 for an all-zero
    block, where `quantize_kernel_int8_np` keeps 0). Rounding to
    nearest, the values and the other scales are that function's bit
    for bit, on any device: the same fp32 max, division and
    round-half-to-even. The 127
    is a tensor on w's device: CUDA torch turns a division by a Python
    scalar into a product with its reciprocal, one rounding more, which
    moved some scales by an ulp on the card."""
    w = w.to(torch.float32)
    k, n = w.shape[-2], w.shape[-1]
    nb = -(-k // block)
    pad = nb * block - k
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
    blocks = w.reshape(w.shape[:-2] + (nb, block, n))
    s = blocks.abs().amax(dim=-2) / torch.full((), 127.0, device=w.device)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(_round(blocks / safe[..., None, :], gen), -127, 127)
    return q.to(values_dtype).reshape(w.shape), safe


def quantize_rows_int8(x, gen=None, values_dtype=torch.int8):
    """Per-row (per-token) activation quantization: [.., K] -> (q
    [.., K] in `values_dtype`, scales fp32 [.., 1])."""
    x = x.to(torch.float32)
    s = x.abs().amax(dim=-1, keepdim=True) / 127.0
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(_round(x / safe, gen), -127, 127)
    return q.to(values_dtype), safe


def dequantize_kernel(q, scales, block, k=None, dtype=torch.float32):
    """(q [.., K', N], scales [.., nb, N]) -> dequantized [.., k, N]
    (k defaults to K')."""
    kp = q.shape[-2]
    nb = scales.shape[-2]
    pad = nb * block - kp
    if pad > 0:
        q = F.pad(q, (0, 0, 0, pad))
    blocks = q.reshape(q.shape[:-2] + (nb, block, q.shape[-1]))
    deq = blocks.to(torch.float32) * scales[..., None, :]
    deq = deq.reshape(deq.shape[:-3] + (nb * block, deq.shape[-1]))
    return deq[..., :k if k is not None else kp, :].to(dtype)


# ----------------------------------------------------------------------
# the weight-only epilogue (int8 serving)
# ----------------------------------------------------------------------
def int8_matmul(x, q, scales, block, out_dtype):
    """The weight-only dequant-in-matmul epilogue, the JAX package's
    `int8_matmul`: x [.., K] @ int8 q [K or nb*block, N] with
    per-(block, column) scales [nb, N] -> [.., N] in out_dtype. K is
    padded to whole blocks; each block's partial product runs in
    out_dtype (one batched GEMM over the blocks), each partial is
    multiplied by its scale row and the partials are summed. Plain
    torch on every device: the int8 weights are cast to out_dtype a
    block batch at a time in every call (a 16-bit copy of the weight,
    written and read once more, where a weight-only GEMM kernel would
    widen in registers)."""
    k, n = x.shape[-1], q.shape[-1]
    nb = scales.shape[-2]
    kp = nb * block
    if kp != k:
        x = F.pad(x, (0, kp - k))
    if q.shape[-2] != kp:
        q = F.pad(q, (0, 0, 0, kp - q.shape[-2]))
    lead = x.shape[:-1]
    xb = x.reshape(-1, nb, block).to(out_dtype).transpose(0, 1)
    part = torch.bmm(xb, q.reshape(nb, block, n).to(out_dtype))
    out = (part * scales.to(out_dtype)[:, None, :]).sum(dim=0)
    return out.reshape(lead + (n,))


# ----------------------------------------------------------------------
# K6 and its plain twin
# ----------------------------------------------------------------------
def _qmm_plain(xq, wq, sx, sw, block, out_dtype):
    """The twin of K6 over G groups: xq [G, M, Kp] and wq [G, Kp, N]
    (integer values, any dtype), sx [G, M, 1], sw [G, nb, N] -> [G, M, N]
    in out_dtype. Each block's partial is an fp32 product of the
    integer-valued operands (exact: every partial sum is an integer
    below 2^24), scaled by its column scale and added in ascending block
    order; then the row scale and the cast. Separate torch ops, so no
    product and sum are fused: the kernel's __fmul_rn/__fadd_rn order."""
    nb = sw.shape[-2]
    xf = xq.to(torch.float32)
    wf = wq.to(torch.float32)
    acc = None
    for b in range(nb):
        ks = slice(b * block, (b + 1) * block)
        part = torch.matmul(xf[..., ks], wf[..., ks, :])
        term = part * sw[..., b:b + 1, :]
        acc = term if acc is None else acc + term
    return (acc * sx).to(out_dtype)


def _check_block(block):
    if block % _KERNEL_BLOCK_MULTIPLE:
        raise ValueError(
            f"quantized_compute block must be a multiple of 128 on the "
            f"kernel path (int8 tensor-core tiling), got {block}; CPU "
            f"tensors take any block")


def _qmm_launch(xq, wq, sx, sw, block, out_dtype):
    """K6 on CUDA tensors: xq [G, M, Kp] int8, wq [G, Kp, N] int8, sx
    [G, M, 1] and sw [G, nb, N] fp32 -> [G, M, N] in out_dtype. The
    kernel takes the weights transposed ([G, N, Kp], K contiguous: 8-bit
    wgmma reads both operands K-major), which costs one int8 copy of
    them, and sw rows of a multiple of 4 columns (its tensor map's
    16-byte stride), padded here where N is not."""
    _check_block(block)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"quantized_matmul kernel: int8 operands, got "
                        f"{xq.dtype} and {wq.dtype}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("quantized_matmul kernel: float32 scales")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"quantized_matmul kernel: output dtype {out_dtype} "
                        "not supported (float32, bfloat16 or float16)")
    g, m, kp = xq.shape
    n = wq.shape[-1]
    nb = kp // block
    if tuple(wq.shape) != (g, kp, n) or tuple(sx.shape) != (g, m, 1) or \
            tuple(sw.shape) != (g, nb, n) or kp != nb * block:
        raise ValueError(
            f"quantized_matmul kernel: shapes xq {tuple(xq.shape)}, wq "
            f"{tuple(wq.shape)}, sx {tuple(sx.shape)}, sw {tuple(sw.shape)} "
            f"do not fit block {block}")
    if any(t.device != xq.device for t in (wq, sx, sw)):
        raise ValueError("quantized_matmul kernel: operands on different "
                         "devices")
    wqt = wq.transpose(1, 2).contiguous()
    sw = F.pad(sw, (0, -n % 4))
    return _qmm_kernel(xq.contiguous(), wqt, sx.contiguous(),
                       sw.contiguous(), block, out_dtype)


def _qmm_kernel(xq, wqt, sx, sw, block, out_dtype):
    """The K6 launch on operands in its layouts (`_qmm_launch` checks
    and makes them): xq [G, M, Kp] and wqt [G, N, Kp] int8, sx [G, M, 1]
    and sw [G, nb, N rounded up to 4] fp32, all contiguous."""
    from deepspeed_tpu_torch.ops import _build
    if xq.data_ptr() % 16 or wqt.data_ptr() % 16 or sw.data_ptr() % 16:
        raise ValueError("quantized_matmul kernel: operands must be "
                         "16-byte aligned")
    g, m, kp = xq.shape
    n = wqt.shape[1]
    out = torch.empty((g, m, n), dtype=out_dtype, device=xq.device)
    fn = _build.function("quantized_matmul", "ds_quantized_matmul",
                         _QMM_ARGTYPES)
    err = fn(xq.data_ptr(), wqt.data_ptr(), sx.data_ptr(), sw.data_ptr(),
             out.data_ptr(), g, m, n, kp, block, sw.shape[-1],
             _DTYPE_CODE[out_dtype], xq.device.index or 0,
             _build.stream_ptr(xq))
    _build.check(err, "quantized_matmul kernel")
    quantized_matmul.launches += 1
    return out


def _qmm(xq, wq, sx, sw, block, out_dtype):
    """K6 for CUDA tensors, its twin for CPU tensors (grouped shapes)."""
    if xq.is_cuda:
        return _qmm_launch(xq, wq, sx, sw, block, out_dtype)
    return _qmm_plain(xq, wq, sx, sw, block, out_dtype)


def quantized_matmul(x, wq, sw, *, block, out_dtype=None, x_gen=None):
    """x [.., K] (any float dtype) @ PRE-quantized weights (wq
    [nb*block or K, N] int8, any integer-valued dtype on the CPU; sw
    [nb, N]) -> [.., N] in out_dtype
    (default x.dtype). With grouped weights (wq [G, Kp, N], sw
    [G, nb, N]) x is [G, .., K] and group g multiplies x[g].

    Quantizes x per row on the fly (stochastically when `x_gen` is a
    torch.Generator), pads K to nb*block and runs K6 (CUDA) or its twin
    (CPU)."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    grouped = wq.dim() == 3
    k, n = x.shape[-1], wq.shape[-1]
    nb = sw.shape[-2]
    kp = nb * block
    lead = x.shape[:-1]
    if not grouped:
        wq, sw = wq[None], sw[None]
    x3 = x.reshape(wq.shape[0], -1, k)
    xq, sx = quantize_rows_int8(x3, gen=x_gen)
    if kp != k:
        xq = F.pad(xq, (0, kp - k))
    if wq.shape[-2] != kp:
        wq = F.pad(wq, (0, 0, 0, kp - wq.shape[-2]))
    out = _qmm(xq, wq, sx, sw, block, out_dtype)
    return out.reshape(lead + (n,))


quantized_matmul.launches = 0


def reset_launch_count():
    """Zero K6's launch counter."""
    quantized_matmul.launches = 0


# ----------------------------------------------------------------------
# the straight-through training entry point
# ----------------------------------------------------------------------
def _dw(x, g, dtype):
    """dW = x^T g over the rows (grouped: per group), JAX's
    einsum(x.f32, g.f32).astype(w.dtype). bf16 or fp16 operands (both of
    one type) on CUDA take one 16-bit GEMM with an fp32 output: the fp32
    casts of bf16 and fp16 values are exact, so the products are JAX's
    and only the summation order differs (a true fp32 GEMM over every
    projection would cost ~0.5 s a step at gpt2-1.5b). Everything else
    runs the fp32 GEMM."""
    xt = x.transpose(-1, -2)
    if x.is_cuda and x.dtype == g.dtype and \
            x.dtype in (torch.bfloat16, torch.float16):
        mm = torch.bmm if x.dim() == 3 else torch.mm
        return mm(xt, g, out_dtype=torch.float32).to(dtype)
    return torch.matmul(xt.to(torch.float32),
                        g.to(torch.float32)).to(dtype)


class _QuantizedDense(torch.autograd.Function):
    """y = x_q @ W_q (K6), straight-through backward (the JAX package's
    `_qdense` custom VJP). Saves the raw x and w and the seed; the
    backward re-quantizes w with the forward's noise."""

    @staticmethod
    def forward(ctx, x, w, block, out_dtype, seed):
        wq, sw = quantize_kernel_int8(w, block,
                                      gen=stream_generator(seed, 0, w.device))
        y = quantized_matmul(x, wq, sw, block=block, out_dtype=out_dtype,
                             x_gen=stream_generator(seed, 1, x.device))
        ctx.save_for_backward(x, w)
        ctx.block, ctx.seed = block, seed
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        wq, sw = quantize_kernel_int8(
            w, ctx.block, gen=stream_generator(ctx.seed, 0, w.device),
            values_dtype=torch.float32)
        w_eff = dequantize_kernel(wq, sw, ctx.block, k=w.shape[-2],
                                  dtype=x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g.to(x.dtype), w_eff.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            k, n = w.shape[-2], w.shape[-1]
            lead = (w.shape[0],) if w.dim() == 3 else ()
            dw = _dw(x.reshape(lead + (-1, k)), g.reshape(lead + (-1, n)),
                     w.dtype)
        return dx, dw, None, None, None


def quantized_dense(x, kernel, *, block=DEFAULT_QUANT_BLOCK, out_dtype=None,
                    stochastic_rounding=False, seed=None):
    """y = x @ kernel with the int8 quantized-compute forward and a
    straight-through backward: the training entry point.

    kernel [K, N] (or [G, K, N] with x [G, .., K], the experts) is
    quantized per (K-block, column) in every call, x per row. CUDA
    tensors run K6, whose `block` must be a multiple of 128; CPU tensors
    take any positive block. With `stochastic_rounding` and an int
    `seed`, both quantizations round stochastically from the seed's
    streams; without a seed, to nearest."""
    if block <= 0:
        raise ValueError(f"quantized_compute block must be > 0, got {block}")
    if x.is_cuda:
        _check_block(block)
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    seed = seed if stochastic_rounding else None
    return _QuantizedDense.apply(x, kernel, int(block), out_dtype, seed)


def bf16_fallback_matmul(x, kernel, *, out_dtype=None,
                         stochastic_rounding=False, gen=None):
    """The fallback when quantized compute resolves off: a plain
    compute-dtype GEMM, bit for bit the unquantized projection, unless
    `stochastic_rounding` is on, a generator is given and the compute
    dtype is bf16: then the fp32 -> bf16 operand casts round
    stochastically (bf16_optimizer.stochastic_round_bf16, x first, then
    the kernel, from the one generator)."""
    from deepspeed_tpu_torch.runtime.bf16_optimizer import \
        stochastic_round_bf16
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if stochastic_rounding and gen is not None and \
            out_dtype == torch.bfloat16:
        x = stochastic_round_bf16(x.to(torch.float32), gen)
        kernel = stochastic_round_bf16(kernel.to(torch.float32), gen)
    return torch.matmul(x.to(out_dtype), kernel.to(out_dtype))
