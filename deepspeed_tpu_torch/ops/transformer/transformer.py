"""Parameter modules of the GPT-2 block (port of
deepspeed_tpu/ops/transformer/transformer.py:35-147: SplitDense,
QuantizedDense, LNParams, plain_layernorm), plus the torch counterparts
of the two flax layers the JAX block applies directly (nn.Dense and
nn.LayerNorm).

Dense kernels keep flax's [in, out] layout (`x @ kernel`), so a JAX
parameter tree converts by a plain unstack (models/convert.py) and the
parity tests compare like with like. Parameters are created empty;
`GPT2ForCausalLM.init` or a converted tree fills them.
"""

import torch
from torch import nn

from deepspeed_tpu_torch.ops.transformer.quantized_matmul import (
    DEFAULT_QUANT_BLOCK, bf16_fallback_matmul, quantized_dense,
    resolve_quantized_compute)
from deepspeed_tpu_torch.utils.rng import stream_generator


class Dense(nn.Module):
    """flax nn.Dense(dtype=compute dtype): `x @ kernel + bias` with the
    input, kernel and bias cast to the compute dtype first."""

    def __init__(self, in_features, features, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            (in_features, features), dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty((features,),
                                             dtype=param_dtype))

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)


class SplitDense(Dense):
    """nn.Dense-compatible parameters that return `(x @ kernel, bias)`
    instead of adding the bias, so the bias rides a fused epilogue
    kernel (ops/transformer/fused_ops.py) with the residual/LayerNorm or
    GeLU that follows."""

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        return y, self.bias


class QuantizedDense(Dense):
    """Dense/SplitDense parameters (the same "kernel"/"bias", so a tree
    loads either way) whose product runs the int8 quantized-compute
    family (ops/transformer/quantized_matmul.py) when `mode` resolves on
    for the input's device: weights quantized per (K-block, column) in
    every call, activations per row, kernel K6 on CUDA, the
    straight-through backward in the compute dtype.

    When `mode` resolves off, the product is `bf16_fallback_matmul` (the
    JAX package's sr_fallback=True): with `stochastic_rounding` and a
    quant seed its bf16 operand casts round stochastically, otherwise it
    is bit for bit Dense/SplitDense. Stochastic rounding engages only
    when the caller passes a `quant_seed`; without one, rounding is to
    nearest. `split=True` returns `(x @ kernel, bias)` for the fused
    epilogues, as SplitDense does."""

    def __init__(self, in_features, features, dtype, param_dtype, *,
                 mode="on", block=DEFAULT_QUANT_BLOCK,
                 stochastic_rounding=False, split=False):
        super().__init__(in_features, features, dtype, param_dtype)
        resolve_quantized_compute(mode)   # ValueError on a bad mode
        self.mode, self.block = mode, int(block)
        self.stochastic_rounding = bool(stochastic_rounding)
        self.split = split

    def forward(self, x, quant_seed=None):
        x = x.to(self.dtype)
        seed = quant_seed if self.stochastic_rounding else None
        if resolve_quantized_compute(self.mode, x.device):
            y = quantized_dense(x, self.kernel, block=self.block,
                                out_dtype=self.dtype,
                                stochastic_rounding=self.stochastic_rounding,
                                seed=seed)
        else:
            y = bf16_fallback_matmul(
                x, self.kernel, out_dtype=self.dtype,
                stochastic_rounding=self.stochastic_rounding,
                gen=stream_generator(seed, 0, x.device))
        if self.split:
            return y, self.bias
        return y + self.bias.to(self.dtype)


class LNParams(nn.Module):
    """LayerNorm "scale"/"bias" parameters without applying the norm:
    the fused bias+residual+LayerNorm kernel applies it."""

    def __init__(self, features, param_dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty((features,),
                                              dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty((features,),
                                             dtype=param_dtype))

    def forward(self):
        return self.scale, self.bias


class LayerNorm(LNParams):
    """flax nn.LayerNorm(dtype=float32) numerics: fp32 statistics with
    the fast-variance formula, `(x - mean) * (rsqrt(var + eps) * scale)
    + bias` in flax's association."""

    def __init__(self, features, param_dtype, eps):
        super().__init__(features, param_dtype)
        self.eps = eps

    def forward(self, x):
        x32 = x.to(torch.float32)
        mu = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) -
                          mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.to(torch.float32)
        return (x32 - mu) * mul + self.bias.to(torch.float32)


def plain_layernorm(x, scale, bias, eps):
    """flax nn.LayerNorm(dtype=fp32) numerics off raw scale/bias params
    (fast-variance formula, variance clamped >= 0), for the LN
    applications the fused chain does not cover (the first block's
    leading norm when no boundary is carried). Same formula as
    fused_ops._ln_stats."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    return (x32 - mu) * torch.rsqrt(var + eps) * \
        scale.to(torch.float32) + bias.to(torch.float32)
