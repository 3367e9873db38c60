"""The fused BERT-style transformer layer and its parameter modules
(port of deepspeed_tpu/ops/transformer/transformer.py).

The parameter modules (SplitDense, QuantizedDense, LNParams,
plain_layernorm), the torch counterparts of the two flax layers the JAX
blocks apply directly (nn.Dense and nn.LayerNorm), and the block helpers
(`projection`, `project`, `run_block`, `init_params`) serve the GPT-2
block and this layer alike.

`DeepSpeedTransformerLayer(config)` is the drop-in encoder layer: one
`core` (`_TransformerLayerCore`) holding the QKV projection as one
[H, 3H] kernel (`attn_qkvw`), the output projection (`attn_ow`), the
attention LayerNorm (`attn_layer_norm`), the MLP (`inter_w`, exact-erf
GeLU, `output_w`) and the output LayerNorm (`layer_norm`), pre-LN or
post-LN. On the fused path (`fused_ops`: "auto" = on CUDA when hidden
dropout is inactive) each bias + residual + LayerNorm is one launch of
kernel K3 and the intermediate bias + GeLU one launch of K4; attention
takes flash (K1, backward K2), non-causal, when there is no mask and no
attention dropout and `flash_attention_usable` holds, else
`dense_attention` with the additive [B, 1, 1, T] mask and attention
dropout. Hidden dropout runs on the unfused path, as in JAX.

The memory flags (`normalize_invertible`, `gelu_checkpoint`,
`attn_dropout_checkpoint`) run the core under remat: on the fused path
per fusion, as the JAX layer does (the `save_fused_epilogues` policy
keeps K3's and K4's named outputs, so the recompute launches no K3-fwd
and skips the GEMMs that only feed it; the layer's flash outputs carry no
names in the JAX layer, so K1-fwd runs again, as there), else the whole
block is recomputed. The values are the same either way.
`stochastic_mode` is accepted and ignored, as in JAX. fp16
(`fp16=True`) runs K1-K4 in their fp16 forms, and the quantized
projections K6 with an fp16 output.

Dense kernels keep flax's [in, out] layout (`x @ kernel`), so a JAX
parameter tree converts by a plain unstack (models/convert.py) and the
parity tests compare like with like. Parameters are created empty; a
model's `init`, `DeepSpeedTransformerLayer.init_params` or a converted
tree fills them.
"""

import contextlib
import inspect

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    dense_attention, dropout, flash_attention, flash_attention_usable)
from deepspeed_tpu_torch.ops.transformer.fused_ops import (
    FUSED_LN_OUT, FUSED_LN_SUM, fused_bias_gelu,
    fused_bias_residual_layernorm, resolve_fused_ops)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import dead_gemms, remat
from deepspeed_tpu_torch.ops.transformer.quantized_matmul import (
    DEFAULT_QUANT_BLOCK, bf16_fallback_matmul, quantized_dense,
    resolve_quantized_compute)
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.rng import stream_generator, stream_seed

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


class DeepSpeedTransformerConfig:
    """The layer's configuration, field for field the JAX package's (and
    the reference's `ops/transformer/transformer.py:39-154`). `bf16`
    selects bf16 compute; `fused_ops` and `quantized_compute` are
    "auto" | "on" | "off", "auto" keyed to CUDA as in the port's
    `resolve_fused_ops` / `resolve_quantized_compute`; `head_packing` is
    validated and selects nothing on this device (one kernel serves
    packed and unpacked heads)."""

    def __init__(self,
                 batch_size=-1,
                 max_seq_length=-1,
                 hidden_size=-1,
                 intermediate_size=-1,
                 heads=-1,
                 attn_dropout_ratio=-1,
                 hidden_dropout_ratio=-1,
                 num_hidden_layers=-1,
                 initializer_range=-1,
                 local_rank=-1,
                 seed=-1,
                 fp16=False,
                 pre_layer_norm=True,
                 normalize_invertible=False,
                 gelu_checkpoint=False,
                 adjust_init_range=True,
                 attn_dropout_checkpoint=False,
                 stochastic_mode=False,
                 huggingface=False,
                 training=True,
                 bf16=False,
                 layer_norm_eps=1e-12,
                 head_packing="auto",
                 fused_ops="auto",
                 quantized_compute="off",
                 quant_block=128,
                 quant_stochastic_rounding=False):
        self.batch_size = batch_size
        self.max_seq_length = max_seq_length
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size if intermediate_size > 0 \
            else 4 * hidden_size
        self.heads = heads
        self.attn_dropout_ratio = max(attn_dropout_ratio, 0)
        self.hidden_dropout_ratio = max(hidden_dropout_ratio, 0)
        self.num_hidden_layers = num_hidden_layers
        self.initializer_range = initializer_range if initializer_range > 0 \
            else 0.02
        self.local_rank = local_rank
        self.seed = seed
        self.fp16 = fp16
        self.pre_layer_norm = pre_layer_norm
        self.normalize_invertible = normalize_invertible
        self.gelu_checkpoint = gelu_checkpoint
        self.adjust_init_range = adjust_init_range
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.stochastic_mode = stochastic_mode
        self.huggingface = huggingface
        self.training = training
        self.bf16 = bf16
        self.layer_norm_eps = layer_norm_eps
        self.head_packing = head_packing
        self.fused_ops = fused_ops
        self.quantized_compute = quantized_compute
        self.quant_block = quant_block
        self.quant_stochastic_rounding = quant_stochastic_rounding

    @classmethod
    def from_dict(cls, json_object):
        known = set(inspect.signature(cls.__init__).parameters) - {"self"}
        config = cls(**{k: v for k, v in json_object.items() if k in known})
        for key, value in json_object.items():
            if key not in known:
                setattr(config, key, value)
        return config

    @property
    def any_checkpointing(self):
        return (self.normalize_invertible or self.gelu_checkpoint or
                self.attn_dropout_checkpoint)

    @property
    def compute_dtype(self):
        """fp16 with `fp16`, bf16 with `bf16`, else fp32 (the JAX
        layer's order)."""
        if self.fp16:
            return torch.float16
        return torch.bfloat16 if self.bf16 else torch.float32


def projection(in_features, features, dtype, param_dtype, mode="off",
               block=DEFAULT_QUANT_BLOCK, stochastic_rounding=False,
               split=False):
    """A block projection: Dense (SplitDense with `split`), or
    QuantizedDense when quantized compute `mode` is configured (it
    resolves "auto" per call, on the input's device; resolved off, it is
    the JAX package's sr_fallback: a plain GEMM whose bf16 operand casts
    round stochastically when `stochastic_rounding` and a quant seed are
    given). The parameters are the same either way."""
    if mode != "auto" and not resolve_quantized_compute(mode):
        return (SplitDense if split else Dense)(in_features, features,
                                                dtype, param_dtype)
    return QuantizedDense(in_features, features, dtype, param_dtype,
                          mode=mode, block=block,
                          stochastic_rounding=stochastic_rounding,
                          split=split)


def project(proj, x, seed, index):
    """`proj(x)`; a QuantizedDense also takes stream `index` of the
    block's quant `seed` for its stochastic rounding."""
    if isinstance(proj, QuantizedDense):
        return proj(x, stream_seed(seed, index))
    return proj(x)


def _block_call(block, params, *args):
    return torch.func.functional_call(block, params, args)


def run_block(block, rematerialize, *args, policy=None):
    """One block, under remat when `rematerialize`: the block's inputs
    and what the remat `policy` names are kept (None: nothing more, the
    full-block remat), the rest recomputed in the backward
    (`activation_checkpointing.checkpointing.remat`). The block's
    parameters are passed explicitly, so the recompute reads the same
    tensors as the forward even when the caller swapped them in
    (functional_call)."""
    if not rematerialize:
        return block(*args)
    return remat(_block_call, block, dict(block.named_parameters()), *args,
                 policy=policy)


def epilogue_gemms(use_fused):
    """Context for a GEMM whose output feeds only a K3 launch
    (bias + residual + LayerNorm): on the fused path, `dead_gemms` of
    K3's named outputs (a recompute that keeps them skips the GEMM)."""
    if use_fused:
        return dead_gemms((FUSED_LN_OUT, FUSED_LN_SUM))
    return contextlib.nullcontext()


class _TransformerLayerCore(nn.Module):
    """The block body (a module of its own so the memory flags can
    recompute it whole). Projection j (attn_qkvw 0, attn_ow 1, inter_w 2,
    output_w 3) rounds stochastically from stream j of `quant_seed`;
    dropout draws from stream 0 of `dropout_seed`, so a recompute draws
    the forward's masks again."""

    def __init__(self, config: DeepSpeedTransformerConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = cfg.compute_dtype
        h, inter = cfg.hidden_size, cfg.intermediate_size
        eps = cfg.layer_norm_eps

        def split_dense(in_features, features):
            # every projection returns (x @ kernel, bias): the bias rides
            # a fused epilogue, or `_dense` adds it
            return projection(in_features, features, self.dtype,
                              torch.float32, cfg.quantized_compute,
                              cfg.quant_block, cfg.quant_stochastic_rounding,
                              split=True)

        self.attn_qkvw = split_dense(h, 3 * h)
        self.attn_ow = split_dense(h, h)
        self.attn_layer_norm = LayerNorm(h, torch.float32, eps)
        self.inter_w = split_dense(h, inter)
        self.output_w = split_dense(inter, h)
        self.layer_norm = LayerNorm(h, torch.float32, eps)

    def _dense(self, proj, x, quant_seed, index):
        """x @ kernel + bias in the compute dtype (flax nn.Dense)."""
        y, b = project(proj, x, quant_seed, index)
        return y + b.to(self.dtype)

    def forward(self, hidden_states, attention_mask=None,
                deterministic=True, dropout_seed=None, quant_seed=None):
        cfg = self.config
        dt = self.dtype
        eps = cfg.layer_norm_eps
        b, t, h = hidden_states.shape
        nh = cfg.heads
        hid_drop = not deterministic and cfg.hidden_dropout_ratio > 0.0
        attn_drop = not deterministic and cfg.attn_dropout_ratio > 0.0
        gen = None
        if hid_drop or attn_drop:
            if dropout_seed is None:
                raise ValueError(
                    "dropout is active (deterministic=False) but no "
                    "dropout seed was given")
            gen = stream_generator(dropout_seed, 0, hidden_states.device)
        # hidden dropout sits between the bias add and the residual, so
        # the fused chains need it inactive; attention dropout sits
        # inside the attention op and does not constrain them
        use_fused = resolve_fused_ops(
            cfg.fused_ops, deterministic or cfg.hidden_dropout_ratio == 0.0,
            hidden_states.device)
        ln_attn, ln_out = self.attn_layer_norm, self.layer_norm

        # ---- attention ----
        x = hidden_states
        if cfg.pre_layer_norm:
            attn_input = (plain_layernorm(x, ln_attn.scale, ln_attn.bias,
                                          eps)
                          if use_fused else ln_attn(x)).to(dt)
        else:
            attn_input = x.to(dt)
        qkv = self._dense(self.attn_qkvw, attn_input, quant_seed, 0)
        # column slices of qkv, viewed [B, T, H, D] in place
        q, k, v = (part.view(b, t, nh, h // nh)
                   for part in qkv.split(h, dim=-1))
        ctx = self._attention(q, k, v, attention_mask, attn_drop, gen)
        ctx = ctx.reshape(b, t, h)
        with epilogue_gemms(use_fused):
            attn_y, attn_b = project(self.attn_ow, ctx, quant_seed, 1)
        if use_fused:
            if cfg.pre_layer_norm:
                # one launch: attn_ow bias + residual + the MLP's pre-norm;
                # `x` carries on un-normalized
                mlp_input, x = fused_bias_residual_layernorm(
                    attn_y, attn_b, x, ln_out.scale, ln_out.bias, eps=eps,
                    out_dtype=dt, sum_dtype=torch.promote_types(x.dtype, dt))
            else:
                # post-LN: the normalized sum is the carry (no sum output,
                # so no sum cotangent reaches the backward kernel)
                x = fused_bias_residual_layernorm(
                    attn_y, attn_b, x, ln_attn.scale, ln_attn.bias, eps=eps,
                    out_dtype=torch.float32, return_sum=False)
                mlp_input = x.to(dt)
        else:
            attn_out = attn_y + attn_b.to(dt)
            if hid_drop:
                attn_out = dropout(attn_out, cfg.hidden_dropout_ratio, gen)
            x = x + attn_out
            if not cfg.pre_layer_norm:
                x = ln_attn(x)
            mlp_input = (ln_out(x) if cfg.pre_layer_norm else x).to(dt)

        # ---- MLP ----
        inter_y, inter_b = project(self.inter_w, mlp_input,
                                         quant_seed, 2)
        if use_fused:
            inter = fused_bias_gelu(inter_y, inter_b, approximate=False,
                                    out_dtype=dt)
            if cfg.pre_layer_norm:
                return x + self._dense(self.output_w, inter, quant_seed, 3)
            with epilogue_gemms(use_fused):
                mlp_y, mlp_b = project(self.output_w, inter, quant_seed, 3)
            return fused_bias_residual_layernorm(
                mlp_y, mlp_b, x, ln_out.scale, ln_out.bias, eps=eps,
                out_dtype=torch.float32, return_sum=False)
        inter = nn.functional.gelu(inter_y + inter_b.to(dt),
                                   approximate="none")
        mlp_out = self._dense(self.output_w, inter, quant_seed, 3)
        if hid_drop:
            mlp_out = dropout(mlp_out, cfg.hidden_dropout_ratio, gen)
        x = x + mlp_out
        if not cfg.pre_layer_norm:
            x = ln_out(x)
        return x

    def _attention(self, q, k, v, attention_mask, attn_drop, gen):
        """Non-causal flash attention (K1, backward K2) without a mask
        and without attention dropout where `flash_attention_usable`
        holds; else dense attention with the additive mask ([B, 1, 1, T]
        or [B, 1, T, T]) and the fp32 softmax, dropout on the
        probabilities."""
        cfg = self.config
        if attention_mask is None and not attn_drop and \
                flash_attention_usable(q, True):
            return flash_attention(q, k, v, causal=False,
                                   head_packing=cfg.head_packing)
        return dense_attention(q, k, v, mask=attention_mask,
                               dropout_rate=cfg.attn_dropout_ratio,
                               dropout_gen=gen if attn_drop else None)


class DeepSpeedTransformerLayer(nn.Module):
    """Drop-in layer: `layer(hidden_states, attention_mask)` ->
    hidden_states (the reference's `transformer.py:470-614`).
    `attention_mask` is additive, [B, 1, 1, T] (or [B, 1, T, T]);
    `deterministic` defaults to `not config.training`; `dropout_seed`
    (an int) seeds the dropout masks and `quant_seed` the quantized
    projections' stochastic rounding. The parameters are
    `core.{attn_qkvw,attn_ow,inter_w,output_w}.{kernel,bias}` ([in, out]
    kernels) and `core.{attn_layer_norm,layer_norm}.{scale,bias}`, all
    fp32, as the JAX layer's tree has them, on `device` ("cuda" unless
    the caller asks for the CPU). Under a memory flag and gradients, the
    core runs under remat: per fusion (`save_fused_epilogues`) on the
    fused path, as the JAX layer does, else the whole block."""

    def __init__(self, config: DeepSpeedTransformerConfig, device="cuda"):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.core = _TransformerLayerCore(config)

    def forward(self, hidden_states, attention_mask=None,
                deterministic=None, dropout_seed=None, quant_seed=None):
        cfg = self.config
        if deterministic is None:
            deterministic = not cfg.training
        policy = None
        if resolve_fused_ops(cfg.fused_ops,
                             deterministic or cfg.hidden_dropout_ratio == 0.0,
                             hidden_states.device):
            policy = "save_fused_epilogues"
        return run_block(self.core,
                         cfg.any_checkpointing and torch.is_grad_enabled(),
                         hidden_states, attention_mask, deterministic,
                         dropout_seed, quant_seed, policy=policy)

    def init_params(self, seed=0):
        """Fill the parameters from `seed` with the JAX layer's init:
        normal(initializer_range) for attn_qkvw and inter_w, the output
        projections' std scaled by 1/sqrt(2 * num_hidden_layers) under
        `adjust_init_range`, zero biases, unit LayerNorm scales. The
        draws are torch's, not JAX's. Returns the parameter dict."""
        init_params(self, seed, lambda n: layer_init_std(self.config, n),
                    self.core.attn_qkvw.kernel.device)
        return {n: p.detach() for n, p in self.named_parameters()}


def layer_init_std(cfg, name):
    """The JAX layer's init std of parameter `name` (None: a constant
    init, zero biases and unit scales)."""
    if not name.endswith(".kernel"):
        return None
    std = cfg.initializer_range
    if (".attn_ow." in name or ".output_w." in name) and \
            cfg.adjust_init_range and cfg.num_hidden_layers > 0:
        # output-projection init scaled down with depth (the reference's
        # "output std dev", transformer.py:477-489)
        std = cfg.initializer_range / np.sqrt(2.0 * cfg.num_hidden_layers)
    return std


# flax's lecun_normal: a normal truncated at 2 standard deviations whose
# variance is 1 / fan_in; this is the std of the untruncated normal
_TRUNC_STD = 0.87962566103423978


def init_params(module, seed, init_std, device):
    """Fill every parameter of `module` from `seed`: `init_std(name)` is
    a float (normal(0, std)), "lecun" (flax's lecun_normal over the
    kernel's [in, out] layout) or None (unit LayerNorm scales, zero
    elsewhere). The draws are torch's, from a generator on `device`, not
    JAX's: the two packages give different weights from one seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            std = init_std(name)
            if std == "lecun":
                s = float(np.sqrt(1.0 / p.shape[0])) / _TRUNC_STD
                nn.init.trunc_normal_(p, 0.0, s, -2.0 * s, 2.0 * s,
                                      generator=gen)
            elif std is not None:
                p.normal_(0.0, std, generator=gen)
            elif name.endswith(".scale"):
                p.fill_(1.0)
            else:
                p.zero_()
