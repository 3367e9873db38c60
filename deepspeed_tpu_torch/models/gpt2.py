"""GPT-2 family, inference forward (port of deepspeed_tpu/models/gpt2.py).

The JAX model scans one block over a stacked [n_layer, ...] parameter
tree; here the stack is an `nn.ModuleList` walked by a Python loop.
The block keeps both phrasings of the JAX block:

* fused (the path the JAX package runs on its accelerator, and this
  port's on CUDA): c_proj bias + residual + ln_2 as one launch of
  kernel K3, c_fc bias + tanh-GeLU as one launch of kernel K4, and the
  layer boundary carried as (residual_stream, (mlp_y, mlp_b)) so that
  each boundary's mlp_c_proj bias + residual + next ln_1 (and, after
  the last block, ln_f) is one more launch of K3;
* unfused (nn.LayerNorm / nn.Dense / gelu op by op), the CPU default.

Attention takes flash (kernel K1) exactly where the JAX package does
(`flash_attention_usable`), and dense attention elsewhere.

Parameters keep flax's names and layouts, flattened: "wte", "wpe",
"h.{i}.{c_attn,c_proj,c_fc,mlp_c_proj}.{kernel,bias}" with [in, out]
kernels, "h.{i}.{ln_1,ln_2}.{scale,bias}", "ln_f.{scale,bias}".
`models/convert.py` turns a JAX tree into this form.

Out of this slice (each raises NotImplementedError naming its slice):
training (losses, dropout, remat's recompute, progressive layer drop),
mixture-of-experts, int8 quantized compute, sequence parallelism.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    dense_attention, flash_attention, flash_attention_usable)
from deepspeed_tpu_torch.ops.transformer.fused_ops import (
    fused_bias_gelu, fused_bias_residual_layernorm, resolve_fused_ops)
from deepspeed_tpu_torch.ops.transformer.transformer import (
    Dense, LayerNorm, SplitDense, plain_layernorm)
from deepspeed_tpu_torch.utils.device import resolve_device

TRAINING_SLICE = "the training slice (slice 2 of the port)"


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.1
    layer_norm_epsilon: float = 1e-5
    dtype: Any = torch.bfloat16      # compute dtype
    param_dtype: Any = torch.float32  # storage dtype of parameters
    # remat recomputes activations in the backward; the forward of this
    # slice computes the same values with it on or off
    remat: bool = True
    remat_policy: Optional[str] = None
    attention_impl: str = "auto"    # auto | pallas (the kernel) | xla
    attention_head_packing: str = "auto"
    fused_ops: str = "auto"
    quantized_compute: str = "off"
    quant_block: int = 128
    quant_stochastic_rounding: bool = False
    sequence_parallel: Optional[str] = None
    sp_mesh: Any = None
    sp_axis: str = "model"
    moe: Any = None
    initializer_range: float = 0.02

    @property
    def head_dim(self):
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} is no multiple of "
                             f"n_head {self.n_head}")
        return self.n_embd // self.n_head


GPT2_SIZES = {
    "gpt2-tiny": dict(n_layer=2, n_embd=64, n_head=4, vocab_size=512,
                      n_positions=128),
    "gpt2-125m": dict(n_layer=12, n_embd=768, n_head=12),
    "gpt2-350m": dict(n_layer=24, n_embd=1024, n_head=16),
    "gpt2-760m": dict(n_layer=24, n_embd=1536, n_head=16),
    "gpt2-1.5b": dict(n_layer=48, n_embd=1600, n_head=25),
    "gpt2-2.7b": dict(n_layer=32, n_embd=2560, n_head=32),
    "gpt2-6.7b": dict(n_layer=32, n_embd=4096, n_head=32),
    "gpt2-13b": dict(n_layer=40, n_embd=5120, n_head=40),
}


def gpt2_config(name="gpt2-125m", **overrides) -> GPT2Config:
    base = dict(GPT2_SIZES[name])
    base.update(overrides)
    return GPT2Config(**base)


def tiny_gpt2_config(**overrides):
    """Small config for tests (the JAX package's tiny_gpt2_config)."""
    base = dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2,
                n_head=4, dropout=0.0, dtype=torch.float32, remat=False)
    base.update(overrides)
    return GPT2Config(**base)


def check_supported(cfg: GPT2Config):
    """Raise for the options whose code paths are later slices."""
    if cfg.moe is not None:
        raise NotImplementedError(
            "mixture-of-experts GPT-2 is ported in the MoE slice")
    if cfg.quantized_compute not in ("off", False, 0, None):
        raise NotImplementedError(
            "int8 quantized compute (kernel K6) is ported in the "
            "quantized-compute slice")
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "sequence parallelism (ring/ulysses, kernel K5) is ported in "
            "the sequence-parallel slice")
    if cfg.attention_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"attention_impl={cfg.attention_impl!r}: "
                         "expected 'auto', 'pallas' or 'xla'")


def _attention(cfg, q, k, v):
    """Causal attention over [B, T, H, D]: flash (kernel K1 on CUDA, its
    plain twin on the CPU) where usable, dense attention elsewhere;
    attention_impl="pallas" insists on flash, "xla" on dense."""
    if cfg.attention_impl in ("pallas", "auto"):
        if flash_attention_usable(q, True):
            return flash_attention(q, k, v, causal=True,
                                   head_packing=cfg.attention_head_packing)
        if cfg.attention_impl == "pallas":
            raise RuntimeError("flash attention requested but unusable "
                               "for these shapes/settings")
    return dense_attention(q, k, v, causal=True)


def embed_tokens(cfg: GPT2Config, wte, wpe, input_ids):
    """Token + position embedding in the compute dtype."""
    t = input_ids.shape[1]
    return wte[input_ids].to(cfg.dtype) + wpe[:t][None].to(cfg.dtype)


def stacked_block_params(params, n_layer):
    """The per-layer parameter dicts of a flat parameter dict:
    [{"c_attn.kernel": ..., "ln_1.scale": ..., ...}] * n_layer, the
    port's counterpart of the JAX stacked [n_layer, ...] subtree."""
    layers = [{} for _ in range(n_layer)]
    for name, value in params.items():
        if name.startswith("h."):
            _, idx, leaf = name.split(".", 2)
            layers[int(idx)][leaf] = value
    return layers


class GPT2Block(nn.Module):
    """Pre-LN transformer block (attention + MLP), inference forward.

    Boundary contract (as in the JAX block): with
    `boundary=(prev_mlp_y, prev_mlp_b)` the true hidden state is
    `hidden + prev_mlp_y + prev_mlp_b`, folded into this block's ln_1
    by one fused launch; with `return_boundary=True` the block returns
    `(residual_stream, (mlp_y, mlp_b))` and leaves its trailing add to
    the next block (or the model's fused ln_f). Both need the fused
    path."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        cfg = config
        self.config = cfg
        c, pd = cfg.n_embd, cfg.param_dtype
        eps = cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(c, pd, eps)
        self.c_attn = Dense(c, 3 * c, cfg.dtype, pd)
        self.c_proj = SplitDense(c, c, cfg.dtype, pd)
        self.ln_2 = LayerNorm(c, pd, eps)
        self.c_fc = SplitDense(c, 4 * c, cfg.dtype, pd)
        self.mlp_c_proj = SplitDense(4 * c, c, cfg.dtype, pd)

    def forward(self, hidden, boundary=None, return_boundary=False):
        cfg = self.config
        b, t, c = hidden.shape
        h, d = cfg.n_head, cfg.head_dim
        eps = cfg.layer_norm_epsilon
        use_fused = resolve_fused_ops(cfg.fused_ops, True, hidden.device)
        if (boundary is not None or return_boundary) and not use_fused:
            raise ValueError(
                "GPT2Block boundary fusion requires the fused-ops path "
                "(resolve_fused_ops must be active)")
        sum_dtype = torch.promote_types(hidden.dtype, cfg.dtype)

        # --- attention ---
        if use_fused and boundary is not None:
            prev_y, prev_b = boundary
            x, hidden = fused_bias_residual_layernorm(
                prev_y, prev_b, hidden, self.ln_1.scale, self.ln_1.bias,
                eps=eps, out_dtype=cfg.dtype, sum_dtype=sum_dtype)
        elif use_fused:
            x = plain_layernorm(hidden, self.ln_1.scale, self.ln_1.bias,
                                eps).to(cfg.dtype)
        else:
            x = self.ln_1(hidden).to(cfg.dtype)
        qkv = self.c_attn(x)
        # column slices of qkv, viewed [B, T, H, D] in place (no copy)
        q, k, v = (part.view(b, t, h, d) for part in qkv.split(c, dim=-1))
        attn = _attention(cfg, q, k, v).reshape(b, t, c)
        attn_y, attn_b = self.c_proj(attn)
        if use_fused:
            # one launch: c_proj bias + residual + ln_2
            y, hidden = fused_bias_residual_layernorm(
                attn_y, attn_b, hidden, self.ln_2.scale, self.ln_2.bias,
                eps=eps, out_dtype=cfg.dtype, sum_dtype=sum_dtype)
            fc_y, fc_b = self.c_fc(y)
            # one launch: c_fc bias + tanh GeLU (GPT-2's approximation)
            y = fused_bias_gelu(fc_y, fc_b, approximate=True,
                                out_dtype=cfg.dtype)
            mlp_y, mlp_b = self.mlp_c_proj(y)
            if return_boundary:
                return hidden, (mlp_y, mlp_b)
            return hidden + (mlp_y + mlp_b.to(cfg.dtype))
        hidden = hidden + (attn_y + attn_b.to(cfg.dtype))
        y = self.ln_2(hidden).to(cfg.dtype)
        fc_y, fc_b = self.c_fc(y)
        y = nn.functional.gelu(fc_y + fc_b.to(cfg.dtype),
                               approximate="tanh")
        mlp_y, mlp_b = self.mlp_c_proj(y)
        return hidden + (mlp_y + mlp_b.to(cfg.dtype))


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with the tied-embedding LM head; returns logits in the
    compute dtype."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        cfg = config
        self.config = cfg
        pd = cfg.param_dtype
        self.wte = nn.Parameter(torch.empty((cfg.vocab_size, cfg.n_embd),
                                            dtype=pd))
        self.wpe = nn.Parameter(torch.empty((cfg.n_positions, cfg.n_embd),
                                            dtype=pd))
        self.h = nn.ModuleList(GPT2Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, pd, cfg.layer_norm_epsilon)

    def forward(self, input_ids):
        cfg = self.config
        hidden = embed_tokens(cfg, self.wte, self.wpe, input_ids)
        if resolve_fused_ops(cfg.fused_ops, True, hidden.device):
            # boundary fusion: the zero first boundary's bias takes
            # wte's dtype, as in the JAX model's carry0
            prev = (torch.zeros(hidden.shape, dtype=cfg.dtype,
                                device=hidden.device),
                    torch.zeros((cfg.n_embd,), dtype=self.wte.dtype,
                                device=hidden.device))
            for block in self.h:
                hidden, prev = block(hidden, prev, True)
            hidden = fused_bias_residual_layernorm(
                prev[0], prev[1], hidden, self.ln_f.scale, self.ln_f.bias,
                eps=cfg.layer_norm_epsilon, out_dtype=torch.float32,
                return_sum=False)
        else:
            for block in self.h:
                hidden = block(hidden)
            hidden = self.ln_f(hidden)
        return torch.matmul(hidden.to(cfg.dtype),
                            self.wte.to(cfg.dtype).t())


def _init_std(cfg, name):
    """Per-leaf init std of the JAX model (None = constant init)."""
    leaf = name.rsplit(".", 1)[-1]
    if name in ("wte", "wpe"):
        return cfg.initializer_range
    if leaf == "kernel":
        if ".c_proj." in name or ".mlp_c_proj." in name:
            # GPT-2's residual-scaling trick: proj init scaled by depth
            return cfg.initializer_range / np.sqrt(2 * cfg.n_layer)
        return cfg.initializer_range
    return None


class GPT2ForCausalLM:
    """Entry point: `init(seed)` -> params, `apply(params, input_ids)`
    -> logits [B, T, vocab], as in the JAX package. Parameters live on
    `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, config: GPT2Config, device="cuda"):
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.module = GPT2LMHeadModel(config)
        self.module.eval()

    def init(self, seed=0):
        """Fill the parameters from `seed` with the JAX model's
        per-leaf init (normal(std) kernels and embeddings, zero biases,
        unit LayerNorm scales). The draws are torch's, not JAX's: the
        two packages give different weights from one seed. Returns the
        parameter dict."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.module.named_parameters():
                std = _init_std(self.config, name)
                if std is not None:
                    p.normal_(0.0, std, generator=gen)
                elif name.endswith(".scale"):
                    p.fill_(1.0)
                else:
                    p.zero_()
        return self.params()

    def params(self):
        """{name: tensor} views of the module's parameters."""
        return {name: p.detach()
                for name, p in self.module.named_parameters()}

    def load_params(self, params):
        """Copy a flat parameter dict (e.g. from
        models.convert.params_from_jax) into the module."""
        own = dict(self.module.named_parameters())
        missing = set(own) - set(params)
        extra = set(params) - set(own)
        if missing or extra:
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(missing)[:5]}, extra "
                           f"{sorted(extra)[:5]}")
        with torch.no_grad():
            for name, p in own.items():
                src = torch.as_tensor(params[name])
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} "
                                     f"!= {tuple(p.shape)}")
                p.copy_(src)
        return self.params()

    def apply(self, params, input_ids, deterministic=True,
              layer_keep_prob=None):
        """Logits [B, T, vocab] (compute dtype) of `input_ids` [B, T]
        under `params` (a flat parameter dict, e.g. from `init`)."""
        if not deterministic:
            raise NotImplementedError(
                f"dropout (deterministic=False) comes with {TRAINING_SLICE}")
        if layer_keep_prob is not None:
            raise NotImplementedError(
                f"progressive layer drop comes with {TRAINING_SLICE}")
        ids = torch.as_tensor(np.asarray(input_ids) if not
                              isinstance(input_ids, torch.Tensor)
                              else input_ids)
        ids = ids.to(device=self.device, dtype=torch.long)
        with torch.no_grad():
            return torch.func.functional_call(self.module, params, (ids,))

    def loss_fn(self, params, batch, rngs=None, deterministic=False,
                layer_keep_prob=None, return_router_stats=False):
        raise NotImplementedError(
            f"losses, remat and the backward come with {TRAINING_SLICE}")
