"""GPT-2 family: forward and causal-LM loss (port of
deepspeed_tpu/models/gpt2.py).

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

Attention takes flash (kernel K1, backward K2) exactly where the JAX
package does (`flash_attention_usable`), and dense attention elsewhere.

Training (`loss_fn`) adds what the JAX scan cell does around the block:
full-block remat (`remat=True`, `remat_policy=None`) through
`torch.utils.checkpoint` over each block, carrying the boundary tuple;
dropout on the embedding, the attention probabilities and both
projections (the unfused path, as in JAX), drawn from per-layer
`torch.Generator`s seeded from `rngs["dropout"]`, so a block's
recompute draws the same masks; and the chunked tied-head
cross-entropy, whose [B, T, vocab] logits never exist.

Parameters keep flax's names and layouts, flattened: "wte", "wpe",
"h.{i}.{c_attn,c_proj,c_fc,mlp_c_proj}.{kernel,bias}" with [in, out]
kernels, "h.{i}.{ln_1,ln_2}.{scale,bias}", "ln_f.{scale,bias}".
`models/convert.py` turns a JAX tree into this form.

Out of this slice (each raises NotImplementedError naming its slice):
named remat policies, progressive layer drop, mixture-of-experts, int8
quantized compute, sequence parallelism.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    dense_attention, dropout, flash_attention, flash_attention_usable)
from deepspeed_tpu_torch.ops.transformer.fused_ops import (
    fused_bias_gelu, fused_bias_residual_layernorm, resolve_fused_ops)
from deepspeed_tpu_torch.ops.transformer.transformer import (
    Dense, LayerNorm, SplitDense, plain_layernorm)
from deepspeed_tpu_torch.utils.device import resolve_device

REMAT_POLICY_SLICE = ("named remat policies (the save_fused_epilogues "
                      "and save_only_these_names forms) come with the "
                      "memory slice of the port (ROADMAP Queue 1 item 5)")
PLD_SLICE = ("progressive layer drop comes with the remainder slice of "
             "the port (ROADMAP Queue 1 item 10)")


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


def _attention(cfg, q, k, v, dropout_gen=None):
    """Causal attention over [B, T, H, D]: flash (kernel K1 on CUDA, its
    plain twin on the CPU) where usable, dense attention elsewhere;
    attention_impl="pallas" insists on flash, "xla" on dense. Dropout
    (a `dropout_gen`) keeps to dense attention, as in the JAX model."""
    if cfg.attention_impl in ("pallas", "auto"):
        if flash_attention_usable(q, dropout_gen is None):
            return flash_attention(q, k, v, causal=True,
                                   head_packing=cfg.attention_head_packing)
        if cfg.attention_impl == "pallas":
            raise RuntimeError("flash attention requested but unusable "
                               "for these shapes/settings")
    return dense_attention(q, k, v, causal=True, dropout_rate=cfg.dropout,
                           dropout_gen=dropout_gen)


def _generator_seed(seed, index):
    """The seed of dropout stream `index` (0: the embedding, i + 1:
    block i) of one step's `seed`."""
    return (int(seed) * 1000003 + index) % (1 << 63)


def _generator(seed, index, device):
    """A fresh torch.Generator on `device` for stream `index` of
    `seed`: a remat recompute of a block builds it again and draws the
    same masks."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_generator_seed(seed, index))
    return gen


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
    """Pre-LN transformer block (attention + MLP).

    Boundary contract (as in the JAX block): with
    `boundary=(prev_mlp_y, prev_mlp_b)` the true hidden state is
    `hidden + prev_mlp_y + prev_mlp_b`, folded into this block's ln_1
    by one fused launch; with `return_boundary=True` the block returns
    `(residual_stream, (mlp_y, mlp_b))` and leaves its trailing add to
    the next block (or the model's fused ln_f). Both need the fused
    path. With `deterministic=False` and dropout > 0 the block draws its
    masks from a generator seeded by `dropout_seed`, on the unfused path
    (dropout sits inside the fused chains)."""

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

    def forward(self, hidden, boundary=None, return_boundary=False,
                deterministic=True, dropout_seed=None):
        cfg = self.config
        b, t, c = hidden.shape
        h, d = cfg.n_head, cfg.head_dim
        eps = cfg.layer_norm_epsilon
        drop = not deterministic and cfg.dropout > 0.0
        gen = _generator(dropout_seed, 0, hidden.device) if drop else None
        use_fused = resolve_fused_ops(cfg.fused_ops, not drop,
                                      hidden.device)
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
        attn = _attention(cfg, q, k, v, gen).reshape(b, t, c)
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
        attn = attn_y + attn_b.to(cfg.dtype)
        if drop:
            attn = dropout(attn, cfg.dropout, gen)
        hidden = hidden + attn
        y = self.ln_2(hidden).to(cfg.dtype)
        fc_y, fc_b = self.c_fc(y)
        y = nn.functional.gelu(fc_y + fc_b.to(cfg.dtype),
                               approximate="tanh")
        mlp_y, mlp_b = self.mlp_c_proj(y)
        y = mlp_y + mlp_b.to(cfg.dtype)
        if drop:
            y = dropout(y, cfg.dropout, gen)
        return hidden + y


def _block_call(block, params, *args):
    return torch.func.functional_call(block, params, args)


def _run_block(block, remat, *args):
    """One block, under full-block remat when `remat`: torch.utils
    .checkpoint keeps the block's inputs (the boundary tuple) and
    recomputes the rest in the backward. The block's parameters are
    passed explicitly, so the recompute reads the same tensors as the
    forward even when the caller swapped them in (functional_call)."""
    if not remat:
        return block(*args)
    return checkpoint(_block_call, block, dict(block.named_parameters()),
                      *args, use_reentrant=False, preserve_rng_state=False)


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with the tied-embedding LM head; returns logits in the
    compute dtype, or with `return_hidden=True` the final hidden states
    (compute dtype) and wte, for the chunked loss. Under gradients and
    `remat`, each block runs under full-block remat."""

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

    def forward(self, input_ids, deterministic=True, return_hidden=False,
                dropout_seed=None):
        cfg = self.config
        drop = not deterministic and cfg.dropout > 0.0
        if drop and dropout_seed is None:
            raise ValueError("dropout is active (deterministic=False, "
                             f"dropout={cfg.dropout}) but no dropout seed "
                             'was given (rngs={"dropout": seed})')
        remat = cfg.remat and torch.is_grad_enabled()
        hidden = embed_tokens(cfg, self.wte, self.wpe, input_ids)
        if drop:
            hidden = dropout(hidden, cfg.dropout,
                             _generator(dropout_seed, 0, hidden.device))

        def seed(i):
            # block i's stream: a seed of its own, drawn again on recompute
            return _generator_seed(dropout_seed, i + 1) if drop else None

        if resolve_fused_ops(cfg.fused_ops, not drop, hidden.device):
            # boundary fusion: the zero first boundary's bias takes
            # wte's dtype, as in the JAX model's carry0
            prev = (torch.zeros(hidden.shape, dtype=cfg.dtype,
                                device=hidden.device),
                    torch.zeros((cfg.n_embd,), dtype=self.wte.dtype,
                                device=hidden.device))
            for i, block in enumerate(self.h):
                hidden, prev = _run_block(block, remat, hidden, prev, True,
                                          deterministic, seed(i))
            hidden = fused_bias_residual_layernorm(
                prev[0], prev[1], hidden, self.ln_f.scale, self.ln_f.bias,
                eps=cfg.layer_norm_epsilon, out_dtype=torch.float32,
                return_sum=False)
        else:
            for i, block in enumerate(self.h):
                hidden = _run_block(block, remat, hidden, None, False,
                                    deterministic, seed(i))
            hidden = self.ln_f(hidden)
        if return_hidden:
            return hidden.to(cfg.dtype), self.wte
        return torch.matmul(hidden.to(cfg.dtype),
                            self.wte.to(cfg.dtype).t())


class _TiedHeadLogits(torch.autograd.Function):
    """fp32 logits h @ wᵀ from operands in the compute dtype, with the
    fp32 accumulator kept (the JAX package's
    preferred_element_type=float32): on CUDA one bf16 GEMM with an fp32
    output, on the CPU the same products (exact in fp32) summed in fp32.

    Backward: the fp32 cotangent is rounded once to the operands' dtype
    for the two GEMMs (fp32 accumulation, outputs in the operands'
    dtype), where the JAX package multiplies the fp32 cotangent itself;
    in fp32 compute the two are the same arithmetic."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.dtype == torch.float32:
            return torch.matmul(h, w.t())
        if h.is_cuda:
            return torch.mm(h, w.t(), out_dtype=torch.float32)
        return torch.matmul(h.float(), w.float().t())

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        dh = torch.matmul(g, w) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(g.t(), h) if ctx.needs_input_grad[1] else None
        return dh, dw


def _chunk_nll_sum(hc, wte_c, lc, ignore_index):
    """Sum of token NLLs of one chunk: [chunk, vocab] fp32 logits from
    the tied head, fp32 logsumexp and gold logit, ignored labels
    dropped."""
    logits = _TiedHeadLogits.apply(hc, wte_c)
    valid = lc != ignore_index
    safe = torch.where(valid, lc, torch.zeros_like(lc))
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, safe[:, None])[:, 0]
    return torch.where(valid, logz - gold, torch.zeros_like(logz)).sum()


def chunked_tied_head_loss(hidden, wte, labels, ignore_index=-100,
                           chunk_tokens=1024):
    """Tied-embedding LM head + token CE without ever materialising the
    full [B, T, vocab] logits: a loop over chunks of `chunk_tokens`
    tokens, each under torch.utils.checkpoint, so the backward
    recomputes the chunk's [chunk, vocab] logits tile instead of
    keeping it. Mean over the non-ignored tokens. The logits tile is
    fp32 from operands in the compute dtype (`_TiedHeadLogits`)."""
    b, t, c = hidden.shape
    n = b * t
    h = hidden.reshape(n, c)
    lab = labels.reshape(n)
    wte_c = wte.to(hidden.dtype)
    total = None
    for start in range(0, n, chunk_tokens):
        part = checkpoint(_chunk_nll_sum, h[start:start + chunk_tokens],
                          wte_c, lab[start:start + chunk_tokens],
                          ignore_index, use_reentrant=False,
                          preserve_rng_state=False)
        total = part if total is None else total + part
    count = (lab != ignore_index).sum().clamp(min=1)
    return total / count


def cross_entropy_loss(logits, labels, ignore_index=-100):
    """Token-level CE in fp32; mean over non-ignored positions."""
    logits = logits.to(torch.float32)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


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

    def _ids(self, x):
        t = x if isinstance(x, torch.Tensor) else \
            torch.as_tensor(np.asarray(x))
        return t.to(device=self.device, dtype=torch.long)

    def apply(self, params, input_ids, deterministic=True,
              layer_keep_prob=None):
        """Logits [B, T, vocab] (compute dtype) of `input_ids` [B, T]
        under `params` (a flat parameter dict, e.g. from `init`), with
        no gradients: the inference forward. Dropout runs in `loss_fn`,
        which takes its seed."""
        if not deterministic:
            raise NotImplementedError(
                "apply is the deterministic inference forward; dropout "
                "runs in loss_fn(params, batch, rngs)")
        if layer_keep_prob is not None:
            raise NotImplementedError(PLD_SLICE)
        with torch.no_grad():
            return torch.func.functional_call(self.module, params,
                                              (self._ids(input_ids),))

    @staticmethod
    def _shifted_labels(batch):
        """(input_ids, labels): `labels` as given (next-token targets),
        or the ids shifted left with -100 in the last position."""
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
        if labels is None:
            labels = torch.cat(
                [input_ids[:, 1:],
                 torch.full_like(input_ids[:, :1], -100)], dim=1)
        return input_ids, labels

    def loss_fn(self, params, batch, rngs=None, deterministic=False,
                layer_keep_prob=None, return_router_stats=False):
        """Mean next-token cross-entropy of `batch` ({"input_ids" [B,T],
        optional "labels" [B,T]}) under `params`, differentiable in
        every parameter. `rngs={"dropout": seed}` (an int) seeds the
        step's dropout when `deterministic` is False and dropout > 0.
        Under `remat` every block runs under full-block remat."""
        cfg = self.config
        if layer_keep_prob is not None:
            raise NotImplementedError(PLD_SLICE)
        if return_router_stats:
            raise ValueError(
                "return_router_stats requires a model built with "
                "GPT2Config(moe=...)")
        if cfg.remat and cfg.remat_policy is not None:
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r}: {REMAT_POLICY_SLICE}; "
                "remat_policy=None (full-block remat) is supported")
        input_ids, labels = self._shifted_labels(
            {k: self._ids(v) for k, v in batch.items()})
        seed = (rngs or {}).get("dropout")
        hidden, wte = torch.func.functional_call(
            self.module, params, (input_ids,),
            {"deterministic": deterministic, "return_hidden": True,
             "dropout_seed": seed})
        return chunked_tied_head_loss(hidden, wte, labels)
