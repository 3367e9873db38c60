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
remat (`remat=True`) over each block, carrying the boundary tuple, under
`remat_policy`, resolved as the JAX model resolves it
(`resolve_remat_policy`): None is full-block remat; "save_fused_epilogues"
keeps the kernels' named outputs (attention's out and lse, both outputs
of each K3, K4's sum), so the backward's recompute launches no K1-fwd or
K3-fwd and runs c_attn, c_fc and K4-fwd again; "save_only_these_names:
attn_out,attn_lse" keeps attention's; "dots_with_no_batch_dims_saveable"
keeps the projections' GEMM outputs
(runtime/activation_checkpointing/checkpointing.py);
dropout on the embedding, the attention probabilities and both
projections (the unfused path, as in JAX), drawn from per-layer
`torch.Generator`s seeded from `rngs["dropout"]`, so a block's
recompute draws the same masks; and the chunked tied-head
cross-entropy, whose [B, T, vocab] logits never exist.

Quantized compute (`quantized_compute` "on"/"auto", or the engine's
`quantized_compute` block through `configure_quantized_compute`): the
four projections of a dense block, and c_attn/c_proj of an MoE block,
are `QuantizedDense`s, the int8 forward of kernel K6 with the
straight-through backward; "auto" quantizes on CUDA only. With
`quant_stochastic_rounding` each projection rounds stochastically from
its own stream of `rngs["quant"]` (the step's seed, then the layer,
then the projection), so a block's remat recompute and the backward
see the forward's noise. The parameter tree is the same either way.

Mixture-of-experts (`GPT2Config(moe=MoEConfig(...))`, the JAX MoE
model): every `every_n_layers`-th layer is a `MoEGPT2Block` (the
attention half of a block with plain LayerNorms and Dense projections,
then `moe/layer.py`'s MoEMLP), the others dense `GPT2Block`s called
without the boundary carry, as the JAX super-cell scan calls them. The
router stats of the MoE layers are summed and divided by their count;
`loss_fn` adds aux_loss_weight * stats[STAT_AUX] to the cross-entropy.

Parameters keep flax's names and layouts, flattened: "wte", "wpe",
"h.{i}.{c_attn,c_proj,c_fc,mlp_c_proj}.{kernel,bias}" with [in, out]
kernels, "h.{i}.{ln_1,ln_2}.{scale,bias}", "ln_f.{scale,bias}"; an MoE
layer has "h.{i}.moe_mlp.wg" and "h.{i}.moe_mlp.experts.{wi,bi,wo,bo}"
in place of c_fc/mlp_c_proj. `models/convert.py` turns a JAX tree into
this form.

Sequence parallelism (`sequence_parallel` "ring" or "ulysses", over the
process group `sp_group`, None for WORLD; the JAX model's `sp_mesh` and
`sp_axis`): every rank of the group holds the whole batch and the same
parameters, as the JAX model on a data=1, model=P mesh does. Attention
takes the rank's T chunk of q/k/v (`scatter_sequence`, whose backward
all-gathers the chunks' gradients), runs `ring_attention` or
`ulysses_attention` over the group, and all-gathers the output chunks
(`gather_sequence`), so every rank computes the same loss and the same
gradients. Attention dropout under sequence parallelism raises, as in
JAX.

Progressive layer drop (`layer_keep_prob`, a 0-dim tensor or float:
the engine's per-step theta): as in the JAX model, the stack then keeps
the plain carry (no boundary fusion; the fused path still runs K3 for
ln_2 and K4 in each block) and gates each block's output: with dropout
on (`deterministic=False`) a bernoulli draw per block keeps the block
(`torch.where(gate, out, hidden)`), drawn on the device from stream 2 of
the block's dropout seed (the JAX model draws from flax's dropout rng:
the two packages keep different blocks from one seed); deterministic,
`hidden + p * (out - hidden)`.

fp16 compute (`dtype=torch.float16`) runs every kernel of its path in
its fp16 form: K1-K4, and with MoE K8 and grouped K4, with quantized
compute K6 (fp16 out), under the ring K5 and K2's given-delta entry.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.convert import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models.wrapper import ModelWrapper
from deepspeed_tpu_torch.moe.layer import MoEConfig, MoEMLP
from deepspeed_tpu_torch.moe.router import STAT_AUX
from deepspeed_tpu_torch.ops.sequence import (
    gather_sequence, ring_attention, scatter_sequence, ulysses_attention)
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    dense_attention, dropout, flash_attention,
    flash_attention_rematerializable, flash_attention_usable)
from deepspeed_tpu_torch.ops.transformer.fused_ops import (
    fused_bias_gelu, fused_bias_residual_layernorm, resolve_fused_ops)
from deepspeed_tpu_torch.ops.transformer.quantized_matmul import \
    resolve_quantized_compute
from deepspeed_tpu_torch.ops.transformer.transformer import (
    LayerNorm, epilogue_gemms, plain_layernorm, project, projection,
    run_block)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import resolve_checkpoint_policy
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.rng import stream_generator, stream_seed

# the stream of a block's dropout seed that PLD's gate draws from
PLD_STREAM = 2


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
    # remat recomputes activations in the backward (what `remat_policy`
    # keeps excepted); the values are the same with it on or off
    remat: bool = True
    remat_policy: Optional[str] = None
    attention_impl: str = "auto"    # auto | pallas (the kernel) | xla
    attention_head_packing: str = "auto"
    fused_ops: str = "auto"
    quantized_compute: str = "off"
    quant_block: int = 128
    quant_stochastic_rounding: bool = False
    sequence_parallel: Optional[str] = None   # None | "ring" | "ulysses"
    sp_group: Any = None    # torch.distributed process group; None = WORLD
    moe: Any = None
    initializer_range: float = 0.02

    @property
    def head_dim(self):
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} is no multiple of "
                             f"n_head {self.n_head}")
        return self.n_embd // self.n_head

    @property
    def moe_cells(self):
        """Number of MoE layers (the JAX super-cell count): each cell is
        every_n_layers - 1 dense blocks and one MoE block."""
        if self.moe is None:
            raise ValueError("moe_cells needs GPT2Config(moe=...)")
        every = self.moe.every_n_layers
        if self.n_layer % every:
            raise ValueError(
                f"moe.every_n_layers={every} must divide n_layer="
                f"{self.n_layer}")
        return self.n_layer // every

    def is_moe_layer(self, i):
        """Whether layer i is the MoE block of its cell."""
        return self.moe is not None and \
            (i + 1) % self.moe.every_n_layers == 0


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


def resolve_remat_policy(name):
    """Remat-policy string -> RematPolicy (the JAX model's
    `resolve_remat_policy`): registered custom policies (incl. the
    built-in "save_fused_epilogues" per-fusion policy) first, then
    "save_only_these_names:a,b" over the kernels' output names (the
    model names its attention output "attn_out"), then the
    argument-free `jax.checkpoint_policies` names."""
    return resolve_checkpoint_policy(name)


def check_supported(cfg: GPT2Config):
    """Raise for an unknown remat policy, for an `moe` that is no
    MoEConfig and for the options' bad values."""
    resolve_remat_policy(cfg.remat_policy)   # ValueError if unknown
    if cfg.moe is not None:
        if not isinstance(cfg.moe, MoEConfig):
            raise TypeError(f"GPT2Config.moe must be a moe.MoEConfig or "
                            f"None, got {type(cfg.moe).__name__}")
        cfg.moe.validate()
        cfg.moe_cells   # every_n_layers must divide n_layer
    resolve_quantized_compute(cfg.quantized_compute)   # ValueError if bad
    if cfg.quant_block <= 0:
        raise ValueError(f"quant_block must be > 0, got {cfg.quant_block}")
    if cfg.sequence_parallel and cfg.sequence_parallel not in SP_IMPLS:
        raise ValueError(
            f"sequence_parallel={cfg.sequence_parallel!r}; valid values: "
            f"{sorted(SP_IMPLS)} or None")
    if cfg.attention_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"attention_impl={cfg.attention_impl!r}: "
                         "expected 'auto', 'pallas' or 'xla'")


SP_IMPLS = {"ring": ring_attention, "ulysses": ulysses_attention}


def _sp_attention(cfg, q, k, v):
    """Causal attention of the replicated [B, T, H, D] q/k/v over the
    sequence-parallel group: the rank's chunk in, the chosen body, the
    whole output back on every rank."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "sequence_parallel requires an initialized torch.distributed "
            "process group (deepspeed_tpu_torch.init_distributed; "
            "GPT2Config.sp_group, None for WORLD), as the JAX model "
            "requires sp_mesh")
    group = cfg.sp_group
    ql, kl, vl = (scatter_sequence(x, group) for x in (q, k, v))
    out = SP_IMPLS[cfg.sequence_parallel](
        ql, kl, vl, group=group, causal=True,
        head_packing=cfg.attention_head_packing)
    return gather_sequence(out, group)


def _attention(cfg, q, k, v, dropout_gen=None):
    """Causal attention over [B, T, H, D]: flash (kernel K1 on CUDA, its
    plain twin on the CPU) where usable, dense attention elsewhere;
    attention_impl="pallas" insists on flash, "xla" on dense. Dropout
    (a `dropout_gen`) keeps to dense attention, as in the JAX model.
    With `sequence_parallel`, ring or Ulysses attention over the group
    (`_sp_attention`)."""
    if cfg.sequence_parallel:
        if dropout_gen is not None:
            raise ValueError("attention dropout is not supported under "
                             "sequence parallelism")
        return _sp_attention(cfg, q, k, v)
    if cfg.attention_impl in ("pallas", "auto"):
        if flash_attention_usable(q, dropout_gen is None):
            # under remat, (out, lse) carry the names "attn_out" /
            # "attn_lse" that the named policies keep
            flash = flash_attention_rematerializable if cfg.remat else \
                flash_attention
            return flash(q, k, v, causal=True,
                         head_packing=cfg.attention_head_packing)
        if cfg.attention_impl == "pallas":
            raise RuntimeError("flash attention requested but unusable "
                               "for these shapes/settings")
    # the JAX model names this route's output "attn_out" too; the port's
    # remat frame keeps kernel outputs only, so under a names policy the
    # recompute rebuilds it (as its own backward needs the softmax anyway)
    return dense_attention(q, k, v, causal=True, dropout_rate=cfg.dropout,
                           dropout_gen=dropout_gen)


def _projection(cfg: GPT2Config, in_features, features, split=False):
    """A block projection under the config's compute dtype and quantized
    compute settings (`ops.transformer.transformer.projection`)."""
    return projection(in_features, features, cfg.dtype, cfg.param_dtype,
                      cfg.quantized_compute, cfg.quant_block,
                      cfg.quant_stochastic_rounding, split=split)


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
    (dropout sits inside the fused chains). `quant_seed` seeds the
    projections' stochastic rounding (projection j its stream j)."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        cfg = config
        self.config = cfg
        c, pd = cfg.n_embd, cfg.param_dtype
        eps = cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(c, pd, eps)
        self.c_attn = _projection(cfg, c, 3 * c)
        self.c_proj = _projection(cfg, c, c, split=True)
        self.ln_2 = LayerNorm(c, pd, eps)
        self.c_fc = _projection(cfg, c, 4 * c, split=True)
        self.mlp_c_proj = _projection(cfg, 4 * c, c, split=True)

    def forward(self, hidden, boundary=None, return_boundary=False,
                deterministic=True, dropout_seed=None, quant_seed=None):
        cfg = self.config
        b, t, c = hidden.shape
        h, d = cfg.n_head, cfg.head_dim
        eps = cfg.layer_norm_epsilon
        drop = not deterministic and cfg.dropout > 0.0
        gen = stream_generator(dropout_seed, 0, hidden.device) if drop \
            else None
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
        qkv = project(self.c_attn, x, quant_seed, 0)
        # column slices of qkv, viewed [B, T, H, D] in place (no copy)
        q, k, v = (part.view(b, t, h, d) for part in qkv.split(c, dim=-1))
        attn = _attention(cfg, q, k, v, gen).reshape(b, t, c)
        with epilogue_gemms(use_fused):
            attn_y, attn_b = project(self.c_proj, attn, quant_seed, 1)
        if use_fused:
            # one launch: c_proj bias + residual + ln_2
            y, hidden = fused_bias_residual_layernorm(
                attn_y, attn_b, hidden, self.ln_2.scale, self.ln_2.bias,
                eps=eps, out_dtype=cfg.dtype, sum_dtype=sum_dtype)
            fc_y, fc_b = project(self.c_fc, y, quant_seed, 2)
            # one launch: c_fc bias + tanh GeLU (GPT-2's approximation)
            y = fused_bias_gelu(fc_y, fc_b, approximate=True,
                                out_dtype=cfg.dtype)
            mlp_y, mlp_b = project(self.mlp_c_proj, y, quant_seed, 3)
            if return_boundary:
                return hidden, (mlp_y, mlp_b)
            return hidden + (mlp_y + mlp_b.to(cfg.dtype))
        attn = attn_y + attn_b.to(cfg.dtype)
        if drop:
            attn = dropout(attn, cfg.dropout, gen)
        hidden = hidden + attn
        y = self.ln_2(hidden).to(cfg.dtype)
        fc_y, fc_b = project(self.c_fc, y, quant_seed, 2)
        y = nn.functional.gelu(fc_y + fc_b.to(cfg.dtype),
                               approximate="tanh")
        mlp_y, mlp_b = project(self.mlp_c_proj, y, quant_seed, 3)
        y = mlp_y + mlp_b.to(cfg.dtype)
        if drop:
            y = dropout(y, cfg.dropout, gen)
        return hidden + y


class MoEGPT2Block(nn.Module):
    """Pre-LN block whose MLP is MoEMLP (the JAX MoEGPT2Block): the
    attention half with plain LayerNorms (flax numerics, fp32) and Dense
    c_attn/c_proj under the dense block's names, then router + dispatch
    + experts + combine. Returns (hidden, stats [E+2]). Dropout draws
    from the generator of `dropout_seed`'s stream 0, router jitter from
    its stream 1; `quant_seed` seeds c_attn/c_proj's stochastic
    rounding (the experts round to nearest, as in the JAX model)."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        cfg = config
        self.config = cfg
        c, pd = cfg.n_embd, cfg.param_dtype
        eps = cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(c, pd, eps)
        self.c_attn = _projection(cfg, c, 3 * c)
        self.c_proj = _projection(cfg, c, c)
        self.ln_2 = LayerNorm(c, pd, eps)
        self.moe_mlp = MoEMLP(cfg.moe, c, 4 * c, cfg.dtype, pd)

    def forward(self, hidden, deterministic=True, dropout_seed=None,
                quant_seed=None):
        cfg = self.config
        b, t, c = hidden.shape
        h, d = cfg.n_head, cfg.head_dim
        drop = not deterministic and cfg.dropout > 0.0
        gen = stream_generator(dropout_seed, 0, hidden.device) if drop \
            else None
        jitter = None
        if not deterministic and cfg.moe.jitter_eps > 0.0 and \
                dropout_seed is not None:
            jitter = stream_generator(dropout_seed, 1, hidden.device)

        x = self.ln_1(hidden).to(cfg.dtype)
        qkv = project(self.c_attn, x, quant_seed, 0)
        q, k, v = (part.view(b, t, h, d) for part in qkv.split(c, dim=-1))
        attn = project(self.c_proj,
                       _attention(cfg, q, k, v, gen).reshape(b, t, c),
                       quant_seed, 1)
        if drop:
            attn = dropout(attn, cfg.dropout, gen)
        hidden = hidden + attn
        y = self.ln_2(hidden).to(cfg.dtype)
        y, stats = self.moe_mlp(y, deterministic, jitter)
        if drop:
            y = dropout(y, cfg.dropout, gen)
        return hidden + y, stats


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
        self.h = nn.ModuleList(
            MoEGPT2Block(cfg) if cfg.is_moe_layer(i) else GPT2Block(cfg)
            for i in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, pd, cfg.layer_norm_epsilon)

    def forward(self, input_ids, deterministic=True, return_hidden=False,
                dropout_seed=None, quant_seed=None, layer_keep_prob=None):
        """Logits, or with `return_hidden` (final hidden, wte); an MoE
        model returns (that, router stats [E+2] averaged over its MoE
        layers). `quant_seed` seeds the quantized projections' stochastic
        rounding, block i from its stream i + 1. `layer_keep_prob` gates
        each block (progressive layer drop)."""
        cfg = self.config
        drop = not deterministic and cfg.dropout > 0.0
        pld = layer_keep_prob is not None
        if (drop or (pld and not deterministic)) and dropout_seed is None:
            raise ValueError("dropout or progressive layer drop is active "
                             f"(deterministic=False, dropout={cfg.dropout})"
                             ' but no dropout seed was given (rngs='
                             '{"dropout": seed})')
        remat = cfg.remat and torch.is_grad_enabled()
        policy = resolve_remat_policy(cfg.remat_policy)
        hidden = embed_tokens(cfg, self.wte, self.wpe, input_ids)
        if drop:
            hidden = dropout(hidden, cfg.dropout,
                             stream_generator(dropout_seed, 0, hidden.device))
        # router jitter and PLD's gate, like dropout, draw from the
        # step's seed
        stochastic = not deterministic and dropout_seed is not None and (
            drop or pld or
            (cfg.moe is not None and cfg.moe.jitter_eps > 0.0))

        def seed(i):
            # block i's stream: a seed of its own, drawn again on recompute
            return stream_seed(dropout_seed, i + 1) if stochastic else None

        def qseed(i):
            return stream_seed(quant_seed, i + 1)

        if cfg.moe is not None:
            return self._moe_forward(hidden, remat, policy, deterministic,
                                     seed, qseed, return_hidden)
        if pld:
            # PLD gates completed block outputs: the plain carry
            for i, block in enumerate(self.h):
                out = run_block(block, remat, hidden, None, False,
                                deterministic, seed(i), qseed(i),
                                policy=policy)
                hidden = _pld_gate(hidden, out, layer_keep_prob,
                                   deterministic, seed(i))
            hidden = self.ln_f(hidden)
        elif resolve_fused_ops(cfg.fused_ops, not drop, hidden.device):
            # boundary fusion: the zero first boundary's bias takes
            # wte's dtype, as in the JAX model's carry0
            prev = (torch.zeros(hidden.shape, dtype=cfg.dtype,
                                device=hidden.device),
                    torch.zeros((cfg.n_embd,), dtype=self.wte.dtype,
                                device=hidden.device))
            for i, block in enumerate(self.h):
                hidden, prev = run_block(block, remat, hidden, prev, True,
                                         deterministic, seed(i), qseed(i),
                                         policy=policy)
            hidden = fused_bias_residual_layernorm(
                prev[0], prev[1], hidden, self.ln_f.scale, self.ln_f.bias,
                eps=cfg.layer_norm_epsilon, out_dtype=torch.float32,
                return_sum=False)
        else:
            for i, block in enumerate(self.h):
                hidden = run_block(block, remat, hidden, None, False,
                                   deterministic, seed(i), qseed(i),
                                   policy=policy)
            hidden = self.ln_f(hidden)
        if return_hidden:
            return hidden.to(cfg.dtype), self.wte
        return torch.matmul(hidden.to(cfg.dtype),
                            self.wte.to(cfg.dtype).t())

    def _moe_forward(self, hidden, remat, policy, deterministic, seed,
                     qseed, return_hidden):
        """The MoE stack: dense blocks without the boundary carry (the
        JAX super-cell calls them so), MoE blocks returning router stats,
        which sum over the MoE layers and divide by their count; then a
        plain ln_f."""
        cfg = self.config
        stats = torch.zeros((cfg.moe.num_experts + 2,), dtype=torch.float32,
                            device=hidden.device)
        for i, block in enumerate(self.h):
            if cfg.is_moe_layer(i):
                hidden, s = run_block(block, remat, hidden, deterministic,
                                      seed(i), qseed(i),
                                      policy=policy)
                stats = stats + s
            else:
                hidden = run_block(block, remat, hidden, None, False,
                                   deterministic, seed(i), qseed(i),
                                   policy=policy)
        stats = stats / float(cfg.moe_cells)
        hidden = self.ln_f(hidden)
        if return_hidden:
            return (hidden.to(cfg.dtype), self.wte), stats
        return torch.matmul(hidden.to(cfg.dtype),
                            self.wte.to(cfg.dtype).t()), stats


def _pld_gate(hidden, out, keep_prob, deterministic, seed):
    """Progressive layer drop on one block: `hidden + p * (out -
    hidden)` when deterministic, else `out` where a bernoulli(p) draw
    (on the device, stream PLD_STREAM of the block's seed) keeps the
    block and `hidden` where it drops it. No host read."""
    p = torch.as_tensor(keep_prob, dtype=torch.float32, device=hidden.device)
    if deterministic:
        return (hidden + p * (out - hidden)).to(out.dtype)
    gen = stream_generator(seed, PLD_STREAM, hidden.device)
    gate = torch.rand((), generator=gen, device=hidden.device) < p
    return torch.where(gate, out, hidden)


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
    if name in ("wte", "wpe") or leaf in ("wg", "wi"):
        return cfg.initializer_range
    if leaf == "wo":
        # the experts' down projection: the residual-scaled init
        return cfg.initializer_range / np.sqrt(2 * cfg.n_layer)
    if leaf == "kernel":
        if ".c_proj." in name or ".mlp_c_proj." in name:
            # GPT-2's residual-scaling trick: proj init scaled by depth
            return cfg.initializer_range / np.sqrt(2 * cfg.n_layer)
        return cfg.initializer_range
    return None


class GPT2ForCausalLM(ModelWrapper):
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
        return self._init_params(seed, lambda n: _init_std(self.config, n))

    def params_to_jax(self, params, remat=False, stack=torch.stack):
        """The JAX tree of a flat parameter dict (the engine's checkpoint
        layout): the scanned children named for `remat`."""
        return params_to_jax(params, remat=remat, stack=stack)

    def params_from_jax(self, tree, dtype=None):
        return params_from_jax(tree, dtype)

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
        if layer_keep_prob is not None and self.config.moe is not None:
            raise ValueError(
                "progressive_layer_drop is not supported with "
                "mixture-of-experts (no per-cell keep-prob gate)")
        with torch.no_grad():
            out = torch.func.functional_call(
                self.module, params, (self._ids(input_ids),),
                {"layer_keep_prob": layer_keep_prob})
        if self.config.moe is not None:
            out, _stats = out   # logits only; the stats ride loss_fn
        return out

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
        step's dropout when `deterministic` is False and dropout > 0;
        `rngs["quant"]` (an int) seeds the quantized projections'
        stochastic rounding when `quant_stochastic_rounding` is on.
        Under `remat` every block runs under remat with `remat_policy`."""
        cfg = self.config
        if layer_keep_prob is not None and cfg.moe is not None:
            raise ValueError(
                "progressive_layer_drop is not supported with "
                "mixture-of-experts (no per-cell keep-prob gate)")
        if return_router_stats and cfg.moe is None:
            raise ValueError(
                "return_router_stats requires a model built with "
                "GPT2Config(moe=...)")
        input_ids, labels = self._shifted_labels(
            {k: self._ids(v) for k, v in batch.items()})
        rngs = rngs or {}
        out = torch.func.functional_call(
            self.module, params, (input_ids,),
            {"deterministic": deterministic, "return_hidden": True,
             "dropout_seed": rngs.get("dropout"),
             "quant_seed": rngs.get("quant"),
             "layer_keep_prob": layer_keep_prob})
        if cfg.moe is None:
            return chunked_tied_head_loss(*out, labels)
        (hidden, wte), stats = out
        loss = chunked_tied_head_loss(hidden, wte, labels) + \
            float(cfg.moe.aux_loss_weight) * stats[STAT_AUX]
        return (loss, stats) if return_router_stats else loss

    # -- mixture-of-experts hooks ----------------------------------------
    def moe_info(self):
        """Engine-facing MoE summary (None for a dense model)."""
        moe = self.config.moe
        if moe is None:
            return None
        return dict(num_experts=moe.num_experts, top_k=moe.top_k,
                    capacity_factor=moe.capacity_factor,
                    aux_loss_weight=moe.aux_loss_weight,
                    every_n_layers=moe.every_n_layers,
                    jitter_eps=moe.jitter_eps,
                    width=self.config.n_embd,
                    moe_layers=self.config.moe_cells)

    def configure_moe(self, mesh=None, num_experts=None,
                      every_n_layers=None, top_k=None,
                      capacity_factor=None, aux_loss_weight=None,
                      jitter_eps=None, fused_dispatch=None):
        """Engine hook for the `moe` config block. The structural keys
        (num_experts, every_n_layers) are verified against the built
        model; the router knobs are applied to the model's MoE layers in
        place (the parameters stay). `mesh` must be None: expert meshes
        need world size > 1."""
        moe = self.config.moe
        if moe is None:
            raise ValueError(
                "moe config block is enabled but the model was built "
                "without MoE structure; construct it with "
                "GPT2Config(moe=MoEConfig(...)) so the parameters carry "
                "the expert leaves")
        for key, want in (("num_experts", num_experts),
                          ("every_n_layers", every_n_layers)):
            have = getattr(moe, key)
            if want is not None and int(want) != have:
                raise ValueError(
                    f"moe.{key}={want} does not match the model's built "
                    f"structure ({have}); structural keys cannot be "
                    "reconfigured after init")
        updates = {}
        if mesh is not None:
            updates["mesh"] = mesh
        if top_k is not None:
            updates["top_k"] = int(top_k)
        if capacity_factor is not None:
            updates["capacity_factor"] = float(capacity_factor)
        if aux_loss_weight is not None:
            updates["aux_loss_weight"] = float(aux_loss_weight)
        if jitter_eps is not None:
            updates["jitter_eps"] = float(jitter_eps)
        if fused_dispatch is not None:
            updates["fused_dispatch"] = fused_dispatch
        moe = dataclasses.replace(moe, **updates).validate()
        self.config = dataclasses.replace(self.config, moe=moe)
        for module in self.module.modules():
            if isinstance(module, MoEMLP):
                module.moe = moe
            elif hasattr(module, "config"):
                module.config = self.config

    def configure_quantized_compute(self, mode, block=None,
                                    stochastic_rounding=None):
        """Engine hook for the `quantized_compute` config block: rebuild
        the module with the int8 quantized-compute projections switched
        to `mode` ("off" | "on" | "auto"), the quantization `block` and
        `stochastic_rounding` where given. The parameter tree is the
        same either way: the rebuilt module adopts the current parameter
        tensors (no copy), so `params()` and converted trees stay
        valid."""
        resolve_quantized_compute(mode)   # ValueError on a bad mode
        updates = {"quantized_compute": mode}
        if block is not None:
            updates["quant_block"] = int(block)
        if stochastic_rounding is not None:
            updates["quant_stochastic_rounding"] = bool(stochastic_rounding)
        config = dataclasses.replace(self.config, **updates)
        check_supported(config)
        with torch.device("meta"):
            module = GPT2LMHeadModel(config)
        module.load_state_dict(self.module.state_dict(), assign=True)
        module.train(self.module.training)
        self.config, self.module = config, module
