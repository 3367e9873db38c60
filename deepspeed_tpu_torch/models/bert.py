"""BERT family: the pretraining model on DeepSpeedTransformerLayer (port
of deepspeed_tpu/models/bert.py).

The JAX encoder scans one `DeepSpeedTransformerLayer` over a stacked
[L, ...] parameter tree; here the stack is an `nn.ModuleList` walked by
a Python loop with the scan cell's dtype-stable carry (each layer's
output cast back to the carry's dtype: the fused post-LN layer returns
fp32). Heads for pretraining: the MLM transform (dense, exact GeLU,
LayerNorm) and vocabulary decoder, and NSP on the tanh pooler of [CLS].

On CUDA the encoder layers take the fused epilogues (K3 for each bias +
residual + LayerNorm, K4 for the intermediate bias + erf-GeLU) when
hidden dropout is inactive, and flash attention (K1, backward K2),
non-causal, when there is no attention mask and no attention dropout;
`mlm_head_in_compute_dtype` "auto" runs the head's matmuls in the
compute dtype on CUDA (the JAX package's TPU-only "auto": CPU numerics
stay fp32). The embedding and MLM-transform LayerNorms are plain torch,
as they are plain flax in JAX.

Parameters keep the JAX tree's names, flattened:
"bert.embeddings.{word_embeddings,position_embeddings,
token_type_embeddings}", "bert.embeddings.LayerNorm.{scale,bias}",
"bert.encoder.layer.{i}.core.<leaf>" (the layer's names),
"bert.pooler.{kernel,bias}", "transform", "transform_ln", "decoder",
"seq_relationship" ({kernel [in, out], bias} or {scale, bias}).
`models/convert.py` `bert_params_from_jax` turns a JAX tree into this
form and `bert_params_to_jax` back.

fp16 (`fp16=True`) computes in fp16 on the fp16 forms of K1-K4, with
the MLM head's matmuls in fp16 where `mlm_head_in_compute_dtype` says
so. Out of this slice (raises naming its ROADMAP Queue 1 item): the
ZeRO-3 gather scheduler and its scheduled forward (`_zero3_forward`,
item 6).
"""

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.convert import (bert_params_from_jax,
                                                bert_params_to_jax)
from deepspeed_tpu_torch.models.gpt2 import \
    cross_entropy_loss as _cross_entropy
from deepspeed_tpu_torch.models.wrapper import ModelWrapper
from deepspeed_tpu_torch.ops.transformer.flash_attention import dropout
from deepspeed_tpu_torch.ops.transformer.transformer import (
    Dense, DeepSpeedTransformerConfig, DeepSpeedTransformerLayer,
    LayerNorm, layer_init_std)
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.rng import stream_generator, stream_seed

ZERO3_SLICE = ("the ZeRO-3 gather scheduler comes with world size > 1 "
               "(ROADMAP Queue 1 item 6)")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = False      # classic BERT is post-LN
    fp16: bool = False
    bf16: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    attn_dropout_checkpoint: bool = False
    attention_head_packing: str = "auto"
    # fused epilogues ("auto" | "on" | "off"): "auto" fuses on CUDA when
    # hidden dropout is inactive; the parameters are the same either way
    fused_ops: str = "auto"
    # the MLM head's matmuls in the compute dtype: "auto" on CUDA,
    # True / False force
    mlm_head_in_compute_dtype: Any = "auto"


BERT_SIZES = {
    "bert-tiny": dict(hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=512,
                      vocab_size=512),
    "bert-base": dict(hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072),
    "bert-large": dict(hidden_size=1024, num_hidden_layers=24,
                       num_attention_heads=16, intermediate_size=4096),
}


def bert_config(name="bert-base", **overrides) -> BertConfig:
    base = dict(BERT_SIZES[name])
    base.update(overrides)
    return BertConfig(**base)


def tiny_bert_config(**overrides):
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=128, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, bf16=False)
    base.update(overrides)
    return BertConfig(**base)


def _ds_layer_config(cfg: BertConfig) -> DeepSpeedTransformerConfig:
    return DeepSpeedTransformerConfig(
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        heads=cfg.num_attention_heads,
        attn_dropout_ratio=cfg.attention_probs_dropout_prob,
        hidden_dropout_ratio=cfg.hidden_dropout_prob,
        num_hidden_layers=cfg.num_hidden_layers,
        initializer_range=cfg.initializer_range,
        pre_layer_norm=cfg.pre_layer_norm,
        fp16=cfg.fp16,
        bf16=cfg.bf16,
        normalize_invertible=cfg.normalize_invertible,
        gelu_checkpoint=cfg.gelu_checkpoint,
        attn_dropout_checkpoint=cfg.attn_dropout_checkpoint,
        layer_norm_eps=cfg.layer_norm_eps,
        head_packing=cfg.attention_head_packing,
        fused_ops=cfg.fused_ops,
        training=True)


def additive_attention_mask(attention_mask):
    """[B, T] 1/0 -> additive [B, 1, 1, T] fp32 (None passes through)."""
    if attention_mask is None:
        return None
    mask = (1.0 - attention_mask.to(torch.float32)) * -1e9
    return mask[:, None, None, :]


def mlm_head_dtype(cfg: BertConfig, device):
    """The dtype of the MLM head's matmuls: `mlm_head_in_compute_dtype`
    "auto" = the compute dtype on CUDA, fp32 elsewhere."""
    head_compute = cfg.mlm_head_in_compute_dtype
    if head_compute == "auto":
        head_compute = torch.device(device).type == "cuda"
    if not head_compute:
        return torch.float32
    return torch.float16 if cfg.fp16 else \
        torch.bfloat16 if cfg.bf16 else torch.float32


def _promoted_layernorm(ln, x):
    """flax nn.LayerNorm() without a dtype: fp32 statistics, the output
    in the promotion of the input's and the parameters' dtypes."""
    out_dtype = torch.promote_types(x.dtype, ln.scale.dtype)
    return ln(x).to(out_dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty((cfg.vocab_size, h)))
        self.position_embeddings = nn.Parameter(
            torch.empty((cfg.max_position_embeddings, h)))
        self.token_type_embeddings = nn.Parameter(
            torch.empty((cfg.type_vocab_size, h)))
        self.LayerNorm = LayerNorm(h, torch.float32, cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids=None, dropout_gen=None):
        t = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = self.word_embeddings[input_ids] + \
            self.position_embeddings[:t][None] + \
            self.token_type_embeddings[token_type_ids]
        h = _promoted_layernorm(self.LayerNorm, h)
        if dropout_gen is not None:
            h = dropout(h, self.config.hidden_dropout_prob, dropout_gen)
        return h


class BertEncoder(nn.Module):
    """num_hidden_layers DeepSpeedTransformerLayers under "layer"."""

    def __init__(self, config: BertConfig):
        super().__init__()
        ds_cfg = _ds_layer_config(config)
        # the layers on the device the model is built on
        device = torch.get_default_device()
        self.layer = nn.ModuleList(
            DeepSpeedTransformerLayer(ds_cfg, device=device)
            for _ in range(config.num_hidden_layers))

    def forward(self, hidden, attention_mask, deterministic=True, seed=None,
                qseed=None):
        for i, layer in enumerate(self.layer):
            out = layer(hidden, attention_mask, deterministic, seed(i),
                        qseed(i))
            # the scan cell's dtype-stable carry: the fused post-LN
            # layer returns fp32 while the carry may be bf16
            hidden = out.to(hidden.dtype)
        return hidden


class BertModel(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)
        # flax nn.Dense() on the fp32 [CLS] row: an fp32 product
        self.pooler = Dense(config.hidden_size, config.hidden_size,
                            torch.float32, torch.float32)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic=True, dropout_seed=None, quant_seed=None):
        """(sequence output [B, T, H] in the carry's dtype, pooled [B, H]
        fp32). `dropout_seed` seeds the embedding's dropout (its stream
        0) and layer i's (stream i + 1); `quant_seed` layer i's
        stochastic rounding (stream i + 1)."""
        cfg = self.config
        drop = not deterministic and (cfg.hidden_dropout_prob > 0.0 or
                                      cfg.attention_probs_dropout_prob > 0.0)
        if drop and dropout_seed is None:
            raise ValueError("dropout is active (deterministic=False) but "
                             'no dropout seed was given (rngs={"dropout": '
                             "seed})")
        emb_gen = None
        if not deterministic and cfg.hidden_dropout_prob > 0.0:
            emb_gen = stream_generator(dropout_seed, 0, input_ids.device)
        h = self.embeddings(input_ids, token_type_ids, emb_gen)
        h = self.encoder(
            h, additive_attention_mask(attention_mask), deterministic,
            lambda i: stream_seed(dropout_seed, i + 1) if drop else None,
            lambda i: stream_seed(quant_seed, i + 1))
        pooled = torch.tanh(self.pooler(h[:, 0].to(torch.float32)))
        return h, pooled


class BertForPreTraining(nn.Module):
    """MLM + NSP heads (the BingBert pretraining objective). Returns
    (mlm logits [B, T, vocab] in the head's dtype, nsp logits [B, 2]
    fp32)."""

    def __init__(self, config: BertConfig, head_dtype=torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        h = cfg.hidden_size
        self.bert = BertModel(cfg)
        self.transform = Dense(h, h, head_dtype, torch.float32)
        self.transform_ln = LayerNorm(h, torch.float32, cfg.layer_norm_eps)
        self.decoder = Dense(h, cfg.vocab_size, head_dtype, torch.float32)
        self.seq_relationship = Dense(h, 2, torch.float32, torch.float32)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic=True, dropout_seed=None, quant_seed=None):
        sequence_output, pooled = self.bert(
            input_ids, attention_mask, token_type_ids, deterministic,
            dropout_seed, quant_seed)
        x = self.transform(sequence_output)
        x = nn.functional.gelu(x, approximate="none")
        x = self.transform_ln(x)
        mlm_logits = self.decoder(x)
        nsp_logits = self.seq_relationship(pooled)
        return mlm_logits, nsp_logits


def _init_std(cfg: BertConfig, name):
    """The JAX model's init std of parameter `name` (a float), "lecun"
    for flax's default Dense kernel init, or None for a constant."""
    if name.startswith("bert.embeddings.") and name.endswith("_embeddings"):
        return cfg.initializer_range
    if name.startswith("bert.encoder."):
        return layer_init_std(_ds_layer_config(cfg), name)
    if name.endswith(".kernel"):
        return "lecun"
    return None


class BertForPreTrainingLM(ModelWrapper):
    """Engine-facing wrapper: batch keys input_ids, attention_mask,
    token_type_ids, masked_lm_labels ([B, T], -100 = unmasked) and
    next_sentence_label ([B]). Parameters live on `device` ("cuda"
    unless the caller asks for the CPU)."""

    def __init__(self, config: BertConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.module = BertForPreTraining(
                config, mlm_head_dtype(config, self.device))
        self.module.eval()

    def bind_zero3_scheduler(self, sched):
        """The JAX engine's hook for its stage-3 gather scheduler; None
        is the only value this slice takes."""
        if sched is not None:
            raise NotImplementedError(ZERO3_SLICE)

    def init(self, seed=0):
        """Fill the parameters from `seed` with the JAX model's
        per-leaf init: normal(initializer_range) embeddings and encoder
        kernels (the output projections' std scaled by depth), flax's
        lecun_normal for the pooler and head kernels, zero biases, unit
        LayerNorm scales. The draws are torch's, not JAX's. Returns the
        parameter dict."""
        return self._init_params(seed, lambda n: _init_std(self.config, n))

    def params_to_jax(self, params, remat=False, stack=torch.stack):
        """The JAX tree of a flat parameter dict (the engine's
        checkpoint layout); `remat` renames nothing in BERT's tree."""
        return bert_params_to_jax(params, stack=stack)

    def params_from_jax(self, tree, dtype=None):
        return bert_params_from_jax(tree, dtype)

    def _tensors(self, batch):
        out = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.asarray(v))
            out[k] = t.to(self.device)
        return out

    def _logits(self, params, batch, rngs, deterministic):
        batch = self._tensors(batch)
        mask = batch.get("attention_mask")
        token_types = batch.get("token_type_ids")
        rngs = rngs or {}
        return torch.func.functional_call(
            self.module, params,
            (batch["input_ids"].long(), mask,
             None if token_types is None else token_types.long()),
            {"deterministic": deterministic,
             "dropout_seed": rngs.get("dropout"),
             "quant_seed": rngs.get("quant")}), batch

    def apply(self, params, input_ids, attention_mask=None,
              token_type_ids=None):
        """(mlm logits, nsp logits) of a batch under `params`, without
        gradients: the deterministic forward."""
        batch = {"input_ids": input_ids}
        if attention_mask is not None:
            batch["attention_mask"] = attention_mask
        if token_type_ids is not None:
            batch["token_type_ids"] = token_type_ids
        with torch.no_grad():
            return self._logits(params, batch, None, True)[0]

    def loss_fn(self, params, batch, rngs=None, deterministic=False, **_):
        """MLM cross-entropy (mean over the labels that are not -100),
        plus the NSP cross-entropy when the batch has
        next_sentence_label. `rngs={"dropout": seed}` (an int) seeds the
        dropout when `deterministic` is False."""
        (mlm_logits, nsp_logits), batch = self._logits(params, batch, rngs,
                                                       deterministic)
        loss = _cross_entropy(mlm_logits, batch["masked_lm_labels"].long())
        if "next_sentence_label" in batch:
            loss = loss + _cross_entropy(
                nsp_logits, batch["next_sentence_label"].long())
        return loss
