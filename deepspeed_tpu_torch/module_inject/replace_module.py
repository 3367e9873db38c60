"""Module injection: swap HF-style BERT layers for the fused layer (port
of deepspeed_tpu/module_inject/replace_module.py).

As in the JAX package, injection is parameter-tree surgery: an HF BERT
layer's parameters (nested dicts of torch tensors or numpy arrays, with
[in, out] dense kernels as HF's Flax BERT keeps them) convert into the
`DeepSpeedTransformerLayer` layout, q/k/v concatenated into one [H, 3H]
qkv kernel (the reference's `replace_module.py:34-56`), and the fused
layer runs in its place. `revert_transformer_layer` is the inverse, and
`replace_module` the generic walker that applies any policy over a tree.
A tensor tree converts to tensors, a numpy tree to numpy arrays.
"""

from typing import Any, Callable, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.transformer.transformer import \
    DeepSpeedTransformerConfig
from deepspeed_tpu_torch.utils.logging import logger


def _concat(parts):
    if all(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat(parts, dim=-1)
    return np.concatenate([np.asarray(p) for p in parts], axis=-1)


def _split3(x):
    if isinstance(x, torch.Tensor):
        return x.chunk(3, dim=-1)
    return np.split(np.asarray(x), 3, axis=-1)


def _is_hf_bert_layer(subtree) -> bool:
    try:
        return "query" in subtree["attention"]["self"] and \
            "dense" in subtree["intermediate"]
    except (KeyError, TypeError):
        return False


def convert_bert_layer_params(hf_layer):
    """HF BERT layer parameters -> DeepSpeedTransformerLayer parameters
    (`{"core": {...}}`, the q/k/v concat)."""
    attn_self = hf_layer["attention"]["self"]
    attn_out = hf_layer["attention"]["output"]
    qkv = ("query", "key", "value")
    return {"core": {
        "attn_qkvw": {"kernel": _concat([attn_self[n]["kernel"]
                                         for n in qkv]),
                      "bias": _concat([attn_self[n]["bias"] for n in qkv])},
        "attn_ow": {"kernel": attn_out["dense"]["kernel"],
                    "bias": attn_out["dense"]["bias"]},
        "attn_layer_norm": {"scale": attn_out["LayerNorm"]["scale"],
                            "bias": attn_out["LayerNorm"]["bias"]},
        "inter_w": {"kernel": hf_layer["intermediate"]["dense"]["kernel"],
                    "bias": hf_layer["intermediate"]["dense"]["bias"]},
        "output_w": {"kernel": hf_layer["output"]["dense"]["kernel"],
                     "bias": hf_layer["output"]["dense"]["bias"]},
        "layer_norm": {"scale": hf_layer["output"]["LayerNorm"]["scale"],
                       "bias": hf_layer["output"]["LayerNorm"]["bias"]},
    }}


def revert_bert_layer_params(ds_layer):
    """DeepSpeedTransformerLayer parameters -> HF BERT layer parameters
    (the reference's `replace_module.py:93`)."""
    core = ds_layer["core"]
    qk, kk, vk = _split3(core["attn_qkvw"]["kernel"])
    qb, kb, vb = _split3(core["attn_qkvw"]["bias"])
    return {
        "attention": {
            "self": {
                "query": {"kernel": qk, "bias": qb},
                "key": {"kernel": kk, "bias": kb},
                "value": {"kernel": vk, "bias": vb},
            },
            "output": {
                "dense": {"kernel": core["attn_ow"]["kernel"],
                          "bias": core["attn_ow"]["bias"]},
                "LayerNorm": {"scale": core["attn_layer_norm"]["scale"],
                              "bias": core["attn_layer_norm"]["bias"]},
            },
        },
        "intermediate": {
            "dense": {"kernel": core["inter_w"]["kernel"],
                      "bias": core["inter_w"]["bias"]},
        },
        "output": {
            "dense": {"kernel": core["output_w"]["kernel"],
                      "bias": core["output_w"]["bias"]},
            "LayerNorm": {"scale": core["layer_norm"]["scale"],
                          "bias": core["layer_norm"]["bias"]},
        },
    }


def replace_module(params, policy: Callable[[tuple, Any], Optional[Any]]):
    """Generic recursive walker (the reference's
    `replace_module.py:161-193`): `policy(path, subtree)` returns a
    replacement subtree or None to recurse. Returns (new_tree,
    replaced_count)."""
    count = 0

    def walk(path, node):
        nonlocal count
        if isinstance(node, dict):
            replacement = policy(path, node)
            if replacement is not None:
                count += 1
                return replacement
            return {k: walk(path + (k,), v) for k, v in node.items()}
        return node

    return walk((), params), count


def replace_transformer_layer(orig_layer_impl=None, model=None,
                              params=None, config=None,
                              micro_batch_size=-1, bert_config=None,
                              seed=-1, preln=False, fp16=False,
                              training=True):
    """Convert every HF BERT layer in `params` to fused-layer parameters
    (the reference's `replace_transformer_layer`, `replace_module.py:6`).

    Returns (transformer_config, new_params, num_replaced). Run the
    converted layers with DeepSpeedTransformerLayer(transformer_config).
    """
    if params is None:
        raise ValueError("pass the HF model's parameter tree as params=")
    hidden = None
    heads = None
    if bert_config is not None:
        hidden = getattr(bert_config, "hidden_size", None)
        heads = getattr(bert_config, "num_attention_heads", None)
    converted_kernels = []

    def policy(path, node):
        if not _is_hf_bert_layer(node):
            return None
        out = convert_bert_layer_params(node)
        converted_kernels.append(out["core"]["attn_qkvw"]["kernel"])
        return out

    new_params, count = replace_module(params, policy)
    if count == 0:
        logger.warning("replace_transformer_layer: no BERT layers found")
    if config is None and hidden is None and count > 0:
        # the geometry from the converted qkv kernel: [hidden, 3 * hidden]
        hidden = int(converted_kernels[0].shape[0])
    if config is None and heads is None and hidden is not None:
        # BERT-family models use head_dim 64; pass bert_config= to
        # override
        heads = max(hidden // 64, 1)
        logger.warning(
            f"replace_transformer_layer: num_attention_heads not given; "
            f"assuming head_dim=64 -> heads={heads}")
    ds_config = config or DeepSpeedTransformerConfig(
        hidden_size=hidden if hidden is not None else -1,
        heads=heads if heads is not None else -1,
        pre_layer_norm=preln,
        fp16=fp16,
        training=training)
    return ds_config, new_params, count


def revert_transformer_layer(params):
    """The inverse conversion over a whole tree (the reference's
    `replace_module.py:93`). Returns (new_params, num_reverted)."""
    def policy(path, node):
        if isinstance(node.get("core"), dict) and \
                "attn_qkvw" in node["core"]:
            return revert_bert_layer_params(node)
        return None

    return replace_module(params, policy)
