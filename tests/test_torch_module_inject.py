"""PyTorch port: module injection (`module_inject/replace_module.py`)
against the JAX package.

HF-layout BERT layer trees built from a numpy seed ([in, out] dense
kernels, as HF's Flax BERT keeps them) convert into the fused layer's
parameters and back; the converted layer reproduces the HF post-LN
layer's math; the tree walk replaces every layer and counts them; and
the port's converted tree equals the JAX package's leaf for leaf, from
a tensor tree and from a numpy tree. Importing the slice's modules
(the layer, BERT, module injection) loads nothing of JAX.

Tolerance: the converted layer against HF's math in fp32 within 2e-4
absolute and relative, the JAX test's (`tests/test_bert_and_inject.py`;
dense attention and LayerNorm in another association, observed
<= 7.2e-7 absolute); conversion itself is exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.module_inject import (
    convert_bert_layer_params as jconvert,
    replace_transformer_layer as jreplace)
from deepspeed_tpu_torch.module_inject import (convert_bert_layer_params,
                                               replace_transformer_layer,
                                               revert_bert_layer_params,
                                               revert_transformer_layer)
from deepspeed_tpu_torch.ops import module_inject as ops_inject
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-4, rtol=2e-4)


def _fake_hf_bert_layer(h=64, inter=128, seed=0, as_numpy=False):
    rng = np.random.RandomState(seed)

    def leaf(x):
        x = x.astype(np.float32)
        return x if as_numpy else torch.from_numpy(x)

    def dense(i, o):
        return {"kernel": leaf(rng.randn(i, o) * 0.02),
                "bias": leaf(rng.randn(o) * 0.02)}

    def ln(n):
        return {"scale": leaf(1.0 + 0.1 * rng.randn(n)),
                "bias": leaf(0.1 * rng.randn(n))}

    return {
        "attention": {
            "self": {"query": dense(h, h), "key": dense(h, h),
                     "value": dense(h, h)},
            "output": {"dense": dense(h, h), "LayerNorm": ln(h)},
        },
        "intermediate": {"dense": dense(h, inter)},
        "output": {"dense": dense(inter, h), "LayerNorm": ln(h)},
    }


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


@pytest.mark.parametrize("as_numpy", [False, True], ids=["torch", "numpy"])
def test_convert_revert_roundtrip(as_numpy):
    hf = _fake_hf_bert_layer(as_numpy=as_numpy)
    ds = convert_bert_layer_params(hf)
    kernel = ds["core"]["attn_qkvw"]["kernel"]
    assert tuple(kernel.shape) == (64, 192)
    assert isinstance(kernel, np.ndarray if as_numpy else torch.Tensor)
    back = revert_bert_layer_params(ds)
    want, got = dict(_leaves(hf)), dict(_leaves(back))
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("as_numpy", [False, True], ids=["torch", "numpy"])
def test_converted_tree_equals_jax(as_numpy):
    hf = _fake_hf_bert_layer(seed=3, as_numpy=as_numpy)
    jhf = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), hf)
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jconvert(jhf))))
    got = dict(_leaves(convert_bert_layer_params(hf)))
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_converted_layer_matches_hf_math():
    """The fused layer with converted parameters reproduces the HF BERT
    post-LN layer computation (the criterion of the reference's
    test_cuda_forward.py)."""
    h, nh, inter, t = 64, 4, 128, 64
    hf = _fake_hf_bert_layer(h, inter)
    ds_params = convert_bert_layer_params(hf)
    cfg = DeepSpeedTransformerConfig(
        hidden_size=h, intermediate_size=inter, heads=nh,
        attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
        num_hidden_layers=1, pre_layer_norm=False, training=False,
        layer_norm_eps=1e-12)
    layer = DeepSpeedTransformerLayer(cfg, device="cpu")
    layer.load_state_dict({name: torch.from_numpy(v) for name, v in
                           _leaves(ds_params)})
    x = torch.from_numpy(np.random.RandomState(1).randn(2, t, h)
                         .astype(np.float32))
    with torch.no_grad():
        out = layer(x)

    def d(p, v):
        return v @ p["kernel"] + p["bias"]

    def lnorm(p, v, eps=1e-12):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]

    att = hf["attention"]
    q, k, v = (d(att["self"][n], x).reshape(2, t, nh, h // nh)
               for n in ("query", "key", "value"))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(h // nh)
    ctx = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v) \
        .reshape(2, t, h)
    attn = lnorm(att["output"]["LayerNorm"], x + d(att["output"]["dense"],
                                                   ctx))
    mlp = d(hf["output"]["dense"], torch.nn.functional.gelu(
        d(hf["intermediate"]["dense"], attn)))
    ref = lnorm(hf["output"]["LayerNorm"], attn + mlp)
    torch.testing.assert_close(out, ref, **TOL)


def test_replace_transformer_layer_tree_walk():
    tree = {
        "embeddings": {"word": {"kernel": torch.zeros((10, 64))}},
        "encoder": {"layer": {
            "0": _fake_hf_bert_layer(seed=0),
            "1": _fake_hf_bert_layer(seed=1),
        }},
    }
    cfg, new_tree, count = replace_transformer_layer(params=tree,
                                                     bert_config=None)
    assert count == 2
    assert "attn_qkvw" in new_tree["encoder"]["layer"]["0"]["core"]
    assert new_tree["embeddings"]["word"]["kernel"] is \
        tree["embeddings"]["word"]["kernel"]   # untouched
    # the geometry from the qkv kernel, head dim 64 assumed
    assert isinstance(cfg, DeepSpeedTransformerConfig)
    assert cfg.hidden_size == 64 and cfg.heads == 1
    jcfg, _, jcount = jreplace(params=jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x)), tree), bert_config=None)
    assert jcount == count and vars(jcfg) == vars(cfg)
    reverted, rcount = revert_transformer_layer(new_tree)
    assert rcount == 2
    assert "query" in reverted["encoder"]["layer"]["0"]["attention"]["self"]
    # the ops alias is the same implementation
    assert ops_inject.replace_transformer_layer is replace_transformer_layer


def test_replace_takes_the_bert_config_geometry():
    class HFConfig:
        hidden_size = 64
        num_attention_heads = 4

    cfg, _, count = replace_transformer_layer(
        params={"layer": _fake_hf_bert_layer()}, bert_config=HFConfig(),
        preln=True)
    assert count == 1 and cfg.heads == 4 and cfg.pre_layer_norm
    _, same, none = replace_transformer_layer(params={"x": {"y": 1}})
    assert none == 0 and same == {"x": {"y": 1}}
    with pytest.raises(ValueError, match="params="):
        replace_transformer_layer()


def test_bert_slice_imports_load_no_jax():
    """The slice's modules and the package root (which re-exports the
    layer) leave no jax/flax module and nothing of deepspeed_tpu in
    sys.modules."""
    code = (
        "import sys\n"
        "import deepspeed_tpu_torch\n"
        "from deepspeed_tpu_torch import DeepSpeedTransformerLayer\n"
        "import deepspeed_tpu_torch.models.bert\n"
        "import deepspeed_tpu_torch.module_inject\n"
        "import deepspeed_tpu_torch.ops.module_inject\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deepspeed_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
