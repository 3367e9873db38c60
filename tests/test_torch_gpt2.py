"""PyTorch port: the GPT-2 inference forward against the JAX package.

A JAX GPT-2 tree (tiny config, numpy-converted) goes through
`models.convert.params_from_jax` into the port; both packages then
compute logits of the same numpy-seeded ids. The JAX forward runs with
flash attention in Pallas interpret mode (T=128 takes flash) and with
fused_ops "on" (the fused epilogue chain and the boundary carry) and
"off" (op by op); the port runs the same phrasing on the CPU through
its plain twins.

Tolerance: fp32 throughout, two layers; the packages differ only in
reduction order, so logits agree to atol = rtol = 1e-5 (observed
~3e-7).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jgpt2.tiny_gpt2_config(n_positions=128)
    params = jgpt2.GPT2ForCausalLM(cfg).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_forward_logits_match_jax(jax_tree, fused):
    ids = np.random.RandomState(1).randint(0, 256, (2, 128)).astype(np.int32)
    jcfg = jgpt2.tiny_gpt2_config(n_positions=128, fused_ops=fused)
    ref = np.asarray(jgpt2.GPT2ForCausalLM(jcfg).apply(jax_tree, ids))
    tcfg = tgpt2.tiny_gpt2_config(n_positions=128, fused_ops=fused)
    model = tgpt2.GPT2ForCausalLM(tcfg, device="cpu")
    params = model.load_params(params_from_jax(jax_tree))
    got = model.apply(params, ids)
    assert got.shape == (2, 128, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_params_from_jax_layout(jax_tree):
    params = params_from_jax(jax_tree)
    cfg = tgpt2.tiny_gpt2_config(n_positions=128)
    own = tgpt2.GPT2ForCausalLM(cfg, device="cpu").params()
    assert set(params) == set(own)
    for name, value in params.items():
        assert tuple(value.shape) == tuple(own[name].shape), name
    stacked = jax_tree["h"]["GPT2Block_0"]
    # [in, out] kernels: an unstack, no transpose
    np.testing.assert_array_equal(params["h.1.c_attn.kernel"].numpy(),
                                  stacked["c_attn"]["kernel"][1])
    np.testing.assert_array_equal(params["h.0.ln_2.scale"].numpy(),
                                  stacked["ln_2"]["scale"][0])


def test_params_from_jax_accepts_the_remat_child_name(jax_tree):
    """Under remat the JAX scan child is CheckpointGPT2Block_0 (same
    leaves); the converter takes either name and nothing else."""
    rcfg = jgpt2.tiny_gpt2_config(n_positions=128, remat=True)
    shapes = jax.eval_shape(
        lambda: jgpt2.GPT2ForCausalLM(rcfg).init(
            jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8),
                                                          np.int32)}))
    (child,) = shapes["h"]
    assert child == "CheckpointGPT2Block_0"
    renamed = dict(jax_tree, h={child: jax_tree["h"]["GPT2Block_0"]})
    a, b = params_from_jax(renamed), params_from_jax(jax_tree)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError):
        params_from_jax(dict(jax_tree, h={"MoECell_0": {}}))


def test_config_and_sizes_match_jax():
    j_fields = {f.name for f in dataclasses.fields(jgpt2.GPT2Config)}
    t_fields = {f.name for f in dataclasses.fields(tgpt2.GPT2Config)}
    assert j_fields == t_fields
    jd, td = jgpt2.GPT2Config(), tgpt2.GPT2Config()
    for name in j_fields - {"dtype", "param_dtype"}:
        assert getattr(jd, name) == getattr(td, name), name
    assert td.dtype == torch.bfloat16 and td.param_dtype == torch.float32
    assert jgpt2.GPT2_SIZES == tgpt2.GPT2_SIZES
    for name in tgpt2.GPT2_SIZES:
        assert tgpt2.gpt2_config(name).head_dim == \
            jgpt2.gpt2_config(name).head_dim


def test_init_follows_the_jax_per_leaf_scheme():
    cfg = tgpt2.tiny_gpt2_config(n_layer=4, n_embd=128)
    model = tgpt2.GPT2ForCausalLM(cfg, device="cpu")
    p = model.init(seed=3)
    assert torch.equal(p["h.0.c_attn.bias"], torch.zeros(3 * 128))
    assert torch.equal(p["ln_f.scale"], torch.ones(128))
    assert abs(float(p["wte"].std()) - 0.02) < 2e-3
    assert abs(float(p["h.2.c_fc.kernel"].std()) - 0.02) < 2e-3
    proj = 0.02 / np.sqrt(2 * 4)
    assert abs(float(p["h.1.mlp_c_proj.kernel"].std()) - proj) < 1e-3
    # same seed, same weights
    again = tgpt2.GPT2ForCausalLM(cfg, device="cpu").init(seed=3)
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_out_of_slice_options_raise():
    cfg = tgpt2.tiny_gpt2_config()
    for bad in (dict(moe=object()), dict(quantized_compute="on"),
                dict(sequence_parallel="ring")):
        with pytest.raises(NotImplementedError):
            tgpt2.GPT2ForCausalLM(dataclasses.replace(cfg, **bad),
                                  device="cpu")
    model = tgpt2.GPT2ForCausalLM(cfg, device="cpu")
    ids = np.zeros((1, 8), np.int64)
    with pytest.raises(NotImplementedError):
        model.apply(model.params(), ids, deterministic=False)
    # training is ported (slice 2); its later-slice options still raise
    with pytest.raises(NotImplementedError):
        model.loss_fn(model.params(), {"input_ids": ids},
                      layer_keep_prob=0.5)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config())


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|flax)\b|from\s+(jax|jaxlib|flax)\b|"
    r"import\s+deepspeed_tpu(\.|\s|$)|from\s+deepspeed_tpu(\.|\s))",
    re.MULTILINE)


def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
    """A source scan of the port and chip_smoke.py: no jax/flax import
    and no import of deepspeed_tpu (deepspeed_tpu_torch is fine)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "deepspeed_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            src = f.read()
        bad = [m.group(0).strip() for m in _FORBIDDEN.finditer(src)]
        assert not bad, (path, bad)
