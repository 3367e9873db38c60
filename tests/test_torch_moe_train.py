"""PyTorch port: mixture-of-experts GPT-2 training against the JAX package.

A JAX MoE GPT-2 tree (every other layer MoE, 4 experts, top-2) goes
through `params_from_jax` into the port; both packages compute the loss
(cross-entropy + aux_loss_weight * aux), the router stats and every
gradient on the same numpy-seeded ids, with remat on and off and the
port on both dispatch routes (the K8 twins and the einsum pair). Then
`initialize` -> `train_batch` with the `moe` block runs 10 steps in both
engines at gradient accumulation 1 and 2.

Tolerances (fp32; the packages differ in reduction order only, and the
routing, which is discontinuous, comes out equal): loss within 1e-6
relative, stats within 1e-6, every gradient within 1e-5 relative L2
(observed <= 7e-7). The 10-step trajectory (AdamW with a warm-up
schedule, no clipping): each step's loss within 1e-6 relative (observed
<= 2.8e-7 at gas 1 and 2). Gradient clipping is left to the dense
trajectory test (`test_torch_engine.py`), which runs the same engine
code: with clip 0.5 here the per-step clip factor carries the ~1e-7
gradient differences into every update, and the gap grows to ~1.5e-6 by
step 10. bf16 (the JAX model's own bf16 compute on the same tree): the loss
within 2e-3 relative, several bf16 roundings of the residual stream.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.moe import MoEConfig as JMoE
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.moe import MoEConfig as TMoE
from deepspeed_tpu_torch.moe import STAT_AUX
from torch_one_thread import one_torch_thread  # noqa: F401

MOE = dict(num_experts=4, top_k=2, capacity_factor=1.0, every_n_layers=2)
SEQ = 32


def _jcfg(**over):
    base = dict(n_layer=4, n_positions=SEQ, moe=JMoE(**MOE).validate())
    base.update(over)
    return jgpt2.tiny_gpt2_config(**base)


def _tcfg(**over):
    base = dict(n_layer=4, n_positions=SEQ, moe=TMoE(**MOE).validate())
    base.update(over)
    return tgpt2.tiny_gpt2_config(**base)


def _ids(rows=4, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (rows, SEQ)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def jax_tree():
    model = jgpt2.GPT2ForCausalLM(_jcfg())
    params = model.init(jax.random.PRNGKey(0), {"input_ids": _ids()})
    return params, jax.tree_util.tree_map(np.asarray, params)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_moe_loss_grads_and_stats_match_jax(jax_tree, remat, fused):
    params, tree = jax_tree
    ids = _ids(seed=1)
    jmodel = jgpt2.GPT2ForCausalLM(_jcfg(remat=remat))
    if remat:
        # the remat tree names its scanned children Checkpoint*
        params = {**params, "h": {"Checkpoint" + k: v
                                  for k, v in params["h"].items()}}
    (j_loss, j_stats), j_grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {"input_ids": ids}, deterministic=True,
                                 return_router_stats=True),
        has_aux=True)(params)
    j_flat = params_from_jax(jax.tree_util.tree_map(np.asarray, j_grads))

    tcfg = _tcfg(remat=remat, moe=dataclasses.replace(
        TMoE(**MOE), fused_dispatch=fused))
    model = tgpt2.GPT2ForCausalLM(tcfg, device="cpu")
    p = {k: v.clone().requires_grad_(True)
         for k, v in model.load_params(params_from_jax(tree)).items()}
    loss, stats = model.loss_fn(p, {"input_ids": ids}, deterministic=True,
                                return_router_stats=True)
    grads = torch.autograd.grad(loss, list(p.values()))
    assert abs(float(loss.detach()) - float(j_loss)) <= \
        1e-6 * abs(float(j_loss))
    np.testing.assert_allclose(stats.detach().numpy(), j_stats, atol=1e-6,
                               rtol=1e-6)
    assert set(j_flat) == set(p)
    for name, g in zip(p, grads):
        assert _rel(g.numpy(), j_flat[name]) <= 1e-5, name
    # the aux term rides the loss
    ce = tgpt2.GPT2ForCausalLM(dataclasses.replace(tcfg, moe=dataclasses
                               .replace(tcfg.moe, aux_loss_weight=0.0)),
                               device="cpu")
    ce_loss = ce.loss_fn(p, {"input_ids": ids}, deterministic=True).detach()
    assert abs(float(ce_loss) + 0.01 * float(stats[STAT_AUX]) -
               float(loss)) <= 1e-6


def test_moe_bf16_loss_matches_jax(jax_tree):
    tree = jax_tree[1]
    ids = _ids(seed=2)
    bf = dict(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    jmodel = jgpt2.GPT2ForCausalLM(_jcfg(**bf))
    jtree = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                   tree)
    ref = float(jmodel.loss_fn(jtree, {"input_ids": ids},
                               deterministic=True))
    model = tgpt2.GPT2ForCausalLM(_tcfg(dtype=torch.bfloat16,
                                        param_dtype=torch.bfloat16),
                                  device="cpu")
    params = model.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtree)))
    got = float(model.loss_fn(params, {"input_ids": ids},
                              deterministic=True))
    assert abs(got - ref) <= 2e-3 * abs(ref), (got, ref)


def test_params_from_jax_maps_the_moe_cells(jax_tree):
    """Cell c of the JAX scan holds layers 2c (dense) and 2c + 1 (MoE);
    the remat names map the same; a three-layer cell numbers its dense
    children 0 and 1."""
    tree = jax_tree[1]
    flat = params_from_jax(tree)
    model = tgpt2.GPT2ForCausalLM(_tcfg(), device="cpu")
    assert set(flat) == set(model.params())
    np.testing.assert_array_equal(
        flat["h.3.moe_mlp.experts.wi"].numpy(),
        tree["h"]["MoEGPT2Block_0"]["moe_mlp"]["experts"]["wi"][1])
    np.testing.assert_array_equal(flat["h.2.c_fc.kernel"].numpy(),
                                  tree["h"]["GPT2Block_0"]["c_fc"]["kernel"][1])
    renamed = dict(tree, h={"Checkpoint" + k: v
                            for k, v in tree["h"].items()})
    again = params_from_jax(renamed)
    assert all(torch.equal(again[k], flat[k]) for k in flat)
    bf = params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), tree))
    assert bf["h.1.moe_mlp.wg"].dtype == torch.bfloat16
    three = jgpt2.GPT2ForCausalLM(_jcfg(n_layer=6, moe=JMoE(
        **dict(MOE, every_n_layers=3))))
    shapes = jax.eval_shape(lambda: three.init(
        jax.random.PRNGKey(0), {"input_ids": _ids()}))
    fake = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    tmodel = tgpt2.GPT2ForCausalLM(_tcfg(n_layer=6, moe=TMoE(
        **dict(MOE, every_n_layers=3))), device="cpu")
    assert set(params_from_jax(fake)) == set(tmodel.params())
    assert isinstance(tmodel.module.h[2], tgpt2.MoEGPT2Block)
    assert isinstance(tmodel.module.h[4], tgpt2.GPT2Block)


def test_moe_hooks_and_what_raises(jax_tree):
    model = tgpt2.GPT2ForCausalLM(_tcfg(), device="cpu")
    info = model.moe_info()
    assert info["num_experts"] == 4 and info["moe_layers"] == 2
    with pytest.raises(ValueError):
        model.configure_moe(num_experts=8)
    with pytest.raises(ValueError):
        model.configure_moe(every_n_layers=1)
    model.configure_moe(top_k=1, capacity_factor=2.0)
    assert model.config.moe.top_k == 1
    assert model.module.h[1].moe_mlp.moe.top_k == 1
    ids = _ids()
    with pytest.raises(ValueError, match="progressive_layer_drop"):
        model.loss_fn(model.params(), {"input_ids": ids},
                      layer_keep_prob=0.5)
    dense = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(), device="cpu")
    with pytest.raises(ValueError):
        dense.configure_moe(num_experts=4)
    assert dense.moe_info() is None
    with pytest.raises(ValueError):
        tgpt2.GPT2ForCausalLM(_tcfg(n_layer=3), device="cpu")
    logits = model.apply(model.load_params(params_from_jax(jax_tree[1])),
                         ids)
    assert logits.shape == (4, SEQ, 256)


def _ds_config(gas, **extra):
    return dict({"train_batch_size": 8 * gas,
                 "gradient_accumulation_steps": gas,
                 "steps_per_print": 1000,
                 "optimizer": {"type": "AdamW",
                               "params": {"lr": 1e-3,
                                          "weight_decay": 0.01}},
                 "scheduler": {"type": "WarmupLR",
                               "params": {"warmup_num_steps": 5,
                                          "warmup_max_lr": 1e-3}},
                 "moe": {"enabled": True, "num_experts": 4, "top_k": 2,
                         "capacity_factor": 1.0, "every_n_layers": 2}},
                **extra)


def _port_engine(tree, config):
    model = tgpt2.GPT2ForCausalLM(_tcfg(moe=TMoE(
        num_experts=4, every_n_layers=2)), device="cpu")
    return dst.initialize(model=model, model_parameters=params_from_jax(tree),
                          config=config)[0]


@pytest.mark.parametrize("gas", [1, 2])
def test_moe_trajectory_matches_jax_engine(jax_tree, gas):
    """10 steps of initialize -> train_batch with the moe block (the
    model is built with the default router knobs; the block sets top_k
    and capacity_factor through configure_moe) in both engines."""
    params, tree = jax_tree
    config = _ds_config(gas)
    jmodel = jgpt2.GPT2ForCausalLM(_jcfg(moe=JMoE(num_experts=4,
                                                  every_n_layers=2)))
    jengine, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params, config=config)
    engine = _port_engine(tree, dict(config,
                                     train_micro_batch_size_per_gpu=8))
    assert engine.module.config.moe.capacity_factor == 1.0
    rng = np.random.RandomState(gas)
    batches = [{"input_ids": rng.randint(0, 256, (gas, 8, SEQ))
                .astype(np.int32)} for _ in range(3)]
    ref, got = [], []
    for step in range(10):
        ref.append(float(jengine.train_batch(batch=batches[step % 3])))
        got.append(float(engine.train_batch(batch=batches[step % 3])))
    ref, got = np.array(ref), np.array(got)
    assert np.all(np.abs(got - ref) <= 1e-6 * np.abs(ref)), (got, ref)
    assert got[-1] < got[0]


def test_moe_train_batch_makes_no_host_sync(jax_tree, monkeypatch):
    engine = _port_engine(jax_tree[1], dict(
        _ds_config(1), train_micro_batch_size_per_gpu=8))
    batch = engine.stage_batch({"input_ids": _ids(8)[None]})
    engine.train_batch(batch=batch)
    calls = []
    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
                 "__int__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("synchronize"))
    for _ in range(2):
        loss = engine.train_batch(batch=batch)
    assert calls == []
    assert isinstance(loss, torch.Tensor) and loss.shape == ()


def test_moe_block_checks_the_model(jax_tree):
    """An enabled moe block on a dense model, or with structural keys
    the model was not built with, raises."""
    dense = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=SEQ),
                                  device="cpu")
    with pytest.raises(ValueError, match="without MoE structure"):
        dst.initialize(model=dense, model_parameters=dense.init(0),
                       config=dict(_ds_config(1),
                                   train_micro_batch_size_per_gpu=8))
    with pytest.raises(ValueError, match="structural"):
        _port_engine(jax_tree[1], dict(_ds_config(1),
                                       train_micro_batch_size_per_gpu=8,
                                       moe={"enabled": True,
                                            "num_experts": 8}))
