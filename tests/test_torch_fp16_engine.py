"""PyTorch port: the fp16 engine against the JAX engine, and the masked
skip (split out of tests/test_torch_fp16.py, whose docstring sets out
what these hold and their tolerances, to spread the test clock over
workers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.lamb import FusedLamb
from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io
from deepspeed_tpu_torch.runtime.bf16_optimizer import adamw_bf16
from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam

from test_torch_fp16 import LOSS_TOL, SEQ
from torch_one_thread import one_torch_thread  # noqa: F401


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def _fp16_config(**extra):
    cfg = {"train_batch_size": 8, "steps_per_print": 1000,
           "gradient_clipping": 0.5,
           "fp16": {"enabled": True, "initial_scale_power": 17,
                    "loss_scale_window": 2, "hysteresis": 2},
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 5,
                                    "warmup_max_lr": 3e-3}}}
    cfg.update(extra)
    return cfg


# the batches of the 10 steps: "u" one repeated token (overflows from
# 2^15), "r" random tokens (clean up to 2^17). With the scale from 2^17,
# window 2 and hysteresis 2: overflow (hysteresis 1), overflow (drop to
# 2^16), clean, overflow (hysteresis 1), clean (the checkpoint: scale,
# good_steps and hysteresis all off their initial values), clean (growth
# to 2^17, hysteresis restored), overflow, overflow (drop), clean, clean
# (growth)
STEP_KINDS = "uurur" + "ruurr"
SAVE_AFTER = 5
WANT_OVERFLOW = [k == "u" for k in STEP_KINDS]


def _batch(kind, i):
    if kind == "u":
        return np.zeros((1, 8, SEQ), np.int32)
    return np.random.RandomState(i).randint(0, 256, (1, 8, SEQ)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def tiny_tree():
    cfg = jgpt2.tiny_gpt2_config(n_positions=SEQ, dtype=jnp.float16)
    model = jgpt2.GPT2ForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _port(tree, config, optimizer=None, lr_scheduler=None):
    model = tgpt2.GPT2ForCausalLM(
        tgpt2.tiny_gpt2_config(n_positions=SEQ, dtype=torch.float16),
        device="cpu")
    return dst.initialize(model=model, model_parameters=params_from_jax(tree),
                          optimizer=optimizer, lr_scheduler=lr_scheduler,
                          config=dict(config,
                                      train_micro_batch_size_per_gpu=8))[0]


def _stats(engine, jax_engine=False):
    state = engine.state
    if jax_engine:
        get = lambda x: np.asarray(jax.device_get(x)).item()  # noqa: E731
    else:
        get = lambda x: x.item()  # noqa: E731
    return (get(state.scale.loss_scale), get(state.scale.good_steps),
            get(state.scale.hysteresis), engine.skipped_steps,
            get(state.global_steps))


@pytest.fixture(scope="module")
def fp16_run(tiny_tree, tmp_path_factory):
    """Both engines through the 10 steps, each saving after step 5 (tag
    "t" under `<root>/jax` and `<root>/port`); per step the losses, the
    scale and step counters, and the lrs. The port runs on one CPU
    thread, so that a resumed run can be compared bit for bit."""
    jmodel, jparams, tree = tiny_tree
    config = _fp16_config(fp16={"enabled": True, "initial_scale_power": 17,
                                "loss_scale_window": 2, "hysteresis": 2})
    root = tmp_path_factory.mktemp("fp16")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jengine = deepspeed_tpu.initialize(
            model=jmodel, model_parameters=jparams, config=config)[0]
        engine = _port(tree, config)
        steps = []
        for i, kind in enumerate(STEP_KINDS):
            if i == SAVE_AFTER:
                jengine.save_checkpoint(str(root / "jax"), tag="t",
                                        async_save=False)
                engine.save_checkpoint(str(root / "port"), tag="t",
                                       async_save=False)
            batch = {"input_ids": _batch(kind, i)}
            ref = float(jengine.train_batch(batch=batch))
            got = engine.train_batch(batch=batch)
            steps.append(dict(ref=ref, got=got.clone(),
                              jstats=_stats(jengine, jax_engine=True),
                              stats=_stats(engine),
                              lrs=(engine.get_lr(), jengine.get_lr())))
    finally:
        torch.set_num_threads(threads)
    return dict(root=root, config=config, tree=tree, jengine=jengine,
                engine=engine, steps=steps)


def test_fp16_engine_matches_jax_engine(fp16_run):
    engine, jengine = fp16_run["engine"], fp16_run["jengine"]
    assert engine.fp16_enabled() and engine.dynamic_loss_scale()
    skipped = 0
    for i, step in enumerate(fp16_run["steps"]):
        got, ref = float(step["got"]), step["ref"]
        assert abs(got - ref) <= LOSS_TOL * abs(ref), (i, got, ref)
        assert step["stats"] == step["jstats"], (i, step)
        assert (step["stats"][3] > skipped) == WANT_OVERFLOW[i], i
        skipped = step["stats"][3]
        np.testing.assert_allclose(*step["lrs"], rtol=1e-6)
    assert fp16_run["steps"][SAVE_AFTER - 1]["stats"] == \
        (2.0 ** 16, 1, 1, 3, 2)
    assert engine.global_steps == jengine.global_steps == 10
    assert engine.skipped_steps == sum(WANT_OVERFLOW) == 5


def _flat(path):
    return ckpt_io.load_checkpoint_flat(path, "t")[:2]


def _bits(x):
    x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x
    return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_fp16_checkpoints_load_both_ways(fp16_run):
    """The JAX engine's directory, saved mid-window (scale 2^16, good
    steps 1, hysteresis 1, 3 skipped), loads into the port: the live
    scale, the counters and, written back, every entry's bytes but the
    injected lr; the port's loads into the JAX engine: every leaf of its
    state and its scale equal the port file's bytes."""
    root = fp16_run["root"]
    engine = _port(fp16_run["tree"], fp16_run["config"])
    engine.load_checkpoint(str(root / "jax"), tag="t")
    assert _stats(engine) == (2.0 ** 16, 1, 1, 3, 2)
    assert engine.global_steps == SAVE_AFTER
    engine.save_checkpoint(str(root / "reload"), tag="t", async_save=False)
    jflat, jmeta = _flat(str(root / "jax"))
    pflat, pmeta = _flat(str(root / "reload"))
    assert set(pflat) == set(jflat)
    assert any(k.startswith("aux/scale") for k in jflat)
    for key, value in jflat.items():
        if key == "optim.hyperparams['learning_rate']":
            np.testing.assert_allclose(pflat[key], value, rtol=1e-6)
        else:
            assert _bits(pflat[key]) == _bits(value), key
    assert pmeta["skipped_steps"] == jmeta["skipped_steps"] == 3
    jengine = fp16_run["jengine"]
    jengine.load_checkpoint(str(root / "port"), tag="t")
    assert _stats(jengine, jax_engine=True) == (2.0 ** 16, 1, 1, 3, 2)
    pflat, _ = _flat(str(root / "port"))
    payload = jengine._ckpt_payload(jengine.state)
    for prefix in ("module", "opt_state"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(payload[prefix]))[0]:
            key = ("module" if prefix == "module" else "optim") + \
                jax.tree_util.keystr(path)
            assert _bits(pflat[key]) == _bits(leaf), key


def test_fp16_port_resume_is_bit_exact(fp16_run):
    """A fresh engine loading the port's mid-window save and taking the
    last 5 steps gives the uninterrupted run's losses, counters and
    parameters bit for bit (one CPU thread, as the run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine = _port(fp16_run["tree"], fp16_run["config"])
        engine.load_checkpoint(str(fp16_run["root"] / "port"), tag="t")
        for i in range(SAVE_AFTER, len(STEP_KINDS)):
            loss = engine.train_batch(
                batch={"input_ids": _batch(STEP_KINDS[i], i)})
            assert torch.equal(loss, fp16_run["steps"][i]["got"]), i
            assert _stats(engine) == fp16_run["steps"][i]["stats"], i
    finally:
        torch.set_num_threads(threads)
    for name, p in fp16_run["engine"].params.items():
        assert torch.equal(p, engine.params[name]), name


def _leaves(engine):
    """Every tensor of the engine's state (parameters, masters, optimizer
    state, counters), detached copies."""
    state = engine.state
    out = list(state.params.values()) + list(state.master or []) + \
        engine._state_tensors(state.opt_state) + [state.global_steps]
    return [t.detach().clone() for t in out]


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


OPTIMIZERS = {
    "adamw": {"type": "AdamW", "params": {"lr": 1e-3,
                                          "weight_decay": 0.01}},
    "lamb": {"type": "Lamb", "params": {"lr": 2e-3, "weight_decay": 0.01}},
    "sgd": {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9}},
    "onebit": {"type": "OneBitAdam", "params": {"lr": 1e-3,
                                                "freeze_step": 1}},
}
class NoKeepAdamW:
    """A client transform whose update takes no `keep`: the engine
    restores its state where a step overflowed."""

    def __init__(self):
        self._t = adamw_bf16(learning_rate=1e-3, state_dtype=torch.float32)
        self.init = self._t.init

    def update(self, grads, state, params=None, lr=None):
        return self._t.update(grads, state, params, lr)


CLIENTS = {
    "fused-lamb": lambda: FusedLamb(lr=2e-3),
    "onebit-facade": lambda: OnebitAdam(lr=1e-3, freeze_step=1),
    "transform": NoKeepAdamW,
}


@pytest.mark.parametrize("name", list(OPTIMIZERS) + list(CLIENTS))
def test_skipped_steps_leave_every_leaf_bit_identical(tiny_tree, name):
    """A clean step, then one whose gradients overflow (a repeated-token
    batch at 2^17, and at a static 2^40 where they hold inf and NaN):
    the skipped step leaves every leaf's bits; the counters count it."""
    tree = tiny_tree[2]
    client = CLIENTS[name]() if name in CLIENTS else None
    extra = {} if client else {"optimizer": OPTIMIZERS[name]}
    for fp16 in ({"enabled": True, "initial_scale_power": 17},
                 {"enabled": True, "loss_scale": 2 ** 40}):
        engine = _port(tree, _fp16_config(fp16=fp16, **extra),
                       optimizer=client)
        static = "loss_scale" in fp16
        if not static:
            engine.train_batch(batch={"input_ids": _batch("r", 0)})
            assert engine.skipped_steps == 0
        before = _leaves(engine)
        scale = engine.loss_scale()
        loss = engine.train_batch(batch={"input_ids": _batch("u", 1)})
        assert bool(torch.isfinite(loss))
        after = _leaves(engine)
        assert len(before) == len(after)
        for a, b in zip(before, after):
            assert _same_bits(a, b)
        assert engine.skipped_steps == 1
        assert engine.global_steps == (1 if static else 2)
        if static:
            assert engine.loss_scale() == scale == 2.0 ** 40
        else:
            assert engine.state.scale.hysteresis.item() == 1


def test_fp16_train_batch_makes_no_host_sync(tiny_tree, monkeypatch):
    """fp16 with the config's scheduler: the unscale, the overflow vote,
    the masked update and the scale automaton read nothing back, also on
    an overflowed step."""
    engine = _port(tiny_tree[2], _fp16_config())
    batches = [engine.stage_batch({"input_ids": _batch(k, i)})
               for i, k in enumerate("ru")]
    engine.train_batch(batch=batches[0])
    calls = []
    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
                 "__int__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    for b in batches * 2:
        engine.train_batch(batch=b)
    assert calls == []
    monkeypatch.undo()
    assert engine.skipped_steps == 2
