"""PyTorch port: checkpoints against the JAX package, both ways, in each
mode of tests/test_torch_checkpoint.py (split out of it, whose
docstring sets out what these hold and their tolerances, and whose modes
and helpers they share, to spread the test clock over workers).
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io

from test_torch_checkpoint import (BF16_TOL, FP32_TOL, MODES, _batches,
                                   _bits, _ds_config, _flat, _jax_flat,
                                   _model_cfgs, _port_engine)
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=list(MODES))
def jax_run(request, tmp_path_factory):
    """The JAX engine of a mode after two steps and a save to
    `<dir>/jax` (tag "t"), then one more step (its loss is the next
    loss after the save), with the initial tree."""
    mode = request.param
    jcfg, _ = _model_cfgs(mode)
    model = jgpt2.GPT2ForCausalLM(jcfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    engine = deepspeed_tpu.initialize(model=model, model_parameters=params,
                                      config=_ds_config(mode))[0]
    batches = _batches()
    for b in batches[:2]:
        engine.train_batch(batch=b)
    root = tmp_path_factory.mktemp(f"ckpt_{mode}")
    engine.save_checkpoint(str(root / "jax"), tag="t", async_save=False)
    next_loss = float(engine.train_batch(batch=batches[2]))
    return dict(mode=mode, engine=engine, root=root, batches=batches,
                next_loss=next_loss,
                tree=jax.tree_util.tree_map(np.asarray, params))


def _port_save_after_two_steps(run):
    """A port engine from the run's initial tree, two steps, saved to
    `<dir>/port` (tag "t"); returns the engine (once, per run)."""
    if "port" not in run:
        engine = _port_engine(run["mode"], run["tree"])
        for b in run["batches"][:2]:
            engine.train_batch(batch=b)
        engine.save_checkpoint(str(run["root"] / "port"), tag="t",
                               async_save=False)
        run["port"] = engine
    return run["port"]


def _loss_tol(mode):
    return BF16_TOL if MODES[mode]["bf16"] is not None else FP32_TOL


def test_port_writes_the_jax_entries(jax_run):
    _port_save_after_two_steps(jax_run)
    jflat, jmeta, jopt = _flat(str(jax_run["root"] / "jax"))
    pflat, pmeta, popt = _flat(str(jax_run["root"] / "port"))

    def layout(flat):
        return {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}

    assert layout(pflat) == layout(jflat)
    assert set(pmeta) == set(jmeta) | {"torch_rng"}
    assert popt == jopt
    for key in ("global_steps", "skipped_steps", "micro_steps",
                "lr_scheduler"):
        assert pmeta[key] == jmeta[key], key
    assert pmeta["rng"].dtype == np.uint32 and pmeta["rng"].shape == (2,)
    if MODES[jax_run["mode"]]["stage"]:
        # the JAX save sharded the moments into bucket files
        assert any(n.startswith("zero_pp_rank") for n in
                   os.listdir(jax_run["root"] / "jax" / "t"))


def test_jax_checkpoint_loads_into_port(jax_run):
    mode = jax_run["mode"]
    src = str(jax_run["root"] / "jax")
    engine = _port_engine(mode, jax_run["tree"])
    with mock.patch.object(ckpt_io.logger, "warning") as warn:
        path, client = engine.load_checkpoint(src)
    assert path.endswith("t") and client == {}
    assert not warn.called, warn.call_args_list
    # the loaded state, written back, holds the file's bytes in every
    # entry but the injected learning rate (each package evaluates its
    # schedule)
    engine.save_checkpoint(str(jax_run["root"] / "reload"), tag="t",
                           async_save=False)
    jflat, jmeta, _ = _flat(src)
    pflat, pmeta, _ = _flat(str(jax_run["root"] / "reload"))
    lr_key = "optim.hyperparams['learning_rate']"
    for key, value in jflat.items():
        if key == lr_key:
            np.testing.assert_allclose(pflat[key], value, rtol=1e-6)
        else:
            assert _bits(pflat[key]) == _bits(value), key
    moments = [k for k in jflat if ".mu[" in k or ".nu[" in k]
    assert moments and all(bool(torch.any(jflat[k] != 0))
                           for k in moments if ".nu[" in k)
    assert engine.global_steps == 2 and engine.micro_steps == 2
    loss = float(engine.train_batch(batch=jax_run["batches"][2]))
    ref = jax_run["next_loss"]
    assert abs(loss - ref) <= _loss_tol(mode) * abs(ref), (loss, ref)


def test_port_checkpoint_loads_into_jax(jax_run):
    mode = jax_run["mode"]
    port = _port_save_after_two_steps(jax_run)
    jengine = jax_run["engine"]
    src = str(jax_run["root"] / "port")
    with mock.patch("deepspeed_tpu.runtime.engine.logger") as log:
        path, client = jengine.load_checkpoint(src, tag="t")
    warnings = [str(c.args[0]) for c in log.warning.call_args_list]
    assert not any("reset" in w for w in warnings), warnings
    assert set(client) == {"torch_rng"}
    assert jengine.global_steps == 2
    pflat, _, _ = _flat(src)
    # the checkpoint-facing trees (ZeRO's padding taken off)
    payload = jengine._ckpt_payload(jengine.state)
    jmodule = _jax_flat(payload["module"], "module")
    jopt = _jax_flat(payload["opt_state"], "optim")
    assert set(jmodule) | set(jopt) == {k for k in pflat
                                        if not k.startswith("aux/")}
    for key, value in {**jmodule, **jopt}.items():
        assert _bits(pflat[key]) == _bits(value), key
    batch = jax_run["batches"][3]
    ref = float(port.train_batch(batch=batch))
    loss = float(jengine.train_batch(batch=batch))
    assert abs(loss - ref) <= _loss_tol(mode) * abs(ref), (loss, ref)
