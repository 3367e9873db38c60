"""PyTorch port: LAMB, SGD, 1-bit Adam and the client objects through
both engines in fp16, their checkpoints both ways and the port's resume
(split out of tests/test_torch_optimizers.py, whose docstring sets out
what these hold and their tolerances, and whose cases and helpers they
share, to spread the test clock over workers).
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
from deepspeed_tpu.ops.lamb import fused_lamb as jlamb
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu_torch.models.convert import optimizer_state_to_jax
from deepspeed_tpu_torch.ops.lamb import fused_lamb as tlamb
from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io
from deepspeed_tpu_torch.runtime import lr_schedules as tsched

from test_torch_optimizers import (ENGINE_CASES, LOSS_TOL, SAVE_AFTER,
                                   STATE_TOL, _batches, _client_objects,
                                   _config, _jax_opt_flat, _port)
from test_torch_optimizers import tiny_tree  # noqa: F401 (the fixture)
from torch_one_thread import one_torch_thread  # noqa: F401


def _flat(path):
    return ckpt_io.load_checkpoint_flat(path, "t")[0]


def _bits(x):
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.fixture(scope="module", params=list(ENGINE_CASES))
def opt_run(request, tiny_tree, tmp_path_factory):
    """Both engines of one optimizer case through KINDS, each saving after
    the fourth step (tag "t" under `<root>/jax` and `<root>/port`); the
    port on one CPU thread (its resume is compared bit for bit)."""
    case = request.param
    jmodel, jparams, tree = tiny_tree
    spec = ENGINE_CASES[case]

    def engines():
        if spec.get("client"):
            jopt, jsch = _client_objects(jlamb, jsched)
            topt, tsch = _client_objects(tlamb, tsched)
            return (deepspeed_tpu.initialize(
                model=jmodel, model_parameters=jparams, config=_config(),
                optimizer=jopt.transformation, lr_scheduler=jsch)[0],
                    _port(tree, _config(), optimizer=topt,
                          lr_scheduler=tsch))
        return (deepspeed_tpu.initialize(
            model=jmodel, model_parameters=jparams,
            config=_config(spec["optimizer"]))[0],
                _port(tree, _config(spec["optimizer"])))

    root = tmp_path_factory.mktemp(f"opt_{case}")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jengine, engine = engines()
        steps = []
        for i, batch in enumerate(_batches()):
            if i == SAVE_AFTER:
                jengine.save_checkpoint(str(root / "jax"), tag="t",
                                        async_save=False)
                engine.save_checkpoint(str(root / "port"), tag="t",
                                       async_save=False)
            ref = float(jengine.train_batch(batch=batch))
            got = engine.train_batch(batch=batch)
            steps.append(dict(
                ref=ref, got=got.clone(),
                counts=(engine.skipped_steps, engine.loss_scale()),
                jcounts=(jengine.skipped_steps, jengine.loss_scale()),
                lrs=(engine.get_lr(), jengine.get_lr())))
    finally:
        torch.set_num_threads(threads)
    return dict(case=case, root=root, jengine=jengine, engine=engine,
                steps=steps, make_port=lambda: engines()[1])


def test_optimizer_trajectory_matches_jax_engine(opt_run):
    engine, jengine = opt_run["engine"], opt_run["jengine"]
    for i, step in enumerate(opt_run["steps"]):
        got, ref = float(step["got"]), step["ref"]
        assert abs(got - ref) <= LOSS_TOL * abs(ref), (i, got, ref)
        assert step["counts"] == step["jcounts"], (i, step)
        np.testing.assert_allclose(*step["lrs"], rtol=1e-6)
    assert engine.skipped_steps == 2
    assert int(engine.state.global_steps) == \
        int(jax.device_get(jengine.state.global_steps)) == 3
    want = _jax_opt_flat(jengine)
    got = optimizer_state_to_jax(engine)
    assert set(got) == set(want)
    fields = {}
    for key, w in want.items():
        g = np.asarray(got[key], np.float32)
        if "[" not in key:   # counts and hyperparameters
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
            continue
        # per state field (every leaf's mu, say): the key bias's
        # gradient is zero in exact arithmetic, so its moments are each
        # package's fp16 roundoff and compare only within the field
        field = fields.setdefault(key[:key.index("[")], [[], []])
        field[0].append(g.ravel())
        field[1].append(w.ravel())
    assert fields
    fields = {k: [np.concatenate(x) for x in v] for k, v in fields.items()}
    if ".exp_avg" in fields:
        # 1-bit Adam's momentum is scale * sign past freeze_step, and a
        # near-zero entry's sign is roundoff: compare what it compresses,
        # exp_avg + worker_error (the corrected momentum), continuous
        for i in (0, 1):
            fields[".exp_avg"][i] = fields[".exp_avg"][i] + \
                fields[".worker_error"][i]
        del fields[".worker_error"]
    for name, (g, w) in fields.items():
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= STATE_TOL, (name, err)


def test_optimizer_checkpoints_load_both_ways(opt_run):
    """The JAX engine's save loads into the port (written back: every
    entry's bytes but the injected lr, the moments among them); the
    port's loads into the JAX engine (every leaf of its state equals the
    port file's bytes)."""
    root = opt_run["root"]
    engine = opt_run["make_port"]()
    with mock.patch.object(ckpt_io.logger, "warning") as warn:
        engine.load_checkpoint(str(root / "jax"), tag="t")
    assert not warn.called, warn.call_args_list
    engine.save_checkpoint(str(root / "reload"), tag="t", async_save=False)
    jflat, pflat = _flat(str(root / "jax")), _flat(str(root / "reload"))
    assert set(pflat) == set(jflat)
    assert sum(k.startswith("optim") and "[" in k for k in jflat) >= 8
    for key, value in jflat.items():
        if key.endswith("['learning_rate']"):
            np.testing.assert_allclose(pflat[key], value, rtol=1e-6)
        else:
            assert _bits(pflat[key]) == _bits(value), key
    jengine = opt_run["jengine"]
    with mock.patch("deepspeed_tpu.runtime.engine.logger") as log:
        jengine.load_checkpoint(str(root / "port"), tag="t")
    warnings = [str(c.args[0]) for c in log.warning.call_args_list]
    assert not any("reset" in w or "not loaded" in w for w in warnings), \
        warnings
    pflat = _flat(str(root / "port"))
    payload = jengine._ckpt_payload(jengine.state)
    for prefix, name in (("module", "module"), ("opt_state", "optim")):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(payload[prefix]))[0]:
            key = name + jax.tree_util.keystr(path)
            assert _bits(pflat[key]) == _bits(leaf), key


def test_optimizer_port_resume_is_bit_exact(opt_run):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine = opt_run["make_port"]()
        engine.load_checkpoint(str(opt_run["root"] / "port"), tag="t")
        for i, batch in enumerate(_batches()):
            if i < SAVE_AFTER:
                continue
            loss = engine.train_batch(batch=batch)
            assert torch.equal(loss, opt_run["steps"][i]["got"]), i
    finally:
        torch.set_num_threads(threads)
    for name, p in opt_run["engine"].params.items():
        assert torch.equal(p, engine.params[name]), name
    for a, b in zip(engine._state_tensors(engine.state.opt_state),
                    opt_run["engine"]._state_tensors(
                        opt_run["engine"].state.opt_state)):
        assert torch.equal(a, b)
