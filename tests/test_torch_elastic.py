"""PyTorch port: elasticity, the elastic supervisor at world size 1,
the ZeRO memory plan and `env_report`, against the JAX package.

Held here:
  * `compute_elastic_config` and its helpers equal the JAX package's
    over a grid of configs and world sizes, raising the same error
    classes (exact: integer math);
  * the config resolves the same batch triple as the JAX
    `DeepSpeedConfig` at world size 1, and the same conflicts;
  * `ElasticRuntimeConfig` validates as the JAX one; `classify_failure`
    agrees with it on the same event sequences;
  * `FaultInjector` spawns, kills and reaps real sentinel processes;
  * the supervisor on gpt2-tiny at world size 1: two injected stalls
    escalate into one in-place recovery whose replayed losses are bit
    for bit the pre-failure ones (one torch thread); its event's fields
    equal the JAX supervisor's on one CPU device under the same script,
    and the losses agree within the engines' fp32 training tolerance
    (1e-5 relative, as tests/test_torch_engine.py: reduction order
    only); a lost host raises `ElasticityIncompatibleWorldSize` (the
    JAX supervisor raises its base class `ElasticityError`: nothing is
    left to re-form onto);
  * `ZeroShardingPolicy.memory_plan` equals the JAX policy's at world
    size 1 for stages 0-2, `sr_mode` and gas 1 / 4 (exact);
  * `env_report` and `python -m deepspeed_tpu_torch.elasticity` run on
    the CPU.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu import elasticity as jel
from deepspeed_tpu.elasticity import runtime as jrt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.zero.partition import \
    ZeroShardingPolicy as JPolicy
from deepspeed_tpu.version import __version__ as jversion
from deepspeed_tpu_torch import elasticity as tel
from deepspeed_tpu_torch.elasticity import runtime as trt
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.zero.partition import \
    ZeroShardingPolicy as TPolicy
from deepspeed_tpu_torch.version import __version__ as tversion
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_versions_equal():
    import deepspeed_tpu.version as jv
    import deepspeed_tpu_torch.version as tv
    assert tversion == jversion
    for k in ("__version_major__", "__version_minor__",
              "__version_patch__", "git_hash", "git_branch"):
        assert getattr(tv, k) == getattr(jv, k)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the class name is the outcome compared
        return ("raise", type(e).__name__)


_GRID = [
    dict(max_train_batch_size=10000, micro_batch_sizes=[8, 12, 16, 17],
         min_gpus=32, max_gpus=1500),
    dict(max_train_batch_size=2000, micro_batch_sizes=[2, 4],
         min_gpus=1, max_gpus=100),
    dict(max_train_batch_size=48, micro_batch_sizes=[2]),
    dict(max_train_batch_size=4, micro_batch_sizes=[2]),
    dict(max_train_batch_size=720, micro_batch_sizes=[3, 5, 7],
         prefer_larger_batch=False),
    dict(max_train_batch_size=100, micro_batch_sizes=[0, 2]),
    dict(micro_batch_sizes=[2, 4, 6]),
    dict(max_train_batch_size=64, micro_batch_sizes=[4], version=0.2),
    dict(max_train_batch_size=64, micro_batch_sizes=[4], version=0.05),
]


@pytest.mark.parametrize("block", _GRID)
@pytest.mark.parametrize("world", [0, 1, 2, 3, 4, 8, 31, 32, 48])
@pytest.mark.parametrize("target", [None, "0.2.0"])
def test_compute_elastic_config_equals_jax(block, world, target):
    cfg = {"elasticity": dict(block, enabled=True)}
    t = _outcome(lambda: tel.compute_elastic_config(
        ds_config=cfg, target_deepspeed_version=target or tversion,
        world_size=world))
    j = _outcome(lambda: jel.compute_elastic_config(
        ds_config=cfg, target_deepspeed_version=target or jversion,
        world_size=world))
    assert t == j


@pytest.mark.parametrize("cfg", [{}, {"elasticity": {"enabled": False}},
                                 {"elasticity": {"enabled": True}}])
def test_compute_elastic_config_errors_equal_jax(cfg):
    assert _outcome(lambda: tel.compute_elastic_config(cfg, tversion)) == \
        _outcome(lambda: jel.compute_elastic_config(cfg, jversion))


@pytest.mark.parametrize("bases,ceiling", [([1], 720), ([2, 3], 100),
                                           ([8, 12, 16, 17], 10000),
                                           ([5], 4)])
def test_elastic_helpers_equal_jax(bases, ceiling):
    assert tel.get_candidate_batch_sizes(bases, ceiling) == \
        jel.get_candidate_batch_sizes(bases, ceiling)
    for batch in (24, 96, 720, 10080):
        assert tel.get_valid_gpus(batch, bases, 1, 100) == \
            jel.get_valid_gpus(batch, bases, 1, 100)
    assert tel.HCN_LIST == jel.HCN_LIST
    assert tel.elasticity_enabled({"elasticity": {"enabled": True}}) is \
        jel.elasticity_enabled({"elasticity": {"enabled": True}})


@pytest.mark.parametrize("extra", [
    {}, {"train_batch_size": 8},
    {"train_batch_size": 8, "ignore": True},
    {"gradient_accumulation_steps": 3, "ignore": True},
    {"train_micro_batch_size_per_gpu": 4},
])
@pytest.mark.parametrize("micro", [[2], [2, 4], [3]])
def test_config_batch_triple_equals_jax(extra, micro):
    extra = dict(extra)
    block = {"enabled": True, "max_train_batch_size": 48,
             "micro_batch_sizes": micro, "version": 0.1}
    if extra.pop("ignore", False):
        block["ignore_non_elastic_batch_info"] = True
    base = {"elasticity": block, **extra}

    def triple(cls):
        c = cls(json.loads(json.dumps(base)), world_size=1)
        return (c.elasticity_enabled, c.train_batch_size,
                c.train_micro_batch_size_per_gpu,
                c.gradient_accumulation_steps)
    assert _outcome(lambda: triple(TConfig)) == \
        _outcome(lambda: triple(JConfig))


def test_scheduler_config_must_match(monkeypatch):
    block = {"enabled": True, "max_train_batch_size": 48,
             "micro_batch_sizes": [2], "version": 0.1}
    monkeypatch.setenv(tel.DEEPSPEED_ELASTICITY_CONFIG, json.dumps(
        dict(block, max_train_batch_size=96)))
    for cls in (TConfig, JConfig):
        with pytest.raises(Exception) as err:
            cls({"elasticity": dict(block)}, world_size=1)
        assert type(err.value).__name__ == "ElasticityConfigError"
    monkeypatch.setenv(tel.DEEPSPEED_ELASTICITY_CONFIG, json.dumps(block))
    assert TConfig({"elasticity": dict(block)}, world_size=1) \
        .train_batch_size == 48


@pytest.mark.parametrize("block", [
    {}, {"enabled": True}, {"enabled": True, "hosts": 0},
    {"enabled": True, "checkpoint_interval": 0},
    {"enabled": True, "drain_timeout_sec": 0},
    {"enabled": True, "load_retries": -1},
    {"enabled": True, "max_recoveries": 0},
    {"enabled": True, "hosts": 4, "checkpoint_dir": "x",
     "escalate_after": 2, "loss_continuity_atol": 0.0},
])
def test_runtime_config_validates_as_jax(block):
    def fields(cls):
        return vars(cls(block))
    assert _outcome(lambda: fields(trt.ElasticRuntimeConfig)) == \
        _outcome(lambda: fields(jrt.ElasticRuntimeConfig))


_SEQS = [
    [("host_slow", 1), ("host_lost", 2), ("stall", None)],
    [("host_slow", 0)],
    [("stall", None)],
    [("stall", None), ("stall", None)],
    [("stall_escalated", None)],
    [("capacity_returned", 3)],
    [("capacity_returned", 3), ("host_lost", 3)],
    [],
]


@pytest.mark.parametrize("seq", _SEQS)
@pytest.mark.parametrize("before", [0, 1, 2])
@pytest.mark.parametrize("escalate_after", [0, 2, 3])
def test_classify_failure_equals_jax(seq, before, escalate_after):
    got = trt.classify_failure([trt.FaultEvent(k, host=h) for k, h in seq],
                               before, escalate_after)
    ref = jrt.classify_failure([jrt.FaultEvent(k, host=h) for k, h in seq],
                               before, escalate_after)
    assert got == ref


def test_batch_spec_and_constants_equal_jax():
    assert trt.BatchSpec(2, 3, 4, 24).rows == jrt.BatchSpec(2, 3, 4, 24).rows
    assert trt.BatchSpec._fields == jrt.BatchSpec._fields
    for k in ("HOST_LOST", "HOST_SLOW", "STALL", "STALL_ESCALATED",
              "CAPACITY_RETURNED", "ENGINE_ERROR"):
        assert getattr(trt, k) == getattr(jrt, k)
    assert set(trt.__all__) == set(jrt.__all__)
    assert tel.ElasticSupervisor is trt.ElasticSupervisor


def test_fault_injector_sentinels():
    with trt.FaultInjector() as inj:
        pid = inj.spawn_host(0)
        os.kill(pid, 0)                       # alive
        with pytest.raises(ValueError, match="live sentinel"):
            inj.spawn_host(0)
        assert inj.poll() == [] and not inj.host_dead(0)
        inj.sigkill_host(0)
        assert inj.wait_host_dead(0, timeout=10.0)
        (ev,) = inj.poll()
        assert (ev.kind, ev.host, ev.info["returncode"]) == \
            (trt.HOST_LOST, 0, -signal.SIGKILL)
        assert inj.poll() == []               # reported once
        pid2 = inj.spawn_host(0)              # re-backed after death
        assert pid2 != pid and not inj.host_dead(0)
        inj.inject_stall(why="test")
        inj.mark_host_slow(1)
        inj.return_capacity(2)
        assert [e.kind for e in inj.poll()] == \
            [trt.STALL, trt.HOST_SLOW, trt.CAPACITY_RETURNED]
    # closed: every sentinel killed and reaped
    with pytest.raises(ProcessLookupError):
        os.kill(pid2, 0)


# ----------------------------------------------------------------------
# the supervisor at world size 1
# ----------------------------------------------------------------------
T = 32


def _elastic_config(**runtime):
    rt = {"enabled": True, "hosts": 1, "checkpoint_interval": 2,
          "drain_timeout_sec": 10.0, "escalate_after": 2,
          "loss_continuity_atol": 0.0}
    rt.update(runtime)
    return {"steps_per_print": 10000,
            "zero_optimization": {"stage": 2},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "elasticity": {"enabled": True, "max_train_batch_size": 4,
                           "micro_batch_sizes": [2], "version": 0.1,
                           "runtime": rt}}


def _batch_fn(step, spec):
    rng = np.random.RandomState(1000 + step)
    ids = rng.randint(0, 256, (spec.total, T)).astype(np.int32)
    return {"input_ids": ids.reshape(spec.gas, spec.rows, T)}


@pytest.fixture(scope="module")
def tiny_tree():
    cfg = jgpt2.tiny_gpt2_config(n_positions=T)
    model = jgpt2.GPT2ForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _port_supervisor(tree, save_dir, **runtime):
    def factory():
        model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=T),
                                      device="cpu")
        return model, params_from_jax(tree)
    return trt.ElasticSupervisor(_elastic_config(**runtime), factory,
                                 _batch_fn, save_dir=str(save_dir),
                                 device="cpu")


def _stall_script(sup):
    sup.run(3)
    sup.injector.inject_stall()
    sup.injector.inject_stall()
    return sup.run(8)


_EVENT_KEYS = ("kind", "cause", "lost_hosts", "world_before", "world_after",
               "micro_batch", "gradient_accumulation_steps",
               "resumed_from_tag", "resumed_step", "replayed_steps")


def test_escalated_stall_recovers_in_place_like_jax(tiny_tree, tmp_path):
    jmodel, jparams, tree = tiny_tree
    sup = _port_supervisor(tree, tmp_path / "port")
    try:
        rep = _stall_script(sup)
    finally:
        sup.close()
    (rec,) = rep["recoveries"]
    assert rec["cause"] == trt.STALL_ESCALATED
    assert (rec["world_after"], rec["resumed_from_tag"],
            rec["replayed_steps"]) == (1, "global_step2", 1)
    # fp32 Adam at gas 2: the parameters are the fp32 store (no master
    # copy), two fp32 moments, the fp32 accumulator
    n = sup_params(tree)
    assert rec["zero_plan_bytes"] == {"params": 4 * n, "master": 0,
                                      "opt_state": 8 * n, "grads": 4 * n}
    # the replayed step's loss: bit for bit
    assert sup.replayed_losses and all(
        a == b for a, b in sup.replayed_losses.values())
    assert rep["steps"] == 8 and rep["world_size"] == 1
    assert (rep["micro_batch"], rep["gradient_accumulation_steps"]) == (2, 2)

    jsup = jrt.ElasticSupervisor(_elastic_config(),
                                 lambda: (jmodel, jparams), _batch_fn,
                                 save_dir=str(tmp_path / "jax"),
                                 devices=jax.devices()[:1])
    try:
        jrep = _stall_script(jsup)
    finally:
        jsup.close()
    (jrec,) = jrep["recoveries"]
    assert {k: rec[k] for k in _EVENT_KEYS} == \
        {k: jrec[k] for k in _EVENT_KEYS}
    assert set(rec) == set(jrec)
    assert set(rep) == set(jrep)
    got = np.array([rep["losses"][s] for s in range(8)])
    ref = np.array([jrep["losses"][s] for s in range(8)])
    assert np.all(np.abs(got - ref) <= 1e-5 * np.abs(ref)), (got, ref)


def sup_params(tree):
    return sum(int(np.prod(np.shape(x)))
               for x in jax.tree_util.tree_leaves(tree))


def test_lost_host_raises_incompatible_world_size(tiny_tree, tmp_path):
    _, _, tree = tiny_tree
    sup = _port_supervisor(tree, tmp_path)
    try:
        sup.run(1)
        sup.injector.spawn_host(0)
        sup.injector.sigkill_host(0)
        assert sup.injector.wait_host_dead(0)
        with pytest.raises(tel.ElasticityIncompatibleWorldSize,
                           match="every host is lost"):
            sup.run(3)
        assert issubclass(tel.ElasticityIncompatibleWorldSize,
                          tel.ElasticityError)
    finally:
        sup.close()


def test_engine_error_recovers_and_monitor_gets_events(tiny_tree,
                                                      tmp_path):
    """A batch_fn failure recovers like the engine's; the recovery
    event reaches the port's monitor with the JAX package's keys."""
    _, _, tree = tiny_tree
    failed = []

    def batch_fn(step, spec):
        if step == 3 and not failed:
            failed.append(step)
            raise OSError("input pipeline hiccup")
        return _batch_fn(step, spec)
    out = tmp_path / "mon"
    cfg = _elastic_config()
    cfg["monitor"] = {"enabled": True, "output_path": str(out),
                      "sinks": ["jsonl"]}

    def factory():
        model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=T),
                                      device="cpu")
        return model, params_from_jax(tree)
    sup = trt.ElasticSupervisor(cfg, factory, batch_fn,
                                save_dir=str(tmp_path / "ck"), device="cpu")
    try:
        rep = sup.run(5)
    finally:
        sup.close()
    (rec,) = rep["recoveries"]
    assert rec["cause"] == trt.ENGINE_ERROR and "hiccup" in rec["error"]
    events = [json.loads(line) for line in open(out / "events.jsonl")]
    recs = [e for e in events if e["kind"] == "recovery"]
    assert len(recs) == 1
    assert set(_EVENT_KEYS) <= set(recs[0])


def test_world_size_above_one_names_item_6(tiny_tree, tmp_path):
    _, _, tree = tiny_tree
    with pytest.raises(NotImplementedError, match="item 6"):
        _port_supervisor(tree, tmp_path, hosts=2)
    with pytest.raises(tel.ElasticityConfigError):
        trt.ElasticSupervisor({"elasticity": {"enabled": False}},
                              None, None, device="cpu")
    # the card by default: no card here, the port's error
    with pytest.raises(RuntimeError, match="cuda"):
        trt.ElasticSupervisor(_elastic_config(), None, None)
    # a returned host other than the one alive would grow the world
    sup = _port_supervisor(tree, tmp_path / "grow")
    try:
        sup.injector.return_capacity(0)          # alive: nothing to do
        sup.run(1)
        sup.injector.return_capacity(1)
        with pytest.raises(NotImplementedError, match="item 6"):
            sup.run(2)
    finally:
        sup.close()


# ----------------------------------------------------------------------
# the ZeRO memory plan
# ----------------------------------------------------------------------
class _Mesh1:
    shape = {"pipe": 1, "data": 1, "model": 1}


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("sr_mode", [False, True])
@pytest.mark.parametrize("gas", [1, 4])
@pytest.mark.parametrize("compute_bytes", [2, 4])
def test_memory_plan_equals_jax(tiny_tree, stage, sr_mode, gas,
                                compute_bytes):
    _, params, tree = tiny_tree
    shapes = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype), params)
    ref = JPolicy(_Mesh1(), stage).memory_plan(
        shapes, compute_bytes=compute_bytes, sr_mode=sr_mode, gas=gas)
    flat = params_from_jax(tree)
    for tree_form in (flat, {k: tuple(v.shape) for k, v in flat.items()}):
        got = TPolicy(stage).memory_plan(tree_form,
                                         compute_bytes=compute_bytes,
                                         sr_mode=sr_mode, gas=gas)
        assert got == ref


def test_memory_plan_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="stage"):
        TPolicy(4)
    with pytest.raises(NotImplementedError, match="item 6"):
        TPolicy(2, dp_size=2)


def test_engine_zero_policy_matches_its_ledger(tiny_tree):
    """engine.zero_policy's plan equals the bytes the memory ledger
    registers for each state category (the optimizer's 0-d step count
    aside: the plan counts the moments), in fp32, bf16 master-less and
    bf16 with fp32 masters (the supervisor's `sr_mode`: no fp32 store
    beside the parameters unless mixed precision)."""
    from deepspeed_tpu_torch.monitor import memory as mem
    import deepspeed_tpu_torch as dst
    _, _, tree = tiny_tree
    for gas, bf16 in ((1, False), (2, False), (1, "sr"), (2, "masters")):
        model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=T),
                                      device="cpu")
        conf = {"train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": gas,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "zero_optimization": {"stage": 2}}
        if bf16:
            conf["bf16"] = {"enabled": True,
                            "master_weights": bf16 == "masters"}
        engine, *_ = dst.initialize(model=model,
                                    model_parameters=params_from_jax(tree),
                                    config=conf)
        st = engine.state
        plan = engine.zero_policy.memory_plan(
            {n: p.shape for n, p in st.params.items()},
            compute_bytes=next(iter(st.params.values())).element_size(),
            sr_mode=not engine.mixed_precision, gas=gas)
        led = engine.monitor.ledger.totals()
        scalars = sum(t.numel() * t.element_size()
                      for t in _tensors(st.opt_state) if t.dim() == 0)
        assert plan["params"] == led["hbm"].get(mem.CAT_PARAMS, 0)
        assert plan["master"] == led["hbm"].get(mem.CAT_MASTER, 0)
        assert plan["opt_state"] == led["hbm"].get(mem.CAT_OPT, 0) - scalars
        assert plan["grads"] == led["hbm"].get(mem.CAT_GRADS, 0)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------
def _run(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)


def test_env_report_runs_on_the_cpu_and_names_each_kernel():
    from deepspeed_tpu_torch import env_report
    from deepspeed_tpu_torch.ops import _build
    got = _run("-m", "deepspeed_tpu_torch.env_report")
    assert got.returncode == 0, got.stderr
    for name in _build.SOURCES:
        assert f"deepspeed_tpu_torch/ops/csrc/{name}.cu" in got.stdout
    assert "csrc/adam/cpu_adam.cpp" in got.stdout
    assert "no card" in got.stdout
    rows = env_report.kernel_builds()
    assert sorted(r["name"] for r in rows) == sorted(
        f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    assert env_report.card() is None


def test_ds_elastic_cli_equals_jax(tmp_path):
    path = tmp_path / "ds.json"
    path.write_text(json.dumps({"elasticity": {
        "enabled": True, "max_train_batch_size": 2000,
        "micro_batch_sizes": [2, 4], "min_gpus": 1, "max_gpus": 100}}))
    for args in (["-c", str(path)], ["-c", str(path), "-w", "4"]):
        t = _run("-m", "deepspeed_tpu_torch.elasticity", *args)
        j = _run("-m", "deepspeed_tpu.elasticity", *args)
        assert t.returncode == j.returncode == 0, (t.stderr, j.stderr)
        assert t.stdout == j.stdout and "final_batch_size" in t.stdout
