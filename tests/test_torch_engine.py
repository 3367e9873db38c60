"""PyTorch port: the training engine against the JAX engine.

Both packages run `initialize` -> `train_batch` on gpt2-tiny from the
same weights (the JAX tree converted by `params_from_jax`) over the same
numpy-seeded batches, in fp32 with AdamW (weight decay), a WarmupLR
schedule and gradient clipping, at gradient accumulation 1 (here) and 2
(tests/test_torch_engine_gas2.py), and their loss trajectories over 10
steps must agree. The JAX engine
spreads the global batch over the 8 virtual CPU devices of the test
harness (data parallel, micro batch 1 per device); the port runs it as
one micro batch of 8 on one device: the same mean loss and the same
update.

Tolerance: fp32, reduction order only: each step's loss within 1e-5
relative (observed < 1e-6 over the 10 steps).

Also here: the config's batch-triple resolution against the JAX
package's DeepSpeedConfig, the constants, what raises for the later
slices, the checkpoint block, the forward/backward/step API against
train_batch, and the guard that train_batch never waits for the
device.
"""

import os

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import constants as JC
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.config import \
    DeepSpeedConfigError as JDeepSpeedConfigError
from deepspeed_tpu.runtime.mesh import build_mesh
from deepspeed_tpu.runtime.zero import config as JZ
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime import constants as TC
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.zero import config as TZ
from torch_one_thread import one_torch_thread  # noqa: F401

TRAJ_TOL = 1e-5


def _ds_config(gas):
    return {"train_batch_size": 8 * gas,
            "gradient_accumulation_steps": gas,
            "steps_per_print": 1000,
            "gradient_clipping": 0.5,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 5,
                                     "warmup_max_lr": 3e-3}}}


@pytest.fixture(scope="module")
def jax_model_and_tree():
    cfg = jgpt2.tiny_gpt2_config(n_positions=128)
    model = jgpt2.GPT2ForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _port_engine(tree, config, **cfg_overrides):
    model = tgpt2.GPT2ForCausalLM(
        tgpt2.tiny_gpt2_config(n_positions=128, **cfg_overrides),
        device="cpu")
    return dst.initialize(model=model, model_parameters=params_from_jax(tree),
                          config=config)


@pytest.mark.parametrize("gas", [1])
def test_loss_trajectory_matches_jax_engine(jax_model_and_tree, gas):
    """gas 1 here, gas 2 in tests/test_torch_engine_gas2.py (the same
    check, `check_loss_trajectory`)."""
    check_loss_trajectory(jax_model_and_tree, gas)


def check_loss_trajectory(jax_model_and_tree, gas):
    jmodel, jparams, tree = jax_model_and_tree
    config = _ds_config(gas)
    jengine, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=jparams, config=config)
    engine, optimizer, loader, sched = _port_engine(
        tree, dict(config, train_micro_batch_size_per_gpu=8))
    assert optimizer is engine and loader is None
    assert sched is engine.lr_scheduler
    rng = np.random.RandomState(gas)
    batches = [{"input_ids": rng.randint(0, 256, (gas, 8, 128))
                .astype(np.int32)} for _ in range(3)]
    ref, got = [], []
    for step in range(10):
        ref.append(float(jengine.train_batch(batch=batches[step % 3])))
        got.append(float(engine.train_batch(batch=batches[step % 3])))
    ref, got = np.array(ref), np.array(got)
    assert np.all(np.abs(got - ref) <= TRAJ_TOL * np.abs(ref)), (got, ref)
    assert got[-1] < got[0]
    assert engine.global_steps == 10
    assert engine.micro_steps == 10 * gas
    np.testing.assert_allclose(engine.get_lr(), jengine.get_lr(),
                               rtol=1e-6)


def test_forward_backward_step_equals_train_batch(jax_model_and_tree):
    """The microbatch API (forward, backward, step) at gas 2 takes the
    same steps as train_batch: the same losses and parameters, bit for
    bit. One CPU thread: the CPU's embedding backward adds its rows in a
    thread-dependent order, and Adam turns that noise on a gradient that
    is zero in exact arithmetic (the key bias) into a full-lr step."""
    tree = jax_model_and_tree[2]
    config = dict(_ds_config(2), train_micro_batch_size_per_gpu=8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fused, _, _, _ = _port_engine(tree, config)
        manual, _, _, _ = _port_engine(tree, config)
        rng = np.random.RandomState(11)
        for _ in range(3):
            stacked = rng.randint(0, 256, (2, 8, 128)).astype(np.int32)
            loss = fused.train_batch(batch={"input_ids": stacked})
            micro = []
            for i in range(2):
                assert manual.is_gradient_accumulation_boundary() == \
                    (i == 1)
                micro.append(manual({"input_ids": stacked[i]}))
                manual.backward(micro[-1])
                manual.step()
            assert torch.equal(loss, torch.stack(micro).mean())
    finally:
        torch.set_num_threads(threads)
    for name, p in fused.params.items():
        assert torch.equal(p, manual.params[name]), name
    assert manual.global_steps == fused.global_steps == 3


def test_train_batch_makes_no_host_sync(jax_model_and_tree, monkeypatch):
    """Nothing inside train_batch reads a tensor back to the host or
    waits for the device: the loss returns as a tensor."""
    tree = jax_model_and_tree[2]
    engine, _, _, _ = _port_engine(
        tree, dict(_ds_config(2), train_micro_batch_size_per_gpu=8))
    batch = engine.stage_batch({"input_ids": np.random.RandomState(0)
                                .randint(0, 256, (2, 8, 128))})
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
    for _ in range(3):
        loss = engine.train_batch(batch=batch)
    assert calls == []
    assert isinstance(loss, torch.Tensor) and loss.shape == ()


@pytest.mark.parametrize("d", [
    {"train_batch_size": 32},
    {"train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 8},
    {"train_batch_size": 32, "gradient_accumulation_steps": 4},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2},
    {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 4,
     "bf16": {"enabled": True, "master_weights": False},
     "zero_optimization": {"stage": 2}, "gradient_clipping": 1.0,
     "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
     "scheduler": {"type": "WarmupLR", "params": {}}},
    # Apex AMP maps to bf16 in both packages; its other params are ignored
    {"train_batch_size": 8, "amp": {"enabled": True, "opt_level": "O1"}},
    # the flagship's (bench.py bench_gpt2_15b)
    {"train_micro_batch_size_per_gpu": 11, "gradient_accumulation_steps": 1,
     "steps_per_print": 1000,
     "bf16": {"enabled": True, "master_weights": False},
     "zero_optimization": {"stage": 2},
     "optimizer": {"type": "AdamW",
                   "params": {"lr": 1e-4, "weight_decay": 0.01}}},
    # ZeRO-Offload with the compressed wire
    {"train_batch_size": 8, "bf16": {"enabled": True},
     "zero_optimization": {"stage": 2, "cpu_offload": True,
                           "offload_wire": {"grad_bits": 1,
                                            "param_bits": 8,
                                            "warmup_steps": 3}}},
    # blocks the port validates and keeps, switched off
    {"train_batch_size": 8,
     "async_dispatch": {"enabled": False, "steps_per_sync": 4,
                        "prefetch_depth": 3},
     "overlap": {"enabled": False, "sites": ["ring", "moe_dispatch"],
                 "issue_distance": 2},
     "autotune": {"enabled": False, "table_path": "table.json"}},
    # mesh blocks one device resolves: every axis 1, or data inferred
    {"train_batch_size": 8, "mesh": {"pipe": 1, "data": 1, "model": 1}},
    {"train_batch_size": 8, "mesh": {"data": -1, "expert": 1}},
])
def test_config_resolves_like_jax(d):
    j, t = JConfig(dict(d), world_size=1), TConfig(dict(d))
    # the JAX engine builds its mesh from the block (one device here)
    mesh = build_mesh(d.get("mesh"), devices=jax.devices()[:1])
    assert list(t.mesh_shape.items()) == list(mesh.shape.items())
    for attr in ("train_batch_size", "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps", "steps_per_print",
                 "zero_optimization_stage", "zero_enabled",
                 "bfloat16_enabled", "bfloat16_master_weights",
                 "gradient_clipping", "optimizer_name", "optimizer_params",
                 "scheduler_name", "scheduler_params",
                 "checkpoint_tag_validation_enabled",
                 "checkpoint_tag_validation_fail", "checkpoint_async_save",
                 "checkpoint_keep_last", "checkpoint_writer_queue_depth",
                 "checkpoint_queue_policy", "async_dispatch_enabled",
                 "async_dispatch_steps_per_sync",
                 "async_dispatch_prefetch_depth", "autotune", "overlap"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for attr in ("stage", "cpu_offload", "offload_wire_grad_bits",
                 "offload_wire_param_bits", "offload_wire_warmup_steps"):
        assert getattr(t.zero_config, attr) == \
            getattr(j.zero_config, attr), attr
    assert t.zero_config.offload_wire_compressed() == \
        j.zero_config.offload_wire_compressed()


@pytest.mark.parametrize("block", [
    {"checkpoint": {"tag_validation": "bogus"}},
    {"checkpoint": {"keep_last": -1}},
    {"checkpoint": {"writer_queue_depth": 0}},
    {"checkpoint": {"queue_policy": "spill"}},
    {"autotune": {"table_path": 3}},
    {"autotune": True},
    {"async_dispatch": {"steps_per_sync": -2}},
    {"async_dispatch": {"prefetch_depth": 0}},
    {"overlap": {"sites": ["ring", "nowhere"]}},
    {"overlap": {"issue_distance": 0}},
], ids=["tag_validation", "keep_last", "writer_queue_depth", "queue_policy",
        "table_path", "autotune_not_a_dict", "steps_per_sync",
        "prefetch_depth", "overlap_site", "issue_distance"])
def test_config_rejects_bad_block_values_like_jax(block):
    """A bad value in a block the port validates fails in both packages
    with DeepSpeedConfigError (before the port refuses the block as not
    ported yet)."""
    d = dict({"train_batch_size": 8}, **block)
    with pytest.raises(JDeepSpeedConfigError):
        JConfig(dict(d), world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        TConfig(dict(d))


@pytest.mark.parametrize("mesh", [
    {"data": 0}, {"data": -1, "model": -1}, {"pipe": -1},
    {"model": -2}, {"expert": 1, "data": 0},
], ids=["zero_axis", "two_inferred", "pipe_inferred_data_default",
        "negative_axis", "expert_order"])
def test_config_rejects_a_malformed_mesh_like_jax(mesh):
    """A mesh block that no device count resolves fails in the port as
    `build_mesh` fails in the JAX engine, with the same message."""
    with pytest.raises(AssertionError) as ref:
        build_mesh(mesh, devices=jax.devices()[:1])
    with pytest.raises(AssertionError) as got:
        TConfig({"train_batch_size": 8, "mesh": mesh})
    assert str(got.value) == str(ref.value)


def test_config_rejects_an_inconsistent_triple():
    bad = {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2}
    with pytest.raises(AssertionError):
        JConfig(dict(bad), world_size=1)
    with pytest.raises(Exception, match="batch"):
        TConfig(dict(bad))


@pytest.mark.parametrize("mine,ref", [(TC, JC), (TZ, JZ)],
                         ids=["constants", "zero-config"])
def test_constants_equal_jax(mine, ref):
    names = [n for n in dir(mine) if n.isupper()]
    assert len(names) >= 6
    for name in names:
        assert getattr(mine, name) == getattr(ref, name), name


# fp16 (with MoE and quantized compute too), 1-bit Adam, progressive
# layer drop, LAMB, the activation_checkpointing and async_dispatch
# blocks, dump_state and the tools' blocks (elasticity, flops_profiler,
# autotune: tests/test_torch_{elastic,flops_profiler,autotune}.py) are
# ported
@pytest.mark.parametrize("extra,match", [
    ({"zero_optimization": {"stage": 3}}, "stage 3"),
    ({"zero_optimization": {"stage": 3, "cpu_offload": True}}, "stage 3"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"mesh": {"model": 2, "data": 1}}, "mesh with model above 1"),
])
def test_later_slices_raise(jax_model_and_tree, extra, match):
    config = dict({"train_micro_batch_size_per_gpu": 2}, **extra)
    with pytest.raises(NotImplementedError, match=match):
        _port_engine(jax_model_and_tree[2], config)


@pytest.mark.parametrize("extra,item", [
    ({"zero_optimization": {"stage": 3, "cpu_offload": True}}, 6),
    ({"zero_optimization": {"stage": 3}}, 6),
    ({"pipeline": {"stages": 2}}, 6),
    # blocks the JAX engine acts on (runtime/engine.py) and the port not yet
    ({"sparse_gradients": True}, 6),
    ({"mesh": {"model": 2, "data": 1}}, 6),
])
def test_later_slices_name_their_roadmap_item(jax_model_and_tree, extra,
                                              item):
    """Each raise names the ROADMAP Queue 1 item that ports it."""
    config = dict({"train_micro_batch_size_per_gpu": 2}, **extra)
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item}$"):
        _port_engine(jax_model_and_tree[2], config)


def _telemetry_block(block, out):
    """The config of one telemetry block, its files under `out`."""
    if block == "monitor":
        return {"monitor": {"enabled": True, "output_path": str(out)}}
    if block == "tensorboard":
        return {"tensorboard": {"enabled": True, "output_path": str(out),
                                "job_name": "job"}}
    return {"wall_clock_breakdown": True}


@pytest.mark.parametrize("api", ["train_batch", "forward_backward_step"])
@pytest.mark.parametrize("block", ["monitor", "tensorboard",
                                   "wall_clock_breakdown"])
def test_telemetry_blocks_run_and_write(jax_model_and_tree, block, api,
                                        tmp_path, monkeypatch):
    """The monitor, tensorboard and wall_clock_breakdown blocks, which
    raised until the monitor was ported, build an engine that trains
    through either API and writes its sink at the fences: the monitor's
    JSONL `metrics` events, the tensorboard block's tfevents scalars
    (read back with their CRCs), the breakdown's span log line."""
    import json
    from deepspeed_tpu_torch.monitor.tfevents import read_tfevents
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    logged = []
    monkeypatch.setattr(engine_mod.logger, "info", logged.append)
    config = dict({"train_micro_batch_size_per_gpu": 2,
                   "steps_per_print": 2}, **_telemetry_block(block, tmp_path))
    engine, _, _, _ = _port_engine(jax_model_and_tree[2], config)
    ids = np.random.RandomState(4).randint(0, 256, (2, 128))
    for _ in range(4):
        if api == "train_batch":
            engine.train_batch(batch={"input_ids": ids[None]})
        else:
            loss = engine({"input_ids": ids})
            engine.backward(loss)
            engine.step()
    engine.shutdown()
    assert engine.global_steps == 4
    if block == "monitor":
        events = [json.loads(line) for line in
                  open(tmp_path / "events.jsonl")]
        metrics = [e for e in events if e["kind"] == "metrics"]
        assert [e["step"] for e in metrics] == [2, 4]
        assert all(np.isfinite(e["loss"]) for e in metrics)
    elif block == "tensorboard":
        (name,) = os.listdir(tmp_path / "job")
        records = read_tfevents(str(tmp_path / "job" / name))
        tags = {tag for r in records for tag in r.get("scalars", {})}
        assert {"Train/Samples/lr", "Train/Samples/train_loss"} <= tags
    else:
        spans = [m for m in logged if "span ms/step" in m]
        assert len(spans) == 2
        want = "step" if api == "train_batch" else "forward"
        assert all(f"{want}:" in m for m in spans)


@pytest.mark.parametrize("block,attr,value", [
    ({"async_save": False}, "checkpoint_async_save", False),
    ({"keep_last": 3}, "checkpoint_keep_last", 3),
    ({"writer_queue_depth": 2, "queue_policy": "drop"},
     "checkpoint_queue_policy", "drop"),
    ({"tag_validation": "Fail"}, "checkpoint_tag_validation_fail", True),
])
def test_checkpoint_block_configures_the_engine(jax_model_and_tree, block,
                                                attr, value, tmp_path):
    """The `checkpoint` block, which raised until checkpoints were
    ported, now sets the engine's checkpoint knobs, and a save under it
    commits."""
    engine, _, _, _ = _port_engine(
        jax_model_and_tree[2], {"train_micro_batch_size_per_gpu": 2,
                                "checkpoint": block})
    assert getattr(engine, attr)() == value
    assert engine.save_checkpoint(str(tmp_path), tag="t") is True
    engine.wait_for_checkpoint()
    assert sorted(os.listdir(tmp_path)) == ["latest", "t"]


def test_checkpoints_and_client_objects_name_their_roadmap_item(
        jax_model_and_tree, tmp_path):
    """Checkpoints work since ROADMAP Queue 1 item 2 was ported, client
    optimizer objects since item 4 was: an object without init/update
    is refused as no optimizer."""
    engine, _, _, _ = _port_engine(jax_model_and_tree[2],
                                   {"train_micro_batch_size_per_gpu": 2})
    assert engine.save_checkpoint(str(tmp_path)) is True
    assert engine.load_checkpoint(str(tmp_path)) == (
        f"{tmp_path}/global_step0", {})
    with pytest.raises(TypeError, match="init"):
        dst.initialize(model=engine.module, model_parameters=engine.params,
                       optimizer=object(),
                       config={"train_micro_batch_size_per_gpu": 2})


@pytest.mark.parametrize("amp,error", [
    (True, '"amp" must be a dict'),
    ({"enabled": True}, "amp and fp16"),
])
def test_amp_block_rejects_like_jax(amp, error):
    """A non-dict amp block, and amp with fp16, fail in both packages."""
    d = {"train_batch_size": 8, "amp": amp}
    if error == "amp and fp16":
        d["fp16"] = {"enabled": True}
    with pytest.raises(Exception):
        JConfig(dict(d), world_size=1)
    with pytest.raises(DeepSpeedConfigError, match=error):
        TConfig(dict(d))


def test_checkpoints_raise_and_eval_batch(jax_model_and_tree, tmp_path):
    """A checkpoint saved after a step and loaded into an engine built
    from other weights gives the same eval_batch loss; eval_batch is
    the model's deterministic loss without gradients."""
    engine, _, _, _ = _port_engine(jax_model_and_tree[2],
                                   {"train_micro_batch_size_per_gpu": 2})
    ids = np.random.RandomState(3).randint(0, 256, (2, 128))
    engine.train_batch(batch={"input_ids": ids[None]})
    engine.save_checkpoint(str(tmp_path), tag="t", async_save=False)
    loss = engine.eval_batch({"input_ids": ids})
    ref = engine.module.loss_fn(engine.params, {"input_ids": ids},
                                deterministic=True)
    assert not loss.requires_grad and torch.equal(loss, ref.detach())
    other = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                  device="cpu")
    fresh, _, _, _ = dst.initialize(
        model=other, model_parameters=other.init(5),
        config={"train_micro_batch_size_per_gpu": 2})
    assert not torch.equal(fresh.eval_batch({"input_ids": ids}), loss)
    fresh.load_checkpoint(str(tmp_path))
    assert torch.equal(fresh.eval_batch({"input_ids": ids}), loss)


def test_dataloader_feeds_train_batch(jax_model_and_tree):
    """deepspeed_io batches a sized dataset; RepeatingLoader restarts
    it; train_batch draws gas microbatches from the iterator."""
    data = [{"input_ids": np.full((128,), i % 256, np.int32)}
            for i in range(20)]
    engine, _, loader, _ = dst.initialize(
        model=tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                    device="cpu"),
        model_parameters=params_from_jax(jax_model_and_tree[2]),
        training_data=data,
        config={"train_micro_batch_size_per_gpu": 4,
                "gradient_accumulation_steps": 2})
    assert isinstance(loader, DeepSpeedDataLoader) and len(loader) == 5
    first = next(iter(loader))
    assert first["input_ids"].shape == (4, 128)
    it = RepeatingLoader(loader)
    for _ in range(4):      # 8 microbatches: the loader restarts once
        assert bool(torch.isfinite(engine.train_batch(data_iter=it)))
    assert engine.micro_steps == 8


def test_timers_on_the_cpu():
    """On the CPU the timers read the host clock; the throughput timer
    counts the steps after its warm-up and reports each window."""
    import time
    from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                                 ThroughputTimer)
    timers = SynchronizedWallClockTimer("cpu")
    timers("step").start()
    time.sleep(0.01)
    timers("step").stop()
    assert timers("step").elapsed() >= 0.01
    assert timers("step").elapsed() == 0.0      # reset by the last read
    logs = []
    tput = ThroughputTimer(batch_size=4, start_step=1, steps_per_output=2,
                           device="cpu", logging_fn=logs.append)
    for _ in range(5):
        tput.start()
        time.sleep(0.005)
        tput.stop()
    assert len(logs) == 2
    rate = tput.avg_samples_per_sec()
    assert 0 < rate < 4 / 0.005
