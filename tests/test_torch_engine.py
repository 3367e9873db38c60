"""PyTorch port: the training engine against the JAX engine.

Both packages run `initialize` -> `train_batch` on gpt2-tiny from the
same weights (the JAX tree converted by `params_from_jax`) over the same
numpy-seeded batches, in fp32 with AdamW (weight decay), a WarmupLR
schedule and gradient clipping, at gradient accumulation 1 and 2, and
their loss trajectories over 10 steps must agree. The JAX engine
spreads the global batch over the 8 virtual CPU devices of the test
harness (data parallel, micro batch 1 per device); the port runs it as
one micro batch of 8 on one device: the same mean loss and the same
update.

Tolerance: fp32, reduction order only: each step's loss within 1e-5
relative (observed < 1e-6 over the 10 steps).

Also here: the config's batch-triple resolution against the JAX
package's DeepSpeedConfig, the constants, what raises for the later
slices, the forward/backward/step API against train_batch, and the
guard that train_batch never waits for the device.
"""

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import constants as JC
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.zero import config as JZ
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime import constants as TC
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.zero import config as TZ

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


@pytest.mark.parametrize("gas", [1, 2])
def test_loss_trajectory_matches_jax_engine(jax_model_and_tree, gas):
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
])
def test_config_resolves_like_jax(d):
    j, t = JConfig(dict(d), world_size=1), TConfig(dict(d))
    for attr in ("train_batch_size", "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps", "steps_per_print",
                 "zero_optimization_stage", "zero_enabled",
                 "bfloat16_enabled", "bfloat16_master_weights",
                 "gradient_clipping", "optimizer_name", "optimizer_params",
                 "scheduler_name", "scheduler_params"):
        assert getattr(t, attr) == getattr(j, attr), attr


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


@pytest.mark.parametrize("extra,match", [
    ({"fp16": {"enabled": True}}, "fp16"),
    ({"zero_optimization": {"stage": 3}}, "stage 3"),
    ({"zero_optimization": {"stage": 2, "cpu_offload": True}}, "Offload"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"moe": {"enabled": True}}, "mixture"),
    ({"monitor": {"enabled": True}}, "monitor"),
    ({"progressive_layer_drop": {"enabled": True}}, "layer drop"),
    ({"optimizer": {"type": "Lamb"}}, "lamb"),
])
def test_later_slices_raise(jax_model_and_tree, extra, match):
    config = dict({"train_micro_batch_size_per_gpu": 2}, **extra)
    with pytest.raises(NotImplementedError, match=match):
        _port_engine(jax_model_and_tree[2], config)


def test_checkpoints_raise_and_eval_batch(jax_model_and_tree):
    engine, _, _, _ = _port_engine(jax_model_and_tree[2],
                                   {"train_micro_batch_size_per_gpu": 2})
    with pytest.raises(NotImplementedError, match="checkpoint"):
        engine.save_checkpoint("unused")
    ids = np.random.RandomState(3).randint(0, 256, (2, 128))
    loss = engine.eval_batch({"input_ids": ids})
    ref = engine.module.loss_fn(engine.params, {"input_ids": ids},
                                deterministic=True)
    assert not loss.requires_grad and torch.equal(loss, ref.detach())


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
