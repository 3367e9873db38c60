"""PyTorch port: the async_dispatch block and runtime/prefetch.py against
the JAX package (the cases of `tests/test_async_dispatch.py` that apply).

PrefetchLoader collates and stacks as the JAX loader does (the same
arrays, from the same microbatches), ends on a partial tail, and hands a
worker's error to the consumer; `engine.prefetch` feeds `train_batch`,
which then gives the losses and parameters of the same batches fed
directly, bit for bit (one torch thread); a client scheduler object
turns async dispatch off, as in the JAX engine, and is stepped by the
synced loop; the hot loop reads nothing from the device between its
fences (reads counted through the tensor conversions the engine could
call), while the synced fp16 loop reads each step's overflow flag; the
block's settings resolve as the JAX config's, and `dump_state` logs the
config at init. On the card the loader's side stream is held in
`tests/test_torch_cuda.py`.
"""

import logging
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.prefetch import PrefetchLoader as JLoader
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.prefetch import PrefetchLoader
from deepspeed_tpu_torch.utils.logging import logger as port_logger
from torch_one_thread import one_torch_thread  # noqa: F401

SEQ = 32


def _model():
    return tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=SEQ),
                                 device="cpu")


def _micro(n, seed=0, rows=4):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, 256, (rows, SEQ))}
            for _ in range(n)]


def _engine(config, **kw):
    model = _model()
    params = model.init(0)
    return dst.initialize(model=model, model_parameters=params,
                          config=config, **kw)[0]


def _config(gas=2, **extra):
    d = {"train_micro_batch_size_per_gpu": 4,
         "gradient_accumulation_steps": gas, "steps_per_print": 10000,
         "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}},
         "scheduler": {"type": "WarmupDecayLR",
                       "params": {"warmup_max_lr": 3e-3,
                                  "warmup_num_steps": 3,
                                  "total_num_steps": 50}}}
    d.update(extra)
    return d


# ----------------------------------------------------------------------
# PrefetchLoader alone
# ----------------------------------------------------------------------
def test_loader_stacks_like_the_jax_loader():
    micro = [{"x": np.full((4, 2), i, np.float32),
              "y": np.arange(8).reshape(4, 2) + i} for i in range(6)]
    mine = PrefetchLoader(iter(micro), stage_fn=None, gas=2, depth=2)
    ref = JLoader(iter(micro), stage_fn=None, gas=2, depth=2)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == (2, 4, 2)
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    for loader in (mine, ref):
        with pytest.raises(StopIteration):
            next(loader)
        loader.close()


def test_loader_propagates_worker_errors():
    def boom():
        yield {"x": np.zeros((2, 2), np.float32)}
        raise RuntimeError("loader exploded")

    loader = PrefetchLoader(boom(), stage_fn=None, gas=1, depth=2)
    next(loader)
    with pytest.raises(RuntimeError, match="loader exploded"):
        next(loader)
    loader.close()


def test_loader_drops_partial_tail():
    micro = [{"x": np.zeros((2,), np.float32)} for _ in range(3)]
    loader = PrefetchLoader(iter(micro), stage_fn=None, gas=2, depth=2)
    next(loader)   # 2 microbatches consumed
    with pytest.raises(StopIteration):   # 1 leftover < gas
        next(loader)
    loader.close()


def test_loader_stages_at_most_depth_ahead():
    taken = []

    def source():
        for i in range(20):
            taken.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    staged = []
    with PrefetchLoader(source(), stage_fn=lambda b: staged.append(1) or
                        {k: torch.as_tensor(v) for k, v in b.items()},
                        gas=1, depth=3, device="cpu") as loader:
        first = next(loader)
        assert isinstance(first["x"], torch.Tensor)
        for _ in range(200):
            if loader.occupancy() == 3:
                break
            time.sleep(0.01)
        # one taken, three queued, one staged and blocked in put
        assert loader.occupancy() == 3 and len(taken) <= 5
    assert loader._thread is not None and not loader._thread.is_alive()


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
def test_prefetch_feeds_train_batch_bit_for_bit():
    """The same 3 steps fed through engine.prefetch and fed directly:
    equal losses and parameters, then StopIteration past the data."""
    micro = _micro(6)
    fed = _engine(_config())
    loader = fed.prefetch(iter(micro))
    assert loader.depth == fed.prefetch_depth() == 2
    got = [fed.train_batch(data_iter=loader) for _ in range(3)]
    with pytest.raises(StopIteration):
        fed.train_batch(data_iter=loader)
    loader.close()
    direct = _engine(_config())
    ref = [direct.train_batch(data_iter=iter(micro[2 * i:2 * i + 2]))
           for i in range(3)]
    assert torch.equal(torch.stack(got), torch.stack(ref))
    assert all(torch.equal(fed.state.params[k], direct.state.params[k])
               for k in fed.state.params)


def test_client_scheduler_forces_sync_mode():
    client = lr_schedules.WarmupLR(lr_schedules._OptimizerShim(lr=0.0),
                                   warmup_max_lr=1e-2)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    port_logger.addHandler(handler)
    try:
        engine = _engine({"train_batch_size": 4,
                          "optimizer": {"type": "Adam",
                                        "params": {"lr": 1e-2}}},
                         lr_scheduler=client)
    finally:
        port_logger.removeHandler(handler)
    assert not engine.async_dispatch_enabled()
    assert any(line.startswith("async_dispatch: disabled") for line in lines)
    loss = engine.train_batch(batch={"input_ids": _micro(1)[0]
                                     ["input_ids"][None]})
    assert np.isfinite(float(loss))
    # the synced path advanced the client scheduler on the hot loop
    assert client.last_batch_iteration == 0
    # the config scheduler keeps async dispatch on
    assert _engine(_config()).async_dispatch_enabled()


class _Reads:
    """Counts the tensor-to-host conversions the engine could make."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
            real = getattr(torch.Tensor, name)

            def counting(t, *a, _real=real, **k):
                self.n += 1
                return _real(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, counting)


@pytest.mark.parametrize("mode", ["bf16", "fp16"])
def test_hot_loop_reads_the_device_only_at_its_fences(mode, monkeypatch):
    """Async dispatch with steps_per_sync 3: no read in the steps
    between fences; under fp16 one read a fence (the scheduler mirror's
    step counter), none under bf16."""
    precision = {"fp16": {"enabled": True, "initial_scale_power": 8}} \
        if mode == "fp16" else {"bf16": {"enabled": True}}
    engine = _engine(_config(gas=1, async_dispatch={"steps_per_sync": 3},
                             **precision))
    batches = [{"input_ids": m["input_ids"][None]} for m in _micro(7)]
    engine.train_batch(batch=batches[0])
    fences = []
    real_fence = engine._sync_fence
    engine._sync_fence = lambda: (fences.append(engine._host_steps),
                                  real_fence())
    reads = _Reads(monkeypatch)
    per_step = []
    for b in batches[1:]:
        before = reads.n
        engine.train_batch(batch=b)
        per_step.append(reads.n - before)
    assert engine.steps_per_sync() == 3
    assert fences == [3, 6]
    want = 1 if mode == "fp16" else 0
    # the steps after the first are host steps 2..7: fences at 3 and 6
    assert per_step == [want if step in (3, 6) else 0
                        for step in range(2, 8)]


def test_synced_fp16_loop_reads_each_step(monkeypatch):
    """The inverse control: with async_dispatch off the fp16 loop reads
    each step's overflow flag (to hold the scheduler on a skip)."""
    engine = _engine(_config(gas=1, async_dispatch={"enabled": False},
                             fp16={"enabled": True,
                                   "initial_scale_power": 8}))
    assert not engine.async_dispatch_enabled()
    batches = [{"input_ids": m["input_ids"][None]} for m in _micro(5)]
    engine.train_batch(batch=batches[0])
    reads = _Reads(monkeypatch)
    for b in batches[1:]:
        engine.train_batch(batch=b)
    assert reads.n >= len(batches) - 1


@pytest.mark.parametrize("block", [
    {}, {"async_dispatch": {"enabled": True, "steps_per_sync": 4,
                            "prefetch_depth": 3}},
    {"async_dispatch": {"enabled": False}}, {"dump_state": True},
], ids=["absent", "on", "off", "dump_state"])
def test_block_resolves_like_jax(block):
    d = dict({"train_batch_size": 8, "steps_per_print": 5}, **block)
    mine, ref = dst.DeepSpeedConfig(dict(d)), JConfig(dict(d), world_size=1)
    for attr in ("async_dispatch_enabled", "async_dispatch_steps_per_sync",
                 "async_dispatch_prefetch_depth", "dump_state"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    engine = _engine(dict(d, train_batch_size=4))
    assert engine.steps_per_sync() == \
        (ref.async_dispatch_steps_per_sync or ref.steps_per_print)
    assert engine.async_dispatch_enabled() == ref.async_dispatch_enabled
    assert engine._config.dump_state == ref.dump_state


def test_dump_state_logs_the_config():
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    port_logger.addHandler(handler)
    try:
        _engine({"train_batch_size": 4, "dump_state": True})
    finally:
        port_logger.removeHandler(handler)
    start = lines.index("DeepSpeedEngine configuration:")
    body = lines[start + 1:]
    assert any(line.split()[0] == "train_batch_size" and
               line.split()[-1] == "4" for line in body)
    assert any(line.split()[0] == "dump_state" for line in body)
