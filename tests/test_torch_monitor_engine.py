"""PyTorch port: the training engine's monitor against the JAX engine's.

Both packages train gpt2-tiny (2 layers, 64 wide, fp32) from the same
weights (the JAX tree converted by `params_from_jax`) over the same
numpy batches with the monitor on (`steps_per_sync` 2, 6 steps, the
JSONL sink, numerics), and the events they write must agree: the same
event kinds and key sets; loss, grad norm, loss scale, overflow count
and tokens; the numerics group labels and per-group stats; the memory
ledger's categories and bytes. The JAX engine spreads the batch over
the harness's 8 virtual CPU devices, the port runs one micro batch of
8 on one device: the same mean loss and update.

Tolerance: fp32, reduction order only: 1e-5 relative. AdamW at lr 3e-4:
at 3e-3 Adam turns the ~1e-7 gradient differences on parameters whose
gradient is zero in exact arithmetic (the key bias) into full-lr steps,
and by the third window the per-group stats of the small groups differ
by up to 4e-5; at 3e-4 every compared value agrees within 1.7e-6.

Also here: the fp16 engine's overflow count and loss scale, the MoE
router fields at a fence (routes held equal, as tests/
test_torch_moe_train.py holds them), `snapshot()`'s stable key set with
the monitor on and off, the host-read guard (no read in a step, one
copy at a fence), `wall_clock_breakdown`'s span log without a device
barrier, and a SIGTERM'd training process leaving a flight dump.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.tiny_gpt2_config(n_positions=128)
    model = jgpt2.GPT2ForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _config(out, **extra):
    mon = {"enabled": True, "output_path": str(out),
           "numerics": {"enabled": True}}
    mon.update(extra.pop("monitor", {}))
    return dict({"train_batch_size": 8, "steps_per_print": 1000,
                 "gradient_clipping": 0.5,
                 "async_dispatch": {"steps_per_sync": 2},
                 "optimizer": {"type": "AdamW",
                               "params": {"lr": 3e-4, "weight_decay": 0.01}},
                 "monitor": mon}, **extra)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, 256, (1, 8, 128)).astype(np.int32)}
            for _ in range(n)]


def _events(out):
    return [json.loads(line) for line in open(os.path.join(out,
                                                           "events.jsonl"))]


def _by_kind(events, kind):
    return [e for e in events if e["kind"] == kind]


def _train_both(tree, tmp_path, config_fn, steps=6, port_cfg=None,
                jax_cfg=None):
    jmodel, jparams, flat = tree
    jengine, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=jparams,
        config=config_fn(tmp_path / "jax"))
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(
        n_positions=128, **(port_cfg or {})), device="cpu")
    engine, *_ = dst.initialize(
        model=model, model_parameters=params_from_jax(flat),
        config=dict(config_fn(tmp_path / "torch"),
                    train_micro_batch_size_per_gpu=8))
    for b in _batches(steps):
        jengine.train_batch(batch=b)
        engine.train_batch(batch=b)
    return jengine, engine


def _close(a, b):
    return abs(a - b) <= TOL * max(abs(a), abs(b), 1e-30)


# ----------------------------------------------------------------------
# the fp32 engine's events
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def fp32_runs(tree, tmp_path_factory):
    """The `overlap_inflight` ledger entry reads each package's
    process-wide overlap state, which an earlier test in the same
    process may have left: both start from an empty one."""
    from deepspeed_tpu.ops import overlap as joverlap
    from deepspeed_tpu_torch.ops import overlap as toverlap
    joverlap.reset_inflight()
    toverlap.reset_inflight()
    out = tmp_path_factory.mktemp("fp32")
    jengine, engine = _train_both(tree, out, _config)
    snaps = (jengine.monitor.snapshot(), engine.monitor.snapshot())
    jengine.shutdown()
    engine.shutdown()
    return _events(out / "jax"), _events(out / "torch"), snaps, engine


def _check_card_keys(events):
    """chip_smoke.py holds the card's events to key sets written out
    there (the card has no JAX): they must be the JAX engine's."""
    import chip_smoke
    for e in events:
        want = chip_smoke.MON_EVENT_KEYS.get(e["kind"])
        if want is not None:
            assert set(e) == want | chip_smoke.MON_BASE_KEYS, e["kind"]


def test_event_kinds_and_keys_equal_jax(fp32_runs):
    ref, got, _, _ = fp32_runs
    assert [e["kind"] for e in got] == [e["kind"] for e in ref]
    _check_card_keys(ref)
    for r, g in zip(ref, got):
        assert sorted(g) == sorted(r), g["kind"]
        if g["kind"] == "metrics":
            for block in ("memory", "wire", "checkpoint", "prefetch"):
                assert sorted(g[block]) == sorted(r[block]), block


def test_metrics_equal_jax(fp32_runs):
    ref, got, _, _ = fp32_runs
    ref, got = _by_kind(ref, "metrics"), _by_kind(got, "metrics")
    assert len(got) == 3
    for r, g in zip(ref, got):
        assert g["step"] == r["step"]
        assert g["window_steps"] == r["window_steps"] == 2
        for key in ("loss", "grad_norm", "loss_scale"):
            assert _close(g[key], r[key]), (key, g[key], r[key])
        for key in ("overflow_count", "tokens", "micro_steps"):
            assert g[key] == r[key], key
        assert _close(g["lr"], r["lr"])


def test_numerics_groups_and_stats_equal_jax(fp32_runs):
    ref, got, _, engine = fp32_runs
    ref, got = _by_kind(ref, "numerics"), _by_kind(got, "numerics")
    assert len(got) == len(ref) == 3
    names = ["h/GPT2Block_0", "ln_f/bias", "ln_f/scale", "wpe", "wte"]
    assert engine.monitor._numerics_names["grad"] == names
    for r, g in zip(ref, got):
        for key in ("grad_norm", "grad_absmax"):
            assert list(g[key]) == list(r[key]) == names
            for name in names:
                assert _close(g[key][name], r[key][name]), (key, name)
        assert g["grad_nonfinite"] == r["grad_nonfinite"]
        assert g["first_nonfinite"] is None and r["first_nonfinite"] is None
        assert g["window_steps"] == r["window_steps"]
        # activation stats are tapped by layer-exposing models only
        assert g["act_absmax"] is None and r["act_absmax"] is None


def test_memory_ledger_equal_jax(fp32_runs):
    """The same categories with the same bytes, but for the optimizer
    state's scalars: optax's state (the JAX engine's) holds the injected
    hyperparameters and a second step count as device scalars, the
    port's keeps them as host numbers beside its one int32 count."""
    ref, got, _, engine = fp32_runs
    ref, got = _by_kind(ref, "memory"), _by_kind(got, "memory")
    assert len(got) == len(ref) == 3
    scalars = 7 * 4    # lr, b1, b2, eps, eps_root, weight_decay, count
    for r, g in zip(ref, got):
        for space in ("hbm", "host"):
            want = dict(r[space]["categories"])
            if space == "hbm":
                want["opt_state"] -= scalars
            assert g[space]["categories"] == want, space
            assert sorted(g[space]) == sorted(r[space])
        assert g["hbm"]["ledger_bytes"] == r["hbm"]["ledger_bytes"] - scalars
    st = engine.state
    params = sum(p.numel() * p.element_size() for p in st.params.values())
    opt = sum(t.numel() * t.element_size()
              for t in engine._state_tensors(st.opt_state))
    cats = got[-1]["hbm"]["categories"]
    assert cats["params"] == params and cats["opt_state"] == opt


def test_snapshot_keys_equal_jax_on_and_off(fp32_runs, tree):
    _, _, (jsnap, snap), _ = fp32_runs
    assert list(snap) == list(jsnap)
    assert snap["numerics"] is not None and snap["router"] is None
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                  device="cpu")
    off, *_ = dst.initialize(model=model,
                             model_parameters=params_from_jax(tree[2]),
                             config={"train_batch_size": 8})
    off.train_batch(batch=_batches(1)[0])
    snap_off = off.monitor.snapshot()
    assert list(snap_off) == list(snap)
    assert snap_off["enabled"] is False and snap_off["loss"] is None


# ----------------------------------------------------------------------
# fp16: overflow count and loss scale
# ----------------------------------------------------------------------
def test_fp16_overflow_count_and_scale_equal_jax(tree, tmp_path):
    """From 2^32 the first steps overflow; the fences' overflow counts
    and loss scales equal the JAX engine's."""
    def config(out):
        return _config(out, fp16={"enabled": True, "loss_scale": 0,
                                  "initial_scale_power": 32})
    jengine, engine = _train_both(tree, tmp_path, config)
    jengine.shutdown()
    engine.shutdown()
    ref = _by_kind(_events(tmp_path / "jax"), "metrics")
    got = _by_kind(_events(tmp_path / "torch"), "metrics")
    assert [g["overflow_count"] for g in got] == \
        [r["overflow_count"] for r in ref]
    assert got[-1]["overflow_count"] > 0
    assert [g["loss_scale"] for g in got] == [r["loss_scale"] for r in ref]


# ----------------------------------------------------------------------
# MoE: the router event
# ----------------------------------------------------------------------
def test_moe_router_fields_equal_jax(tmp_path):
    """gpt2-tiny at 4 layers with 4 experts in every other layer (the
    MoE trajectory test's model, tests/test_torch_moe_train.py, whose
    routes come out equal in both packages): the `moe` event's fields
    and the `router` events' expert loads, drop fraction and aux loss
    agree."""
    from deepspeed_tpu.moe import MoEConfig as JMoE
    from deepspeed_tpu_torch.moe import MoEConfig as TMoE
    moe = dict(num_experts=4, every_n_layers=2)
    seq = 32
    jmodel = jgpt2.GPT2ForCausalLM(jgpt2.tiny_gpt2_config(
        n_layer=4, n_positions=seq, moe=JMoE(**moe).validate()))
    ids = np.random.RandomState(0).randint(0, 256, (4, seq))
    params = jmodel.init(jax.random.PRNGKey(0),
                         {"input_ids": ids.astype(np.int32)})
    config = {"train_batch_size": 8, "steps_per_print": 1000,
              "async_dispatch": {"steps_per_sync": 2},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "moe": {"enabled": True, "num_experts": 4, "top_k": 2,
                      "capacity_factor": 1.0, "every_n_layers": 2}}
    jengine, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params,
        config=dict(config, monitor={"enabled": True,
                                     "output_path": str(tmp_path / "jax")}))
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(
        n_layer=4, n_positions=seq, moe=TMoE(**moe).validate()),
        device="cpu")
    engine, *_ = dst.initialize(
        model=model, model_parameters=params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)),
        config=dict(config, train_micro_batch_size_per_gpu=8,
                    monitor={"enabled": True,
                             "output_path": str(tmp_path / "torch")}))
    rng = np.random.RandomState(3)
    for _ in range(4):
        b = {"input_ids": rng.randint(0, 256, (1, 8, seq)).astype(np.int32)}
        jengine.train_batch(batch=b)
        engine.train_batch(batch=b)
    jengine.shutdown()
    engine.shutdown()
    ref, got = _events(tmp_path / "jax"), _events(tmp_path / "torch")
    _check_card_keys(ref)
    (jm,), (tm,) = _by_kind(ref, "moe"), _by_kind(got, "moe")
    assert {k: v for k, v in tm.items() if k != "ts"} == \
        {k: v for k, v in jm.items() if k != "ts"}
    ref, got = _by_kind(ref, "router"), _by_kind(got, "router")
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        assert sorted(g) == sorted(r)
        assert g["num_experts"] == r["num_experts"] == 4
        assert g["window_steps"] == r["window_steps"] == 2
        np.testing.assert_allclose(g["expert_load"], r["expert_load"],
                                   rtol=TOL, atol=1e-6)
        for key in ("drop_fraction", "aux_loss", "load_max"):
            assert abs(g[key] - r[key]) <= 1e-5 * max(1, abs(r[key])), key


# ----------------------------------------------------------------------
# no host read between fences
# ----------------------------------------------------------------------
def test_monitored_steps_read_nothing_and_fences_copy_once(tree, tmp_path,
                                                          monkeypatch):
    """With the monitor, numerics and the memory ledger on, a step calls
    no .item/.cpu/.tolist/.numpy; a fence makes one .cpu() (of one
    stacked tensor) and reads nothing else from the device."""
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                  device="cpu")
    engine, *_ = dst.initialize(
        model=model, model_parameters=params_from_jax(tree[2]),
        config=dict(_config(tmp_path, monitor={"trace": {"enabled": True}},
                            wall_clock_breakdown=True),
                    train_micro_batch_size_per_gpu=8))
    staged = [engine.stage_batch(b) for b in _batches(4)]
    calls = []
    for name in ("item", "cpu", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    fences = []
    real = engine.monitor.on_fence
    monkeypatch.setattr(engine.monitor, "on_fence",
                        lambda: (fences.append(list(calls)), real())[1])
    engine.train_batch(batch=staged[0])
    assert calls == [] and fences == []
    engine.train_batch(batch=staged[1])
    assert fences == [[]]
    assert calls == ["cpu", "numpy"]
    del calls[:]
    engine.train_batch(batch=staged[2])
    assert calls == []
    engine.shutdown()


def test_wall_clock_breakdown_logs_spans_without_a_barrier(tree,
                                                           monkeypatch):
    """wall_clock_breakdown without a monitor block: forward, backward
    and step spans logged at print fences; nothing synchronizes the
    device for them (torch.cuda.synchronize is never called)."""
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    logged = []
    monkeypatch.setattr(engine_mod.logger, "info", logged.append)
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1))
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                  device="cpu")
    engine, *_ = dst.initialize(
        model=model, model_parameters=params_from_jax(tree[2]),
        config={"train_micro_batch_size_per_gpu": 4,
                "gradient_accumulation_steps": 2, "steps_per_print": 2,
                "wall_clock_breakdown": True})
    ids = _batches(1)[0]["input_ids"][0, :4]
    for _ in range(4):
        for _ in range(2):
            loss = engine({"input_ids": ids})
            engine.backward(loss)
            engine.step()
    spans = [m for m in logged if "span ms/step" in m]
    assert len(spans) == 2 and syncs == []
    for m in spans:
        assert all(f"{k}:" in m for k in ("forward", "backward", "step"))


# ----------------------------------------------------------------------
# SIGTERM leaves a flight dump
# ----------------------------------------------------------------------
def test_sigterm_leaves_a_flight_dump(tmp_path):
    """A training process killed by SIGTERM after its first steps dumps
    its flight recorder (reason `sigterm`) before it exits."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import sys, time
        import numpy as np
        import deepspeed_tpu_torch as dst
        from deepspeed_tpu_torch.models import gpt2 as tgpt2
        model = tgpt2.GPT2ForCausalLM(
            tgpt2.tiny_gpt2_config(n_positions=64), device="cpu")
        engine, *_ = dst.initialize(
            model=model, model_parameters=model.init(0),
            config={{"train_batch_size": 2, "monitor": {{
                "enabled": True, "output_path": {str(tmp_path)!r}}}}})
        ids = np.zeros((1, 2, 64), np.int32)
        engine.train_batch(batch={{"input_ids": ids}})
        print("stepped", flush=True)
        time.sleep(60)
    """)
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if line.strip() == "stepped":
                break
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGTERM
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("flight_")]
    assert len(dumps) == 1
    doc = json.load(open(tmp_path / dumps[0]))
    assert doc["reason"] == "sigterm" and doc["step"] == 1
