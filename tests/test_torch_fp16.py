"""PyTorch port: fp16 mixed precision with dynamic loss scaling against
the JAX package.

* The loss-scale automaton (`runtime/fp16/loss_scaler.py`) against the
  JAX package's `update_loss_scale` at every transition (growth at the
  window, the hysteresis, the drop, the min-scale floor, the reset of
  good_steps, a clean window restoring the hysteresis, the static form)
  and over random overflow sequences: exact. The host classes against
  the JAX package's, and the host scaler against the automaton where
  the two agree (delayed_shift 1): exact.
* The `fp16` and `progressive_layer_drop` blocks resolve to the JAX
  package's settings, and fp16 with bf16 fails in both.
The engine's checks (in tests/test_torch_fp16_engine.py, split out to
spread the test clock over workers):
* The engine in fp16 (gpt2-tiny, AdamW, WarmupLR, clipping) against the
  JAX engine over 10 steps whose batches overflow at known scales: a
  batch of one repeated token sums its embedding gradient over every
  position and overflows fp16 from scale 2^15 (|g| ~ 9.5e4 there), a
  random batch stays below 1.7e4 up to 2^17 (T 32). Per step the overflow
  flag, the scale, skipped_steps, the device step count and the lr are
  equal; the loss agrees within 2e-3 relative (fp16 activations in each
  package's own order; observed below 2e-4). Checkpoints saved
  mid-window (the scale, good_steps and hysteresis off their initial
  values) load both ways bit for bit, and the port resumes from its own
  bit for bit.
* A skipped step leaves every parameter, master, moment and counter bit
  for bit as it was, for every optimizer, also when the gradients hold
  inf and NaN (a static scale of 2^40), and `train_batch` in fp16 reads
  nothing back from the device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls
from torch_one_thread import one_torch_thread  # noqa: F401

# the engine tests' (tests/test_torch_fp16_engine.py) loss tolerance and
# sequence length
LOSS_TOL = 2e-3
SEQ = 32


# ----------------------------------------------------------------------
# the automaton
# ----------------------------------------------------------------------
AUTOMATON_CASES = [
    # (scale, good_steps, hysteresis, overflow, kwargs)
    ("clean", 1024.0, 5, 2, False, {}),
    ("growth-at-window", 1024.0, 999, 2, False, {}),
    ("growth-at-second-window", 1024.0, 1999, 2, False, {}),
    ("hysteresis-decrement", 1024.0, 7, 2, True, {}),
    ("drop", 1024.0, 7, 1, True, {}),
    ("drop-resets-hysteresis-3", 1024.0, 0, 1, True, {"delayed_shift": 3}),
    ("min-scale-floor", 1.5, 0, 1, True, {"min_scale": 1.0}),
    ("at-min-scale", 1.0, 3, 1, True, {}),
    ("window-restores-hysteresis", 1024.0, 3, 1, False,
     {"scale_window": 4}),
    ("delayed-shift-1", 8.0, 0, 1, True, {"delayed_shift": 1}),
    ("scale-factor-4", 64.0, 9, 2, False,
     {"scale_window": 10, "scale_factor": 4.0}),
    ("static-overflow", 128.0, 0, 1, True, {"dynamic": False}),
]


@pytest.mark.parametrize("name,scale,good,hyst,overflow,kw",
                         AUTOMATON_CASES, ids=[c[0] for c in AUTOMATON_CASES])
def test_automaton_transition_matches_jax(name, scale, good, hyst, overflow,
                                          kw):
    jstate = jls.LossScaleState(jnp.float32(scale), jnp.int32(good),
                                jnp.int32(hyst))
    tstate = tls.LossScaleState(torch.tensor(scale), torch.tensor(
        good, dtype=torch.int32), torch.tensor(hyst, dtype=torch.int32))
    want = jls.update_loss_scale(jstate, jnp.asarray(overflow), **kw)
    got = tls.update_loss_scale(tstate, torch.tensor(overflow), **kw)
    for g, w in zip(got, want):
        assert g.dtype == {np.float32: torch.float32,
                           np.int32: torch.int32}[np.asarray(w).dtype.type]
        assert g.item() == np.asarray(w).item(), name


@pytest.mark.parametrize("kw", [
    {}, {"scale_window": 3}, {"scale_window": 5, "delayed_shift": 3},
    {"scale_window": 2, "delayed_shift": 1, "min_scale": 4.0},
], ids=["defaults", "window-3", "window-5-shift-3", "window-2-floor"])
def test_automaton_sequences_match_jax(kw):
    """200 random overflow flags through both automata from 2^10 (the
    JAX one jitted, as the JAX engine runs it): every state equal."""
    flags = np.random.RandomState(len(kw)).rand(200) < 0.3
    shift = kw.get("delayed_shift", 2)
    jstate = jls.make_loss_scale_state(2.0 ** 10, shift)
    tstate = tls.make_loss_scale_state(2.0 ** 10, shift)
    step = jax.jit(lambda s, o: jls.update_loss_scale(s, o, **kw))
    for flag in flags:
        jstate = step(jstate, jnp.asarray(flag))
        tstate = tls.update_loss_scale(tstate, torch.tensor(bool(flag)), **kw)
        assert [t.item() for t in tstate] == \
            [np.asarray(j).item() for j in jstate]


def test_host_scalers_match_jax_and_the_automaton():
    """The host DynamicLossScaler against the JAX package's over random
    flags (every field), and at delayed_shift 1 its scale against the
    automaton's; CreateLossScaler picks as the JAX package does."""
    flags = np.random.RandomState(7).rand(300) < 0.2
    for args in ({}, {"delayed_shift": 3, "scale_window": 4},
                 {"delayed_shift": 2, "scale_window": 3,
                  "consecutive_hysteresis": True}):
        j, t = jls.DynamicLossScaler(**args), tls.DynamicLossScaler(**args)
        for flag in flags:
            j.update_scale(bool(flag))
            t.update_scale(bool(flag))
            assert (t.cur_scale, t.cur_hysteresis, t.cur_iter,
                    t.last_overflow_iter) == (j.cur_scale, j.cur_hysteresis,
                                              j.cur_iter,
                                              j.last_overflow_iter)
    host = tls.DynamicLossScaler(init_scale=2 ** 12, scale_window=4,
                                 delayed_shift=1)
    state = tls.make_loss_scale_state(2.0 ** 12, 1)
    for flag in flags:
        host.update_scale(bool(flag))
        state = tls.update_loss_scale(state, torch.tensor(bool(flag)),
                                      scale_window=4, delayed_shift=1)
        assert host.cur_scale == state.loss_scale.item()
    for args in ((False, 1, False, None), (True, 64, False, None),
                 (True, 0, True, None),
                 (True, 0, True, {"init_scale": 2 ** 8, "scale_window": 7,
                                  "min_scale": 2, "delayed_shift": 3})):
        j, t = jls.CreateLossScaler(*args), tls.CreateLossScaler(*args)
        assert type(t).__name__ == type(j).__name__
        assert (t.loss_scale, t.dynamic) == (j.loss_scale, j.dynamic)
        assert [x.item() for x in t.state()] == \
            [np.asarray(x).item() for x in j.state()]


# ----------------------------------------------------------------------
# the config blocks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("block", [
    {"fp16": {"enabled": True}},
    {"fp16": {"enabled": True, "loss_scale": 128}},
    {"fp16": {"enabled": True, "initial_scale_power": 16,
              "loss_scale_window": 500, "hysteresis": 3,
              "min_loss_scale": 0.5}},
    {"fp16": {"enabled": True, "hysteresis": 1}},
    {"fp16": {"enabled": False, "loss_scale": 7}},
    {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                "gamma": 0.001}},
    {"progressive_layer_drop": {"enabled": True}},
    {"progressive_layer_drop": {"enabled": False, "theta": 0.3}},
], ids=["fp16", "static", "dynamic-args", "hysteresis-only", "fp16-off",
        "pld", "pld-defaults", "pld-off"])
def test_fp16_and_pld_blocks_resolve_like_jax(block):
    d = dict({"train_batch_size": 8}, **block)
    j, t = JConfig(dict(d), world_size=1), TConfig(dict(d))
    for attr in ("fp16_enabled", "loss_scale", "initial_dynamic_scale",
                 "dynamic_loss_scale_args", "pld_enabled", "pld_params"):
        assert getattr(t, attr) == getattr(j, attr), attr


def test_fp16_with_bf16_fails_like_jax():
    d = {"train_batch_size": 8, "fp16": {"enabled": True},
         "bf16": {"enabled": True}}
    with pytest.raises(AssertionError, match="mutually exclusive"):
        JConfig(dict(d), world_size=1)
    with pytest.raises(AssertionError, match="mutually exclusive"):
        TConfig(dict(d))
