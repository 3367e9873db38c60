"""PyTorch port: the optimizers (runtime/bf16_optimizer.py) and the LR
schedules (runtime/lr_schedules.py) against the JAX package.

* adamw_bf16: the bf16 moments and the fp32 updates after three steps on
  the same numpy grads against the JAX package's adamw_bf16; the fp32
  state form against optax.adamw and `adam` against optax.adam (the
  engine's fp32-master path).
* stochastic_round_bf16: unbiasedness, exactness on representable
  values, NaN/inf passthrough (tests/test_bf16_sr.py:19,36 mirrored:
  the port's random stream differs from JAX's, so the checks are
  statistical).
* The master-less (stochastic rounding) engine's loss trajectory
  against the port's own fp32-master path, as in the JAX test.
* The schedules' host classes and step-indexed device form against the
  JAX package's.

Tolerances: moments are one bf16 rounding of the same fp32 value (rtol
1e-2, one bf16 ulp, where the two fp32 values straddle a rounding
point), and an update that reads such a moment inherits that (rtol
1e-2 after the first step); the first update and the fp32 optimizers
to fp32 roundoff (rtol 1e-5); schedules fp32 on one side (rtol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from deepspeed_tpu.runtime import bf16_optimizer as jbo
from deepspeed_tpu.runtime import lr_schedules as jls
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import bf16_optimizer as tbo
from deepspeed_tpu_torch.runtime import lr_schedules as tls


def _grads(seed, shapes):
    r = np.random.RandomState(seed)
    return [(0.1 * r.randn(*s)).astype(np.float32) for s in shapes]


SHAPES = [(4, 6), (6,)]


def test_adamw_bf16_moments_and_updates_match_jax():
    params = [np.asarray(x, np.float32) for x in _grads(0, SHAPES)]
    jp = [jnp.asarray(p, jnp.bfloat16) for p in params]
    tp = [torch.from_numpy(p).to(torch.bfloat16) for p in params]
    jtx = jbo.adamw_bf16(learning_rate=1e-2, weight_decay=0.1)
    ttx = tbo.adamw_bf16(learning_rate=1e-2, weight_decay=0.1)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        g = _grads(10 + step, SHAPES)
        jup, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        tup, tstate = ttx.update([torch.from_numpy(x) for x in g], tstate,
                                 tp)
        # the first update is fp32 math on zero moments; later ones read
        # moments that may sit one bf16 ulp apart (see the module note)
        rtol = 1e-5 if step == 0 else 1e-2
        for a, b in zip(tup, jup):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=1e-9)
    inner = jstate.inner_state
    assert int(tstate.count) == int(inner.count) == 3
    for mine, ref in ((tstate.mu, inner.mu), (tstate.nu, inner.nu)):
        for a, b in zip(mine, ref):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), rtol=1e-2)


@pytest.mark.parametrize("decay", [0.05, None], ids=["adamw", "adam"])
def test_fp32_adam_matches_optax(decay):
    params = [torch.from_numpy(p) for p in _grads(1, SHAPES)]
    ref_tx = optax.adamw(learning_rate=3e-3, weight_decay=decay) \
        if decay is not None else optax.adam(learning_rate=3e-3)
    tx = tbo.adamw_bf16(learning_rate=3e-3, weight_decay=decay,
                        state_dtype=torch.float32) \
        if decay is not None else tbo.adam(learning_rate=3e-3)
    ref_p = [jnp.asarray(p.numpy()) for p in params]
    ref_state, state = ref_tx.init(ref_p), tx.init(params)
    for step in range(3):
        g = _grads(20 + step, SHAPES)
        ref_u, ref_state = ref_tx.update([jnp.asarray(x) for x in g],
                                         ref_state, ref_p)
        ref_p = optax.apply_updates(ref_p, ref_u)
        updates, state = tx.update([torch.from_numpy(x) for x in g], state,
                                   params, None)
        for p, u in zip(params, updates):
            p.add_(u)
    for a, b in zip(params, ref_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-8)


def test_update_takes_a_device_scalar_learning_rate():
    """The engine passes the lr as a 0-dim tensor; the update is the
    same as with the Python float."""
    params = [torch.from_numpy(p) for p in _grads(2, SHAPES)]
    g = [torch.from_numpy(x) for x in _grads(3, SHAPES)]
    tx = tbo.adamw_bf16(weight_decay=0.1, state_dtype=torch.float32)
    a, _ = tx.update(g, tx.init(params), params, 1e-3)
    b, _ = tx.update(g, tx.init(params), params,
                     torch.tensor(1e-3, dtype=torch.float32))
    for x, y in zip(list(a), list(b)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0.0)


def test_stochastic_round_unbiased():
    """E[sr(x)] == x for x strictly between two bf16 grid points, and
    sr only ever returns one of the two neighbours."""
    lo = 1.0
    hi = float(torch.nextafter(torch.tensor(1.0, dtype=torch.bfloat16),
                               torch.tensor(2.0, dtype=torch.bfloat16)))
    frac = 0.25
    x = lo * (1 - frac) + hi * frac
    gen = torch.Generator()
    gen.manual_seed(0)
    out = tbo.stochastic_round_bf16(torch.full((20000,), x), gen).float()
    assert set(torch.unique(out).tolist()) <= {lo, hi}
    p_hi = float((out == hi).float().mean())
    assert abs(p_hi - frac) < 0.02, p_hi
    assert abs(float(out.mean()) - x) < (hi - lo) * 0.03


def test_stochastic_round_exact_and_specials():
    gen = torch.Generator()
    gen.manual_seed(1)
    xs = torch.tensor([1.0, -2.0, 0.0, float("inf"), float("-inf"),
                       float("nan")])
    out = tbo.stochastic_round_bf16(xs, gen)
    assert out.dtype == torch.bfloat16
    out = out.float()
    assert out[:3].tolist() == [1.0, -2.0, 0.0]
    assert torch.isinf(out[3]) and out[3] > 0
    assert torch.isinf(out[4]) and out[4] < 0
    assert torch.isnan(out[5])


def test_stochastic_round_apply_writes_in_place():
    gen = torch.Generator()
    gen.manual_seed(2)
    p = torch.ones(1000, dtype=torch.bfloat16)
    ident = p.data_ptr()
    tbo.stochastic_round_apply([p], [torch.full((1000,), 1e-3)], gen)
    assert p.data_ptr() == ident
    # 1e-3 is an eighth of the bf16 ulp at 1.0: about 1 in 8 rounds up
    assert 0.06 < float((p > 1.0).float().mean()) < 0.2


def _tiny_engine(master_weights, ids):
    cfg = tgpt2.tiny_gpt2_config(dtype=torch.bfloat16)
    model = tgpt2.GPT2ForCausalLM(cfg, device="cpu")
    params = model.init(seed=0)
    engine, _, _, _ = dst.initialize(
        model=model, model_parameters=params,
        config={"train_batch_size": 8, "steps_per_print": 1000,
                "bf16": {"enabled": True,
                         "master_weights": master_weights},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    return engine


def test_sr_trajectory_matches_fp32_master():
    """The master-less path (bf16 params and moments, stochastic
    rounding) and the fp32-master path stay close over 20 steps on a
    memorisation task, with the JAX test's bounds."""
    ids = np.random.RandomState(0).randint(0, 256, (8, 64))
    e_sr, e_ref = _tiny_engine(False, ids), _tiny_engine(True, ids)
    assert e_sr.bf16_sr_mode and e_sr.state.master is None
    assert all(m.dtype == torch.bfloat16 for m in e_sr.state.opt_state.mu)
    assert all(p.dtype == torch.bfloat16 for p in e_sr.params.values())
    assert all(m.dtype == torch.float32 for m in e_ref.state.master)
    l_sr, l_ref = [], []
    for _ in range(20):
        l_sr.append(float(e_sr.train_batch(batch={"input_ids": ids[None]})))
        l_ref.append(float(e_ref.train_batch(
            batch={"input_ids": ids[None]})))
    assert abs(l_sr[0] - l_ref[0]) < 0.05, (l_sr[0], l_ref[0])
    assert abs(l_sr[-1] - l_ref[-1]) < max(0.15 * abs(l_ref[-1]), 0.3), \
        (l_sr[-1], l_ref[-1])
    assert l_sr[-1] < l_sr[0]


@pytest.mark.parametrize("name,params", [
    (tls.WARMUP_LR, {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                     "warmup_num_steps": 10}),
    (tls.WARMUP_DECAY_LR, {"warmup_max_lr": 1e-3, "warmup_num_steps": 10,
                           "total_num_steps": 30}),
    (tls.ONE_CYCLE, {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                     "cycle_first_step_size": 8, "decay_step_size": 4,
                     "decay_lr_rate": 0.1}),
    (tls.LR_RANGE_TEST, {"lr_range_test_min_lr": 1e-4,
                         "lr_range_test_step_size": 5,
                         "lr_range_test_staircase": True}),
])
def test_schedules_match_jax(name, params):
    """Host classes step by step, and the step-indexed device form over
    a whole range at once, against the JAX package's."""
    cls = {tls.WARMUP_LR: "WarmupLR", tls.WARMUP_DECAY_LR: "WarmupDecayLR",
           tls.ONE_CYCLE: "OneCycle", tls.LR_RANGE_TEST: "LRRangeTest"}[name]
    mine = getattr(tls, cls)(None, **params)
    ref = getattr(jls, cls)(None, **params)
    for _ in range(40):
        mine.step()
        ref.step()
        assert mine.get_last_lr() == ref.get_last_lr()
    steps = np.arange(40)
    got = tls.device_schedule_fn(name, params)(torch.from_numpy(steps))
    want = np.asarray(jls.device_schedule_fn(name, params)(
        jnp.asarray(steps)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
    host = []
    for i in steps:
        s = getattr(tls, cls)(None, **params)
        s.step(int(i))
        host.append(s.get_last_lr()[0])
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-5)
    const = tls.device_schedule_fn(None, base_lr=2e-4)(torch.tensor(3))
    assert float(const) == pytest.approx(2e-4)
