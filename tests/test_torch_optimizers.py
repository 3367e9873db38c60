"""PyTorch port: the engine's other optimizers, client objects and
progressive layer drop against the JAX package.

* LAMB (`ops/lamb/fused_lamb.py`, the clipped trust ratio), SGD with and
  without momentum (optax's `sgd` as the JAX engine wires it) and 1-bit
  Adam's single-worker form across its freeze_step (error feedback
  included) against the JAX transforms on random trees, 4 steps (1-bit
  Adam 5): every update and every state leaf within 1e-6 relative (fp32;
  the two packages' pow and sum orders differ in the last ulp), the
  error feedback within 1e-6 of its leaf's largest entry (it is a
  difference of numbers near the compression scale). The 1-bit sign
  packing, unpacking and compression: exact.
* (In tests/test_torch_optimizers_engine.py, split out to spread the
  test clock over workers, sharing this file's cases and helpers.) Each
  optimizer through `initialize` -> `train_batch` in fp16 against
  the JAX engine (gpt2-tiny, dynamic scale from 2^17: two overflowed
  steps, so the masked skip meets the JAX engine's lax.cond, then clean
  ones; 1-bit Adam crosses freeze_step 2): the scale, skipped and device
  step counts equal, the losses within 2e-3 relative (fp16 activations,
  as in `test_torch_fp16.py`), and the optimizer states in the JAX
  layout within 1e-2 relative L2 per state field after the run (the
  counts and hyperparameters within 1e-6; 1-bit Adam's momentum with
  its error feedback, what it compresses, since a sign is discontinuous). The same with client
  objects: the FusedLamb facade and a client scheduler (WarmupLR over a
  host shim) in both packages, where the client scheduler is rewound
  after an overflowed step, so the lrs agree. Each run's checkpoints,
  saved after its fourth step, load both ways bit for bit, and the port
  resumes from its own bit for bit.
* Progressive layer drop: theta against the JAX schedule (exact; the
  engine's too, as the JAX engine updates it before each step), the
  deterministic gate through GPT-2's loss against the JAX model (fp32,
  1e-5 relative), and the stochastic gate by its keep rate over seeds
  (the streams differ by construction): within 4 standard deviations of
  theta.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.lamb import fused_lamb as jlamb
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu.runtime.fp16 import onebit_adam as jonebit
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.lamb import fused_lamb as tlamb
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deepspeed_tpu_torch.runtime import sgd as tsgd
from deepspeed_tpu_torch.runtime.fp16 import onebit_adam as tonebit
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL = 1e-6
SEQ = 32
LOSS_TOL = 2e-3
# the optimizer states after 3 applied fp16 steps, per field: relative L2
# (the fp16 gradients differ by each package's rounding order; observed
# up to 5.5e-3 in LAMB's mu)
STATE_TOL = 1e-2


def _tree(seed):
    r = np.random.RandomState(seed)
    shapes = {"a": (5, 7), "b": (13,), "c": (3, 4, 2), "zero": (6,)}
    tree = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tree["zero"][:] = 0.0   # a zero leaf: the trust ratio's norm guard
    return tree


def _run_both(jtx, ttx, steps=4, lr=None):
    """Updates and states of the JAX transform and the port's over
    `steps` random gradient trees (the parameters move by the updates)."""
    params = _tree(0)
    names = sorted(params)
    jstate = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    jupdate = jax.jit(jtx.update)
    tparams = [torch.from_numpy(params[k].copy()) for k in names]
    tstate = ttx.init(tparams)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for step in range(steps):
        grads = _tree(step + 1)
        grads["zero"][:] = 0.0 if step == 0 else grads["zero"]
        jupd, jstate = jupdate({k: jnp.asarray(v) for k, v in
                                grads.items()}, jstate, jp)
        tupd, tstate = ttx.update([torch.from_numpy(grads[k]) for k in names],
                                  tstate, tparams, lr)
        tupd = list(tupd)
        for k, u in zip(names, tupd):
            np.testing.assert_allclose(u.numpy(), np.asarray(jupd[k]),
                                       rtol=RTOL, atol=1e-7)
        jp = optax.apply_updates(jp, jupd)
        for p, u in zip(tparams, tupd):
            p.add_(u)
    return names, jstate, tstate


def test_lamb_matches_jax():
    for kw in ({"weight_decay": 0.01}, {"bias_correction": False},
               {"weight_decay": 0.1, "max_coeff": 0.5, "min_coeff": 0.2}):
        names, js, ts = _run_both(jlamb.lamb(learning_rate=2e-3, **kw),
                                  tlamb.lamb(learning_rate=2e-3, **kw))
        inner = js.inner_state
        assert ts.count.item() == int(inner.count) == int(js.count)
        for k, m, v in zip(names, ts.mu, ts.nu):
            np.testing.assert_allclose(m.numpy(), np.asarray(inner.mu[k]),
                                       rtol=RTOL, atol=1e-8)
            np.testing.assert_allclose(v.numpy(), np.asarray(inner.nu[k]),
                                       rtol=RTOL, atol=1e-10)


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_sgd_matches_optax(momentum):
    names, js, ts = _run_both(
        optax.inject_hyperparams(optax.sgd)(learning_rate=0.05,
                                            momentum=momentum),
        tsgd.sgd(learning_rate=0.05, momentum=momentum))
    assert ts.count.item() == int(js.count)
    if momentum is None:
        assert ts.trace is None
        return
    for k, t in zip(names, ts.trace):
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(js.inner_state[0].trace[k]),
                                   rtol=RTOL, atol=1e-7)


def test_onebit_adam_matches_jax_across_freeze_step():
    names, js, ts = _run_both(
        jonebit.onebit_adam(learning_rate=1e-3, weight_decay=0.01,
                            freeze_step=2),
        tonebit.onebit_adam(learning_rate=1e-3, weight_decay=0.01,
                            freeze_step=2), steps=5)
    assert ts.count.item() == int(js.count) == 5
    for field in ("exp_avg", "exp_avg_sq", "worker_error", "server_error"):
        for k, t in zip(names, getattr(ts, field)):
            want = np.asarray(getattr(js, field)[k])
            # the error feedback is corrected - scale * sign: a difference
            # of two numbers near the compression scale, so it is held to
            # 1e-6 of the leaf's largest entry
            np.testing.assert_allclose(
                t.numpy(), want, rtol=RTOL,
                atol=max(1e-8, RTOL * float(np.abs(want).max())),
                err_msg=field)


@pytest.mark.parametrize("n", [1, 8, 13, 64])
def test_sign_packing_matches_jax(n):
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    x[0] = 0.0
    err = np.random.RandomState(n + 1).randn(n).astype(np.float32)
    packed = tonebit.pack_signs(torch.from_numpy(x))
    want = np.asarray(jonebit.pack_signs(jnp.asarray(x)))
    assert packed.dtype == torch.uint8 and np.array_equal(packed.numpy(),
                                                          want)
    assert np.array_equal(tonebit.unpack_signs(packed, n).numpy(),
                          np.asarray(jonebit.unpack_signs(jnp.asarray(want),
                                                          n)))
    scale, p, e = tonebit.compress(torch.from_numpy(x), torch.from_numpy(err))
    js, jp, je = jonebit.compress(jnp.asarray(x), jnp.asarray(err))
    assert np.array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(scale.item(), float(js), rtol=RTOL)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=RTOL,
                               atol=1e-7)


# ----------------------------------------------------------------------
# through the engines, in fp16
# ----------------------------------------------------------------------
def _config(optimizer=None, **extra):
    cfg = {"train_batch_size": 8, "steps_per_print": 1000,
           "zero_optimization": {"stage": 1},
           "fp16": {"enabled": True, "initial_scale_power": 17,
                    "loss_scale_window": 2}}
    if optimizer is not None:
        cfg["optimizer"] = optimizer
    cfg.update(extra)
    return cfg


# "u": one repeated token, overflows at 2^16 and above; "r": random
# tokens, clean there (see test_torch_fp16.py): two skipped steps, then
# clean ones (1-bit Adam's third applied step is its first compressed
# one); the checkpoints after the fourth step
KINDS = "uurrr"
SAVE_AFTER = 4


def _batches():
    return [{"input_ids": np.zeros((1, 8, SEQ), np.int32) if k == "u" else
             np.random.RandomState(i).randint(0, 256, (1, 8, SEQ))
             .astype(np.int32)} for i, k in enumerate(KINDS)]


@pytest.fixture(scope="module")
def tiny_tree():
    cfg = jgpt2.tiny_gpt2_config(n_positions=SEQ, dtype=jnp.float16)
    model = jgpt2.GPT2ForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _port(tree, config, **kw):
    model = tgpt2.GPT2ForCausalLM(
        tgpt2.tiny_gpt2_config(n_positions=SEQ, dtype=torch.float16),
        device="cpu")
    return dst.initialize(model=model, model_parameters=params_from_jax(tree),
                          config=dict(config,
                                      train_micro_batch_size_per_gpu=8),
                          **kw)[0]


def _jax_opt_flat(jengine):
    payload = jengine._ckpt_payload(jengine.state)
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.device_get(payload["opt_state"]))[0]
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in leaves}


ENGINE_CASES = {
    "lamb": dict(optimizer={"type": "Lamb", "params": {
        "lr": 2e-3, "weight_decay": 0.01, "max_coeff": 10.0,
        "min_coeff": 0.01}}),
    "sgd": dict(optimizer={"type": "SGD", "params": {"lr": 1e-2,
                                                     "momentum": 0.9}}),
    "onebit": dict(optimizer={"type": "OneBitAdam", "params": {
        "lr": 1e-3, "weight_decay": 0.01, "freeze_step": 2}}),
    "client-lamb-scheduler": dict(client=True),
}


def _client_objects(pkg_lamb, pkg_sched):
    sched = pkg_sched.WarmupLR(pkg_sched._OptimizerShim(lr=2e-3),
                               warmup_max_lr=2e-3, warmup_num_steps=4)
    opt = pkg_lamb.FusedLamb(lr=2e-3, weight_decay=0.01)
    return opt, sched


# ----------------------------------------------------------------------
# progressive layer drop
# ----------------------------------------------------------------------
def test_pld_theta_matches_jax():
    j, t = jpld.ProgressiveLayerDrop(theta=0.5, gamma=0.001), \
        tpld.ProgressiveLayerDrop(theta=0.5, gamma=0.001)
    for step in (0, 1, 10, 500, 4000):
        j.update_state(step)
        t.update_state(step)
        assert t.get_theta() == j.get_theta()
        assert t.get_state() == j.get_state()


def test_pld_deterministic_gate_matches_jax(tiny_tree):
    """GPT-2's loss with the deterministic gate hidden + p (out - hidden)
    against the JAX model's, fp32."""
    cfg = jgpt2.tiny_gpt2_config(n_positions=SEQ)
    jmodel = jgpt2.GPT2ForCausalLM(cfg)
    tree = tiny_tree[2]
    tmodel = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=SEQ),
                                   device="cpu")
    params = params_from_jax(tree)
    ids = np.random.RandomState(3).randint(0, 256, (2, SEQ)).astype(np.int32)
    for kp in (0.7, 1.0):
        want = float(jmodel.loss_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                                    {"input_ids": ids}, deterministic=True,
                                    layer_keep_prob=jnp.float32(kp)))
        got = float(tmodel.loss_fn(params, {"input_ids": ids},
                                   deterministic=True,
                                   layer_keep_prob=torch.tensor(kp)))
        assert abs(got - want) <= 1e-5 * abs(want), (kp, got, want)


def test_pld_stochastic_gate_keeps_theta_of_the_blocks():
    """The gate keeps a block with probability theta: over 4000 seeds
    the keep rate is within 4 standard deviations of theta, and the
    gate draws from the block's seed (the same seed, the same draw)."""
    theta, n = 0.6, 4000
    hidden, out = torch.zeros(3), torch.ones(3)
    kept = [bool(tgpt2._pld_gate(hidden, out, torch.tensor(theta), False,
                                 seed)[0]) for seed in range(n)]
    sd = (theta * (1 - theta) / n) ** 0.5
    assert abs(np.mean(kept) - theta) <= 4 * sd
    again = [bool(tgpt2._pld_gate(hidden, out, torch.tensor(theta), False,
                                  seed)[0]) for seed in range(50)]
    assert again == kept[:50]


def test_engine_feeds_pld_theta_like_jax(tiny_tree):
    """The engine's theta per step is the JAX engine's (its
    ProgressiveLayerDrop updated from the host step count before each
    step) and reaches the model as a 0-dim device tensor."""
    config = {"train_batch_size": 8, "steps_per_print": 1000,
              "fp16": {"enabled": True},
              "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                         "gamma": 0.01}}
    engine = _port(tiny_tree[2], config)
    ref = jpld.ProgressiveLayerDrop(theta=0.5, gamma=0.01)
    seen = []
    loss_fn = engine._loss_fn

    def spy(params, batch, rngs=None, deterministic=False, **kw):
        seen.append(kw["layer_keep_prob"])
        return loss_fn(params, batch, rngs=rngs, deterministic=deterministic,
                       **kw)

    engine._loss_fn = spy
    for step, batch in enumerate(_batches()[2:]):
        engine.train_batch(batch=batch)
        ref.update_state(step)
        assert engine.pld_theta() == ref.get_theta()
        assert isinstance(seen[-1], torch.Tensor) and seen[-1].dim() == 0
        np.testing.assert_allclose(seen[-1].item(), ref.get_theta(),
                                   rtol=1e-7)
