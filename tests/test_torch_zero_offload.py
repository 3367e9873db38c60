"""PyTorch port: ZeRO-Offload at world size 1 (runtime/zero/offload.py)
against the JAX package's offload engine.

Both engines train the JAX package's tiny GPT-2 of tests/test_offload_
wire.py (1 layer, n_embd 32, 23,008 parameters) from the same weights
(the JAX tree carried across by models/convert.py) on the same
numpy-seeded batch; the JAX engine spreads its batch of 8 over the 8
virtual CPU devices, the port takes it as one micro batch of 8.

- The port's host masters are in the JAX package's ravel_pytree order:
  the two engines' initial masters are equal bit for bit.
- fp32 compute (clipping and weight decay on): losses within 1e-5
  relative and host masters within 1e-5 relative L2 over 3 steps
  (reduction order only; both run the same native CPU-Adam). bf16
  compute: losses within 2e-2 and masters within 1e-3 relative L2 (the
  two packages round the bf16 forward and backward at different places;
  the masters move by lr-sized steps whose signs follow the gradients).
- The offload engine against the port's own device engine with fp32
  masters: the same AdamW, host against device (JAX's
  test_offload_engine_matches_device_engine bound, 0.05, in bf16; 1e-5
  relative in fp32).
- The wire, routes held equal: the same flat gradients through both
  packages' int8 and 1-bit tails give bit-equal int8 and sign payloads
  and int8 scales; the 1-bit mean-abs scales are within 1 ulp of the
  exactly rounded block means (the port sums in fp64) and within 2 of
  JAX's (whose fp32 sums stray 2 ulps from exact here); the host steps
  on one payload are then bit-equal.
- An overflowed step leaves masters, shadow and residual untouched; the
  warm-up runs an fp32 wire and then compresses; the chunk bounds are
  the JAX package's; the param shadow equals the device fp32 copy bit
  for bit (both sides apply the same unfused dequant); 3 chunks equal 1
  chunk bit for bit; device parameter views are 64-element aligned.
- Checkpoints cross both ways, wire state included, with masters and
  moments bit-equal, and a checkpoint of another wire config (or none)
  restarts the error feedback from zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import config_from_jax, \
    params_from_jax
from deepspeed_tpu_torch.runtime.zero.offload import ZeroOffloadMixin
from torch_one_thread import one_torch_thread  # noqa: F401

SEQ = 64
LOSS_TOL_F32 = 1e-5
MASTER_TOL_F32 = 1e-5
LOSS_TOL_BF16 = 2e-2
MASTER_TOL_BF16 = 1e-3
DEVICE_ENGINE_TOL_BF16 = 0.05
# the global norm: JAX's vdot on the CPU sums in fp32 in one pass (2.4e-5
# from the fp64 norm on these gradients), the port's within 1e-8
NORM_TOL = 1e-4
Q1 = {"grad_bits": 1, "param_bits": 8}
Q8 = {"grad_bits": 8, "param_bits": 8}


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jgpt2.tiny_gpt2_config(n_layer=1, n_embd=32, n_head=4,
                                 n_positions=SEQ, dropout=0.0)
    model = jgpt2.GPT2ForCausalLM(cfg)
    ids = np.random.RandomState(0).randint(0, 256, (8, SEQ)).astype(
        np.int32)
    params = model.init(jax.random.PRNGKey(0), {"input_ids": ids})
    return cfg, model, params, jax.tree_util.tree_map(np.asarray, params), \
        ids


def _ds(wire=None, fp16=False, bf16=True, lr=1e-2, clip=0.0, wd=0.0,
        offload=True):
    zero = {"stage": 2, "cpu_offload": offload}
    if wire is not None:
        zero["offload_wire"] = wire
    ds = {"train_batch_size": 8, "steps_per_print": 1000,
          "gradient_clipping": clip, "zero_optimization": zero,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": lr, "weight_decay": wd}}}
    if fp16:
        ds["fp16"] = {"enabled": True, "loss_scale": 0}
    elif bf16:
        ds["bf16"] = {"enabled": True}
    return ds


def _jax(jax_tree, **kw):
    cfg, model, params, _, _ = jax_tree
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=_ds(**kw))
    return engine


def _port(jax_tree, **kw):
    cfg, _, _, tree, _ = jax_tree
    model = tgpt2.GPT2ForCausalLM(config_from_jax(cfg), device="cpu")
    engine, _, _, _ = dst.initialize(
        model=model, model_parameters=params_from_jax(tree), config=_ds(**kw))
    return engine


def _run(engine, ids, steps):
    return [float(np.asarray(engine.train_batch(
        batch={"input_ids": ids[None]}))) for _ in range(steps)]


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_host_masters_are_in_jax_ravel_order(jax_tree):
    j, t = _jax(jax_tree, bf16=False), _port(jax_tree, bf16=False)
    assert t._host_master.size == j._host_master.size == 23008
    assert np.array_equal(t._host_master, j._host_master)
    assert t._host_adam.native


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_offload_engine_matches_jax_offload_engine(jax_tree, bf16):
    kw = dict(bf16=bf16, clip=0.5, wd=0.01)
    j, t = _jax(jax_tree, **kw), _port(jax_tree, **kw)
    ids = jax_tree[4]
    ref, got = np.array(_run(j, ids, 3)), np.array(_run(t, ids, 3))
    loss_tol, master_tol = (LOSS_TOL_BF16, MASTER_TOL_BF16) if bf16 else \
        (LOSS_TOL_F32 * np.abs(ref), MASTER_TOL_F32)
    assert np.all(np.abs(got - ref) <= loss_tol), (got, ref)
    assert got[-1] < got[0]
    assert _rel_l2(t._host_master, j._host_master) <= master_tol
    assert t._host_adam.step_count == j._host_adam.step_count == 3
    assert t.global_steps == 3 and t.wire_stats == j.wire_stats


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_offload_engine_matches_port_device_engine(jax_tree, bf16):
    """Host CPU-Adam against the port's device AdamW (fp32 masters):
    the same trajectory, the JAX package's test at bf16."""
    dev = _port(jax_tree, bf16=bf16, offload=False)
    off = _port(jax_tree, bf16=bf16)
    assert dev.state.master is not None or not bf16
    ids = jax_tree[4]
    ld, lo = np.array(_run(dev, ids, 5)), np.array(_run(off, ids, 5))
    tol = DEVICE_ENGINE_TOL_BF16 if bf16 else LOSS_TOL_F32 * np.abs(ld)
    assert np.all(np.abs(ld - lo) <= tol), (ld, lo)
    if not bf16:
        master = torch.cat([dev.fp32_params[n].reshape(-1)
                            for n in off._offload_order]).numpy()
        assert _rel_l2(off._host_master, master) <= MASTER_TOL_F32


def _flat_grads(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32) * 1e-2
    g[: n // 7] *= 30.0       # blocks of other magnitudes
    return g


@pytest.mark.parametrize("wire", ["q8", "q1"])
def test_wire_tails_match_jax_and_host_steps_bit_equal(jax_tree, wire):
    cfg = Q8 if wire == "q8" else Q1
    j, t = _jax(jax_tree, wire=cfg), _port(jax_tree, wire=cfg)
    n = t._host_master.size
    flat = _flat_grads(n, 3)
    acc = j._offload_unravel(jnp.asarray(flat))
    t._offload_acc.copy_(torch.from_numpy(flat))
    scale = j.state.scale.loss_scale
    if wire == "q8":
        jq, js, jn = j._offload_grad_tail_q_jit(acc, scale)
        tq, ts, tn = t._offload_grad_tail_q8(t.state.scale.loss_scale)
    else:
        res = np.zeros(t._offload_grad_residual.numel(), np.float32)
        res[:n] = _flat_grads(n, 4) * 0.1
        jq, js, jn, jres = j._offload_grad_tail_q_jit(acc, scale,
                                                      jnp.asarray(res))
        t._offload_grad_residual.copy_(torch.from_numpy(res))
        tq, ts, tn, tres = t._offload_grad_tail_q1(t.state.scale.loss_scale)
        np.testing.assert_allclose(tres.numpy(), np.asarray(jres),
                                   rtol=0, atol=1e-7)
    jq, js = np.asarray(jq), np.asarray(js)
    assert np.array_equal(tq.numpy(), jq)
    if wire == "q8":
        # max-abs / 127: no sum, so the same bits
        assert np.array_equal(ts.numpy(), js)
    else:
        # mean-abs: the port's block sums are the exact sums rounded
        # once (1 ulp at most); JAX's fp32 sums stray 2 ulps from exact
        # on block 0 here, so the two are held within 2
        c = np.zeros(len(res), np.float64)
        c[:n] = np.abs((flat + res[:n]).astype(np.float64))
        count = np.minimum(4096, n - 4096 * np.arange(len(js)))
        exact = (c.reshape(-1, 4096).sum(axis=1).astype(np.float32) /
                 count.astype(np.float32))
        np.testing.assert_array_max_ulp(ts.numpy(), exact, maxulp=1)
        np.testing.assert_array_max_ulp(ts.numpy(), js, maxulp=2)
    np.testing.assert_allclose(float(tn), float(jn), rtol=NORM_TOL)
    # the host steps on one payload (JAX's) are bit-equal
    B = 4096
    for e in (j, t):
        e._host_adam.begin_step()
        lo, hi = 0, n
        pay = jq if wire == "q8" else jq[lo // 8: -(-hi // 8)]
        step = e._host_adam.step_chunk_q8 if wire == "q8" else \
            e._host_adam.step_chunk_q1
        step(lo, hi, e._host_master[lo:hi], pay, js, B, lr=1e-2)
    assert np.array_equal(t._host_master, j._host_master)
    assert np.array_equal(t._host_adam.exp_avg_sq, j._host_adam.exp_avg_sq)


def test_overflow_skips_without_touching_masters_shadow_residual(jax_tree):
    t = _port(jax_tree, wire=Q1, fp16=True, bf16=False, lr=1e-3)
    ids = jax_tree[4]
    _run(t, ids, 2)
    res = t._offload_grad_residual.clone()
    master = t._host_master.copy()
    shadow = t._offload_param_shadow.copy()
    scale = t._host_scaler.cur_scale
    skipped = t.skipped_steps
    t._offload_acc.add_(float("inf"))
    assert t._offload_take_step(lr=1e-3) is True
    assert t.skipped_steps == skipped + 1
    assert t._host_scaler.cur_scale < scale
    assert float(t.state.scale.loss_scale) == t._host_scaler.cur_scale
    assert torch.equal(t._offload_grad_residual, res)
    assert np.array_equal(t._host_master, master)
    assert np.array_equal(t._offload_param_shadow, shadow)
    assert float(t._offload_acc.abs().max()) == 0.0
    assert np.isfinite(_run(t, ids, 1)[0])


def test_fp16_scale_follows_jax(jax_tree):
    """fp16 from 2^32: the same skipped steps and loss scales as the JAX
    offload engine (the host scaler's automaton)."""
    j = _jax(jax_tree, fp16=True, bf16=False, lr=1e-3)
    t = _port(jax_tree, fp16=True, bf16=False, lr=1e-3)
    ids = jax_tree[4]
    for _ in range(4):
        _run(j, ids, 1)
        _run(t, ids, 1)
        assert t._host_scaler.cur_scale == j._host_scaler.cur_scale
    assert t.skipped_steps == int(jax.device_get(j.state.skipped)) > 0
    assert np.array_equal(t._host_master, j._host_master)


def test_warmup_runs_uncompressed_then_engages(jax_tree):
    t = _port(jax_tree, wire={"grad_bits": 1, "param_bits": 8,
                              "warmup_steps": 2})
    ids = jax_tree[4]
    n = t._host_master.size
    _run(t, ids, 1)
    assert t.wire_stats["warmup"] is True
    assert t.wire_stats["d2h_bytes"] == 4 * n
    assert t.wire_stats["h2d_bytes"] == 4 * n
    _run(t, ids, 2)
    assert t.wire_stats["warmup"] is False
    assert t.wire_stats["d2h_bytes"] == -(-n // 8) + 4 * -(-n // 4096)
    t16 = _port(jax_tree, wire={"grad_bits": 16, "warmup_steps": 1},
                bf16=False)
    _run(t16, ids, 1)
    assert t16.wire_stats["d2h_bytes"] == 4 * n
    _run(t16, ids, 1)
    assert t16.wire_stats["d2h_bytes"] == 2 * n
    assert np.array_equal(t._offload_device_flat.numpy(),
                          t._offload_param_shadow)


@pytest.mark.parametrize("n,chunk,align", [(10_000, 1000, 256),
                                           (23_008, 8192, 4096),
                                           (5, 4 << 20, 1),
                                           (12_345_678, 4 << 20, 4096)])
def test_bounds_match_jax(n, chunk, align):
    from deepspeed_tpu.runtime.zero.offload import ZeroOffloadMixin as J

    class Port(ZeroOffloadMixin):
        _OFFLOAD_CHUNK_ELEMS = chunk

    class Ref(J):
        _OFFLOAD_CHUNK_ELEMS = chunk

    bounds = Port()._offload_bounds(n, align)
    assert bounds == Ref()._offload_bounds(n, align)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2 and lo2 % align == 0


def test_param_shadow_tracks_device_copy(jax_tree):
    t = _port(jax_tree, wire=Q8)
    _run(t, jax_tree[4], 3)
    assert np.array_equal(t._offload_device_flat.numpy(),
                          t._offload_param_shadow)
    assert not np.array_equal(t._offload_param_shadow, t._host_master)
    # the device parameters are the device copy, rounded to bf16
    views = t._offload_views(t._offload_device_flat.numpy())
    for name, p in t.state.params.items():
        assert torch.equal(p.detach(), views[name].to(torch.bfloat16))


@pytest.mark.parametrize("wire", [None, Q8, Q1], ids=["native", "q8", "q1"])
def test_three_chunks_equal_one_chunk(jax_tree, wire, monkeypatch):
    one = _port(jax_tree, wire=wire)
    monkeypatch.setattr(ZeroOffloadMixin, "_OFFLOAD_CHUNK_ELEMS", 8192)
    three = _port(jax_tree, wire=wire)
    assert len(one._offload_bounds_cached) == 1
    assert len(three._offload_bounds_cached) == 3
    ids = jax_tree[4]
    assert _run(one, ids, 3) == _run(three, ids, 3)
    assert np.array_equal(one._host_master, three._host_master)
    for a, b in zip(one.state.params.values(), three.state.params.values()):
        assert torch.equal(a, b)


def test_device_views_are_aligned(jax_tree):
    t = _port(jax_tree)
    base = t._offload_param_flat.data_ptr()
    assert base % 16 == 0
    size = t._offload_param_flat.element_size()
    for p in t.state.params.values():
        assert (p.data_ptr() - base) % (64 * size) == 0
        assert p.data_ptr() % 16 == 0
    assert t.state.opt_state == () and t.state.master is None


def test_offload_turns_async_dispatch_off_and_ignores_sr_mode(jax_tree):
    cfg, _, _, tree, _ = jax_tree
    ds = _ds()
    ds["bf16"] = {"enabled": True, "master_weights": False}
    model = tgpt2.GPT2ForCausalLM(config_from_jax(cfg), device="cpu")
    t, _, _, _ = dst.initialize(model=model,
                                model_parameters=params_from_jax(tree),
                                config=ds)
    assert not t.async_dispatch_enabled() and not t.bf16_sr_mode
    assert t.compute_dtype == torch.bfloat16


def test_micro_step_api_equals_train_batch(jax_tree):
    a, b = _port(jax_tree, wire=Q8), _port(jax_tree, wire=Q8)
    ids = jax_tree[4]
    for _ in range(2):
        la = a.train_batch(batch={"input_ids": ids[None]})
        lb = b.forward({"input_ids": ids})
        b.backward(lb)
        b.step()
        assert float(la) == float(lb)
    assert np.array_equal(a._host_master, b._host_master)
    fp32 = b.fp32_params
    fp32[next(iter(fp32))].add_(1.0)
    assert np.array_equal(a._host_master, b._host_master)


def _moments_equal(a, b):
    for x, y in ((a._host_master, b._host_master),
                 (a._host_adam.exp_avg, b._host_adam.exp_avg),
                 (a._host_adam.exp_avg_sq, b._host_adam.exp_avg_sq)):
        assert np.array_equal(x, y)
    assert a._host_adam.step_count == b._host_adam.step_count


@pytest.mark.parametrize("wire", [None, Q1], ids=["native", "q1"])
def test_checkpoint_jax_to_port(jax_tree, wire, tmp_path):
    j = _jax(jax_tree, wire=wire)
    ids = jax_tree[4]
    _run(j, ids, 2)
    j.save_checkpoint(str(tmp_path), tag="j")
    j.wait_for_checkpoint()
    t = _port(jax_tree, wire=wire)
    t.load_checkpoint(str(tmp_path), tag="j")
    _moments_equal(t, j)
    if wire:
        assert np.array_equal(t._offload_grad_residual.numpy(),
                              np.asarray(j._offload_grad_residual))
        assert np.array_equal(t._offload_param_shadow,
                              j._offload_param_shadow)
        assert t._offload_wire_steps == j._offload_wire_steps == 2
    assert t.global_steps == 2
    assert abs(_run(t, ids, 1)[0] - _run(j, ids, 1)[0]) <= LOSS_TOL_BF16


@pytest.mark.parametrize("wire", [None, Q1], ids=["native", "q1"])
def test_checkpoint_port_to_jax(jax_tree, wire, tmp_path):
    t = _port(jax_tree, wire=wire)
    ids = jax_tree[4]
    _run(t, ids, 2)
    t.save_checkpoint(str(tmp_path), tag="t")
    t.wait_for_checkpoint()
    j = _jax(jax_tree, wire=wire)
    j.load_checkpoint(str(tmp_path), tag="t")
    _moments_equal(t, j)
    if wire:
        assert np.array_equal(np.asarray(j._offload_grad_residual),
                              t._offload_grad_residual.numpy())
        assert np.array_equal(j._offload_param_shadow,
                              t._offload_param_shadow)
    assert abs(_run(t, ids, 1)[0] - _run(j, ids, 1)[0]) <= LOSS_TOL_BF16


def test_checkpoint_round_trip_resumes_bit_for_bit(jax_tree, tmp_path):
    """The native wire: the device parameters are the masters rounded,
    so a resumed engine continues bit for bit. (Under param_bits 8 they
    are the shadow rounded, and a load pushes the masters, as in JAX.)"""
    a = _port(jax_tree)
    ids = jax_tree[4]
    _run(a, ids, 2)
    a.save_checkpoint(str(tmp_path), tag="a")
    a.wait_for_checkpoint()
    b = _port(jax_tree)
    b.load_checkpoint(str(tmp_path), tag="a")
    _moments_equal(a, b)
    assert _run(a, ids, 2) == _run(b, ids, 2)
    assert np.array_equal(a._host_master, b._host_master)


@pytest.mark.parametrize("saved", ["int8_wire", "wireless"])
def test_load_of_another_wire_config_restarts_feedback(jax_tree, saved,
                                                       tmp_path):
    a = _port(jax_tree, wire=Q8 if saved == "int8_wire" else None)
    ids = jax_tree[4]
    _run(a, ids, 2)
    a.save_checkpoint(str(tmp_path), tag="a")
    a.wait_for_checkpoint()
    b = _port(jax_tree, wire=Q1)
    _run(b, ids, 2)
    assert float(b._offload_grad_residual.abs().max()) > 0
    b.load_checkpoint(str(tmp_path), tag="a")
    assert float(b._offload_grad_residual.abs().max()) == 0.0
    assert np.array_equal(b._host_master, a._host_master)
    if saved == "wireless":
        assert np.array_equal(b._offload_param_shadow, a._host_master)
    assert np.isfinite(_run(b, ids, 1)[0])


@pytest.mark.parametrize("wire", [{"grad_bits": 4}, {"param_bits": 16},
                                  {"warmup_steps": -1}, [8]],
                         ids=["grad_bits", "param_bits", "warmup", "list"])
def test_bad_wire_values_fail_as_in_jax(wire):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    d = {"train_batch_size": 8,
         "zero_optimization": {"stage": 2, "cpu_offload": True,
                               "offload_wire": wire}}
    with pytest.raises(AssertionError) as ref:
        JConfig(dict(d), world_size=1)
    with pytest.raises(AssertionError) as mine:
        DeepSpeedConfig(dict(d))
    assert str(mine.value) == str(ref.value)


def test_offload_ignored_without_a_zero_stage(jax_tree):
    """cpu_offload at stage 0 is no offload, in both packages."""
    cfg, model, params, tree, _ = jax_tree
    ds = _ds()
    ds["zero_optimization"]["stage"] = 0
    j, _, _, _ = deepspeed_tpu.initialize(model=model,
                                          model_parameters=params, config=ds)
    t = _port(jax_tree)
    t2, _, _, _ = dst.initialize(
        model=tgpt2.GPT2ForCausalLM(config_from_jax(cfg), device="cpu"),
        model_parameters=params_from_jax(tree), config=ds)
    assert not j._offload_enabled() and not t2._offload_enabled()
    assert t._offload_enabled() and t2.state.master is not None
