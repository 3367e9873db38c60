"""PyTorch port: runtime/utils.py, the A/B correctness checker and the
command-line helpers against the JAX package.

`runtime/utils.py`'s partitioning math equals the JAX functions' exactly
(integers); the norms over a tree of gradients (a dict of lists of
tensors here, a pytree there) within 1e-6 relative (fp32 sums in a
different order, observed ~1e-7); the overflow check on finite, inf and
NaN trees; `call_to_str` to the character. The checker steps a primary
engine and its fp32 ZeRO-0 shadow on the same batches: an fp32 primary
with ZeRO-2 agrees, a bf16 primary diverges past a tight tolerance
(raised, or logged), a NaN trips it, and its report has the JAX
report's keys. `add_config_arguments` and `add_tuning_arguments` build
the JAX package's namespaces.
"""

import argparse
import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import utils as ju
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime import utils as tu
from deepspeed_tpu_torch.runtime.correctness import (ABCorrectnessChecker,
                                                     DivergenceError)
from deepspeed_tpu_torch.utils.logging import logger as port_logger
from torch_one_thread import one_torch_thread  # noqa: F401

NORM_TOL = 1e-6


@pytest.mark.parametrize("items,parts", [(10, 3), (48, 4), (7, 7), (3, 5),
                                         (100, 8)])
def test_partition_uniform_matches_jax(items, parts):
    assert tu.partition_uniform(items, parts) == \
        ju.partition_uniform(items, parts)


@pytest.mark.parametrize("seed,parts", [(0, 2), (1, 4), (2, 8), (3, 3)])
def test_partition_balanced_matches_jax(seed, parts):
    weights = list(np.random.RandomState(seed).randint(1, 100, 24))
    assert tu.partition_balanced(weights, parts) == \
        ju.partition_balanced(weights, parts)
    assert tu.prefix_sum_inc(weights) == ju.prefix_sum_inc(weights)
    assert tu.partition_balanced(weights[:2], 4) == \
        ju.partition_balanced(weights[:2], 4)


def _tree(seed, bad=None):
    r = np.random.RandomState(seed)
    arrays = {"a": r.randn(5, 7).astype(np.float32),
              "b": [r.randn(11).astype(np.float32),
                    r.randn(3, 2, 2).astype(np.float32)]}
    if bad is not None:
        arrays["b"][1][1, 0, 1] = bad
    port = {"a": torch.from_numpy(arrays["a"]),
            "b": [torch.from_numpy(x) for x in arrays["b"]]}
    ref = {"a": jnp.asarray(arrays["a"]),
           "b": [jnp.asarray(x) for x in arrays["b"]]}
    return port, ref


@pytest.mark.parametrize("norm_type", [2, float("inf")])
def test_norms_and_clipping_match_jax(norm_type):
    port, ref = _tree(0)
    got = tu.get_grad_norm(port, norm_type)
    want = ju.get_grad_norm(ref, norm_type)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=NORM_TOL)
    assert tu.get_weight_norm is tu.get_grad_norm
    np.testing.assert_allclose(float(tu.global_norm_squared(port)),
                               float(ju.global_norm_squared(ref)),
                               rtol=2 * NORM_TOL)
    clipped, norm = tu.clip_grad_norm_(port, 0.5, norm_type)
    jclipped, jnorm = ju.clip_grad_norm_(ref, 0.5, norm_type)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=NORM_TOL)
    np.testing.assert_allclose(clipped["a"].numpy(), jclipped["a"],
                               rtol=NORM_TOL, atol=1e-7)
    for x, y in zip(clipped["b"], jclipped["b"]):
        np.testing.assert_allclose(x.numpy(), y, rtol=NORM_TOL, atol=1e-7)
    # functional: the input tree keeps its values
    assert torch.equal(port["a"], _tree(0)[0]["a"])
    assert float(tu.get_grad_norm({})) == 0.0


@pytest.mark.parametrize("bad", [None, float("inf"), float("nan")],
                         ids=["finite", "inf", "nan"])
def test_check_overflow_matches_jax(bad):
    port, ref = _tree(1, bad)
    got = tu.CheckOverflow().has_overflow(port)
    assert got.dtype == torch.bool
    assert bool(got) == bool(ju.CheckOverflow().has_overflow(ref))
    assert bool(tu.CheckOverflow.check(port)) == (bad is not None)


def test_small_helpers_match_jax(tmp_path):
    for args, kwargs in [((), {}), ((1, "a"), {}), ((), {"k": 2}),
                         ((3,), {"x": None, "y": [1]})]:
        assert tu.call_to_str("f", *args, **kwargs) == \
            ju.call_to_str("f", *args, **kwargs)
    target = tmp_path / "a" / "b" / "file.txt"
    tu.ensure_directory_exists(str(target))
    assert os.path.isdir(tmp_path / "a" / "b")
    tu.ensure_directory_exists("bare_name")   # no directory part
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    port_logger.addHandler(handler)
    try:
        tu.see_memory_usage("quiet")           # not forced: nothing
        tu.memory_status("here")
    finally:
        port_logger.removeHandler(handler)
    assert len(lines) == 1 and lines[0].startswith("here |")
    stats = tu.device_memory_stats()
    assert set(stats) == {"in_use_bytes", "peak_bytes", "reserved_bytes",
                          "device_count"}


# ----------------------------------------------------------------------
# the A/B checker
# ----------------------------------------------------------------------
def _model():
    return tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=32),
                                 device="cpu")


def _batches(n, gas=1):
    r = np.random.RandomState(3)
    return [{"input_ids": r.randint(0, 256, (gas, 4, 32))} for _ in range(n)]


def _primary(**extra):
    d = {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 100,
         "zero_optimization": {"stage": 2},
         "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}}}
    d.update(extra)
    return d


def test_checker_agrees_on_an_fp32_primary():
    model = _model()
    checker = ABCorrectnessChecker(model, model.init(0), _primary(),
                                   interval=2, loss_atol=1e-6,
                                   param_rtol=1e-6)
    micro = [{"input_ids": b["input_ids"][0]} for b in _batches(4)]
    for i in range(4):
        if i % 2:
            checker.train_batch(data_iter=iter(micro[i:i + 1]))
        else:
            checker.train_batch(batch=_batches(4)[i])
    report = checker.report()
    assert report["steps"] == 4 and report["checks"] == 2
    assert report["max_loss_gap"] <= 1e-6
    assert report["max_param_rel_gap"] <= 1e-6
    assert checker.reference.zero_optimization_stage() == 0
    assert not checker.reference.bfloat16_enabled()
    # the JAX checker's report keys
    assert set(report) == {"steps", "checks", "max_loss_gap",
                           "max_param_rel_gap"}


def test_checker_detects_divergence():
    """A bf16 primary (bf16 parameters and moments, stochastic rounding)
    drifts from the fp32 shadow: past a 1e-6 tolerance it raises, or
    logs when told not to raise."""
    bf16 = _primary(bf16={"enabled": True, "master_weights": False})
    model = _model()
    checker = ABCorrectnessChecker(model, model.init(0), bf16, interval=1,
                                   loss_atol=1e-6)
    with pytest.raises(DivergenceError, match="A/B divergence at step 1"):
        checker.train_batch(batch=_batches(1)[0])
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    port_logger.addHandler(handler)
    model = _model()
    try:
        quiet = ABCorrectnessChecker(model, model.init(0), bf16,
                                     interval=1, loss_atol=1e-6,
                                     param_rtol=1e-9,
                                     raise_on_divergence=False)
        quiet.train_batch(batch=_batches(1)[0])
    finally:
        port_logger.removeHandler(handler)
    assert any("A/B divergence" in line for line in lines)
    assert any("param-norm divergence" in line for line in lines)
    assert quiet.max_loss_gap > 1e-6


def test_checker_trips_on_nan():
    model = _model()
    checker = ABCorrectnessChecker(model, model.init(0), _primary(),
                                   interval=1, loss_atol=10.0)
    checker.primary.state.params["wte"].data.fill_(float("nan"))
    with pytest.raises(DivergenceError, match="nan"):
        checker.train_batch(batch=_batches(1)[0])


# ----------------------------------------------------------------------
# command-line helpers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("argv", [[], ["--deepspeed", "--deepspeed_config",
                                       "ds.json", "--deepspeed_mpi"]])
def test_add_config_arguments_matches_jax(argv):
    mine = dst.add_config_arguments(argparse.ArgumentParser())
    ref = deepspeed_tpu.add_config_arguments(argparse.ArgumentParser())
    assert vars(mine.parse_args(argv)) == vars(ref.parse_args(argv))


@pytest.mark.parametrize("argv", [
    [], ["--lr_schedule", "WarmupLR", "--warmup_max_lr", "0.01"],
    ["--lr_schedule", "OneCycle", "--cycle_min_lr", "0.1"],
    ["--lr_schedule", "WarmupDecayLR", "--warmup_num_steps", "7"],
    ["--lr_schedule", "LRRangeTest"], ["--lr_schedule", "Nope"]])
def test_add_tuning_arguments_matches_jax(argv):
    mine = tlr.add_tuning_arguments(argparse.ArgumentParser()) \
        .parse_args(argv)
    ref = jlr.add_tuning_arguments(argparse.ArgumentParser()) \
        .parse_args(argv)
    assert vars(mine) == vars(ref)
    assert tlr.get_config_from_args(mine) == jlr.get_config_from_args(ref)
