"""PyTorch port: the flops profiler against the JAX package's.

The JAX profiler reads XLA's cost analysis of a compiled program; the
port counts the run itself: aten ops under a dispatch mode, each
hand-written kernel by the cost function its wrapper records
(`kernel_call`). Held here:

  * the string helpers and `num_params` equal the JAX package's;
  * a matmul counts 2·M·N·K in both packages (exact);
  * the gpt2-tiny forward's matrix-product flops equal the count of the
    JAX program's `dot_general`s (walked through its jaxpr, a scan's
    body times its length) exactly: both are the integer 2·M·N·K of the
    same products. (The JAX cost analysis counts a scanned body once,
    and its per-fusion rows give dots no flops on this backend, so the
    jaxpr is the JAX program's count that can be read here);
  * each kernel wrapper records one row equal to its cost function on
    the twin route, and none of the twin's arithmetic;
  * an engine with the block on trains bit for bit as one without it
    (one torch thread) and logs one profile at `profile_step`, whose
    rows count the step: matrix products equal to the closed form of
    the fused chain under full remat, kernel calls equal to the step's
    launches;
  * the config block's fields and defaults equal the JAX package's.
"""

import logging
import math

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.profiling import config as jconfig
from deepspeed_tpu.profiling.flops_profiler import profiler as jprof
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.profiling import config as tconfig
from deepspeed_tpu_torch.profiling.flops_profiler import (FlopsProfiler,
                                                          get_model_profile)
from deepspeed_tpu_torch.profiling.flops_profiler import profiler as tprof
from torch_one_thread import one_torch_thread  # noqa: F401

MATMULS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
           "aten.matmul")


@pytest.mark.parametrize("num", [0, 0.5, 999.0, 1e3, 12345.678, 1e6,
                                 3.2e9, 7.7e12, 1e15])
@pytest.mark.parametrize("precision", [0, 2])
def test_string_helpers_equal_jax(num, precision):
    for name in ("_number_to_string", "flops_to_string",
                 "params_to_string"):
        assert getattr(tprof, name)(num, precision=precision) == \
            getattr(jprof, name)(num, precision=precision)
    assert tprof.flops_to_string(num, units="G") == \
        jprof.flops_to_string(num, units="G")
    for d in (num * 1e-9, num * 1e-5, num):
        assert tprof.duration_to_string(d, precision=precision) == \
            jprof.duration_to_string(d, precision=precision)


@pytest.fixture(scope="module")
def tiny():
    cfg = jgpt2.tiny_gpt2_config(n_positions=128)
    model = jgpt2.GPT2ForCausalLM(cfg)
    ids = np.random.RandomState(0).randint(0, 256, (2, 128)).astype(
        np.int32)
    params = model.init(jax.random.PRNGKey(0), {"input_ids": ids})
    return model, params, ids


def test_num_params_equals_jax(tiny):
    _, params, _ = tiny
    tree = jax.tree_util.tree_map(np.asarray, params)
    flat = params_from_jax(tree)
    assert tprof.num_params(flat) == jprof.num_params(params) > 0
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                  device="cpu")
    assert tprof.num_params(model.init(seed=0)) == jprof.num_params(params)
    lin = torch.nn.Linear(5, 3)
    assert tprof.num_params(lin) == 18


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (96, 40, 128)])
def test_matmul_flops_equal_jax(m, k, n):
    rng = np.random.RandomState(0)
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    got = tprof.cost_analysis_of(lambda x, y: x @ y, torch.as_tensor(a),
                                 torch.as_tensor(b))
    ref = jprof.cost_analysis_of(lambda x, y: x @ y, a, b)
    assert got["flops"] == ref["flops"] == 2 * m * n * k
    # the bytes: both operands read once, the product written once
    assert got["bytes accessed"] == 4 * (m * k + k * n + m * n)
    prof = FlopsProfiler()
    cost = prof.profile_jitted(lambda x, y: x @ y, torch.as_tensor(a),
                               torch.as_tensor(b))
    assert cost["flops"] == prof.get_total_flops() == 2 * m * n * k
    assert prof.get_total_duration() > 0


def _jax_dot_flops(fn, *args):
    """2·M·N·K summed over the dot_generals of fn's jaxpr, each nested
    body counted as many times as it runs (a scan: its length)."""
    def walk(jaxpr, mult):
        total = 0
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                (lc, _), _ = eqn.params["dimension_numbers"]
                lhs = eqn.invars[0].aval.shape
                total += 2 * math.prod(eqn.outvars[0].aval.shape) * \
                    math.prod(lhs[i] for i in lc) * mult
            m = mult * (eqn.params.get("length", 1)
                        if eqn.primitive.name == "scan" else 1)
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        total += walk(sub.jaxpr, m)
                    elif type(sub).__name__ == "Jaxpr":
                        total += walk(sub, m)
        return total
    return walk(jax.make_jaxpr(fn)(*args).jaxpr, 1)


def test_gpt2_tiny_forward_matmul_flops_equal_jax_dots(tiny):
    model, params, ids = tiny
    ref = _jax_dot_flops(lambda p, i: model.apply(p, i), params, ids)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tmodel = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                   device="cpu")
    with torch.no_grad():
        _, ops = tprof.record_ops(tmodel.apply, params_from_jax(tree),
                                  torch.as_tensor(ids))
    rows = tprof.per_fusion_costs_from_ops(ops)
    got = sum(r["flops"] for r in rows if r["name"] in MATMULS)
    # exact: the same products' 2·M·N·K (the CPU forward takes the
    # unfused attention, two bmm a layer, as the JAX program's einsums)
    assert got == ref == 75_497_472
    assert sum(r["flops"] for r in rows) == got
    for r in rows:
        assert set(r) == {"name", "op", "kind", "kernel", "flops", "bytes",
                          "transcendentals", "calls", "est_us", "time_pct"}
    assert abs(sum(r["time_pct"] for r in rows) - 100.0) < 0.1
    sinks = tprof._compact(rows, 3)
    assert [set(s) for s in sinks] == [{"op", "kind", "est_us", "time_pct",
                                        "flops", "bytes", "calls"}] * 3


# ----------------------------------------------------------------------
# the kernels' own rows, on the twin route
# ----------------------------------------------------------------------
def _kernel_cases():
    import importlib
    # the packages export functions under some of these modules' names
    fa = importlib.import_module(
        "deepspeed_tpu_torch.ops.transformer.flash_attention")
    fo = importlib.import_module(
        "deepspeed_tpu_torch.ops.transformer.fused_ops")
    qm = importlib.import_module(
        "deepspeed_tpu_torch.ops.transformer.quantized_matmul")
    fdm = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")
    g = torch.Generator().manual_seed(3)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    b, t, h, d = 1, 128, 2, 64
    q, k, v = rn(b, t, h, d), rn(b, t, h, d), rn(b, t, h, d)
    out, lse = fa._flash_forward(q, k, v, 0.125, True)
    n, hh, w = 48, 64, 256
    y, res = rn(n, hh), rn(n, hh)
    vec = [rn(hh), rn(hh) + 1, rn(hh)]
    s = rn(n, hh)
    x = rn(n, w)
    xq = torch.randint(-127, 128, (1, 8, 128), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (1, 128, 32), generator=g).to(torch.int8)
    sx, sw = rn(1, 8, 1).abs(), rn(1, 1, 32).abs()
    # 6 tokens into 8 slots (6: an empty slot), 3 tokens' top-2 slots
    tok, ye = rn(6, 16), rn(8, 16)
    src = torch.tensor([0, 3, 1, 6, 2, 5, 6, 4], dtype=torch.int32)
    dest = torch.tensor([[0, 2], [1, 7], [3, 4]], dtype=torch.int32)
    cw = rn(3, 2).abs()
    gb = rn(w)
    return {
        "K1-fwd": (lambda: fa._flash_forward(q, k, v, 0.125, True),
                   lambda: fa.flash_fwd_cost(q, True)),
        "K5": (lambda: fa._merge_forward(q, k, v, out.float(), lse, 0.125,
                                         True),
               lambda: fa.merge_cost(q, True)),
        "K2": (lambda: fa.flash_attention_backward(q, k, v, out, lse, q,
                                                   causal=True),
               lambda: fa.flash_bwd_cost(q, True)),
        "K3-fwd": (lambda: fo._ln_forward(y, vec[0], res, vec[1], vec[2],
                                          1e-5, torch.float32,
                                          torch.float32, True),
                   lambda: fo.ln_fwd_cost(y, res, vec, torch.float32,
                                          torch.float32, True)),
        "K3-bwd": (lambda: fo.fused_bias_residual_layernorm_backward(
            s, vec[1], y, res),
            lambda: fo.ln_bwd_cost(s, vec[1], y, res, torch.float32)),
        "K4-fwd": (lambda: fo._gelu_forward(x, gb, True, torch.float32),
                   lambda: fo.gelu_fwd_cost(x, gb, torch.float32)),
        "K4-bwd": (lambda: fo.fused_bias_gelu_backward(x, x,
                                                       approximate=True),
                   lambda: fo.gelu_bwd_cost(x, x, torch.float32, None)),
        "K6": (lambda: qm._qmm(xq, wq, sx, sw, 128, torch.float32),
               lambda: qm.qmm_cost(xq, wq, sw, torch.float32)),
        "K8-dispatch": (lambda: fdm.gather_rows(tok, src),
                        lambda: fdm.gather_cost(tok, src, None)),
        "K8-combine": (lambda: fdm.combine_rows(ye, dest, cw),
                       lambda: fdm.combine_cost(ye, dest)),
    }


_CASES = ("K1-fwd", "K5", "K2", "K3-fwd", "K3-bwd", "K4-fwd", "K4-bwd",
          "K6", "K8-dispatch", "K8-combine")


@pytest.mark.parametrize("name", _CASES)
def test_kernel_row_equals_its_cost_on_the_twin_route(name):
    """One kernel row, equal to the wrapper's cost function, and no aten
    row: the twin's arithmetic is the kernel's, not rows of its own."""
    run, cost = _kernel_cases()[name]
    _, ops = tprof.record_ops(run)
    rows = tprof.per_fusion_costs_from_ops(ops)
    assert [r["name"] for r in rows] == [name]
    flops, nbytes, trans = cost()
    (row,) = rows
    assert (row["flops"], row["bytes"], row["transcendentals"],
            row["calls"], row["kind"]) == \
        (int(flops), int(nbytes), int(trans), 1, tprof.KIND_KERNEL)
    assert flops > 0 or name == "K8-dispatch"
    assert nbytes > 0
    # and outside a profile nothing records
    run()
    assert not tprof._recorders


def test_block_sparse_rows_count_visible_scores():
    """K7: the forward (band or table walk) and the backward's two
    sweeps, each counted over the layout's visible scores."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BSLongformerSparsityConfig, SparseSelfAttention)
    import importlib
    bsa = importlib.import_module(
        "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")
    attn = SparseSelfAttention(BSLongformerSparsityConfig(
        num_heads=2, block=16, num_sliding_window_blocks=3))
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, 128, 2, 64, generator=g, requires_grad=True)
    _, ops = tprof.record_ops(
        lambda: attn(q, q, q, causal=True).sum().backward())
    rows = {r["name"]: r for r in tprof.per_fusion_costs_from_ops(ops)
            if r["kind"] == tprof.KIND_KERNEL}
    assert set(rows) == {"K7-band", "K7-dkv", "K7-dq"}
    layout = attn.sparsity_config.make_layout(128)
    vis = bsa.visible_scores(layout, 16, True)
    assert rows["K7-band"]["transcendentals"] == vis
    assert rows["K7-band"]["flops"] == 4 * 64 * vis
    assert rows["K7-dkv"]["flops"] == 8 * 64 * vis
    assert rows["K7-dq"]["flops"] == 6 * 64 * vis


def test_device_peak_specs():
    assert tprof.device_peak_specs("NVIDIA H100 80GB HBM3") == \
        (989e12, 3350.0)
    assert tprof.device_peak_specs(torch.device("cpu")) == (100e12, 800.0)
    assert tprof.device_peak_specs() == (100e12, 800.0)   # no card here


def test_get_model_profile_module_and_default_device():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(),
                              torch.nn.Linear(64, 16))
    flops, macs, params = get_model_profile(
        model=net, input_shape=(4, 32), print_profile=False,
        as_string=False)
    assert params == 32 * 64 + 64 + 64 * 16 + 16
    assert flops == 2 * 4 * (32 * 64 + 64 * 16) and macs == flops / 2
    text = get_model_profile(model=net, input_shape=(4, 32),
                             print_profile=False)
    assert text[0].endswith("FLOPS") and text[1].endswith("MACs")
    # a module with no parameters makes its input on the card, which
    # this machine does not have: the port's error, no silent CPU
    with pytest.raises(RuntimeError, match="cuda"):
        get_model_profile(model=torch.nn.ReLU(), input_shape=(2, 2),
                          print_profile=False)


# ----------------------------------------------------------------------
# the engine's profile step
# ----------------------------------------------------------------------
class _Lines(logging.Handler):
    """The port's logger does not propagate (caplog misses it)."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


L, H, V, T, B = 2, 128, 256, 128, 2


def _engine_run(profile, steps=3):
    cfg = tgpt2.tiny_gpt2_config(n_positions=T, n_embd=H, n_head=2,
                                 remat=True, attention_impl="pallas",
                                 fused_ops="on")
    model = tgpt2.GPT2ForCausalLM(cfg, device="cpu")
    conf = {"train_micro_batch_size_per_gpu": B, "steps_per_print": 1000,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 3e-3, "weight_decay": 0.01}}}
    if profile:
        conf["flops_profiler"] = {"enabled": True, "profile_step": 2}
    engine, _, _, _ = dst.initialize(model=model,
                                     model_parameters=model.init(seed=0),
                                     config=conf)
    rng = np.random.RandomState(0)
    losses = [engine.train_batch(batch={"input_ids": rng.randint(
        0, V, (1, B, T)).astype(np.int32)}) for _ in range(steps)]
    return losses, engine


def test_engine_profile_step_bit_identical_and_counts():
    """Bit for bit with the block off (one thread: the CPU's embedding
    backward adds rows in thread order); one profile at step 2 counting
    the whole step on the fused chain under full remat:
      matrix products = tokens · (88·L·H² + 8·V·H): each block's 12·H²
      of projections forward (2x), backward (4x) and recomputed (2x,
      but the block's last projection, whose output no backward needs,
      is not: torch's non-reentrant checkpoint stops once the saved
      tensors are back: -8·H²), the tied head's 2·V·H forward,
      recompute (the chunked loss is checkpointed) and 4·V·H backward;
      kernel calls = the step's launches (per layer K1-fwd 2, K2 1,
      K3-fwd 4 (+1 ln_f), K3-bwd 2 (+1), K4-fwd 2, K4-bwd 1)."""
    off, _ = _engine_run(False)
    handler = _Lines()
    tprof.logger.addHandler(handler)
    try:
        on, engine = _engine_run(True)
    finally:
        tprof.logger.removeHandler(handler)
    assert [x.item() for x in on] == [x.item() for x in off]
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    profiles = [m for m in handler.lines if "DeepSpeed Flops Profiler" in m]
    assert len(profiles) == 1 and "Profile at step 2" in profiles[0]
    prof = engine.last_flops_profile
    rows = {r["name"]: r for r in prof.rows}
    tokens = B * T
    mm = sum(r["flops"] for r in prof.rows if r["name"] in MATMULS)
    assert mm == tokens * (88 * L * H * H + 8 * V * H)
    calls = {n: r["calls"] for n, r in rows.items()
             if r["kind"] == tprof.KIND_KERNEL}
    assert calls == {"K1-fwd": 2 * L, "K2": L, "K3-fwd": 4 * L + 1,
                     "K3-bwd": 2 * L + 1, "K4-fwd": 2 * L, "K4-bwd": L}
    import importlib
    fa = importlib.import_module(
        "deepspeed_tpu_torch.ops.transformer.flash_attention")
    q = torch.empty(B, T, 2, H // 2)
    assert rows["K1-fwd"]["flops"] == 2 * L * fa.flash_fwd_cost(q, True)[0]
    assert rows["K2"]["flops"] == L * fa.flash_bwd_cost(q, True)[0]
    assert prof.total_flops == sum(r["flops"] for r in prof.rows)
    assert prof.total_params == tprof.num_params(engine.state.params)


def test_failing_profile_logs_and_training_goes_on(monkeypatch):
    handler = _Lines()
    tprof.logger.addHandler(handler)

    def broken(self, *a, **k):
        raise RuntimeError("report broke")
    monkeypatch.setattr(FlopsProfiler, "print_model_profile", broken)
    try:
        losses, engine = _engine_run(True)
    finally:
        tprof.logger.removeHandler(handler)
    assert len(losses) == 3 and engine.global_steps == 3
    assert any("flops profile failed" in m for m in handler.lines)
    assert not tprof._recorders


@pytest.mark.parametrize("block", [
    {}, {"flops_profiler": {}},
    {"flops_profiler": {"enabled": True}},
    {"flops_profiler": {"enabled": True, "profile_step": 5,
                        "module_depth": 2, "top_modules": 7,
                        "detailed": False}},
])
def test_config_fields_equal_jax(block):
    got = tconfig.DeepSpeedFlopsProfilerConfig(block)
    ref = jconfig.DeepSpeedFlopsProfilerConfig(block)
    assert vars(got) == vars(ref)
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    base = {"train_batch_size": 8, **block}
    assert vars(DeepSpeedConfig(base).flops_profiler_config) == \
        vars(JConfig(base).flops_profiler_config)
