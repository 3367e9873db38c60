"""PyTorch port: fp16 quantized compute (kernel K6 with an fp16 output,
the straight-through `quantized_dense`, the quantized GPT-2, quantized
experts and the engine with the `quantized_compute` block in fp16)
against the JAX package, on the CPU.

The port's K6 wrapper runs its plain twin on the CPU; the JAX side runs
as its own CPU tests run it: the Pallas kernel in interpret mode, or
its XLA fallback. Inputs come from numpy seeds. Reach the JAX module
with importlib (`deepspeed_tpu.ops.transformer` exports a function
named `quantized_matmul` that shadows the module).

Tolerances, each with its reason:
  * the quantizers on fp16 input: bit for bit (fp16 -> fp32 is exact,
    then the same fp32 divisions and half-to-even rounding).
  * K6's twin with an fp16 output: the fp32 result (its sums in another
    order than the interpret kernel's, or the XLA fallback's one fp32
    GEMM: 2e-6 of max|out|, test_torch_quantized_matmul's twin bound)
    rounded once to fp16 (one ulp, 2^-10 relative); an output past
    65504 is inf exactly where JAX's is.
  * quantized_dense in fp16: the forward one fp16 ulp; dx is an fp16
    GEMM in each package's own order and dW an fp32 GEMM of the same
    products rounded once to fp16: 2e-3 relative L2 (two ulps).
  * model level (the tiny GPT-2, the engine): int8 rounding is
    discontinuous, and the fp16 activations of the two packages differ
    by roundoff before each quantizer, so a few entries flip to the
    neighbouring int8 value (tests/test_torch_quantized_matmul.py sets
    out the same in fp32): loss within 5e-3 relative, gradients within
    2e-2 relative L2, the engine's losses within 5e-3 relative per step
    with the scale automaton's state equal.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.moe import MoEConfig as JMoE
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.moe import MoEConfig as TMoE
from deepspeed_tpu_torch.ops.transformer.transformer import QuantizedDense
from torch_one_thread import one_torch_thread  # noqa: F401

jqm = importlib.import_module(
    "deepspeed_tpu.ops.transformer.quantized_matmul")
tqm = importlib.import_module(
    "deepspeed_tpu_torch.ops.transformer.quantized_matmul")

F16_ULP = dict(atol=2 ** -24, rtol=2 ** -10)
TWIN_TOL = 2e-6       # of max|out|: fp32 summation order
STE_TOL = 2e-3
LOSS_TOL, GRAD_TOL = 5e-3, 2e-2
ENGINE_LOSS_TOL = 5e-3
SEQ = 64


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    a, b = _f(a).astype(np.float64), _f(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_fp16_quantizers_match_jax():
    """Rows and (K-block, column) weights quantized from fp16 values, as
    the fp16 path hands them over: the same int8 values and scales."""
    x = _np((37, 1600), 1, scale=3.0)
    x[5] = 0.0
    w = _np((1600, 72), 2, scale=0.05)
    jq, js = jqm.quantize_rows_int8(jnp.asarray(x, jnp.float16))
    tq, ts = tqm.quantize_rows_int8(_t(x).half())
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    jq, js = jqm.quantize_kernel_int8(jnp.asarray(w, jnp.float16), 128)
    tq, ts = tqm.quantize_kernel_int8(_t(w).half(), 128)
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("m,k,n", [(300, 1600, 520), (5, 256, 40)])
def test_fp16_out_twin_matches_jax_kernel(m, k, n):
    """K6's twin with an fp16 output against the JAX kernel in interpret
    mode (and its XLA fallback) on fp16 activations; then scaled past
    65504: inf exactly where JAX's output is inf."""
    x = _np((m, k), 2, scale=3.0)
    w = _np((k, n), 3, scale=0.05)
    wq, sw = jqm.quantize_kernel_int8(jnp.asarray(w), 128)
    x16 = jnp.asarray(x, jnp.float16)
    ref_i = jqm.quantized_matmul(x16, wq, sw, block=128,
                                 out_dtype=jnp.float16, impl="interpret",
                                 block_m=128, block_n=128)
    ref_x = jqm.quantized_matmul(x16, wq.astype(jnp.float32), sw, block=128,
                                 out_dtype=jnp.float16, impl="xla")
    tqm.reset_launch_count()
    got = tqm.quantized_matmul(_t(x).half(), _t(wq), _t(sw), block=128)
    assert got.dtype == torch.float16
    assert tqm.quantized_matmul.launches == 0      # the twin, on the CPU
    for ref in (ref_i, ref_x):
        np.testing.assert_allclose(
            _f(got), _f(ref), rtol=2 ** -10,
            atol=TWIN_TOL * float(np.abs(_f(ref)).max()))
    sw_big = np.asarray(sw) * 4e4
    ref_i = jqm.quantized_matmul(x16, wq, jnp.asarray(sw_big), block=128,
                                 out_dtype=jnp.float16, impl="interpret",
                                 block_m=128, block_n=128)
    got = tqm.quantized_matmul(_t(x).half(), _t(wq), _t(sw_big), block=128)
    mask_j, mask_t = ~np.isfinite(_f(ref_i)), ~np.isfinite(_f(got))
    assert mask_j.any() and (~mask_j).any()
    assert np.array_equal(mask_t, mask_j)


@pytest.mark.parametrize("grouped", [False, True])
def test_fp16_ste_gradients_match_jax(grouped):
    """quantized_dense on fp16 x and W (grouped: the experts' form)
    against the JAX function's VJP: y, dx and dW, each fp16."""
    shape_x, shape_w = ((2, 6, 200), (200, 32)) if not grouped else \
        ((3, 6, 200), (3, 200, 32))
    x, w = _np(shape_x, 6), _np(shape_w, 7, scale=0.1)
    dy = _np(shape_x[:-1] + (32,), 8)

    def jf(x, w):
        if grouped:
            return jax.vmap(lambda a, b: jqm.quantized_dense(
                a, b, block=128, impl="xla"))(x, w)
        return jqm.quantized_dense(x, w, block=128, impl="xla")

    f16 = jnp.float16
    ref, vjp = jax.vjp(jf, jnp.asarray(x, f16), jnp.asarray(w, f16))
    jdx, jdw = vjp(jnp.asarray(dy, f16))
    tx = _t(x).half().requires_grad_(True)
    tw = _t(w).half().requires_grad_(True)
    y = tqm.quantized_dense(tx, tw, block=128)
    assert y.dtype == torch.float16
    np.testing.assert_allclose(_f(y), _f(ref), **F16_ULP)
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(dy).half())
    assert dx.dtype == dw.dtype == torch.float16
    assert _rel(dx, jdx) <= STE_TOL
    assert _rel(dw, jdw) <= STE_TOL


# ----------------------------------------------------------------------
# the quantized GPT-2 and the engine in fp16
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_tree():
    cfg = jgpt2.tiny_gpt2_config(n_positions=SEQ, dtype=jnp.float16)
    model = jgpt2.GPT2ForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def test_fp16_quantized_gpt2_loss_and_grads_match_jax(jax_tree):
    """The tiny GPT-2 with quantized_compute "on" in fp16, its
    parameters fp16 as the engine holds them: the loss and every fp16
    gradient against the JAX model's (fused ops on: the port's K1-K4
    twins, JAX's XLA forms)."""
    _, _, tree = jax_tree
    ids = _ids(1, (2, SEQ))
    jmodel = jgpt2.GPT2ForCausalLM(jgpt2.tiny_gpt2_config(
        n_positions=SEQ, dtype=jnp.float16, fused_ops="on",
        quantized_compute="on"))
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float16), tree)
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {"input_ids": ids},
                                 deterministic=True))(p16)
    ref_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(
        n_positions=SEQ, dtype=torch.float16, fused_ops="on",
        quantized_compute="on"), device="cpu")
    assert isinstance(model.module.h[0].c_attn, QuantizedDense)
    params = {k: v.half().requires_grad_(True)
              for k, v in params_from_jax(tree).items()}
    got = model.loss_fn(params, {"input_ids": ids}, deterministic=True)
    grads = torch.autograd.grad(got, list(params.values()))
    assert abs(float(got.detach()) - float(loss)) <= \
        LOSS_TOL * abs(float(loss))
    for name, g in zip(params, grads):
        assert g.dtype == torch.float16, name
        assert _rel(g, ref_grads[name]) <= GRAD_TOL, name


def _engine_config(**extra):
    return dict({"train_batch_size": 8, "steps_per_print": 1000,
                 "fp16": {"enabled": True, "initial_scale_power": 17,
                          "loss_scale_window": 2, "hysteresis": 2},
                 "optimizer": {"type": "AdamW",
                               "params": {"lr": 3e-3,
                                          "weight_decay": 0.01}},
                 "quantized_compute": {"enabled": True, "mode": "on"}},
                **extra)


def _run_both(jengine, engine, kinds, seq, seed):
    """Step both engines on the same batches ("u" one repeated token,
    "r" random): per step the losses within ENGINE_LOSS_TOL and the
    scale automaton's state, skipped_steps and the step count equal."""
    rng = np.random.RandomState(seed)
    for i, kind in enumerate(kinds):
        ids = np.zeros((1, 8, seq), np.int32) if kind == "u" else \
            rng.randint(0, 256, (1, 8, seq)).astype(np.int32)
        ref = float(jengine.train_batch(batch={"input_ids": ids}))
        got = float(engine.train_batch(batch={"input_ids": ids}))
        assert abs(got - ref) <= ENGINE_LOSS_TOL * abs(ref), (i, got, ref)
        assert float(engine.state.scale.loss_scale) == \
            float(jengine.state.scale.loss_scale), i
        assert int(engine.state.scale.hysteresis) == \
            int(jengine.state.scale.hysteresis), i
        assert engine.skipped_steps == jengine.skipped_steps, i
        assert int(engine.state.global_steps) == \
            int(jengine.state.global_steps), i
    assert 0 < engine.skipped_steps < len(kinds)


def test_fp16_quantized_engine_matches_jax_engine(jax_tree):
    """initialize -> train_batch with the quantized_compute block (mode
    "on": K6's twin on the CPU) and fp16 in both engines, 8 steps."""
    jmodel, jparams, tree = jax_tree
    config = _engine_config()
    jengine = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                       config=config)[0]
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(
        n_positions=SEQ, dtype=torch.float16), device="cpu")
    engine = dst.initialize(model=model,
                            model_parameters=params_from_jax(tree),
                            config=dict(config,
                                        train_micro_batch_size_per_gpu=8))[0]
    assert engine.fp16_enabled()
    assert isinstance(model.module.h[0].mlp_c_proj, QuantizedDense)
    _run_both(jengine, engine, "urrurrrr", SEQ, 3)


def test_fp16_quantized_moe_engine_matches_jax_engine():
    """fp16 with the moe block, quantized experts and the
    quantized_compute block (path E's form) in both engines, 6 steps:
    a tiny MoE GPT-2 (4 layers, 2 MoE, 4 experts, top-2)."""
    seq = 32
    moe = dict(num_experts=4, top_k=2, capacity_factor=1.0, every_n_layers=2,
               quantized_experts="on")
    jmodel = jgpt2.GPT2ForCausalLM(jgpt2.tiny_gpt2_config(
        n_layer=4, n_positions=seq, dtype=jnp.float16,
        moe=JMoE(**moe).validate()))
    params = jmodel.init(jax.random.PRNGKey(1),
                         {"input_ids": np.zeros((1, 8), np.int32)})
    tree = jax.tree_util.tree_map(np.asarray, params)
    config = _engine_config(moe={"enabled": True, "num_experts": 4,
                                 "top_k": 2, "capacity_factor": 1.0,
                                 "every_n_layers": 2})
    jengine = deepspeed_tpu.initialize(model=jmodel, model_parameters=params,
                                       config=config)[0]
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(
        n_layer=4, n_positions=seq, dtype=torch.float16,
        moe=TMoE(**moe, fused_dispatch="on").validate()), device="cpu")
    engine = dst.initialize(model=model,
                            model_parameters=params_from_jax(tree),
                            config=dict(config,
                                        train_micro_batch_size_per_gpu=8))[0]
    assert engine.module.config.moe.quantized_experts == "on"
    _run_both(jengine, engine, "urrurr", seq, 4)
