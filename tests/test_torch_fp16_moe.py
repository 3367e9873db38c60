"""PyTorch port: the fp16 MoE path (kernel K8's and grouped K4's fp16
forms, the MoE GPT-2 and the engine in fp16) against the JAX package,
on the CPU.

The port's wrappers run their plain twins on the CPU; these tests hold
them in fp16 against the JAX package as its own tests run it (the
Pallas kernels in interpret mode, or its XLA route), on numpy-seeded
inputs:

* K8's twins through the autograd Functions (`fused_dispatch`,
  `fused_combine`) against the JAX functions' one VJP, fp16 rows; a
  combine whose fp32 sum passes 65504 is inf in both packages;
* grouped K4 (a bias [G, W], the experts' form) forward and backward in
  fp16 against the JAX kernel vmapped over the groups, as the JAX
  experts run it, with an inf in x and in the cotangent;
* a tiny MoE GPT-2 (4 layers, 2 MoE, 4 experts, top-2) in fp16, its
  parameters fp16 as the engine holds them: loss, router stats and
  every gradient against the JAX model, on both dispatch routes;
* `initialize` -> `train_batch` with the `moe` and `fp16` blocks for 8
  steps against the JAX engine, two batches of one repeated token
  overflowing: the overflow flags, scales, skipped steps and step
  counts equal, the losses close.

Tolerances. Dispatch copies rows: exact. A combine row is one rounding
of an fp32 sum of k products in each package: one fp16 ulp (2^-10
relative; 2^-24 absolute for subnormals); its VJP's dx and d_ye the
same, d_w (fp32 sums over H) 1e-5. Grouped K4: fp16 rows 2e-3 relative
L2 (two ulps, as tests/test_torch_fp16_kernels.py's), dbias 1e-4 (fp32
sums of the same terms, then one fp16 rounding). The model chains many
fp16 roundings in each package's own order: loss 5e-3 relative, stats
1e-3 (fp32 softmax of logits from fp16 hidden states), gradients 5e-3
relative L2 (the fp16 model-parity tolerance of test_torch_fp16_kernels;
the routing comes out equal, checked). The engine: loss within 2e-3
relative per step (test_torch_fp16_engine's), the scale automaton's
state exactly.
"""

import dataclasses
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
from deepspeed_tpu.moe import router as jrouter
from deepspeed_tpu.ops.transformer import fused_ops as jfo
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.moe import MoEConfig as TMoE
from deepspeed_tpu_torch.moe import MoEMLP
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo
from torch_one_thread import one_torch_thread  # noqa: F401

jfd = importlib.import_module("deepspeed_tpu.moe.fused_dispatch")
tfd = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")

F16_ULP = dict(atol=2 ** -24, rtol=2 ** -10)
ROW_TOL, VEC_TOL = 2e-3, 1e-4
LOSS_TOL, STATS_TOL, GRAD_TOL = 5e-3, 1e-3, 5e-3
ENGINE_LOSS_TOL = 2e-3
MOE = dict(num_experts=4, top_k=2, capacity_factor=1.0, every_n_layers=2)
SEQ = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_l2(got, ref):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    return float(np.linalg.norm(got - ref) /
                 max(np.linalg.norm(ref), 1e-30))


def _same_nonfinite(got, ref):
    g, r = ~np.isfinite(_np(got)), ~np.isfinite(_np(ref))
    return bool(r.any()) and np.array_equal(g, r)


def _routed(n, e, k, cf, h, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    cap = jrouter.router_capacity(n, e, k, cf)
    routing, _ = jrouter.top_k_gating_indexed(jnp.asarray(logits), k, cap)
    x, ye, dy, dxe = (rng.standard_normal(s).astype(np.float32)
                      for s in ((n, h), (e * cap, h), (n, h), (e * cap, h)))
    return routing, cap, x, ye, dy, dxe


# ----------------------------------------------------------------------
# K8
# ----------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["pallas-interpret", "xla"])
def test_fp16_fused_dispatch_combine_match_jax(impl):
    """fp16 rows through fused_dispatch and fused_combine and their
    VJPs, against the JAX functions (cf 0.5: drops; cf 1.25: empty
    slots, both in one case each of dispatch and combine)."""
    e, h, n, k = 4, 32, 64, 2
    use_pallas = impl != "xla"
    for cf in (0.5, 1.25):
        routing, cap, x, ye, dy, dxe = _routed(n, e, k, cf, h, 11)
        src, dest = jfd.routing_slots(routing, e, cap)
        keep, w = routing["keep"], routing["w"]

        def jfun(x, ye, w):
            xe = jfd.fused_dispatch(x, src, use_pallas=use_pallas,
                                    interpret=use_pallas)
            y = jfd.fused_combine(ye, dest, keep, w, use_pallas=use_pallas,
                                  interpret=use_pallas)
            return xe, y

        f16 = jnp.float16
        (j_xe, j_y), vjp = jax.vjp(jfun, jnp.asarray(x, f16),
                                   jnp.asarray(ye, f16), w)
        j_dx, j_dye, j_dw = vjp((jnp.asarray(dxe, f16),
                                 jnp.asarray(dy, f16)))
        t_routing = {kk: _t(v) for kk, v in routing.items()}
        t_src, t_dest = tfd.routing_slots(t_routing, e, cap)
        tx = _t(x).half().requires_grad_(True)
        tye = _t(ye).half().requires_grad_(True)
        tw = t_routing["w"].clone().requires_grad_(True)
        t_xe = tfd.fused_dispatch(tx, t_src, t_dest, t_routing["keep"])
        t_y = tfd.fused_combine(tye, t_dest, t_routing["keep"], tw)
        assert t_xe.dtype == t_y.dtype == torch.float16
        np.testing.assert_array_equal(_np(t_xe), _np(j_xe))
        np.testing.assert_allclose(_np(t_y), _np(j_y), **F16_ULP)
        t_dx, t_dye, t_dw = torch.autograd.grad(
            (t_xe, t_y), (tx, tye, tw),
            (_t(dxe).half(), _t(dy).half()))
        assert t_dx.dtype == t_dye.dtype == torch.float16
        np.testing.assert_allclose(_np(t_dx), _np(j_dx), **F16_ULP)
        np.testing.assert_allclose(_np(t_dye), _np(j_dye), **F16_ULP)
        np.testing.assert_allclose(_np(t_dw), _np(j_dw), atol=1e-5,
                                   rtol=1e-5)


def test_fp16_combine_past_65504_is_inf_like_jax():
    """Rows of 40000 summed over two kept slots pass fp16's range: the
    twin writes inf exactly where the JAX kernel (interpret mode) does,
    and a token whose slots were dropped stays finite."""
    e, h, n, k = 4, 16, 32, 2
    routing, cap, _, _, _, _ = _routed(n, e, k, 0.5, h, 12)
    src, dest = jfd.routing_slots(routing, e, cap)
    ye = np.full((e * cap, h), 40000.0, np.float32)
    ones = np.ones_like(np.asarray(routing["w"]))
    j_y = jfd.fused_combine(jnp.asarray(ye, jnp.float16), dest,
                            routing["keep"], jnp.asarray(ones),
                            use_pallas=True, interpret=True)
    t_routing = {kk: _t(v) for kk, v in routing.items()}
    _, t_dest = tfd.routing_slots(t_routing, e, cap)
    t_y = tfd.fused_combine(_t(ye).half(), t_dest, t_routing["keep"],
                            _t(ones))
    assert _same_nonfinite(t_y, j_y)
    assert np.isfinite(_np(t_y)).any()


# ----------------------------------------------------------------------
# grouped K4
# ----------------------------------------------------------------------
@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_fp16_grouped_gelu_matches_jax(approximate):
    """fused_bias_gelu with a bias [G, W] in fp16 (x, bias and the
    cotangent fp16, as the fp16 experts give them) against the JAX
    kernel vmapped over the groups (interpret mode): out, dx and the
    per-group dbias; then an inf in x and one in the cotangent."""
    g, c, w = 4, 12, 64
    r = np.random.RandomState(21 + approximate)
    x = (2.0 * r.randn(g, c, w)).astype(np.float32)
    bias = (0.1 * r.randn(g, w)).astype(np.float32)
    cot = r.randn(g, c, w).astype(np.float32)

    def jrun(x, b):
        return jax.vmap(lambda y, bb: jfo.fused_bias_gelu(
            y, bb, approximate=approximate, impl="interpret"))(x, b)

    def jgrad(x, b, cot):
        return jax.grad(lambda a, bb: jnp.sum(
            jrun(a, bb).astype(jnp.float32) * cot), argnums=(0, 1))(x, b)

    def tgrad(x, b, cot):
        tx = _t(x).half().requires_grad_(True)
        tb = _t(b).half().requires_grad_(True)
        out = tfo.fused_bias_gelu(tx, tb, approximate=approximate)
        return out, torch.autograd.grad((out.float() * _t(cot)).sum(),
                                        (tx, tb))

    jx, jb = jnp.asarray(x, jnp.float16), jnp.asarray(bias, jnp.float16)
    out, got = tgrad(x, bias, cot)
    ref = jgrad(jx, jb, cot)
    assert out.dtype == got[0].dtype == got[1].dtype == torch.float16
    assert _rel_l2(out, jrun(jx, jb)) <= ROW_TOL
    assert _rel_l2(got[0], ref[0]) <= ROW_TOL
    assert _rel_l2(got[1], ref[1]) <= max(ROW_TOL, VEC_TOL)
    x[2, 3, 7] = np.inf
    assert _same_nonfinite(
        tfo.fused_bias_gelu(_t(x).half(), _t(bias).half(),
                            approximate=approximate),
        jrun(jnp.asarray(x, jnp.float16), jb))
    cot[1, 5, 2] = np.inf
    ones = np.ones_like(x)
    _, got = tgrad(ones, bias, cot)
    ref = jgrad(jnp.asarray(ones, jnp.float16), jb, cot)
    assert _same_nonfinite(got[0], ref[0])
    assert _same_nonfinite(got[1], ref[1])
    assert np.isfinite(_np(got[1])[0]).all()     # other groups' dbias


# ----------------------------------------------------------------------
# the MoE GPT-2 and the engine in fp16
# ----------------------------------------------------------------------
def _jcfg(**over):
    base = dict(n_layer=4, n_positions=SEQ, dtype=jnp.float16,
                moe=JMoE(**MOE).validate())
    base.update(over)
    return jgpt2.tiny_gpt2_config(**base)


def _tcfg(**over):
    base = dict(n_layer=4, n_positions=SEQ, dtype=torch.float16,
                moe=TMoE(**MOE).validate())
    base.update(over)
    return tgpt2.tiny_gpt2_config(**base)


def _ids(rows, seed):
    return np.random.RandomState(seed).randint(0, 256, (rows, SEQ)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def jax_moe16():
    """The JAX fp16 MoE model's tree (fp32), and its loss, router stats,
    fp16 gradients and expert choices on fp16 parameters."""
    model = jgpt2.GPT2ForCausalLM(_jcfg())
    params = model.init(jax.random.PRNGKey(0), {"input_ids": _ids(4, 0)})
    tree = jax.tree_util.tree_map(np.asarray, params)
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float16),
                                 tree)
    ids = _ids(4, 1)
    (loss, stats), grads = jax.value_and_grad(
        lambda p: model.loss_fn(p, {"input_ids": ids}, deterministic=True,
                                return_router_stats=True),
        has_aux=True)(p16)
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    return dict(model=model, params=params, tree=tree, ids=ids,
                loss=float(loss), stats=np.asarray(stats, np.float32),
                grads=grads)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_fp16_moe_gpt2_loss_and_grads_match_jax(jax_moe16, fused):
    """The port's fp16 MoE GPT-2 on fp16 parameters (K8's twins with
    fused "on", the einsum pair with "off"; grouped K4's twin in the
    experts) against the JAX model: loss, stats and every gradient,
    each gradient fp16 like its parameter."""
    ref = jax_moe16
    model = tgpt2.GPT2ForCausalLM(_tcfg(moe=dataclasses.replace(
        TMoE(**MOE), fused_dispatch=fused)), device="cpu")
    p = {k: v.half().requires_grad_(True) for k, v in
         model.load_params(params_from_jax(ref["tree"])).items()}
    loss, stats = model.loss_fn(p, {"input_ids": ref["ids"]},
                                deterministic=True, return_router_stats=True)
    grads = torch.autograd.grad(loss, list(p.values()))
    assert abs(float(loss.detach()) - ref["loss"]) <= \
        LOSS_TOL * abs(ref["loss"])
    np.testing.assert_allclose(stats.detach().numpy(), ref["stats"],
                               atol=STATS_TOL, rtol=STATS_TOL)
    assert set(p) == set(ref["grads"])
    for name, g in zip(p, grads):
        assert g.dtype == torch.float16, name
        assert np.isfinite(_np(g)).all(), name
        assert _rel_l2(g, ref["grads"][name]) <= GRAD_TOL, name
    assert all(m.last_expert_idx is not None for m in model.module.modules()
               if isinstance(m, MoEMLP))


# the 8 steps: "u" a batch of one repeated token (it overflows at the
# scale it meets), "r" random tokens
STEP_KINDS = "uurrurrr"


def _engine_config():
    return {"train_batch_size": 8, "steps_per_print": 1000,
            "gradient_clipping": 1.0,
            "fp16": {"enabled": True, "initial_scale_power": 17,
                     "loss_scale_window": 2, "hysteresis": 2},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "moe": {"enabled": True, "num_experts": 4, "top_k": 2,
                    "capacity_factor": 1.0, "every_n_layers": 2}}


def test_fp16_moe_engine_matches_jax_engine(jax_moe16):
    """initialize -> train_batch with the moe and fp16 blocks in both
    engines (the port on K8's twins): per step the loss, the scale
    automaton's state, skipped_steps and the step count."""
    config = _engine_config()
    jengine = deepspeed_tpu.initialize(
        model=jax_moe16["model"], model_parameters=jax_moe16["params"],
        config=config)[0]
    model = tgpt2.GPT2ForCausalLM(_tcfg(moe=dataclasses.replace(
        TMoE(**MOE), fused_dispatch="on")), device="cpu")
    engine = dst.initialize(model=model,
                            model_parameters=params_from_jax(
                                jax_moe16["tree"]),
                            config=dict(config,
                                        train_micro_batch_size_per_gpu=8))[0]
    assert engine.fp16_enabled() and engine.module.config.moe is not None
    rng = np.random.RandomState(2)
    for i, kind in enumerate(STEP_KINDS):
        ids = np.zeros((1, 8, SEQ), np.int32) if kind == "u" else \
            rng.randint(0, 256, (1, 8, SEQ)).astype(np.int32)
        ref = float(jengine.train_batch(batch={"input_ids": ids}))
        got = float(engine.train_batch(batch={"input_ids": ids}))
        assert abs(got - ref) <= ENGINE_LOSS_TOL * abs(ref), (i, got, ref)
        jstate, state = jengine.state, engine.state
        assert float(state.scale.loss_scale) == \
            float(jstate.scale.loss_scale), i
        assert int(state.scale.hysteresis) == \
            int(jstate.scale.hysteresis), i
        assert engine.skipped_steps == jengine.skipped_steps, i
        assert int(state.global_steps) == int(jstate.global_steps), i
    assert 0 < engine.skipped_steps < len(STEP_KINDS)
