"""PyTorch port: the mixture-of-experts modules against the JAX package.

The router (`top_k_gating`, `top_k_gating_indexed`, `router_capacity`),
the fused dispatch/combine (kernel K8's plain twins and their autograd
Functions) against the JAX functions run both through the Pallas kernels
in interpret mode and through the XLA fallback, the grouped-GEMM
experts, `MoEMLP` on both dispatch routes, and the `moe` config block.
Inputs are made with numpy from fixed seeds and handed to both packages.

Tolerances: routing (expert choice, slot, keep) exactly equal; fp32
values to reduction-order roundoff, 1e-6 absolute or relative as stated
per check (observed <= 3e-7); gradients of the MoE layer within 1e-5
relative L2 (fp32, sums in another order).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.moe import experts as jex
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import router as jrouter
from deepspeed_tpu.moe.dispatch import \
    dispatch_buffer_nbytes as j_dispatch_nbytes
from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JErr
from deepspeed_tpu.runtime.config import get_moe_config as j_get_moe_config
from deepspeed_tpu_torch.moe import dispatch as tdispatch
from deepspeed_tpu_torch.moe import experts as tex
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import router as trouter
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError as TErr
from deepspeed_tpu_torch.runtime.config import get_moe_config as t_get_moe_config
from torch_one_thread import one_torch_thread  # noqa: F401

# the packages re-export the function fused_dispatch under the
# submodule's name, so the modules come from importlib
jfd = importlib.import_module("deepspeed_tpu.moe.fused_dispatch")
tfd = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")

F32 = dict(atol=1e-6, rtol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _logits(n, e, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # few distinct values per row: exact ties in the top-k
        return rng.integers(0, 3, (n, e)).astype(np.float32)
    return rng.standard_normal((n, e)).astype(np.float32)


# ----------------------------------------------------------------------
# router
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,e,k,cf,ties", [
    (64, 4, 1, 1.25, False),
    (64, 4, 2, 1.25, False),
    (64, 4, 2, 0.5, False),       # capacity overflow: drops
    (64, 4, 3, 1.0, False),
    (64, 4, 2, 1.25, True),       # exact ties break to the lower index
    (64, 4, 3, 0.75, True),
])
def test_router_matches_jax(n, e, k, cf, ties):
    logits = _logits(n, e, n + k, ties)
    cap = jrouter.router_capacity(n, e, k, cf)
    assert trouter.router_capacity(n, e, k, cf) == cap
    j_routing, j_stats = jrouter.top_k_gating_indexed(jnp.asarray(logits),
                                                      k, cap)
    t_routing, t_stats = trouter.top_k_gating_indexed(_t(logits), k, cap)
    for key in ("e_idx", "slot", "keep"):
        np.testing.assert_array_equal(t_routing[key].numpy(),
                                      np.asarray(j_routing[key]), key)
    np.testing.assert_allclose(t_routing["w"].numpy(), j_routing["w"], **F32)
    np.testing.assert_allclose(t_stats.numpy(), j_stats, **F32)
    jd, jc, js = jrouter.top_k_gating(jnp.asarray(logits), k, cap)
    td, tc, ts = trouter.top_k_gating(_t(logits), k, cap)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, **F32)
    np.testing.assert_allclose(ts.numpy(), js, **F32)
    if cf < 1 and not ties:
        assert float(t_stats[trouter.STAT_DROP]) > 0


def test_router_aux_gradient_matches_jax():
    """The aux entry is differentiable through the probabilities only
    (f_e from first choices carries no gradient)."""
    logits = _logits(64, 4, 5)
    cap = jrouter.router_capacity(64, 4, 2, 1.25)
    ref = jax.grad(lambda x: jrouter.top_k_gating_indexed(
        x, 2, cap)[1][jrouter.STAT_AUX])(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    _, stats = trouter.top_k_gating_indexed(x, 2, cap)
    (got,) = torch.autograd.grad(stats[trouter.STAT_AUX], x)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_router_jitter_draws_from_the_generator():
    logits = _t(_logits(256, 4, 6))
    cap = trouter.router_capacity(256, 4, 2, 2.0)
    plain, _ = trouter.top_k_gating_indexed(logits, 2, cap)

    def jittered(seed):
        gen = torch.Generator().manual_seed(seed)
        return trouter.top_k_gating_indexed(logits, 2, cap, gen=gen,
                                            jitter_eps=0.5)[0]["e_idx"]
    assert torch.equal(jittered(1), jittered(1))
    assert not torch.equal(jittered(1), plain["e_idx"])
    no_eps = trouter.top_k_gating_indexed(
        logits, 2, cap, gen=torch.Generator().manual_seed(1))[0]
    assert torch.equal(no_eps["e_idx"], plain["e_idx"])


# ----------------------------------------------------------------------
# fused dispatch and combine (K8's twins and autograd)
# ----------------------------------------------------------------------
def _routed(n, e, k, cf, h, seed):
    logits = _logits(n, e, seed)
    cap = jrouter.router_capacity(n, e, k, cf)
    routing, _ = jrouter.top_k_gating_indexed(jnp.asarray(logits), k, cap)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, h)).astype(np.float32)
    ye = rng.standard_normal((e * cap, h)).astype(np.float32)
    dy = rng.standard_normal((n, h)).astype(np.float32)
    dxe = rng.standard_normal((e * cap, h)).astype(np.float32)
    return routing, cap, x, ye, dy, dxe


@pytest.mark.parametrize("impl", ["pallas-interpret", "xla"])
@pytest.mark.parametrize("n,k,cf", [(64, 2, 1.25), (64, 2, 0.5),
                                    (64, 1, 1.0)])
def test_fused_dispatch_combine_match_jax(impl, n, k, cf):
    """Forward and backward of fused_dispatch and fused_combine against
    the JAX functions (one VJP; Pallas in interpret mode or XLA), on the
    same routing: dispatch rows exactly, combine and every cotangent
    within 1e-6."""
    e, h = 4, 32
    use_pallas = impl != "xla"
    routing, cap, x, ye, dy, dxe = _routed(n, e, k, cf, h, n + k)
    src, dest = jfd.routing_slots(routing, e, cap)
    keep, w = routing["keep"], routing["w"]

    def jfun(x, ye, w):
        xe = jfd.fused_dispatch(x, src, use_pallas=use_pallas,
                                interpret=use_pallas)
        y = jfd.fused_combine(ye, dest, keep, w, use_pallas=use_pallas,
                              interpret=use_pallas)
        return xe, y

    (j_xe, j_y), vjp = jax.vjp(jfun, jnp.asarray(x), jnp.asarray(ye), w)
    j_dx, j_dye, j_dw = vjp((jnp.asarray(dxe), jnp.asarray(dy)))

    t_routing = {kk: _t(v) for kk, v in routing.items()}
    t_src, t_dest = tfd.routing_slots(t_routing, e, cap)
    np.testing.assert_array_equal(t_src.numpy(), src)
    np.testing.assert_array_equal(t_dest.numpy(), dest)
    tx = _t(x).requires_grad_(True)
    tye = _t(ye).requires_grad_(True)
    tw = t_routing["w"].clone().requires_grad_(True)
    t_xe = tfd.fused_dispatch(tx, t_src, t_dest, t_routing["keep"])
    t_y = tfd.fused_combine(tye, t_dest, t_routing["keep"], tw)
    np.testing.assert_array_equal(t_xe.detach().numpy(), j_xe)
    np.testing.assert_allclose(t_y.detach().numpy(), j_y, **F32)
    t_dx, t_dye, t_dw = torch.autograd.grad(
        (t_xe, t_y), (tx, tye, tw), (_t(dxe), _t(dy)))
    np.testing.assert_allclose(t_dx.numpy(), j_dx, **F32)
    np.testing.assert_allclose(t_dye.numpy(), j_dye, **F32)
    np.testing.assert_allclose(t_dw.numpy(), j_dw, atol=1e-5, rtol=1e-6)


def test_fused_dispatch_bf16_matches_jax():
    """bf16 rows: dispatch is a copy (exact); combine accumulates in
    fp32 and rounds once, as JAX does (equal up to one bf16 ulp where
    the fp32 sums differ in the last bit)."""
    e, h, n, k = 4, 32, 64, 2
    routing, cap, x, ye, _, _ = _routed(n, e, k, 1.25, h, 3)
    src, dest = jfd.routing_slots(routing, e, cap)
    xb, yeb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(ye, jnp.bfloat16)
    j_xe = jfd.fused_dispatch(xb, src, use_pallas=False)
    j_y = jfd.fused_combine(yeb, dest, routing["keep"], routing["w"],
                            use_pallas=False)
    t_routing = {kk: _t(v) for kk, v in routing.items()}
    t_src, t_dest = tfd.routing_slots(t_routing, e, cap)
    t_xe = tfd.fused_dispatch(_t(x).to(torch.bfloat16), t_src)
    t_y = tfd.fused_combine(_t(ye).to(torch.bfloat16), t_dest,
                            t_routing["keep"], t_routing["w"])
    np.testing.assert_array_equal(t_xe.float().numpy(),
                                  np.asarray(j_xe, np.float32))
    np.testing.assert_allclose(t_y.float().numpy(),
                               np.asarray(j_y, np.float32),
                               atol=1e-30, rtol=2 ** -8)


def test_kernel_wrappers_take_the_twins_on_the_cpu():
    """On CPU tensors the kernel wrappers run their twins and count no
    launch; a differentiable dispatch needs dest and keep."""
    routing, cap, x, ye, _, _ = _routed(32, 4, 2, 1.25, 8, 4)
    t_routing = {kk: _t(v) for kk, v in routing.items()}
    src, dest = tfd.routing_slots(t_routing, 4, cap)
    tfd.reset_launch_counts()
    tfd.gather_rows(_t(x), src)
    tfd.combine_rows(_t(ye), dest, t_routing["keep"])
    assert tfd.gather_rows.launches == tfd.combine_rows.launches == 0
    with pytest.raises(ValueError, match="dest and keep"):
        tfd.fused_dispatch(_t(x).requires_grad_(True), src)


# ----------------------------------------------------------------------
# experts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("g", [4, 3])
def test_grouped_gemm_pack_matches_jax(g):
    rng = np.random.default_rng(g)
    x = rng.standard_normal((g, 8, 16)).astype(np.float32)
    w = rng.standard_normal((g, 16, 12)).astype(np.float32)
    ref = np.asarray(jex.grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                      pack=False))
    for pack in (True, False):
        got = tex.grouped_gemm(_t(x), _t(w), pack=pack)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("pack", [True, False])
def test_expert_ffn_matches_jax_and_reference(pack):
    e, c, h, f = 4, 12, 16, 64
    rng = np.random.default_rng(7)
    xe = rng.standard_normal((e, c, h)).astype(np.float32)
    mod = jex.ExpertFFN(num_experts=e, d_model=h, d_ff=f, pack=pack)
    jp = mod.init(jax.random.PRNGKey(0), jnp.asarray(xe))["params"]
    jp = {kk: np.asarray(v) + (0.1 if kk.startswith("b") else 0.0)
          for kk, v in jp.items()}
    dy = rng.standard_normal((e, c, h)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, x: mod.apply({"params": p}, x), jp,
                       jnp.asarray(xe))
    j_dp, j_dx = vjp(jnp.asarray(dy))
    ffn = tex.ExpertFFN(e, h, f, torch.float32, torch.float32, pack=pack)
    params = {kk: _t(v).requires_grad_(True) for kk, v in jp.items()}
    x = _t(xe).requires_grad_(True)
    got = torch.func.functional_call(ffn, params, (x,))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    grads = torch.autograd.grad(got, [x] + list(params.values()), _t(dy))
    assert _rel(grads[0].numpy(), j_dx) <= 1e-5
    for name, gr in zip(params, grads[1:]):
        assert _rel(gr.numpy(), j_dp[name]) <= 1e-5, name
    loop = tex.expert_ffn_reference(params, x)
    np.testing.assert_allclose(loop.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    # quantized experts are ported (K6); a mode outside auto/on/off raises
    with pytest.raises(ValueError, match="quantized_compute"):
        tex.ExpertFFN(e, h, f, torch.float32, torch.float32,
                      quantized="sometimes")


# ----------------------------------------------------------------------
# MoEMLP
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fused", ["on", "off"])
def test_moe_mlp_matches_jax_and_reference(fused):
    """MoEMLP on both dispatch routes against the JAX layer (its XLA
    route) and against moe_mlp_reference: output, stats and the
    gradients of every parameter and of the input."""
    e, h, b, t = 4, 32, 2, 24
    jmoe = jlayer.MoEConfig(num_experts=e, top_k=2, capacity_factor=1.0,
                            fused_dispatch="off").validate()
    tmoe = tlayer.MoEConfig(num_experts=e, top_k=2, capacity_factor=1.0,
                            fused_dispatch=fused).validate()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, t, h)).astype(np.float32)
    dy = rng.standard_normal((b, t, h)).astype(np.float32)
    mod = jlayer.MoEMLP(moe=jmoe, d_model=h, d_ff=4 * h)
    jp = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    (ref, j_stats), vjp = jax.vjp(
        lambda p, x: mod.apply({"params": p}, x), jp, jnp.asarray(x))
    j_dp, j_dx = vjp((jnp.asarray(dy), jnp.zeros_like(j_stats)))
    flat = {"wg": jp["wg"], **{f"experts.{kk}": v
                               for kk, v in jp["experts"].items()}}
    j_flat = {"wg": j_dp["wg"], **{f"experts.{kk}": v
                                   for kk, v in j_dp["experts"].items()}}
    mlp = tlayer.MoEMLP(tmoe, h, 4 * h, torch.float32, torch.float32)
    params = {kk: _t(v).requires_grad_(True) for kk, v in flat.items()}
    tx = _t(x).requires_grad_(True)
    y, stats = torch.func.functional_call(mlp, params, (tx,))
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(stats.detach().numpy(), j_stats, **F32)
    grads = torch.autograd.grad(y, [tx] + list(params.values()), _t(dy))
    assert _rel(grads[0].numpy(), j_dx) <= 1e-5
    for name, gr in zip(params, grads[1:]):
        assert _rel(gr.numpy(), j_flat[name]) <= 1e-5, name
    loop, loop_stats = tlayer.moe_mlp_reference(params, _t(x), tmoe)
    np.testing.assert_allclose(loop.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(loop_stats.detach(), stats.detach())


def test_moe_mlp_route_override_forces_the_choices():
    """The test-only override replaces the router's top-k; gradients
    still reach the router weights."""
    moe = tlayer.MoEConfig(num_experts=4, top_k=2).validate()
    mlp = tlayer.MoEMLP(moe, 16, 64, torch.float32, torch.float32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mlp.parameters():
            p.normal_(0.0, 0.1, generator=gen)
    x = torch.randn((2, 8, 16), generator=gen)
    mlp(x)
    own = mlp.last_expert_idx
    forced = torch.flip(own, dims=[1])
    mlp.route_override = forced
    y, stats = mlp(x)
    assert torch.equal(mlp.last_expert_idx, forced)
    (g,) = torch.autograd.grad(y.sum(), mlp.wg)
    assert float(g.abs().sum()) > 0


def test_moe_config_and_resolvers():
    for bad in (dict(num_experts=1), dict(num_experts=4, top_k=5),
                dict(capacity_factor=0.0), dict(every_n_layers=0),
                dict(aux_loss_weight=-1.0), dict(pack_experts="sometimes"),
                dict(fused_dispatch="maybe")):
        with pytest.raises(ValueError):
            jlayer.MoEConfig(**bad).validate()
        with pytest.raises(ValueError):
            tlayer.MoEConfig(**bad).validate()
    j_fields = {f.name: f.default for f in
                dataclasses.fields(jlayer.MoEConfig)}
    t_fields = {f.name: f.default for f in
                dataclasses.fields(tlayer.MoEConfig)}
    assert j_fields == t_fields
    assert tlayer.resolve_pack_experts("auto") is False
    assert tlayer.resolve_pack_experts(True) is True
    assert tlayer.resolve_fused_dispatch("auto", None, "cpu") is False
    assert tlayer.resolve_fused_dispatch("auto", None, "cuda") is True
    assert tlayer.resolve_fused_dispatch("on", None, "cpu") is True
    assert tlayer.resolve_fused_dispatch("off", None, "cuda") is False
    with pytest.raises(NotImplementedError, match="world size"):
        tlayer.resolve_fused_dispatch("auto", object(), "cuda")
    assert tdispatch.dispatch_buffer_nbytes(8, 640, 1024, torch.bfloat16) \
        == j_dispatch_nbytes(8, 640, 1024, jnp.bfloat16, None)


@pytest.mark.parametrize("block", [
    {}, {"moe": {"enabled": True, "num_experts": 4}},
    {"moe": {"enabled": True, "top_k": 1, "capacity_factor": 2,
             "every_n_layers": 2, "jitter_eps": 0.1,
             "fused_dispatch": True}},
    {"moe": {"num_experts": 1}}, {"moe": {"top_k": 0}},
    {"moe": {"num_experts": 4, "top_k": 5}}, {"moe": {"capacity_factor": 0}},
    {"moe": {"every_n_layers": 0}}, {"moe": {"aux_loss_weight": -1}},
    {"moe": {"jitter_eps": -0.1}}, {"moe": {"fused_dispatch": "maybe"}},
    {"moe": {"num_experts": True}}, {"moe": "yes"},
])
def test_get_moe_config_matches_jax(block):
    try:
        ref = j_get_moe_config(block)
    except JErr:
        with pytest.raises(TErr):
            t_get_moe_config(block)
        return
    assert t_get_moe_config(block) == ref
