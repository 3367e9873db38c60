"""PyTorch port: fused epilogue backwards (kernels K3-bwd, K4-bwd)
against the JAX package.

On the CPU the port's autograd Functions run the backward twins
(`_ln_bwd_math`, `_gelu_bwd_math`); these tests hold their gradients
against `jax.grad` of deepspeed_tpu's fused ops run as the Pallas
kernels in interpret mode (impl="interpret"), on the same numpy-seeded
inputs and cotangents. The LayerNorm chain is taken in both forms: the
two-output block form (the sum's own cotangent flows) and the ln_f
form (return_sum=False, no sum cotangent). The CUDA kernels are held
against the twins on the card in tests/test_torch_cuda.py.

Tolerances, by relative L2 error: fp32 to roundoff (row statistics and
the cross-row sums run in another order): 1e-5. bf16 rows: the
cotangents of y and residual are one bf16 rounding of the same fp32
value in both packages: 1e-2; the parameter gradients are fp32 sums of
the same fp32 terms: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import fused_ops as jfo
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo
from torch_one_thread import one_torch_thread  # noqa: F401

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ROW_TOL = {"fp32": 1e-5, "bf16": 1e-2}
VEC_TOL = 1e-5


def _rel_l2(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("return_sum", [True, False],
                         ids=["block-form", "ln_f-form"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("h", [64, 100])
def test_layernorm_grads_match_jax(h, dt, return_sum):
    """Gradients of y, bias, residual, gamma, beta; H=100 exercises the
    TPU kernel's lane mask."""
    r = np.random.RandomState(h + 2 * return_sum)
    n = 24
    y, res = (r.randn(n, h).astype(np.float32) for _ in range(2))
    bias, beta = ((0.1 * r.randn(h)).astype(np.float32) for _ in range(2))
    gamma = (1.0 + 0.1 * r.randn(h)).astype(np.float32)
    g_out, g_sum = (r.randn(n, h).astype(np.float32) for _ in range(2))
    jdt, tdt = DTYPES[dt]
    out_dt = (jnp.float32, torch.float32) if not return_sum else (jdt, tdt)

    def jloss(y, bias, res, gamma, beta):
        o = jfo.fused_bias_residual_layernorm(
            y, bias, res, gamma, beta, eps=1e-5, out_dtype=out_dt[0],
            sum_dtype=jdt, impl="interpret", return_sum=return_sum)
        if not return_sum:
            return jnp.sum(o.astype(jnp.float32) * g_out)
        return jnp.sum(o[0].astype(jnp.float32) * g_out) + \
            jnp.sum(o[1].astype(jnp.float32) * g_sum)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(y, jdt), bias, jnp.asarray(res, jdt), gamma, beta)

    ty = torch.from_numpy(y).to(tdt).requires_grad_(True)
    tres = torch.from_numpy(res).to(tdt).requires_grad_(True)
    vecs = [torch.from_numpy(x).requires_grad_(True)
            for x in (bias, gamma, beta)]
    o = tfo.fused_bias_residual_layernorm(
        ty, vecs[0], tres, vecs[1], vecs[2], eps=1e-5, out_dtype=out_dt[1],
        sum_dtype=tdt, return_sum=return_sum)
    if return_sum:
        loss = (o[0].float() * torch.from_numpy(g_out)).sum() + \
            (o[1].float() * torch.from_numpy(g_sum)).sum()
    else:
        loss = (o.float() * torch.from_numpy(g_out)).sum()
    got = torch.autograd.grad(loss, [ty, vecs[0], tres, vecs[1], vecs[2]])

    assert got[0].dtype == tdt and got[2].dtype == tdt
    assert all(got[i].dtype == torch.float32 for i in (1, 3, 4))
    for name, a, b in zip(("y", "bias", "residual", "gamma", "beta"),
                          got, ref):
        tol = ROW_TOL[dt] if name in ("y", "residual") else VEC_TOL
        assert _rel_l2(_np(a), _np(b)) <= tol, name


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("w", [64, 100])
def test_gelu_grads_match_jax(w, dt, approximate):
    r = np.random.RandomState(w + approximate)
    x = (2.0 * r.randn(24, w)).astype(np.float32)
    bias = (0.1 * r.randn(w)).astype(np.float32)
    g = r.randn(24, w).astype(np.float32)
    jdt, tdt = DTYPES[dt]

    def jloss(x, bias):
        o = jfo.fused_bias_gelu(x, bias, approximate=approximate,
                                impl="interpret")
        return jnp.sum(o.astype(jnp.float32) * g)

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jdt), bias)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    out = tfo.fused_bias_gelu(tx, tb, approximate=approximate)
    got = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(),
                              (tx, tb))
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    assert _rel_l2(_np(got[0]), _np(ref[0])) <= ROW_TOL[dt]
    assert _rel_l2(_np(got[1]), _np(ref[1])) <= VEC_TOL


def test_backward_wrappers_are_the_twins_on_cpu():
    """The public K3-bwd/K4-bwd wrappers on CPU tensors compute the
    twins' formulas and count no kernel launch; the ln_f form takes no
    sum cotangent."""
    tfo.reset_launch_counts()
    r = np.random.RandomState(0)
    s, dout, dsum = (torch.from_numpy(r.randn(6, 32).astype(np.float32))
                     for _ in range(3))
    gamma = torch.from_numpy((1 + 0.1 * r.randn(32)).astype(np.float32))
    dx, dbias, dgamma, dbeta = tfo.fused_bias_residual_layernorm_backward(
        s, gamma, dout, dsum)
    ds, dg_rows, db_rows = tfo._ln_bwd_math(s, gamma, dout, dsum, 1e-5)
    assert torch.equal(dx, ds) and torch.equal(dbias, ds.sum(0))
    assert torch.equal(dgamma, dg_rows.sum(0))
    assert torch.equal(dbeta, db_rows.sum(0))
    no_sum = tfo.fused_bias_residual_layernorm_backward(s, gamma, dout)
    assert not torch.equal(no_sum[0], dx)
    gx, gb = tfo.fused_bias_gelu_backward(s, dout, approximate=True)
    ref = tfo._gelu_bwd_math(s, dout, True)
    assert torch.equal(gx, ref) and torch.equal(gb, ref.sum(0))
    assert tfo.fused_bias_residual_layernorm_backward.launches == 0
    assert tfo.fused_bias_gelu_backward.launches == 0


def test_inference_forward_takes_no_autograd_path():
    """Without gradients the ln_f form still skips the sum, and the
    outputs equal the grad-enabled path's."""
    r = np.random.RandomState(1)
    y, res = (torch.from_numpy(r.randn(4, 16).astype(np.float32))
              for _ in range(2))
    vecs = [torch.from_numpy(r.randn(16).astype(np.float32))
            for _ in range(3)]
    with torch.no_grad():
        plain = tfo.fused_bias_residual_layernorm(
            y, vecs[0], res, vecs[1], vecs[2], return_sum=False)
    yg = y.clone().requires_grad_(True)
    graded = tfo.fused_bias_residual_layernorm(
        yg, vecs[0], res, vecs[1], vecs[2], return_sum=False)
    assert graded.requires_grad and not plain.requires_grad
    assert torch.equal(plain, graded.detach())


# ----------------------------------------------------------------------
# K3-bwd's launch plan (ops/csrc/fused_ln_bwd.cu): the kernel's index
# arithmetic replayed on the plan, at the paths' widths (1600, 1024), a
# ragged one (1601: scalar accesses), a narrow one (100: one warp a
# row) and a ragged wide one (5121: four vectors a lane), at N 1, 4 and
# the flagship's 11,264 rows
# ----------------------------------------------------------------------
SMS = 132


def _ln_bwd_group_rows(plan, n, cta, group):
    """The rows row group `group` of CTA `cta` takes, in order: k, k +
    grid * groups, ... for k = cta * groups + group (ln_bwd_kernel's
    loop)."""
    return list(range(cta * plan.groups + group, n,
                      plan.grid * plan.groups))


def _ln_bwd_lane_columns(plan, h, lane):
    """The columns lane `lane` of a row group owns in every row: 8 of
    each of its vectors lane + j * 32 * warps_per_row, cut at h."""
    tpr = 32 * plan.warps_per_row
    return [c for j in range(plan.vpt)
            for c in range(8 * (lane + j * tpr),
                           min(h, 8 * (lane + j * tpr) + 8))]


LN_BWD_PLAN_CASES = [(n, h) for h in (1600, 1024, 1601, 100, 5121)
                     for n in (1, 4, 11264)]


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n,h", LN_BWD_PLAN_CASES,
                         ids=[f"N{n}-H{h}" for n, h in LN_BWD_PLAN_CASES])
def test_ln_bwd_plan_covers_every_row_and_column_once(n, h, aligned):
    """The row groups of the grid take every row once, their lanes every
    column of a row once with no warp left idle, the CTA fits 14 warps,
    the grid is one CTA per SM at most with no CTA idle, and 16-byte
    accesses only where h is a multiple of 8 and the pointers align."""
    plan = tfo.ln_bwd_plan(n, h, SMS, aligned=aligned)
    assert plan.threads == 32 * plan.warps_per_row * plan.groups <= 448
    assert 1 <= plan.grid <= SMS
    seen = np.zeros(n, np.int64)
    for cta in range(plan.grid):
        mine = [_ln_bwd_group_rows(plan, n, cta, g)
                for g in range(plan.groups)]
        assert mine[0], "every CTA has rows"
        for rows in mine:
            seen[rows] += 1
    assert (seen == 1).all()
    cols = np.zeros(h, np.int64)
    for lane in range(32 * plan.warps_per_row):
        cols[_ln_bwd_lane_columns(plan, h, lane)] += 1
    assert (cols == 1).all()
    last_warp = range(32 * (plan.warps_per_row - 1),
                      32 * plan.warps_per_row)
    assert any(_ln_bwd_lane_columns(plan, h, lane) for lane in last_warp)
    assert plan.vec == (8 if aligned and h % 8 == 0 else 1)


@pytest.mark.parametrize("n,h", LN_BWD_PLAN_CASES,
                         ids=[f"N{n}-H{h}" for n, h in LN_BWD_PLAN_CASES])
def test_ln_bwd_plan_folds_every_partial_row_once_in_order(n, h):
    """The CTAs' partial rows are folded in fold groups of consecutive
    CTAs, each group in CTA order, then the group rows in group order:
    every CTA lands in one group once, in ascending order; the workspace
    holds the partial rows and (with more than one group) the group
    rows; one counter per fold group and one for the groups."""
    plan = tfo.ln_bwd_plan(n, h, SMS)
    groups = [list(range(f * plan.fold, min(plan.grid, (f + 1) * plan.fold)))
              for f in range(plan.fold_groups)]
    assert [c for g in groups for c in g] == list(range(plan.grid))
    assert all(groups)
    assert plan.fold_groups == -(-plan.grid // plan.fold)
    assert plan.fold * plan.fold >= plan.grid
    assert plan.counters == plan.fold_groups + 1
    assert plan.work_rows == plan.grid + (
        plan.fold_groups if plan.fold_groups > 1 else 0)


@pytest.mark.parametrize("h,vpt,warps,groups", [
    (1600, 1, 7, 2), (1024, 1, 4, 3), (2560, 1, 10, 1), (3584, 1, 14, 1),
    (4096, 4, 4, 1), (5120, 4, 5, 1), (7168, 4, 7, 1), (100, 1, 1, 14)])
def test_ln_bwd_plan_sizes_the_row_group_to_h(h, vpt, warps, groups):
    """One 8-column vector a lane up to h = 3584 (14 warps a CTA), four
    beyond (7 warps a CTA); past 7168 columns the kernel has no layout
    and the plan raises; unaligned pointers take scalar accesses."""
    plan = tfo.ln_bwd_plan(11264, h, SMS)
    assert (plan.vpt, plan.warps_per_row, plan.groups) == \
        (vpt, warps, groups)
    assert tfo.ln_bwd_plan(11264, h, SMS, aligned=False).vec == 1
    with pytest.raises(ValueError, match="widest row"):
        tfo.ln_bwd_plan(4, 7176, SMS)
