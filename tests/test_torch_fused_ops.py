"""PyTorch port: fused epilogues (kernels K3-fwd, K4-fwd) against the
JAX package.

On the CPU the port's wrappers run their plain twins; these tests hold
the twins against deepspeed_tpu's fused ops run both as the Pallas
kernel in interpret mode (impl="interpret") and as the XLA formulation
(impl="xla"), on the same inputs made from a numpy seed. The CUDA
kernels are held against the twins on the card in
tests/test_torch_cuda.py.

Tolerances: fp32 outputs agree to float roundoff (the reductions run
in another order): atol = rtol = 1e-5. bf16 outputs come from the same
fp32 chain rounded once, so a value that straddles a rounding point may
land one bf16 ulp (2^-7 relative at worst) away: atol = rtol = 1e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import fused_ops as jfo
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo
from torch_one_thread import one_torch_thread  # noqa: F401

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(arr, dt):
    """The same values as a JAX array and a torch tensor of dtype dt."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, ref, dt):
    np.testing.assert_allclose(_np(got), _np(ref),
                               **(F32_TOL if dt == "fp32" else BF16_TOL))


def _ln_inputs(n, h, seed):
    r = np.random.RandomState(seed)
    return (r.randn(n, h).astype(np.float32),
            (0.1 * r.randn(h)).astype(np.float32),
            r.randn(n, h).astype(np.float32),
            (1.0 + 0.1 * r.randn(h)).astype(np.float32),
            (0.1 * r.randn(h)).astype(np.float32))


# the dtypes of K3-fwd's operands: (y, residual, bias/gamma/beta, out,
# sum). "fp32" and "bf16" are the model's pairing (rows and outputs in
# the compute dtype, fp32 vectors: serving's fp32 parameters); the
# "bf16_vectors" cases the training paths' bf16 parameters, which the
# kernel reads in their own dtype (the wrapper casts none of them); the
# "post_ln" cases BERT's post-LN form under the bf16 engine (bf16 y, the
# carry's residual, bf16 parameters, fp32 out, the sum in the residual's
# dtype)
LN_DTYPES = {
    "fp32": ("fp32", "fp32", "fp32", "fp32", "fp32"),
    "bf16": ("bf16", "bf16", "fp32", "bf16", "bf16"),
    "bf16-bf16_vectors": ("bf16", "bf16", "bf16", "bf16", "bf16"),
    "fp32-bf16_vectors": ("fp32", "fp32", "bf16", "fp32", "fp32"),
    "post_ln-bf16_residual": ("bf16", "bf16", "bf16", "fp32", "bf16"),
    "post_ln-fp32_residual": ("bf16", "fp32", "bf16", "fp32", "fp32"),
}


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("dt", list(LN_DTYPES))
@pytest.mark.parametrize("h", [64, 100])
def test_bias_residual_layernorm_matches_jax(h, dt, impl):
    """out and resid_sum in each dtype pairing of LN_DTYPES; H=100
    exercises the lane mask of the TPU kernel. Both packages get the same
    vectors (bf16 ones rounded from the same fp32 values) and widen them
    to fp32 inside the chain. Each output within F32_TOL where it is
    fp32 (reduction order), BF16_TOL where it is bf16 (one rounding)."""
    y_dt, r_dt, v_dt, out_dt, sum_dt = LN_DTYPES[dt]
    y, bias, res, gamma, beta = _ln_inputs(12, h, seed=h)
    jy, ty = _both(y, y_dt)
    jr, tr = _both(res, r_dt)
    (jb, tb), (jg, tg), (jbeta, tbeta) = (_both(v, v_dt)
                                          for v in (bias, gamma, beta))
    ref_out, ref_s = jfo.fused_bias_residual_layernorm(
        jy, jb, jr, jg, jbeta, eps=1e-5, out_dtype=DTYPES[out_dt][0],
        sum_dtype=DTYPES[sum_dt][0], impl=impl)
    out, s = tfo.fused_bias_residual_layernorm(
        ty, tb, tr, tg, tbeta, eps=1e-5, out_dtype=DTYPES[out_dt][1],
        sum_dtype=DTYPES[sum_dt][1])
    assert out.dtype == DTYPES[out_dt][1] and s.dtype == DTYPES[sum_dt][1]
    _close(out, ref_out, out_dt)
    _close(s, ref_s, sum_dt)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("h", [64, 100])
def test_ln_f_form_matches_jax(h, impl):
    """The ln_f form: bf16 rows, fp32 output, no sum returned."""
    y, bias, res, gamma, beta = _ln_inputs(12, h, seed=10 + h)
    jy, ty = _both(y, "bf16")
    jr, tr = _both(res, "bf16")
    ref = jfo.fused_bias_residual_layernorm(
        jy, bias, jr, gamma, beta, eps=1e-5, out_dtype=jnp.float32,
        return_sum=False, impl=impl)
    got = tfo.fused_bias_residual_layernorm(
        ty, torch.from_numpy(bias), tr, torch.from_numpy(gamma),
        torch.from_numpy(beta), eps=1e-5, out_dtype=torch.float32,
        return_sum=False)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _close(got, ref, "fp32")


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("approximate", [True, False],
                         ids=["tanh", "erf"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("w", [64, 100])
def test_bias_gelu_matches_jax(w, dt, approximate, impl):
    r = np.random.RandomState(w)
    x = (2.0 * r.randn(12, w)).astype(np.float32)
    bias = (0.1 * r.randn(w)).astype(np.float32)
    jx, tx = _both(x, dt)
    ref = jfo.fused_bias_gelu(jx, bias, approximate=approximate,
                              impl=impl)
    out, s = tfo.fused_bias_gelu_with_sum(tx, torch.from_numpy(bias),
                                          approximate=approximate)
    assert out.dtype == tx.dtype and s.dtype == tx.dtype
    _close(out, ref, dt)
    _close(s, _np(jx) + bias, dt)
    # the public single-output form is the same function
    assert torch.equal(tfo.fused_bias_gelu(
        tx, torch.from_numpy(bias), approximate=approximate), out)


def test_resolve_fused_ops_matches_jax_where_defined():
    for mode in ("on", "off", True, False, None, 0, 1):
        assert tfo.resolve_fused_ops(mode) == jfo.resolve_fused_ops(mode)
    with pytest.raises(ValueError):
        tfo.resolve_fused_ops("on", dropout_inactive=False)
    with pytest.raises(ValueError):
        tfo.resolve_fused_ops("sometimes")
    # "auto" keys on the device, as the JAX package keys on the backend
    assert tfo.resolve_fused_ops("auto", device="cpu") is False
    assert tfo.resolve_fused_ops("auto", device="cuda") is True
    assert tfo.resolve_fused_ops("auto", False, device="cuda") is False


def test_cpu_tensors_take_the_twins_and_count_no_launch():
    tfo.reset_launch_counts()
    y, bias, res, gamma, beta = (torch.from_numpy(a)
                                 for a in _ln_inputs(4, 64, seed=0))
    out, s = tfo.fused_bias_residual_layernorm(y, bias, res, gamma, beta)
    ref_out, ref_s = tfo._ln_fwd_math(y, bias, res, gamma, beta, 1e-5)
    assert torch.equal(out, ref_out) and torch.equal(s, ref_s)
    g = tfo.fused_bias_gelu(y, bias, approximate=True)
    assert torch.equal(g, tfo._gelu_fwd_math(y, bias, True)[0])
    assert tfo.fused_bias_residual_layernorm.launches == 0
    assert tfo.fused_bias_gelu.launches == 0


# K4's launch plan, the tiling the CUDA kernels take (ops/csrc/gelu_rows.cuh)
SMS = 132


def _cta_rows(plan, n, groups):
    """[(group, rows)] of each CTA row of the grid, as the kernels walk
    them from blockIdx.x: CTA j of group g takes the group's blocks of
    block_rows rows j, j + ctas_per_group, ..."""
    rows = n // groups
    out = []
    for bx in range(plan.grid[0]):
        g, j = divmod(bx, plan.ctas_per_group)
        mine = [r for b in range(j, -(-rows // plan.block_rows),
                                 plan.ctas_per_group)
                for r in range(g * rows + b * plan.block_rows,
                               g * rows + min(rows, (b + 1) * plan.block_rows))]
        out.append((g, mine))
    return out


@pytest.mark.parametrize("n", [1, 4, 447, 11264])
@pytest.mark.parametrize("w", [64, 100, 4096, 6400])
def test_gelu_plan_covers_every_row_and_column_once(n, w):
    """The CTA rows partition the N rows and the strips the W columns,
    so the grid's CTAs (CTA row x strip) cover every element exactly
    once, in at most one wave of 2 CTAs per SM."""
    plan = tfo.gelu_plan(n, w, 1, SMS)
    rows = np.zeros(n, np.int64)
    for g, mine in _cta_rows(plan, n, 1):
        assert g == 0 and mine, "every CTA has rows"
        rows[mine] += 1
    assert (rows == 1).all()
    cols = np.zeros(w, np.int64)
    for by in range(plan.strips):
        cols[by * 256:min(w, by * 256 + 256)] += 1
    assert (cols == 1).all() and (plan.strips - 1) * 256 < w
    assert plan.grid == (plan.ctas_per_group, plan.strips)
    assert plan.grid[0] * plan.grid[1] <= max(2 * SMS, plan.strips)


@pytest.mark.parametrize("rows", [5120, 37])
def test_gelu_plan_never_straddles_a_group(rows):
    """G = 8 groups of 5,120 rows (the MoE cell) and of 37 (no multiple
    of the 16-row blocks): each CTA's rows lie in its own group, and each
    group's CTAs cover its rows once."""
    groups, w = 8, 4096
    n = groups * rows
    plan = tfo.gelu_plan(n, w, groups, SMS)
    assert plan.grid[0] == groups * plan.ctas_per_group
    seen = np.zeros(n, np.int64)
    for g, mine in _cta_rows(plan, n, groups):
        assert all(g * rows <= r < (g + 1) * rows for r in mine)
        seen[mine] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n,w,groups", [(11264, 6400, 1), (4, 6400, 1),
                                        (40960, 4096, 8), (296, 100, 8),
                                        (0, 64, 1)])
def test_gelu_plan_sizes_the_workspace_and_counters_from_the_grid(
        n, w, groups):
    plan = tfo.gelu_plan(n, w, groups, SMS)
    assert plan.work_rows == plan.grid[0]
    assert plan.counters == groups * plan.grid[1]
    assert plan.work_rows == groups * plan.ctas_per_group
    if n == 0:
        assert plan.grid[0] == 0 and plan.work_rows == 0


@pytest.mark.parametrize("w,aligned,vec", [(6400, True, 8), (4096, True, 8),
                                           (64, True, 8), (100, True, 1),
                                           (6401, True, 1), (6400, False, 1),
                                           (4, True, 1)])
def test_gelu_plan_falls_back_to_scalar_accesses(w, aligned, vec):
    """16-byte vectors need W (so every row's pitch) a multiple of 8
    columns and every pointer 16-byte aligned."""
    assert tfo.gelu_plan(64, w, 1, SMS, aligned).vec == vec


# K3-fwd's launch plan, the layout the CUDA kernel takes
# (ops/csrc/fused_ln_fwd.cu): the repo's models' widths (gpt2 presets and
# BERT), a ragged one and two small ones
LN_FWD_WIDTHS = [768, 1024, 1536, 1600, 2560, 4096, 5120, 1602, 100, 4]


@pytest.mark.parametrize("n", [1, 4, 127, 2048, 11264])
@pytest.mark.parametrize("h", LN_FWD_WIDTHS)
def test_ln_fwd_plan_covers_every_row_once(n, h):
    """Row group k of the grid (CTA k // groups, group k % groups) takes
    the rows k, k + grid * groups, ...: every row exactly once. A row
    group's lanes cover the row's 8-column vectors with the fewest
    warps; a CTA holds whole row groups within the kernel's 20 warps,
    and the grid one wave (at most 28 warps an SM, or one CTA where a
    row group is wider), never more CTAs than rows need."""
    plan = tfo.ln_fwd_plan(n, h, SMS)
    wpr, groups = plan.warps_per_row, plan.groups
    assert 32 * wpr * 8 >= h > 32 * (wpr - 1) * 8
    assert plan.threads == 32 * wpr * groups <= 32 * 20
    assert wpr == 1 or groups <= 15      # the named barriers 1 .. 15
    total = plan.grid * groups
    seen = np.zeros(n, np.int64)
    for k in range(total):
        seen[k::total] += 1
    assert (seen == 1).all()
    warps = wpr * groups
    assert plan.grid * warps <= SMS * max(tfo._LN_FWD_SM_WARPS, warps)
    assert (plan.grid - 1) * groups < n                # no CTA idle
    if n <= SMS:
        assert groups == 1 and plan.grid == n   # a row a CTA


@pytest.mark.parametrize("h,aligned,vec", [(1600, True, 8), (1024, True, 8),
                                           (5120, True, 8), (1602, True, 1),
                                           (100, True, 1), (1600, False, 1),
                                           (4, True, 1)])
def test_ln_fwd_plan_falls_back_to_scalar_accesses(h, aligned, vec):
    """16-byte vectors need H (so every row's pitch) a multiple of 8
    columns and y's and the residual's pointers 16-byte aligned."""
    assert tfo.ln_fwd_plan(64, h, SMS, aligned).vec == vec


@pytest.mark.parametrize("h", [5121, 8192])
def test_ln_fwd_plan_raises_past_its_widest_row(h):
    with pytest.raises(ValueError, match="widest row"):
        tfo.ln_fwd_plan(64, h, SMS)


def test_ln_fwd_plan_at_the_paths_shapes():
    """The paths' plans: one row a CTA at the decode and prefill-chunk
    shapes; 7-warp row groups at H 1600 (200 vectors), 4 CTAs an SM (28
    warps); two 4-warp row groups a CTA at H 1024 (BERT, MoE), 3 CTAs an
    SM."""
    assert tfo.ln_fwd_plan(4, 1600, SMS) == (8, 7, 1, 224, 4)
    assert tfo.ln_fwd_plan(128, 1600, SMS) == (8, 7, 1, 224, 128)
    assert tfo.ln_fwd_plan(11264, 1600, SMS) == (8, 7, 1, 224, 4 * SMS)
    assert tfo.ln_fwd_plan(2048, 1024, SMS) == (8, 4, 2, 256, 3 * SMS)
    assert tfo.ln_fwd_plan(16384, 1024, SMS) == (8, 4, 2, 256, 3 * SMS)
    assert tfo.ln_fwd_plan(0, 1024, SMS).grid == 0
