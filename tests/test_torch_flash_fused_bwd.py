"""PyTorch port: the one-pass flash attention backward (kernel K2-fused)
against the JAX package.

The JAX package's `_bwd` runs `_bwd_fused_kernel` whenever the whole
sequence is one tile of its 1024-row default block, so at T 128 and 256
`jax.grad` of deepspeed_tpu's `flash_attention_with_lse(...,
interpret=True)` runs that kernel in interpret mode. The port's CUDA
kernel runs there too (`_fused_route`: T <= 1024 in bf16 and fp16 at
head dims 64 and 128); its plain twin `_flash_bwd_fused_plain` walks
the kernel's order (`_fused_plan`'s rounds of 128-row key blocks,
64-row q steps, dQ partials summed round by round): one key block at T
128; at T 256 two CTAs in rotation or, causal at head dim 64, one CTA
pairing both key blocks. These tests hold the twin against JAX in
fp32, bf16 and fp16, causal and not, through both outputs (the lse
cotangent enters as a shift of delta), and the given-delta entry
through `flash_attention_merge`'s VJP (K5's backward). The CUDA kernel
is held against the twin on the card in tests/test_torch_cuda.py.

Tolerances, by relative L2 error ||port - jax|| / ||jax||: fp32 1e-5
(the same products summed in another order; observed ~1e-7); bf16 1e-2
and fp16 2e-3 (both round P and dS to the input dtype before their
products and each gradient once at the end, so an fp32 sum on the other
side of a rounding point moves an element by one ulp: 2^-8 in bf16,
2^-11 in fp16); the merge VJP in bf16 1e-2.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}
REL_TOL = {"fp32": 1e-5, "bf16": 1e-2, "fp16": 2e-3}


def _rel_l2(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _inputs(t, seed, b=1, h=2, d=64):
    r = np.random.RandomState(seed)
    q, k, v, g = (r.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    g_lse = r.randn(b, h, t, 1).astype(np.float32)
    return q, k, v, g, g_lse


def _jax_grads(q, k, v, g, g_lse, dt, causal):
    """jax.grad through the default blocks: one tile at T <= 1024, so
    the Pallas backward is `_bwd_fused_kernel`."""
    jdt = DTYPES[dt][0]

    def f(q, k, v):
        out, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                                interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g) + jnp.sum(lse * g_lse)

    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dt", ["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("t", [128, 256])
def test_fused_twin_matches_jax_one_tile_backward(t, dt, causal):
    """dq, dk, dv of the fused twin, from the forward twin's (out, lse),
    with dO rounded to the input dtype as JAX's cast cotangent is."""
    q, k, v, g, g_lse = _inputs(t, seed=t + 3 * causal + len(dt))
    tdt = DTYPES[dt][1]
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    out, lse = tfa._flash_fwd_plain(tq, tk, tv, 0.125, causal)
    got = tfa._flash_bwd_fused_plain(
        tq, tk, tv, out, lse, torch.from_numpy(g).to(tdt),
        torch.from_numpy(g_lse)[..., 0], 0.125, causal)
    ref = _jax_grads(q, k, v, g, g_lse, dt, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == tdt
        assert _rel_l2(a.float().numpy(), b) <= REL_TOL[dt], name


@pytest.mark.parametrize("t", [128, 256])
def test_fused_route_given_delta_matches_jax_merge_vjp(t):
    """bf16 `flash_attention_merge`'s VJP on the CPU: its backward hands
    the fused twin a given delta (`_fused_route`), held against JAX's
    `flash_attention_merge(..., interpret=True)` in all five inputs."""
    r = np.random.RandomState(t)
    b, h, d = 1, 2, 64
    q, k, v, k2, v2 = (r.randn(b, t, h, d).astype(np.float32)
                       for _ in range(5))
    prev, prev_lse = jfa.flash_attention_with_lse(q, k2, v2, causal=False,
                                                  interpret=True)
    prev, prev_lse = np.array(prev), np.array(prev_lse)
    prev[:, :5] = 0.0
    prev_lse[:, :, :5] = tfa.NEG_INF
    g_out = r.randn(*q.shape).astype(np.float32)
    g_lse = r.randn(*prev_lse.shape).astype(np.float32)
    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)] + \
        [jnp.asarray(prev), jnp.asarray(prev_lse)]
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention_merge(
        *a, causal=True, interpret=True), *jargs)
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
              for x in (q, k, v)] + \
        [torch.from_numpy(x).requires_grad_(True) for x in (prev, prev_lse)]
    assert tfa._fused_route(leaves[0])
    out, lse = tfa.flash_attention_merge(*leaves, causal=True)
    got = torch.autograd.grad((out, lse), leaves, (torch.from_numpy(g_out),
                                                   torch.from_numpy(g_lse)))
    for name, x, y in zip(("q", "k", "v", "prev_out", "prev_lse"), got,
                          want):
        assert _rel_l2(x.float().numpy(), np.asarray(y, np.float32)) <= \
            REL_TOL["bf16"], name


def test_cpu_backward_takes_the_route_twin_and_counts_no_launch():
    """On CPU tensors `flash_attention_backward` runs the twin of the
    kernel its shape routes to, bit for bit: the fused twin at T <= 1024
    in bf16 and fp16 at head dims 64 and 128, the sweeps' twin at T 2048,
    in fp32 and at head dim 256; no launch is counted."""
    tfa.reset_launch_count()
    cases = ((256, 64, torch.bfloat16, True), (128, 128, torch.float16, True),
             (2048, 64, torch.bfloat16, False),
             (256, 64, torch.float32, False),
             (256, 256, torch.bfloat16, False))
    for t, d, dtype, fused in cases:
        q, k, v, g, g_lse = (torch.from_numpy(x) for x in
                             _inputs(t, seed=t + d, h=1, d=d))
        q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
        assert tfa._fused_route(q) == fused
        out, lse = tfa._flash_fwd_plain(q, k, v, d ** -0.5, True)
        got = tfa.flash_attention_backward(q, k, v, out, lse, g,
                                           g_lse[..., 0])
        twin = tfa._flash_bwd_fused_plain if fused else tfa._flash_bwd_plain
        want = twin(q, k, v, out, lse, g, g_lse[..., 0], d ** -0.5, True)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), t
    assert tfa._flash_bwd_fused_launch.launches == 0
    assert tfa.flash_attention_backward.launches == 0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_fused_plan_takes_every_pair_once(causal, d):
    """`_fused_plan` at every cluster size the kernel takes (1-8 key
    blocks): each (key block, q block) pair the mask leaves, once; a CTA's
    key blocks one after the other; a q block's slab fed by at most one
    CTA a round; causal at head dim 64, key blocks paired in
    ceil(nk / 2) CTAs over nk + 1 rounds."""
    for nk in range(1, 9):
        rows, owner = tfa._fused_plan(nk, causal, d)
        pairs = [p for row in rows for p in row if p is not None]
        want = [(kb, j) for kb in range(nk) for j in range(nk)
                if not causal or j >= kb]
        assert sorted(pairs) == want, nk
        for row in rows:
            kbs = [p[0] for p in row if p is not None]
            assert kbs == sorted(kbs, key=kbs.index), nk
        assert sorted(owner) == list(range(nk))
        for r in range(len(rows[0])):
            js = [row[r][1] for row in rows if row[r] is not None]
            assert len(js) == len(set(js)), (nk, r)
        plan = tfa._FusedPlan.of(nk, causal, d)
        assert (plan.ctas, plan.rounds) == (len(rows), len(rows[0]))
        if causal and d == 64:
            assert (len(rows), len(rows[0])) == ((nk + 1) // 2,
                                                 nk + 1 if nk > 1 else 1)

