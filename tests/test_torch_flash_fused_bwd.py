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
through `flash_attention_merge`'s VJP (K5's backward); T 384 and 1000
take clusters of 2-8 CTAs. The plan's tests check that each q block's
dQ partials have one stated order and that the kernel's waits for them
(its batons) cannot deadlock. The CUDA kernel is held against the twin
on the card in tests/test_torch_cuda.py.

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
@pytest.mark.parametrize("t", [128, 256, 384, 1000])
def test_fused_twin_matches_jax_one_tile_backward(t, dt, causal):
    """dq, dk, dv of the fused twin, from the forward twin's (out, lse),
    with dO rounded to the input dtype as JAX's cast cotangent is; T 384
    (three key blocks: causal at head dim 64 the middle one alone in its
    CTA, three partials in the last q block's order) and 1000 (eight key
    blocks, the last 104 rows, the last q step 40)."""
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


@pytest.mark.parametrize("t", [128, 256, 384])
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
        assert (plan.ctas, plan.pairs) == (len(rows), len(rows[0]))
        for c, row in enumerate(rows):
            got = [(plan.kb[c][p], plan.qb[c][p]) for p in range(plan.n[c])]
            assert got == [p for p in row if p is not None], (nk, c)
            kvs = [plan.kv[c][x] for x in range(2) if plan.kv[c][x] >= 0]
            assert kvs == list(dict.fromkeys(kb for kb, _ in got)), (nk, c)
            # at head dim 128 one resident K/V block a CTA
            assert len(kvs) == 1 or (causal and d == 64), (nk, c)
        if causal and d == 64:
            assert (len(rows), len(rows[0])) == ((nk + 1) // 2,
                                                 nk + 1 if nk > 1 else 1)


def _partials_by_links(plan):
    """{q block: [(CTA, pair), ...]} read off the kernel's struct: from
    each q block's first partial along the next links."""
    chains = {}
    for c in range(plan.ctas):
        for p in range(plan.n[c]):
            if plan.first[c][p]:
                chain, at = [], (c, p)
                while at[0] >= 0:
                    chain.append(at)
                    at = (plan.next_cta[at[0]][at[1]],
                          plan.next_pair[at[0]][at[1]])
                chains[plan.qb[c][p]] = chain
    return chains


def _run_batons(n, order):
    """The kernel's dQ adds as a simulation: CTA c takes its n[c] pairs in
    order, and the add of its p-th pair waits until the partial before it
    in its q block's `order` is added (the baton). Returns the adds in
    the order they ran, or None if some CTA waits forever."""
    before = {at: parts[i - 1] for parts in order.values()
              for i, at in enumerate(parts) if i > 0}
    done, ran, nxt = set(), [], [0] * len(n)
    while len(ran) < sum(n):
        moved = False
        for c in range(len(n)):
            if nxt[c] < n[c] and before.get((c, nxt[c]), (c, -1)) in \
                    done | {(c, -1)}:
                done.add((c, nxt[c]))
                ran.append((c, nxt[c]))
                nxt[c] += 1
                moved = True
        if not moved:
            return None
    return ran


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_fused_plan_orders_each_q_blocks_partials(causal, d):
    """Each q block's dQ partials, at every cluster size (1-8 key
    blocks), in one stated order: `_fused_order`, by pair index, every
    pair whose q block it is once; the kernel's struct links them in
    that order (first flag, next CTA and pair) and the twin adds them in
    it too (its loop runs pair index by pair index)."""
    for nk in range(1, 9):
        rows, _ = tfa._fused_plan(nk, causal, d)
        order = tfa._fused_order(rows)
        assert sorted(order) == list(range(nk))
        for j, parts in order.items():
            want = sorted(((c, p) for c, row in enumerate(rows)
                           for p, pair in enumerate(row)
                           if pair is not None and pair[1] == j),
                          key=lambda at: at[1])
            assert parts == want, (nk, j)
            assert len({p for _, p in parts}) == len(parts), (nk, j)
        assert _partials_by_links(tfa._FusedPlan.of(nk, causal, d)) == \
            order, nk


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_fused_plan_batons_run_to_completion(causal, d):
    """The kernel's waits cannot deadlock: with each CTA taking its pairs
    in order and each add waiting for the one before it in its q block
    (the struct's links), every add of every cluster size runs, each q
    block's in its stated order; every baton is passed once."""
    for nk in range(1, 9):
        plan = tfa._FusedPlan.of(nk, causal, d)
        n = [plan.n[c] for c in range(plan.ctas)]
        order = _partials_by_links(plan)
        ran = _run_batons(n, order)
        assert ran is not None, nk
        for parts in order.values():
            assert [at for at in ran if at in parts] == parts, nk
        passed = [(plan.next_cta[c][p], plan.next_pair[c][p])
                  for c in range(plan.ctas) for p in range(n[c])
                  if plan.next_cta[c][p] >= 0]
        waits = [(c, p) for c in range(plan.ctas) for p in range(n[c])
                 if not plan.first[c][p]]
        assert sorted(passed) == sorted(waits), nk


def test_fused_baton_simulation_finds_a_deadlock():
    """The simulation is not vacuous: two CTAs whose q blocks' orders
    cross (each one's first add waits for the other's second) stall."""
    n = [2, 2]
    crossed = {0: [(1, 1), (0, 0)], 1: [(0, 1), (1, 0)]}
    assert _run_batons(n, crossed) is None
    assert _run_batons(n, {0: [(0, 0), (1, 1)], 1: [(1, 0), (0, 1)]}) == \
        [(0, 0), (1, 0), (0, 1), (1, 1)]

