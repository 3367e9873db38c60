"""PyTorch port: block-sparse attention (kernels K7) against the JAX
package.

On the CPU the port's `block_sparse_attention` runs its plain twins (the
K7 kernels' tile walks in PyTorch); these tests hold them against
deepspeed_tpu's `block_sparse_attention` (the Pallas kernels in
interpret mode, as the JAX package's own tests run them) on the same
numpy-seeded inputs, forward and dQ/dK/dV, for the sliding-band, the
aligned-window and the table routes, causal and bidirectional. They also
hold the host code (layouts, tables, band decomposition), the
SparseSelfAttention / BertSparseSelfAttention modules, the utils, the
`sparse_attention` config block and `dense_attention(mask=...)` against
their JAX counterparts. The CUDA kernels are held against the twins on
the card in tests/test_torch_cuda.py.

Tolerances, fp32: outputs atol = rtol = 2e-5 and gradients 1e-4: the
twin walks 64-row tiles in log2 space, the JAX kernel super-rows of up
to 4 layout blocks with natural exp, so the online-softmax sums and the
gradient sums run in another order (the JAX package's own kernel tests
hold the kernel to its dense fallback at 2e-5 and 5e-4). bf16 outputs
(the band twin at the Hopper body's 128 x 64 tile pair against the JAX
kernel in bf16): atol = rtol = 2^-6, two bf16 ulps at |x| in [1, 2):
both round p to bf16 before P.V, each against its own running max (so
at different points), and round the output to bf16 once. Layouts,
tables, walks and config blocks are compared exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa

# the packages export functions under the module names
jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")
jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")
tfa = importlib.import_module(
    "deepspeed_tpu_torch.ops.transformer.flash_attention")

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_OUT_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
# the band forward's tile pair on the Hopper body: 128-row q tiles over
# 64-row k tiles
HOPPER_TILES = tfa._SM90_TILES


def _configs(pkg, h, block):
    """The same configurations built from either package."""
    return [
        pkg.DenseSparsityConfig(num_heads=h, block=block),
        pkg.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=2),
        pkg.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=4,
                                attention="unidirectional"),
        pkg.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=4,
                                horizontal_global_attention=True),
        pkg.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=4,
                                different_layout_per_head=True,
                                num_different_global_patterns=2),
        pkg.VariableSparsityConfig(num_heads=h, block=block,
                                   local_window_blocks=[1, 2],
                                   global_block_indices=[0]),
        pkg.VariableSparsityConfig(num_heads=h, block=block,
                                   num_random_blocks=2,
                                   local_window_blocks=[2, 3],
                                   global_block_indices=[1, 4],
                                   global_block_end_indices=[2, 6],
                                   attention="unidirectional",
                                   different_layout_per_head=True),
        pkg.BigBirdSparsityConfig(num_heads=h, block=block),
        pkg.BigBirdSparsityConfig(num_heads=h, block=block,
                                  num_random_blocks=2,
                                  attention="unidirectional",
                                  different_layout_per_head=True),
        pkg.BSLongformerSparsityConfig(num_heads=h, block=block),
        pkg.BSLongformerSparsityConfig(num_heads=h, block=block,
                                       num_sliding_window_blocks=5,
                                       global_block_indices=[0, 3],
                                       global_block_end_indices=[1, 5],
                                       attention="unidirectional"),
    ]


CONFIG_IDS = ["dense", "fixed", "fixed-uni", "fixed-horizontal",
              "fixed-per-head", "variable", "variable-random-uni-per-head",
              "bigbird", "bigbird-uni-per-head", "bslongformer",
              "bslongformer-uni-ranges"]


@pytest.mark.parametrize("i", range(len(CONFIG_IDS)), ids=CONFIG_IDS)
@pytest.mark.parametrize("t,block", [(512, 32), (512, 128)])
def test_layouts_match_jax(i, t, block):
    got = _configs(tsa, 4, block)[i].make_layout(t)
    want = _configs(jsa, 4, block)[i].make_layout(t)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_layout_seq_len_must_divide():
    with pytest.raises(ValueError):
        tsa.FixedSparsityConfig(num_heads=2, block=32).make_layout(100)


@pytest.mark.parametrize("i", range(len(CONFIG_IDS)), ids=CONFIG_IDS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tables_and_band_decomposition_match_jax(i, causal):
    layout = _configs(jsa, 4, 32)[i].make_layout(512)
    for qt in (1, 2, 4):
        got = tbsa._build_tables(layout, causal, qt)
        want = jbsa._build_tables(layout, causal, qt)
        for a, b in zip(got, want[:9]):      # JAX's last entry is g
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tbsa._band_decompose(layout, causal) == \
        jbsa._band_decompose(layout, causal)
    np.testing.assert_array_equal(
        tbsa.layout_to_dense_mask(layout, 512, 32),
        jbsa.layout_to_dense_mask(layout, 512, 32))


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tile_walks_visit_every_visible_score_once(block, causal):
    """The kernels' walks (forward table, transpose table and, where the
    layout decomposes, the band walk) cover exactly the layout's visible
    scores (element-level causal), each once."""
    t = 512
    for cfg in (tsa.FixedSparsityConfig(num_heads=1, block=block,
                                        num_local_blocks=3),
                tsa.BSLongformerSparsityConfig(
                    num_heads=1, block=block, num_sliding_window_blocks=4,
                    attention="unidirectional"),
                tsa.BigBirdSparsityConfig(num_heads=1, block=block)):
        layout = cfg.make_layout(t)
        plan = tbsa._Plan(layout, causal, block, tbsa.TILE,
                          torch.device("cpu"))
        want = torch.as_tensor(tbsa.layout_to_dense_mask(layout, t,
                                                         block)[0])
        if causal:
            want &= torch.ones((t, t), dtype=torch.bool).tril()
        walks = [(tbsa._table_steps(plan, False, "cpu"), False),
                 (tbsa._table_steps(plan, True, "cpu"), True)]
        if plan.band is not None:
            walks.append((tbsa._band_steps(plan, "cpu"), False))
        for steps, transpose in walks:
            seen = torch.zeros((t, t), dtype=torch.long)
            for idx, vis in steps:
                for own in range(plan.nt):
                    other = int(idx[0, own])
                    rows, cols = (other, own) if transpose else (own, other)
                    seen[rows * 64:(rows + 1) * 64,
                         cols * 64:(cols + 1) * 64] += vis[0, own].long()
            assert torch.equal(seen, want.long())


# the band layouts of the Hopper walk's cases, by (block, kind, causal):
# sliding = BSLongformer (unidirectional with its global column when
# causal, bidirectional without globals when not), aligned = Fixed with
# 4-block windows and their global columns; T takes 5-8 layout blocks and
# is no multiple of 128 at blocks 16-64 (the last q tile runs past T),
# where a 128-row q tile also straddles layout blocks
BAND_T = {16: 320, 32: 320, 64: 448, 128: 768, 256: 1536}


def _band_layout(block, kind, causal, h=2):
    t = BAND_T[block]
    if kind == "sliding":
        cfg = tsa.BSLongformerSparsityConfig(
            num_heads=h, block=block, num_sliding_window_blocks=3,
            **({"attention": "unidirectional"} if causal else
               {"global_block_indices": []}))
    else:
        cfg = tsa.FixedSparsityConfig(
            num_heads=h, block=block, num_local_blocks=4,
            attention="unidirectional" if causal else "bidirectional")
    layout = cfg.make_layout(t)
    assert tbsa._band_decompose(layout, causal)[0] == kind
    return layout, t


@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("kind", ["sliding", "aligned"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_hopper_band_walk_visits_the_tables_pairs(block, kind, causal):
    """The band walk at 128 x 64 tiles visits exactly the (64-row q half,
    k tile) pairs that the 64 x 64 forward table holds, each once, and
    covers exactly the visible scores (rows past T see nothing)."""
    layout, t = _band_layout(block, kind, causal)
    cpu = torch.device("cpu")
    tables = tbsa._Plan(layout, causal, block, tbsa.TILE, cpu)
    walk = tbsa._Plan(layout, causal, block, HOPPER_TILES, cpu)
    want = {(qt, int(kt)) for qt in range(tables.nt)
            for kt, bits in zip(tables.kidx_h[0, qt], tables.kmask_h[0, qt])
            if bits}
    dense = torch.as_tensor(tbsa.layout_to_dense_mask(layout, t, block)[0])
    if causal:
        dense &= torch.ones((t, t), dtype=torch.bool).tril()
    got, seen = [], torch.zeros((t, t), dtype=torch.long)
    for idx, vis in tbsa._band_steps(walk, "cpu"):
        for qt in range(idx.shape[1]):
            kt, v = int(idx[0, qt]), vis[0, qt]
            rows = min(128, t - qt * 128)
            assert not v[rows:].any()
            seen[qt * 128:qt * 128 + rows, kt * 64:(kt + 1) * 64] += \
                v[:rows].long()
            got += [(2 * qt + half, kt) for half in (0, 1)
                    if v[half * 64:(half + 1) * 64].any()]
    assert len(got) == len(set(got)) and set(got) == want
    assert torch.equal(seen, dense.long())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", ["sliding", "aligned"])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
def test_hopper_band_twin_matches_jax(block, kind, causal, dtype):
    """The band twin at the Hopper body's 128 x 64 tile pair (the walk
    and rounding order of K7-band on the card) against the JAX package's
    band kernel in interpret mode, forward, at D 64. In bf16 the public
    route on the CPU takes that pair too and gives the same bits."""
    layout, t = _band_layout(block, kind, causal)
    q, k, v, _ = _qkv(1, t, 2, 64, seed=block + causal)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jbsa.block_sparse_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), layout, block,
        causal=causal, interpret=True)
    xs = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    plan = tbsa._plan(layout, causal, block, HOPPER_TILES,
                      torch.device("cpu"))
    got, _ = tbsa._band_fwd_plain(*xs, plan, 64 ** -0.5)
    tol = BF16_OUT_TOL if dtype == torch.bfloat16 else OUT_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    if dtype == torch.bfloat16:
        assert torch.equal(tsa.block_sparse_attention(*xs, layout, block,
                                                      causal=causal), got)


# the pair tables' layouts, by block: Fixed and BSLongformer (bands with
# global columns), BigBird (random blocks) and a per-head Variable layout;
# T = 448 (the last 128-row tile's lower half lies past T) where the
# block divides it, else 8 blocks
PAIR_T = {16: 448, 32: 448, 64: 448, 128: 1024, 256: 2048}


def _pair_layouts(block):
    t = PAIR_T[block]
    cfgs = (tsa.FixedSparsityConfig(num_heads=2, block=block,
                                    num_local_blocks=3),
            tsa.BSLongformerSparsityConfig(num_heads=2, block=block,
                                           num_sliding_window_blocks=3),
            tsa.BigBirdSparsityConfig(num_heads=2, block=block),
            tsa.VariableSparsityConfig(num_heads=3, block=block,
                                       num_random_blocks=1,
                                       local_window_blocks=[1, 2],
                                       global_block_indices=[0],
                                       different_layout_per_head=True))
    return [c.make_layout(t) for c in cfgs], t


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
def test_pair_tables_walk_the_square_rows(block, causal):
    """The Hopper backward's tables at 128 x 64 (the forward table for dQ,
    the transpose table for dK/dV): each 64-row half of a 128-row row
    lists exactly its square-table row, in order, with the same bits;
    steps where a half does not list the tile, past the row's count, or
    a half past T carry bits 0; the walk covers every visible score once
    (element-level causal); the CTA order is longest walk first."""
    cpu = torch.device("cpu")
    layouts, t = _pair_layouts(block)
    for layout in layouts:
        square = tbsa._plan(layout, causal, block, tbsa.TILE, cpu)
        pair = tbsa._plan(layout, causal, block, HOPPER_TILES, cpu)
        assert pair.head_map is square.head_map
        want = torch.as_tensor(tbsa.layout_to_dense_mask(layout, t, block))
        if causal:
            want &= torch.ones((t, t), dtype=torch.bool).tril()
        for name, transpose, (idx, cnt, mask) in (
                ("dq", False, (square.kidx, square.kcnt, square.kmask)),
                ("dkv", True, (square.qidx, square.qcnt, square.qmask))):
            steps, count, width, order = pair.pairs[name]
            n2 = -(-square.nt // 2)
            assert steps.shape == (len(idx), n2, 3, width)
            for u in range(len(idx)):
                for r in range(n2):
                    live = steps[u, r, :, :count[u, r]]
                    assert (np.diff(live[0]) > 0).all()
                    assert not steps[u, r, :, count[u, r]:].any()
                    for half in (0, 1):
                        row = 2 * r + half
                        got = [(int(c), int(b)) for c, b in
                               zip(live[0], live[1 + half]) if b]
                        sq = [] if row >= square.nt else [
                            (int(c), int(b)) for c, b in
                            zip(idx[u, row, :cnt[u, row]],
                                mask[u, row, :cnt[u, row]])]
                        assert got == sq, (name, u, r, half)
            per_head = count[pair.head_map].reshape(-1)
            assert sorted(order) == list(range(per_head.size))
            assert (np.diff(per_head[order]) <= 0).all()
            seen = torch.zeros((layout.shape[0], t, t), dtype=torch.int16)
            for tiles, vis in tbsa._pair_steps(pair, transpose, cpu):
                for h in range(layout.shape[0]):
                    for r in range(n2):
                        c = int(tiles[h, r]) * 64
                        rows = slice(r * 128, min(t, r * 128 + 128))
                        v = vis[h, r]
                        if transpose:
                            assert not v[:, t - r * 128:].any()
                            seen[h, c:c + 64, rows] += v[:, :t - r * 128]
                        else:
                            assert not v[t - r * 128:].any()
                            seen[h, rows, c:c + 64] += v[:t - r * 128]
            assert torch.equal(seen, want.to(torch.int16)), name


def test_hopper_backward_raises_past_its_longest_walk():
    """The Hopper backward's shared memory holds a walk of 512 steps
    (every 64-row tile of T = 32768); a longer transpose row (a global
    column at T = 32832) raises on the host before any launch."""
    layout = tsa.BSLongformerSparsityConfig(
        num_heads=1, block=64, num_sliding_window_blocks=3).make_layout(32832)
    plan = tbsa._plan(layout, True, 64, HOPPER_TILES, torch.device("cpu"))
    assert plan.pairs["dkv"][2] == 513 > tbsa._SM90_MAX_STEPS
    x = torch.zeros((1, 32832, 1, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 32832))
    with pytest.raises(ValueError, match="512"):
        tbsa._bs_bwd_dkv_sm90_launch(x, x, x, x, lse, x, plan, 0.125)


def _qkv(b, t, h, d, seed):
    r = np.random.RandomState(seed)
    return [r.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


def _jax_fwd_bwd(q, k, v, g, layout, block, causal):
    def f(q, k, v):
        return jbsa.block_sparse_attention(q, k, v, layout, block,
                                           causal=causal, interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


def _torch_fwd_bwd(q, k, v, g, layout, block, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = tsa.block_sparse_attention(qt, kt, vt, layout, block,
                                     causal=causal)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    return [x.detach().numpy() for x in (out, *grads)]


ROUTES = [
    # (id, config, T, H, block, causal, expected band kind or None)
    ("sliding-b32", lambda h, b: jsa.BSLongformerSparsityConfig(
        num_heads=h, block=b, num_sliding_window_blocks=3), 256, 2, 32,
     True, "sliding"),
    ("sliding-b64", lambda h, b: jsa.BSLongformerSparsityConfig(
        num_heads=h, block=b, num_sliding_window_blocks=4), 512, 2, 64,
     True, "sliding"),
    ("aligned-b32-full", lambda h, b: jsa.FixedSparsityConfig(
        num_heads=h, block=b, num_local_blocks=2), 256, 2, 32, False,
     "aligned"),
    ("aligned-b64-causal", lambda h, b: jsa.FixedSparsityConfig(
        num_heads=h, block=b, num_local_blocks=4), 512, 2, 64, True,
     "aligned"),
    ("table-bigbird-causal", lambda h, b: jsa.BigBirdSparsityConfig(
        num_heads=h, block=b), 256, 2, 32, True, None),
    ("table-bigbird-full-b64", lambda h, b: jsa.BigBirdSparsityConfig(
        num_heads=h, block=b), 512, 2, 64, False, None),
    ("table-per-head", lambda h, b: jsa.VariableSparsityConfig(
        num_heads=h, block=b, num_random_blocks=1,
        local_window_blocks=[2], different_layout_per_head=True), 256, 2,
     32, False, None),
    ("lse2d-eight-heads", lambda h, b: jsa.FixedSparsityConfig(
        num_heads=h, block=b, num_local_blocks=2, num_global_blocks=1),
     256, 8, 32, True, "sliding"),
    # blocks under 16 take no kernel: the twins walk tiles of one block
    ("sliding-b8-twin-only", lambda h, b: jsa.BSLongformerSparsityConfig(
        num_heads=h, block=b, num_sliding_window_blocks=3), 128, 2, 8,
     True, "sliding"),
    ("table-b8-twin-only", lambda h, b: jsa.BigBirdSparsityConfig(
        num_heads=h, block=b), 128, 2, 8, False, None),
]


# the pair tables' twin against the JAX VJP: (id, config, T, block,
# causal) at H 2, D 64; T 448 where the last 128-row tile's lower half
# lies past T
PAIR_ROUTES = [
    ("sliding-b32-causal", lambda b: jsa.BSLongformerSparsityConfig(
        num_heads=2, block=b, num_sliding_window_blocks=3), 448, 32, True),
    ("aligned-b64-full", lambda b: jsa.FixedSparsityConfig(
        num_heads=2, block=b, num_local_blocks=2), 448, 64, False),
    ("bigbird-b16-causal", lambda b: jsa.BigBirdSparsityConfig(
        num_heads=2, block=b), 448, 16, True),
    ("per-head-b32-full", lambda b: jsa.VariableSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1, local_window_blocks=[2],
        global_block_indices=[0], different_layout_per_head=True), 448, 32,
     False),
    ("bigbird-b128-full", lambda b: jsa.BigBirdSparsityConfig(
        num_heads=2, block=b), 512, 128, False),
    ("sliding-b256-causal", lambda b: jsa.BSLongformerSparsityConfig(
        num_heads=2, block=b, num_sliding_window_blocks=3), 768, 256, True),
]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name,make,t,block,causal", PAIR_ROUTES,
                         ids=[r[0] for r in PAIR_ROUTES])
def test_pair_table_backward_twin_matches_jax(name, make, t, block, causal,
                                              dtype):
    """The backward twin on the Hopper pair tables (the walk and rounding
    order of the Hopper K7-dkv and K7-dq) against the JAX package's VJP
    in interpret mode: fp32 by the twin itself, to GRAD_TOL; bf16 through
    the public route on the CPU, which takes the pair tables for the
    backward, to 1e-2 relative L2 (the bf16 gradient tolerance of the
    flash backward's tests: one rounding of each output and of P and dS),
    and bit for bit the twin at the pair."""
    layout = make(block).make_layout(t)
    q, k, v, g = _qkv(1, t, 2, 64, seed=t + block + causal)
    cpu = torch.device("cpu")
    pair = tbsa._plan(layout, causal, block, HOPPER_TILES, cpu)
    if dtype == "fp32":
        want = _jax_fwd_bwd(q, k, v, g, layout, block, causal)
        xs = [torch.from_numpy(x) for x in (q, k, v)]
        out, lse = tbsa._bs_fwd_plain(*xs, tbsa._plan(layout, causal, block,
                                                      tbsa.TILE, cpu), 0.125)
        got = tbsa._bs_bwd_plain(*xs, out, lse, torch.from_numpy(g), pair,
                                 0.125)
        for a, b in zip(got, want[1:]):
            np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)
        return

    def jax_bf16(q, k, v):
        return jbsa.block_sparse_attention(q, k, v, layout, block,
                                           causal=causal, interpret=True)
    _, vjp = jax.vjp(jax_bf16, *(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)))
    want = [np.asarray(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(g, jnp.bfloat16))]
    xs = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
          for x in (q, k, v)]
    gt = torch.from_numpy(g).to(torch.bfloat16)
    out = tsa.block_sparse_attention(*xs, layout, block, causal=causal)
    got = torch.autograd.grad(out, xs, gt)
    for a, b in zip(got, want):
        a = a.float().numpy()
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-2
    plain = tbsa._band_fwd_plain if pair.band is not None else \
        tbsa._bs_fwd_plain
    d = [x.detach() for x in xs]
    o, lse = plain(*d, pair, 0.125)
    assert torch.equal(o, out.detach())
    twin = tbsa._bs_bwd_plain(*d, o, lse, gt, pair, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, twin))


# the table forward's pair-table twin against the JAX forward: (id,
# config, block, causal) at H 2 and T 320 (the last 128-row q tile's
# lower half lies past T), layouts `_band_decompose` rejects
PAIR_FWD_ROUTES = [
    ("bigbird-b64-full", lambda b: jsa.BigBirdSparsityConfig(
        num_heads=2, block=b), 64, False),
    ("bigbird-b32-causal", lambda b: jsa.BigBirdSparsityConfig(
        num_heads=2, block=b), 32, True),
    ("per-head-b32-full", lambda b: jsa.VariableSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1, local_window_blocks=[2],
        global_block_indices=[0], different_layout_per_head=True), 32,
     False),
    ("per-head-b64-causal", lambda b: jsa.VariableSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1, local_window_blocks=[1, 2],
        global_block_indices=[0], different_layout_per_head=True), 64, True),
]
PAIR_FWD_T = 320


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name,make,block,causal", PAIR_FWD_ROUTES,
                         ids=[r[0] for r in PAIR_FWD_ROUTES])
def test_pair_table_forward_twin_matches_jax(name, make, block, causal, d):
    """K7-fwd's twin on the forward pair table (the Hopper table
    forward's walk: 128-row q tiles over 64-row k tiles, one sub-block
    mask per half) against the JAX package's forward in interpret mode:
    fp32 by the twin itself, to OUT_TOL; bf16 through the public route on
    the CPU, which takes the pair table for these layouts, to
    BF16_OUT_TOL, and bit for bit the twin at the pair. Rows past T see
    nothing; every real row's lse is finite."""
    t = PAIR_FWD_T
    layout = make(block).make_layout(t)
    cpu = torch.device("cpu")
    pair = tbsa._plan(layout, causal, block, HOPPER_TILES, cpu)
    assert pair.band is None
    q, k, v, _ = _qkv(1, t, 2, d, seed=block + d + causal)

    def jax_fwd(dtype):
        return np.asarray(jbsa.block_sparse_attention(
            *(jnp.asarray(x, dtype) for x in (q, k, v)), layout, block,
            causal=causal, sm_scale=d ** -0.5, interpret=True)
            .astype(jnp.float32))

    out, lse = tbsa._bs_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                  pair, d ** -0.5)
    np.testing.assert_allclose(out.numpy(), jax_fwd(jnp.float32), **OUT_TOL)
    assert bool(torch.isfinite(lse).all())
    xs = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = tsa.block_sparse_attention(*xs, layout, block, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), jax_fwd(jnp.bfloat16),
                               **BF16_OUT_TOL)
    assert torch.equal(got, tbsa._bs_fwd_plain(*xs, pair, d ** -0.5)[0])


def test_cpu_route_takes_the_pair_table_forward_for_bf16(monkeypatch):
    """A bf16 call at head dim 64 on a layout without a band runs the
    table forward's twin on the 128 x 64 pair plan (the Hopper kernel's
    walk), with and without gradients; fp32 keeps the 64-row tables."""
    layout = tsa.BigBirdSparsityConfig(num_heads=2, block=64).make_layout(256)
    walks = []
    real = tbsa._walk_fwd_plain

    def spy(q, k, v, steps, q_tile, tile, sm_scale):
        walks.append((q.dtype, q_tile, tile))
        return real(q, k, v, steps, q_tile, tile, sm_scale)

    monkeypatch.setattr(tbsa, "_walk_fwd_plain", spy)
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(1, 256, 2, 64, seed=5))
    for dtype in (torch.bfloat16, torch.float32):
        xs = [x.to(dtype) for x in (q, k, v)]
        tsa.block_sparse_attention(*xs, layout, 64)
        xs = [x.requires_grad_(True) for x in xs]
        tsa.block_sparse_attention(*xs, layout, 64).float().sum().backward()
    assert walks == [(torch.bfloat16, 128, 64)] * 2 + \
        [(torch.float32, 64, 64)] * 2


def test_hopper_table_forward_raises_past_its_longest_walk():
    """The table forward's shared memory holds a walk of 512 steps; a
    global row of a bidirectional BigBird layout at T = 32832 walks all
    513 k tiles and raises on the host before any launch."""
    layout = tsa.BigBirdSparsityConfig(
        num_heads=1, block=64, num_random_blocks=0,
        num_sliding_window_blocks=1).make_layout(32832)
    plan = tbsa._plan(layout, False, 64, HOPPER_TILES, torch.device("cpu"))
    assert plan.band is None and plan.pairs["dq"][2] == 513
    x = torch.zeros((1, 32832, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="512"):
        tbsa._bs_fwd_sm90_launch(x, x, x, plan, 0.125)


@pytest.mark.parametrize("name,make,t,h,block,causal,kind", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_twin_forward_and_grads_match_jax(name, make, t, h, block, causal,
                                          kind):
    layout = make(h, block).make_layout(t)
    band = tbsa._band_decompose(layout, causal)
    assert (band[0] if band else None) == kind
    q, k, v, g = _qkv(1, t, h, 32, seed=t + h + block + causal)
    want = _jax_fwd_bwd(q, k, v, g, layout, block, causal)
    got = _torch_fwd_bwd(q, k, v, g, layout, block, causal)
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_twins_match_the_dense_fallback_at_blocks_16_and_256():
    """Blocks the JAX tests do not reach: 16 (four sub-blocks per 64-row
    tile side, 16-bit masks) and 256 (one block over four tiles)."""
    for block, t in ((16, 256), (256, 512)):
        cfg = tsa.BSLongformerSparsityConfig(num_heads=2, block=block,
                                             num_sliding_window_blocks=3)
        layout = cfg.make_layout(t)
        q, k, v, g = (torch.from_numpy(x).requires_grad_(True)
                      for x in _qkv(1, t, 2, 32, seed=block))
        for causal in (True, False):
            out = tsa.block_sparse_attention(q, k, v, layout, block,
                                             causal=causal)
            ref = tbsa.block_sparse_attention_dense_fallback(
                q, k, v, layout, block, causal=causal)
            torch.testing.assert_close(out, ref, **OUT_TOL)
            for a, b in zip(torch.autograd.grad(out, (q, k, v), g),
                            torch.autograd.grad(ref, (q, k, v), g)):
                torch.testing.assert_close(a, b, **GRAD_TOL)


def test_dense_attention_mask_matches_jax():
    q, k, v, _ = _qkv(2, 64, 2, 16, seed=3)
    mask = np.where(np.random.RandomState(4).rand(2, 1, 64, 64) < 0.3,
                    -1e30, 0.0).astype(np.float32)
    for causal in (True, False):
        want = jfa.dense_attention(q, k, v, mask=jnp.asarray(mask),
                                   causal=causal)
        got = tfa.dense_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  mask=torch.from_numpy(mask),
                                  causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_sparse_self_attention_with_and_without_masks_matches_jax():
    """Both mask modes of both masks; the attention mask hides one whole
    query row, which both packages then spread evenly over every key."""
    h, t, block = 2, 256, 32
    q, k, v, _ = _qkv(1, t, h, 32, seed=5)
    r = np.random.RandomState(6)
    kpm_add = np.where(np.arange(t) >= t // 2, -1e9, 0.0)[None].astype(
        np.float32)
    kpm_mul = (kpm_add == 0).astype(np.float32)
    am = (r.rand(t, t) < 0.9).astype(np.float32)
    am[7] = 0.0
    rpe = r.randn(1, h, t, t).astype(np.float32) * 0.1
    cases = [("add", "mul", dict()),
             ("add", "mul", dict(key_padding_mask=kpm_add)),
             ("add", "mul", dict(attn_mask=am)),
             ("add", "mul", dict(rpe=rpe, key_padding_mask=kpm_add,
                                 attn_mask=am)),
             ("mul", "add", dict(rpe=rpe, key_padding_mask=kpm_mul,
                                 attn_mask=np.log(am + 1e-3)))]
    for causal in (False, True):
        for kp_mode, am_mode, kw in cases:
            modes = dict(key_padding_mask_mode=kp_mode,
                         attn_mask_mode=am_mode)
            jmod = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(
                num_heads=h, block=block, num_local_blocks=2), **modes)
            tmod = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
                num_heads=h, block=block, num_local_blocks=2), **modes)
            want = jmod(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                        **{n: jnp.asarray(x) for n, x in kw.items()})
            got = tmod(*(torch.from_numpy(x) for x in (q, k, v)),
                       causal=causal,
                       **{n: torch.from_numpy(x) for n, x in kw.items()})
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **OUT_TOL)


def test_bert_sparse_self_attention_matches_jax_with_carried_params():
    from deepspeed_tpu_torch.models.convert import \
        bert_sparse_params_from_jax
    hid, nh, t = 64, 2, 256
    x = np.random.RandomState(7).randn(1, t, hid).astype(np.float32)
    mask = (np.random.RandomState(8).rand(t, t) < 0.95).astype(np.float32)
    jmod = jsa.BertSparseSelfAttention(
        hidden_size=hid, num_attention_heads=nh,
        sparsity_config=jsa.FixedSparsityConfig(num_heads=nh, block=32,
                                                num_local_blocks=2))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tmod = tsa.BertSparseSelfAttention(
        hidden_size=hid, num_attention_heads=nh,
        sparsity_config=tsa.FixedSparsityConfig(num_heads=nh, block=32,
                                                num_local_blocks=2),
        device="cpu")
    tmod.load_state_dict(bert_sparse_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    for attn_mask in (None, mask):
        def loss(p):
            return jnp.sum(jmod.apply(p, jnp.asarray(x), attn_mask if
                                      attn_mask is None else
                                      jnp.asarray(attn_mask)) ** 2)
        want_loss, want_grads = jax.value_and_grad(loss)(params)
        tmod.zero_grad()
        out = tmod(torch.from_numpy(x), None if attn_mask is None else
                   torch.from_numpy(attn_mask))
        got_loss = (out ** 2).sum()
        got_loss.backward()
        np.testing.assert_allclose(got_loss.item(), float(want_loss),
                                   rtol=1e-5)
        got_grads = bert_sparse_params_from_jax(jax.tree_util.tree_map(
            np.asarray, want_grads))
        for name, p in tmod.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(),
                                       got_grads[name].numpy(), **GRAD_TOL)


def test_bert_sparse_self_attention_init_matches_flax_dense():
    """Fresh projections start as flax nn.Dense's: lecun-normal weights
    (std 1/sqrt(fan_in) = 0.03125 at hidden 1024, within 10%; at most
    two truncated stds) and zero biases, against the JAX module's own
    init statistics; the same seed gives the same weights."""
    hid, nh = 1024, 16
    jmod = jsa.BertSparseSelfAttention(hidden_size=hid,
                                       num_attention_heads=nh)
    jparams = jmod.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 256, hid), jnp.float32))["params"]
    tmod = tsa.BertSparseSelfAttention(hid, nh, device="cpu", seed=3)
    for name in ("query", "key", "value"):
        w = getattr(tmod, name).weight.detach()
        jw = np.asarray(jparams[name]["kernel"])
        for std in (float(w.std()), float(jw.std())):
            assert abs(std - 0.03125) <= 0.1 * 0.03125, (name, std)
        limit = 2 * 0.03125 / 0.87962566103423978 + 1e-6
        assert float(w.abs().max()) <= limit
        assert not getattr(tmod, name).bias.detach().any()
        assert not np.asarray(jparams[name]["bias"]).any()
    again = tsa.BertSparseSelfAttention(hid, nh, device="cpu", seed=3)
    assert torch.equal(again.query.weight, tmod.query.weight)


def test_sparse_attention_utils_match_jax():
    ids = np.arange(200).reshape(2, 100).astype(np.int64)
    mask = np.ones((2, 100), np.int64)
    emb = np.random.RandomState(9).randn(2, 100, 8).astype(np.float32)
    table = np.random.RandomState(10).randn(16, 8).astype(np.float32)
    want = jsa.SparseAttentionUtils.pad_to_block_size(
        64, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        inputs_embeds=jnp.asarray(emb), pad_token_id=9,
        model_embeddings=jnp.asarray(table))
    got = tsa.SparseAttentionUtils.pad_to_block_size(
        64, input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(mask),
        inputs_embeds=torch.from_numpy(emb), pad_token_id=9,
        model_embeddings=torch.from_numpy(table))
    assert got[0] == want[0] == 28
    for a, b in zip(got[1:], want[1:]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = tsa.SparseAttentionUtils.unpad_sequence_output(
        28, torch.zeros((2, 128, 8)))
    assert out.shape == (2, 100, 8)
    pe = np.random.RandomState(11).randn(128, 16).astype(np.float32)
    np.testing.assert_array_equal(
        tsa.SparseAttentionUtils.extend_position_embedding(
            torch.from_numpy(pe), 300).numpy(),
        np.asarray(jsa.SparseAttentionUtils.extend_position_embedding(
            pe, 300)))


@pytest.mark.parametrize("block", [
    {"mode": "bigbird", "block": 32, "num_random_blocks": 2},
    {"mode": "bslongformer", "num_sliding_window_blocks": 5, "bogus": 1},
    {"block": 64},
])
def test_sparse_attention_config_block_matches_jax(block):
    from deepspeed_tpu.runtime.config import \
        get_sparse_attention as jget
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    get_sparse_attention)
    d = {"train_batch_size": 2, "sparse_attention": block}
    assert get_sparse_attention(d) == jget(d)
    assert DeepSpeedConfig(d).sparse_attention == jget(d)
    assert get_sparse_attention({}) is None


def test_sparse_attention_config_rejects_unknown_mode():
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfigError,
                                                    get_sparse_attention)
    with pytest.raises(DeepSpeedConfigError):
        get_sparse_attention({"sparse_attention": {"mode": "random"}})


def test_block_sparse_attention_validates_as_jax():
    layout = tsa.FixedSparsityConfig(num_heads=2, block=32).make_layout(256)
    q = torch.zeros((1, 256, 2, 32))
    with pytest.raises(ValueError):
        tsa.block_sparse_attention(q, q, q, layout, 32,
                                   head_packing="packed")
    with pytest.raises(ValueError):
        tsa.block_sparse_attention(q, q, q, layout, 32, head_packing="x")
    with pytest.raises(ValueError):           # layout shape
        tsa.block_sparse_attention(q, q, q, layout[:1], 32)
    no_diag = layout.copy()
    no_diag[:, 3, 3] = 0
    with pytest.raises(ValueError):
        tsa.block_sparse_attention(q, q, q, no_diag, 32, causal=True)
    empty_row = layout.copy()
    empty_row[:, 2] = 0
    with pytest.raises(ValueError):
        tsa.block_sparse_attention(q, q, q, empty_row, 32)
    out = tsa.block_sparse_attention(q, q, q, layout, 32, head_packing="off")
    assert out.shape == q.shape


def test_tables_are_built_once_per_layout():
    layout = tsa.BigBirdSparsityConfig(num_heads=2, block=32).make_layout(256)
    a = tbsa._plan(layout, True, 32, 64, torch.device("cpu"))
    b = tbsa._plan(layout.copy(), True, 32, 64, torch.device("cpu"))
    c = tbsa._plan(layout, False, 32, 64, torch.device("cpu"))
    assert a is b and a is not c
    # the Hopper band forward's plan: its own entry in the one cache,
    # keyed by the tile pair
    band = tsa.FixedSparsityConfig(num_heads=2, block=32).make_layout(256)
    d = tbsa._plan(band, True, 32, HOPPER_TILES, torch.device("cpu"))
    e = tbsa._plan(band, True, 32, 64, torch.device("cpu"))
    assert d is tbsa._plan(band.copy(), True, 32, (128, 64),
                           torch.device("cpu"))
    assert d is not e and (d.q_tile, d.tile) == (128, 64)
    assert (e.q_tile, e.tile) == (64, 64)
    # a layout that does not decompose has a Hopper plan too: the
    # backward's pair tables, built from the cached square plan's
    f = tbsa._plan(layout, True, 32, HOPPER_TILES, torch.device("cpu"))
    assert f.band is None and set(f.pairs) == {"dq", "dkv"}
    assert f.head_map is a.head_map
