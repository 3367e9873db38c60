"""PyTorch port: block-sparse attention's tile walks (the host side of
the K7 kernels): the forward, transpose and band walks cover exactly a
layout's visible scores, each once; the band walk at the Hopper tile
pair visits the tables' pairs; the pair tables walk the square rows
(split out of tests/test_torch_sparse_attention.py to spread the test
clock over workers). Compared exactly.
"""

import numpy as np
import pytest
import torch

from torch_sparse_cases import HOPPER_TILES, _band_layout, tbsa, tsa
from torch_one_thread import one_torch_thread  # noqa: F401


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
