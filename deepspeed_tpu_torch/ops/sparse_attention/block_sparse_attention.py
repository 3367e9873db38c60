"""Block-sparse flash attention (kernels K7-fwd, K7-band, K7-dkv, K7-dq).

Port of deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py.
The four Pallas kernels become the entry points of the hand-written
CUDA source `ops/csrc/block_sparse_attention.cu`:

  K7-fwd   `_bs_fwd_kernel`      the table forward (BigBird, per-head
                                 layouts, any layout `_band_decompose`
                                 rejects): in bf16 and fp16 at head dims
                                 64 and 128 on the Hopper body
                                 (`_bs_fwd_sm90_launch`: 128-row q tiles
                                 over the forward pair table), otherwise
                                 on the WMMA body (`_bs_fwd_launch`)
  K7-band  `_band_fwd_kernel`    the band + global forward (BSLongformer,
                                 Fixed): in bf16 and fp16 at head dims 64
                                 and 128 on the Hopper body of
                                 `ops/csrc/attention_hopper.cuh`
                                 (`_band_fwd_sm90_launch`: TMA, wgmma,
                                 128-row q tiles over 64-row k tiles),
                                 otherwise on the WMMA body
                                 (`_band_fwd_launch`, 64 x 64 tiles)
  K7-dkv   `_bs_bwd_dkv_kernel`  dK and dV over the transpose table
  K7-dq    `_bs_bwd_dq_kernel`   dQ over the forward table: both in bf16
                                 and fp16 at head dims 64 and 128 on the
                                 Hopper sweeps of `attention_hopper.cuh`
                                 (`_bs_bwd_dkv_sm90_launch`,
                                 `_bs_bwd_dq_sm90_launch`: 128-row
                                 resident tiles, 64-row steps by TMA,
                                 wgmma), otherwise on the WMMA bodies
                                 (`_bs_bwd_dkv_launch`, `_bs_bwd_dq_launch`)

The fp16 forms are the Hopper kernels' (the same bodies, instantiated
on `__half`: `wgmma .f16`, fp16 tensor maps); the WMMA bodies take fp32
and bf16, so fp16 on their route (a tile other than 64 rows) raises
`FP16_WMMA_LATER`. On the card every fp16 call takes the Hopper route:
the padding below brings T to a multiple of 64 and D to 64 or 128.

The backward always runs the table kernels, whatever the forward took,
as in the JAX package. The host code is the JAX package's, copied:
`_build_tables`, `_band_decompose`, `layout_to_dense_mask` and the
validations of `block_sparse_attention`. The WMMA kernels walk 64-row
tiles (`TILE`), so their tables are `_build_tables` at tile granularity
(`_tile_tables`): a layout block of 16 or 32 puts several blocks in one
tile, and each table entry carries a bit mask of the visible sub-blocks
of its tile pair. The Hopper kernels keep 128-row tiles resident and
stream 64-row ones (`_hopper_tiles`): the band forward walks its band,
and the table forward and the backward walk pair tables
(`_pair_tables`), the square tables' rows taken two at a time, each step
with one sub-block mask per 64-row half. One plan serves a call's
forward and backward. The TPU launcher's super-rows (`qt`) and head groups (`g`)
amortised its grid-step overhead and have no counterpart here.

The plain twins `_bs_fwd_plain`, `_band_fwd_plain` and `_bs_bwd_plain`
run the kernels' algorithms in PyTorch: the same tile walks at the same
tile pairs (all tiles of a walk step at once), the online softmax in log2 space with masked
scores at -1e30, fp32 sums, p and dS rounded to the input dtype before
their products. A CPU tensor takes the twins; a CUDA tensor launches the
kernels or raises on what they do not take (a head dim above 128, a
block other than 16-256, fp16 on the WMMA bodies). On the card,
`block_sparse_attention` pads a T that is no multiple of 64 with layout
blocks that no row sees and whose rows see nothing, and a head dim
under 128 with zeros to 64 or 128 (sm_scale from the true head dim);
the padding is sliced off the output and so off dQ/dK/dV. The twins
take those shapes as they are: their tile is the layout block where 64
does not fit or the block is under 16.

Built tables and their device copies are cached by (layout bytes,
causal, block, tile pair, device), so the host work and the copy to the
card happen once per layout and tile pair, not once per call.
"""

import ctypes
import threading
from collections import OrderedDict

import numpy as np
import torch

from deepspeed_tpu_torch.profiling.flops_profiler.profiler import \
    kernel_call
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    _DTYPE_CODE, _SM90_TILES, LOG2E, NEG_INF, _check_kernel_operand,
    _kernel_readable, _on_sm90, _strides, dense_attention)

# the kernels' tile: 64 query rows x 64 key rows per step (the Hopper
# bodies: 128 resident rows x 64 streamed rows, `_hopper_tiles`)
TILE = 64
_KERNEL_HEAD_DIMS = (64, 128)
FP16_WMMA_LATER = (
    "block-sparse kernels: fp16 runs the Hopper kernels (head dims 64 and "
    "128 at the 64-row tile); the WMMA kernels' fp16 form is not in the "
    "port: ROADMAP Queue 2 item 9")
_KERNEL_BLOCKS = (16, 32, 64, 128, 256)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
_FWD_ARGTYPES = [_P] * 5 + [_I] * 4 + [_LL, _F, _I] + [_P] * 4 + \
    [_I] * 3 + [_I, _I, _P]
_BAND_ARGTYPES = [_P] * 5 + [_I] * 4 + [_LL, _F, _I] + [_I] * 3 + \
    [_P, _I, _P, _I] + [_I, _I, _P]
# the Hopper band forward's: nmax, the longest walk, after sub_shift
_BAND90_ARGTYPES = _BAND_ARGTYPES[:-3] + [_I] + _BAND_ARGTYPES[-3:]
_DKV_ARGTYPES = [_P] * 9 + [_I] * 4 + [_LL, _F, _F, _I] + [_P] * 4 + \
    [_I] * 3 + [_I, _I, _P]
_DQ_ARGTYPES = [_P] * 7 + [_I] * 4 + [_LL, _F, _F, _I] + [_P] * 4 + \
    [_I] * 3 + [_I, _I, _P]
# the Hopper table forward's and backward's: the pair tables (head_map,
# steps, count, order), their width and sub_shift
_FWD90_ARGTYPES = _FWD_ARGTYPES[:-6] + [_I] * 2 + _FWD_ARGTYPES[-3:]
_DKV90_ARGTYPES = _DKV_ARGTYPES[:-6] + [_I] * 2 + _DKV_ARGTYPES[-3:]
_DQ90_ARGTYPES = _DQ_ARGTYPES[:-6] + [_I] * 2 + _DQ_ARGTYPES[-3:]
# the longest pair-table walk the Hopper table forward and backward take
# (their shared memory holds the walk): every 64-row tile of T = 32768,
# the transpose row of a global column (or, bidirectionally, the forward
# row of a global row) at the sparse path's longest shape
_SM90_MAX_STEPS = 512


# ----------------------------------------------------------------------
# layout -> visible-tile tables (the JAX package's host code)
# ----------------------------------------------------------------------
def _visible_lists(bits):
    """[U, R, C] int bit masks -> (idx [U, R, m], cnt [U, R],
    mask [U, R, m], m): per row, the columns whose mask is nonzero in
    ascending order, padded with column 0 and mask 0 (m >= 1)."""
    nz = bits != 0
    cnt = nz.sum(axis=2).astype(np.int32)
    m = max(1, int(cnt.max()))
    # a stable sort on "is zero" puts the nonzero columns first, in order
    order = np.argsort(~nz, axis=2, kind="stable")[:, :, :m]
    live = np.arange(m)[None, None, :] < cnt[..., None]
    idx = np.where(live, order, 0).astype(np.int32)
    mask = np.where(live, np.take_along_axis(bits, order, axis=2), 0)
    return idx, cnt, mask.astype(np.int32), m


def _build_tables(layout, causal, qt, kt=1):
    """Concrete [H, nq, nk] layout -> visible-block index tables over
    SUPER-ROWS of `qt` consecutive layout rows and super-columns of `kt`
    layout columns (the JAX package's tables are kt = 1):

      head_map [H]            head -> unique-layout index u
      kidx [U*nqs*kmax]       visible key super-columns per q super-row
      kcnt [U*nqs]            count per q super-row
      kmask [U*nqs*kmax]      per-entry bit mask, bit (i * kt + j) set
                              when member row i sees member column j
      qidx/qcnt/qmask         the transpose (visible q super-rows per
                              key super-column) for the dK/dV sweep

    Causality is folded in at block granularity (column <= row), so the
    kernels visit only tiles that hold a visible score. Padding repeats
    index 0 with an all-zero mask. The JAX package's head-group size `g`
    is a TPU grid device and is not built."""
    lay = np.asarray(layout, np.int32)
    unique, inverse = np.unique(lay, axis=0, return_inverse=True)
    U, nq, nk = unique.shape
    assert nq % qt == 0 and nk % kt == 0
    vis = unique != 0
    if causal:
        vis = vis & np.tril(np.ones((nq, nk), bool))[None]
    shift = np.arange(qt)[:, None] * kt + np.arange(kt)[None, :]
    bits = (vis.reshape(U, nq // qt, qt, nk // kt, kt).astype(np.int64) <<
            shift[None, None, :, None, :]).sum(axis=(2, 4))
    kidx, kcnt, kmask, kmax = _visible_lists(bits)
    qidx, qcnt, qmask, qmax = _visible_lists(bits.transpose(0, 2, 1))
    return (np.asarray(inverse, np.int32).reshape(-1), kidx.reshape(-1),
            kcnt.reshape(-1), kmask.reshape(-1), qidx.reshape(-1),
            qcnt.reshape(-1), qmask.reshape(-1), kmax, qmax)


def _tile_tables(layout, causal, block, tile=TILE):
    """`_build_tables` over `tile`-row tiles: the layout is taken to
    sub-blocks of min(block, tile) rows (a block larger than the tile
    repeats over its tiles), and each tile holds rr x rr sub-blocks
    (rr = tile // sub-block), mask bit (i * rr + j) for q sub-row i and
    k sub-column j."""
    lay = np.asarray(layout, np.int32)
    if block > tile:
        e = block // tile
        lay = lay.repeat(e, axis=1).repeat(e, axis=2)
    rr = tile // min(block, tile)
    if rr > 4:
        raise ValueError(f"block {block} in a {tile}-row tile needs "
                         f"{rr * rr} sub-block mask bits; the tables hold 16")
    return _build_tables(lay, causal, rr, rr)


def _band_decompose(layout, causal, max_globals=64, max_band_blocks=64):
    """Causal-folded layout -> ("sliding"|"aligned", w, global_cols)
    when it is EXACTLY a width-w block window (sliding band, or
    window-ALIGNED block-diagonal groups — the reference Fixed
    pattern's "local" attention, `sparsity_config.py:94`) plus a set
    of globally-visible block columns; None otherwise (BigBird random
    blocks, per-head layouts).

    BSLongformer decomposes as sliding, Fixed as aligned; the band
    forward then walks one closed-form band/window span per q tile plus
    the global columns instead of a visible-block table."""
    lay = np.asarray(layout, np.int32)
    if lay.ndim == 3:
        if not (lay == lay[:1]).all():
            return None            # per-head layouts: table path
        lay = lay[0]
    vis = lay != 0
    nq = vis.shape[0]
    if causal:
        vis = vis & np.tril(np.ones_like(vis, dtype=bool))
    rows_i, cols_j = np.nonzero(vis)
    # global columns: visible from EVERY (causal-)eligible row
    gcols = []
    for j in range(nq):
        rows_seeing = vis[:, j]
        expect = np.arange(nq) >= j if causal else np.ones(nq, bool)
        if (rows_seeing == expect).all():
            gcols.append(j)
    gset = set(gcols)
    if len(gcols) > max_globals:
        return None
    off_band = [(i, j) for i, j in zip(rows_i, cols_j) if j not in gset]
    ii = np.arange(nq)[:, None]
    jj = np.arange(nq)[None, :]
    tril = np.tril(np.ones_like(vis, dtype=bool))

    def matches(base):
        expected = base.copy()
        for j in gcols:
            expected[:, j] |= (np.arange(nq) >= j) if causal else True
        if causal:
            expected &= tril
        return np.array_equal(vis, expected)

    # (a) sliding band of width w
    w = max((i - j + 1 for i, j in off_band), default=1)
    if w <= max_band_blocks:
        band = (jj <= ii) & (jj >= ii - w + 1) if causal else \
            (np.abs(ii - jj) < w)
        if matches(band):
            return "sliding", int(w), tuple(int(j) for j in gcols)
    # (b) window-aligned block-diagonal of width w: row i sees cols of
    # its own window floor(i/w) (the Fixed pattern's local part). The
    # minimal candidate w comes from the same max-offset statistic.
    for wa in range(max(w, 1), max_band_blocks + 1):
        aligned = (ii // wa) == (jj // wa)
        if matches(aligned):
            return "aligned", int(wa), tuple(int(j) for j in gcols)
    return None


def _band_span(band, block, nb, causal, tile, qt, q_tile=None):
    """[lo, hi], in k tiles of `tile` rows, of the band span of q tiles
    `qt` (an int array) of `q_tile` rows (default `tile`): the union over
    their rows of the band/window key blocks (the band kernels'
    `band_walk` and `band_walk90` compute the same per CTA)."""
    kind, w, _ = band
    q_tile = q_tile or tile
    qb_lo = qt * q_tile // block
    qb_hi = (qt * q_tile + q_tile - 1) // block
    if kind == "aligned":
        kb_lo = qb_lo // w * w
        kb_hi = qb_hi // w * w + w - 1
    else:
        kb_lo = qb_lo - (w - 1)
        kb_hi = qb_hi + (w - 1)
    if causal:
        kb_hi = np.minimum(kb_hi, qb_hi)
    kb_lo = np.maximum(kb_lo, 0)
    kb_hi = np.minimum(kb_hi, nb - 1)
    lo = kb_lo * block // tile
    hi = ((kb_hi + 1) * block - 1) // tile
    if causal:
        hi = np.minimum(hi, (qt * q_tile + q_tile - 1) // tile)
    return lo, hi


def _band_globals(band, block, t, tile):
    """(gtiles [ng], gbits [t/tile]) of the global columns: the tiles
    that hold one, ascending, and per tile the bit mask of its global
    sub-blocks (min(block, tile) rows each)."""
    sub = min(block, tile)
    gbits = np.zeros(t // tile, np.int32)
    for j in band[2]:
        for sb in range(j * block // sub, (j + 1) * block // sub):
            gbits[sb * sub // tile] |= 1 << (sb % (tile // sub))
    return np.nonzero(gbits)[0].astype(np.int32), gbits


def _band_walks(band, block, t, causal, tile, q_tile=None):
    """The band kernel's walk of every q tile (`q_tile` rows, default
    `tile`; the last one may run past t) over k tiles of `tile` rows,
    padded to one length: (kt [nq, n] key tiles, in_band [nq, n], valid
    [nq, n]). Each q tile visits, in ascending order, the global tiles
    before its band span, the span, and the global tiles after it
    (causal: up to the tile of its last row); a global tile inside the
    span is visited once, in the span."""
    q_tile = q_tile or tile
    nq = -(-t // q_tile)
    gtiles, _ = _band_globals(band, block, t, tile)
    walks = []
    for qt in range(nq):
        lo, hi = (int(x) for x in _band_span(band, block, t // block,
                                              causal, tile, np.int64(qt),
                                              q_tile))
        last = (qt * q_tile + q_tile - 1) // tile
        before = [(int(g), False) for g in gtiles if g < lo]
        after = [(int(g), False) for g in gtiles
                 if g > hi and (not causal or g <= last)]
        walks.append(before + [(kt, True) for kt in range(lo, hi + 1)] +
                     after)
    n = max(len(wk) for wk in walks)
    kt = np.zeros((nq, n), np.int64)
    in_band = np.zeros((nq, n), bool)
    valid = np.zeros((nq, n), bool)
    for qt, wk in enumerate(walks):
        for s, (tile_idx, band_step) in enumerate(wk):
            kt[qt, s], in_band[qt, s], valid[qt, s] = tile_idx, band_step, 1
    return kt, in_band, valid


def layout_to_dense_mask(layout, seq_len, block):
    """[H, nq, nk] block layout -> [H, T, T] boolean mask (the dense
    fallback's mask and the ground truth for kernel tests)."""
    lay = np.asarray(layout, bool)
    return np.kron(lay, np.ones((block, block), dtype=bool))


# ----------------------------------------------------------------------
# the cached tables of one (layout, causal, block, tile pair, device)
# ----------------------------------------------------------------------
def _tile_pair(tile):
    """(q rows, k rows) of a square tile or a pair."""
    if np.ndim(tile) == 0:
        return int(tile), int(tile)
    return tuple(int(x) for x in tile)


def _pair_tables(idx, cnt, mask):
    """A square tile table (idx, mask [U, n, m], cnt [U, n]: per row the
    visible columns, ascending, with their sub-block masks) -> the same
    table over rows taken in pairs (rows 2i and 2i + 1; a last row alone
    pairs with an empty one): (steps [U, n2, 3, m2], count [U, n2], m2).
    Row i of it lists the ascending union of the pair's columns (steps
    [..., 0, :]) and, per step, each member row's mask of that column
    (steps [..., 1 + half, :]), 0 where the row does not list it; steps
    past the count repeat column 0 with masks 0. Each half thus walks
    exactly its square row, with its bits (`_pair_steps`)."""
    u, n, m = idx.shape
    dense = np.zeros((u, n + n % 2, n), np.int32)
    uu, rr, ss = np.nonzero(np.arange(m)[None, None, :] < cnt[..., None])
    dense[uu, rr, idx[uu, rr, ss]] = mask[uu, rr, ss]
    halves = dense.reshape(u, -1, 2, n)
    seen = (halves != 0).any(axis=2)
    count = seen.sum(axis=2).astype(np.int32)
    m2 = max(1, int(count.max()))
    order = np.argsort(~seen, axis=2, kind="stable")[:, :, :m2]
    live = np.arange(m2)[None, None, :] < count[..., None]
    cols = np.where(live, order, 0)
    bits = np.where(live[:, :, None, :],
                    np.take_along_axis(halves, order[:, :, None, :], axis=3),
                    0)
    steps = np.concatenate([cols[:, :, None, :], bits], axis=2)
    return steps.astype(np.int32), count, m2


def _longest_first(count, head_map):
    """The (head, row) pairs of a pair table, longest walk first (the
    LPT rule: the CTAs that take longest start first, so the grid's last
    wave holds short ones); ties head-major, rows ascending: [H * n2] of
    h * n2 + row."""
    per_head = count[head_map].reshape(-1)
    return np.argsort(-per_head, kind="stable").astype(np.int32)


class _Plan:
    """Host tables of one layout at one tile pair and their int32 copies
    on `device`.

    A square tile (`q_tile == tile`) holds, for the table kernels, the
    forward table (visible k tiles per q tile) and the transpose table
    (visible q tiles per k tile) with their sub-block masks, per unique
    layout (`head_map`: head -> unique layout); for a layout
    `_band_decompose` accepts, the band, its global tiles and the band
    walks. The Hopper pair (128-row resident tiles over 64-row streamed
    ones) holds the band where the layout decomposes (the band forward)
    and, for every layout, the Hopper backward's tables, built from the
    square plan's by `_pair_tables`: `dq` the forward table over 128-row
    q tiles (dQ), `dkv` the transpose table over 128-row k tiles (dK/dV),
    each with its row counts and its CTA order (`_longest_first`). The
    twins read the per-head numpy views (`*_h`)."""

    def __init__(self, layout, causal, block, tile, device):
        nb = layout.shape[1]
        self.visible = visible_scores(layout, block, causal)
        self.q_tile, self.tile = _tile_pair(tile)
        tile = self.tile
        self.block, self.causal = block, causal
        self.sub = min(block, tile)
        self.rr = tile // self.sub
        self.sub_shift = self.sub.bit_length() - 1
        self.nt = nb * block // tile
        self.band = _band_decompose(layout, causal)
        tables = {}
        if self.q_tile == tile:
            (hm, kidx, kcnt, kmask, qidx, qcnt, qmask, self.kmax,
             self.qmax) = _tile_tables(layout, causal, block, tile)
            nt = self.nt
            self.head_map = hm
            self.kidx, self.kcnt, self.kmask = (
                kidx.reshape(-1, nt, self.kmax), kcnt.reshape(-1, nt),
                kmask.reshape(-1, nt, self.kmax))
            self.qidx, self.qcnt, self.qmask = (
                qidx.reshape(-1, nt, self.qmax), qcnt.reshape(-1, nt),
                qmask.reshape(-1, nt, self.qmax))
            self.kidx_h, self.kmask_h = self.kidx[hm], self.kmask[hm]
            self.qidx_h, self.qmask_h = self.qidx[hm], self.qmask[hm]
            tables = {"head_map": hm, "kidx": kidx, "kcnt": kcnt,
                      "kmask": kmask, "qidx": qidx, "qcnt": qcnt,
                      "qmask": qmask}
        else:
            square = _plan(layout, causal, block, tile, device)
            self.head_map = hm = square.head_map
            self.pairs = {}
            for name, idx, cnt, mask in (
                    ("dq", square.kidx, square.kcnt, square.kmask),
                    ("dkv", square.qidx, square.qcnt, square.qmask)):
                steps, count, width = _pair_tables(idx, cnt, mask)
                order = _longest_first(count, hm)
                self.pairs[name] = (steps, count, width, order)
                tables.update({f"{name}_steps": steps,
                               f"{name}_count": count,
                               f"{name}_order": order})
            tables["head_map"] = hm
        self.gtiles = self.gbits = self.walks = None
        if self.band is not None:
            self.gtiles, self.gbits = _band_globals(self.band, block,
                                                    nb * block, tile)
            self.walks = _band_walks(self.band, block, nb * block, causal,
                                     tile, self.q_tile)
        self.dev = None
        if device.type == "cuda":
            def on(a):
                return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                       device=device)
            self.dev = {name: on(a) for name, a in tables.items()}
            if self.band is not None:
                self.dev["gtiles"] = on(self.gtiles)
                self.dev["gbits"] = on(self.gbits)


def visible_scores(layout, block, causal):
    """Visible (query, key) pairs of a [H, nb, nb] layout summed over
    heads: the work a block-sparse kernel must do (causal: only keys at
    or before the query)."""
    lay = np.asarray(layout) != 0
    if not causal:
        return int(lay.sum()) * block * block
    diag = int(np.einsum("hii->", lay.astype(np.int64)))
    below = int(np.tril(lay, -1).sum())
    return below * block * block + diag * block * (block + 1) // 2


def _k7_cost(q, plan, products, rows, lse_rows):
    """A K7 kernel's (flops, bytes, transcendentals), as chip_smoke.py's
    bounds count them: `products` products of 2*D flops per visible
    score, `rows` [B, T, H, D] tensors and `lse_rows` fp32 [B, H, T]
    rows read or written once, one exp a visible score."""
    b, t, h, d = q.shape
    nvis = b * plan.visible
    return (2.0 * products * d * nvis,
            rows * b * t * h * d * q.element_size() + lse_rows * b * h * t * 4,
            nvis)


_PLAN_CACHE_SIZE = 32
_plans = OrderedDict()
_plans_lock = threading.Lock()


def _plan(layout, causal, block, tile, device):
    """The cached `_Plan` of these arguments (least recently used out).
    `tile` is the square tile of the table kernels and the WMMA band
    forward, or a (resident rows, streamed rows) pair (`_hopper_tiles`)."""
    key = (layout.tobytes(), layout.shape, layout.dtype.str, bool(causal),
           int(block), _tile_pair(tile), str(device))
    with _plans_lock:
        plan = _plans.get(key)
        if plan is not None:
            _plans.move_to_end(key)
            return plan
    plan = _Plan(layout, bool(causal), int(block), tile, device)
    with _plans_lock:
        _plans[key] = plan
        while len(_plans) > _PLAN_CACHE_SIZE:
            _plans.popitem(last=False)
    return plan


# ----------------------------------------------------------------------
# plain twins: the kernels' tile walks in PyTorch
# ----------------------------------------------------------------------
def _tiles(x, tile):
    """[B, T, H, D] -> [B, H, T/tile, tile, D] in fp32."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).to(torch.float32).reshape(
        b, h, t // tile, tile, d)


def _gather(x_tiles, idx):
    """x_tiles [B, H, n, tile, D], idx [H or 1, m] tile indices ->
    [B, H, m, tile, D]."""
    h = x_tiles.shape[1]
    heads = torch.arange(h, device=idx.device)[:, None]
    return x_tiles[:, heads, idx.expand(h, -1)]


def _mask_vis(bits, q_tiles, k_tiles, plan, device):
    """[H, m, tile, tile] visibility of table entries with sub-block
    masks `bits` [H, m] between q tiles and k tiles ([H, m] each, or
    broadcastable)."""
    tile = plan.tile
    sub_of = torch.arange(tile, device=device) // plan.sub
    bitpos = sub_of[:, None] * plan.rr + sub_of[None, :]
    vis = ((bits[..., None, None] >> bitpos) & 1) != 0
    if plan.causal:
        pos = torch.arange(tile, device=device)
        qp = q_tiles[..., None, None] * tile + pos[:, None]
        kp = k_tiles[..., None, None] * tile + pos[None, :]
        vis = vis & (kp <= qp)
    return vis


def _table_steps(plan, transpose, device):
    """The table walk, step by step: (tile index along the walk [H, nt],
    visibility [H, nt, tile, tile]) for s = 0 .. max - 1. The forward
    table walks k tiles for every q tile; the transpose table q tiles for
    every k tile. Past a row's count the mask is 0: a no-op step."""
    idx_h, mask_h = (plan.qidx_h, plan.qmask_h) if transpose else \
        (plan.kidx_h, plan.kmask_h)
    own = torch.arange(plan.nt, device=device)[None, :]
    for s in range(idx_h.shape[2]):
        idx = torch.as_tensor(idx_h[:, :, s], dtype=torch.long, device=device)
        bits = torch.as_tensor(mask_h[:, :, s], dtype=torch.long,
                               device=device)
        if transpose:
            yield idx, _mask_vis(bits, idx, own, plan, device)
        else:
            yield idx, _mask_vis(bits, own, idx, plan, device)


def _pair_steps(plan, transpose, device):
    """The Hopper backward's walk over the pair tables, step by step:
    (streamed 64-row tile [H, n2], visibility) for s = 0 .. width - 1,
    the visibility [H, n2, 128, 64] (q rows of the resident tile x k
    columns) over the forward table (dQ) or [H, n2, 64, 128] (q rows x
    the resident tile's k columns) over the transpose table (dK/dV), each
    64-row half from its own sub-block bits: a half whose bits are 0
    (its square row does not list the tile, its row lies past T, or the
    step lies past the count) sees nothing."""
    steps = plan.pairs["dkv" if transpose else "dq"][0][plan.head_map]
    own = torch.arange(steps.shape[1], device=device)[None, :]
    for s in range(steps.shape[3]):
        idx = torch.as_tensor(steps[:, :, 0, s], dtype=torch.long,
                              device=device)
        vis = []
        for half in (0, 1):
            bits = torch.as_tensor(steps[:, :, 1 + half, s],
                                   dtype=torch.long, device=device)
            res = 2 * own + half
            vis.append(_mask_vis(bits, idx, res, plan, device) if transpose
                       else _mask_vis(bits, res, idx, plan, device))
        yield idx, torch.cat(vis, dim=-1 if transpose else -2)


def _band_steps(plan, device):
    """The band kernel's walk (`_band_walks`), step by step: (k tiles
    [1, nq], visibility [1, nq, q_tile, tile]) from the closed-form band
    test and the global sub-block bits; rows past T (a last q tile that
    runs past it) see nothing."""
    kind, w, _ = plan.band
    tile, block, q_tile = plan.tile, plan.block, plan.q_tile
    kt_np, in_band_np, valid_np = plan.walks
    gbits = torch.as_tensor(plan.gbits, dtype=torch.long, device=device)
    pos = torch.arange(tile, device=device)
    qp = torch.arange(kt_np.shape[0], device=device)[:, None, None] * \
        q_tile + torch.arange(q_tile, device=device)[:, None]  # [nq, tq, 1]
    qb = qp // block
    live = qp < plan.nt * tile
    for s in range(kt_np.shape[1]):
        kt = torch.as_tensor(kt_np[:, s], device=device)
        kp = kt[:, None, None] * tile + pos[None, None, :]    # [nq, 1, tile]
        kb = kp // block
        glob = ((gbits[kt][:, None, None] >> (pos // plan.sub)[None, None, :])
                & 1) != 0
        if kind == "aligned":
            in_band = kb // w == qb // w
        else:
            in_band = (kb >= qb - (w - 1)) & (kb <= qb + (w - 1))
        in_band = in_band & torch.as_tensor(
            in_band_np[:, s], device=device)[:, None, None]
        vis = (glob | in_band) & live & torch.as_tensor(
            valid_np[:, s], device=device)[:, None, None]
        if plan.causal:
            vis = vis & (kp <= qp)
        yield kt[None, :], vis[None]


def _walk_fwd_plain(q, k, v, steps, q_tile, tile, sm_scale):
    """(out [B, T, H, D] in q.dtype, lse [B*H, T] fp32 log2 space): the
    forward kernels' online softmax over `steps`, all q tiles (of
    `q_tile` rows, the last one padded past T) at once over k tiles of
    `tile` rows."""
    b, t, h, d = q.shape
    f32 = torch.float32
    scale = float(sm_scale * LOG2E)
    tp = -(-t // q_tile) * q_tile
    qt = _tiles(torch.nn.functional.pad(q, (0, 0, 0, 0, 0, tp - t)), q_tile)
    kt, vt = (_tiles(x, tile) for x in (k, v))
    m = torch.full((b, h, tp // q_tile, q_tile, 1), NEG_INF, dtype=f32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qt)
    for idx, vis in steps:
        s = torch.matmul(qt, _gather(kt, idx).transpose(-1, -2)) * scale
        s = s.masked_fill(~vis, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = m_new.clamp(min=NEG_INF / 2)
        p = torch.exp2(s - m_safe)
        alpha = torch.exp2((m - m_safe).clamp(max=0.0))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).to(f32), _gather(vt, idx))
        acc = acc * alpha + pv
        m = m_new
    out = acc / l.clamp(min=1e-30)
    lse = torch.where(l > 0, m + torch.log2(l.clamp(min=1e-30)),
                      torch.full_like(l, float("inf")))
    out = out.reshape(b, h, tp, d)[:, :, :t].permute(0, 2, 1, 3)
    return out.to(q.dtype), lse.reshape(b, h, tp)[..., :t].reshape(b * h, t)


def _bs_fwd_plain(q, k, v, plan, sm_scale):
    """K7-fwd's algorithm: the forward-table walk at the plan's tile pair:
    128-row q tiles over the forward pair table (the Hopper body's walk,
    `_pair_steps`) for a plan at `_SM90_TILES`, else the square tiles
    over the square table (the WMMA body's)."""
    if plan.q_tile != plan.tile:
        return _walk_fwd_plain(q, k, v, _pair_steps(plan, False, q.device),
                               plan.q_tile, plan.tile, sm_scale)
    return _walk_fwd_plain(q, k, v, _table_steps(plan, False, q.device),
                           plan.tile, plan.tile, sm_scale)


def _band_fwd_plain(q, k, v, plan, sm_scale):
    """K7-band's algorithm: the band + global walk at the plan's tile
    pair (the Hopper body's 128 x 64 or the WMMA body's 64 x 64)."""
    return _walk_fwd_plain(q, k, v, _band_steps(plan, q.device),
                           plan.q_tile, plan.tile, sm_scale)


def _bs_bwd_plain(q, k, v, out, lse, dout, plan, sm_scale):
    """(dq, dk, dv) [B, T, H, D] by K7-dkv's and K7-dq's algorithms:
    delta = rowsum(dO * O); P = exp2(S - lse) over the visible scores,
    dP = dO V^T, dS = P (dP - delta) sm_scale; dV += P^T dO with P in
    dO's dtype and dK += dS^T Q over the transpose table, dQ += dS K
    over the forward table, dS in q's dtype, fp32 sums. Each sweep keeps
    tiles of `plan.q_tile` rows resident (the 128-row tiles of the Hopper
    pair, padded past T, over its pair tables; else the square tile over
    the square tables) and streams tiles of `plan.tile` rows."""
    b, t, h, d = q.shape
    rows, tile = plan.q_tile, plan.tile
    tp = -(-t // rows) * rows
    f32 = torch.float32
    scale = float(sm_scale * LOG2E)
    steps = _pair_steps if rows != tile else _table_steps
    delta = (dout.to(f32) * out.to(f32)).sum(dim=-1).permute(0, 2, 1)
    lse = lse.reshape(b, h, t)
    pad = torch.nn.functional.pad
    qs, ks, vs, dos = (_tiles(x, tile) for x in (q, k, v, dout))
    qr, kr, vr, dor = (_tiles(pad(x, (0, 0, 0, 0, 0, tp - t)), rows)
                       for x in (q, k, v, dout))
    lse_s, delta_s = (x.reshape(b, h, t // tile, tile, 1)
                      for x in (lse, delta))
    lse_r, delta_r = (pad(x, (0, tp - t)).reshape(b, h, tp // rows, rows, 1)
                      for x in (lse, delta))

    def p_and_ds(qx, kx, vx, dox, lse_x, delta_x, vis):
        s = torch.matmul(qx, kx.transpose(-1, -2)) * scale
        p = torch.exp2(s.masked_fill(~vis, NEG_INF) - lse_x)
        dp = torch.matmul(dox, vx.transpose(-1, -2))
        ds = p * (dp - delta_x) * sm_scale
        return p.to(dout.dtype).to(f32), ds.to(q.dtype).to(f32)

    dq = torch.zeros_like(qr)
    for idx, vis in steps(plan, False, q.device):
        _, ds = p_and_ds(qr, _gather(ks, idx), _gather(vs, idx), dor, lse_r,
                         delta_r, vis)
        dq = dq + torch.matmul(ds, _gather(ks, idx))
    dk = torch.zeros_like(kr)
    dv = torch.zeros_like(vr)
    for idx, vis in steps(plan, True, q.device):
        qx, dox = _gather(qs, idx), _gather(dos, idx)
        p, ds = p_and_ds(qx, kr, vr, dox, _gather(lse_s, idx),
                         _gather(delta_s, idx), vis)
        dv = dv + torch.matmul(p.transpose(-1, -2), dox)
        dk = dk + torch.matmul(ds.transpose(-1, -2), qx)
    return tuple(x.reshape(b, h, tp, d)[:, :, :t].permute(0, 2, 1, 3)
                 .to(dtype) for x, dtype in ((dq, q.dtype), (dk, k.dtype),
                                             (dv, v.dtype)))


# ----------------------------------------------------------------------
# kernel launchers
# ----------------------------------------------------------------------
def _check_kernel_args(q, block, *others, grid_y=True, hopper=False):
    """Raise on what the K7 kernels do not take; `grid_y`: the kernel's
    grid holds B*H in its y dimension (<= 65535); `hopper`: a Hopper
    kernel (bf16 or fp16), else a WMMA one (fp32 or bf16)."""
    b, t, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"block-sparse kernel: dtype {q.dtype} not "
                        "supported (float32, bfloat16 or float16)")
    if q.dtype == torch.float16 and not hopper:
        raise NotImplementedError(FP16_WMMA_LATER)
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"block-sparse kernel: head_dim {d} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    if t % TILE:
        raise ValueError(f"block-sparse kernel: T={t} is no multiple of "
                         f"{TILE}")
    if block not in _KERNEL_BLOCKS:
        raise ValueError(f"block-sparse kernel: block {block} not in "
                         f"{_KERNEL_BLOCKS}")
    if grid_y and b * h > 65535:
        raise ValueError(f"block-sparse kernel: B*H={b * h} exceeds 65535")
    for name, x in others:
        _check_kernel_operand(name, x, q)


def _fwd_outputs(q):
    b, t, h, d = q.shape
    return (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device),
            torch.empty((b * h, t), dtype=torch.float32, device=q.device))


def _bs_fwd_launch(q, k, v, plan, sm_scale):
    """K7-fwd on the card: (out, lse [B*H, T] log2 space)."""
    from deepspeed_tpu_torch.ops import _build
    _check_kernel_args(q, plan.block, ("q", q), ("k", k), ("v", v))
    out, lse = _fwd_outputs(q)
    t = plan.dev
    fn = _build.function("block_sparse_attention", "ds_bs_attn_fwd",
                         _FWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), *q.shape, _strides(q, k, v),
             float(sm_scale * LOG2E), int(plan.causal),
             t["head_map"].data_ptr(), t["kidx"].data_ptr(),
             t["kcnt"].data_ptr(), t["kmask"].data_ptr(), plan.kmax,
             plan.sub_shift, plan.rr, _DTYPE_CODE[q.dtype],
             q.device.index or 0, _build.stream_ptr(q))
    _build.check(err, "block-sparse forward kernel")
    _bs_fwd_launch.launches += 1
    return out, lse


_bs_fwd_launch.launches = 0


def _band_args(q, k, v, out, lse, plan, sm_scale, *extra):
    """The arguments of the band forward entry points (`extra` after
    sub_shift)."""
    from deepspeed_tpu_torch.ops import _build
    kind, w, _ = plan.band
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *q.shape, _strides(q, k, v),
            float(sm_scale * LOG2E), int(plan.causal),
            plan.block.bit_length() - 1, w, int(kind == "aligned"),
            plan.dev["gtiles"].data_ptr(), len(plan.gtiles),
            plan.dev["gbits"].data_ptr(), plan.sub_shift, *extra,
            _DTYPE_CODE[q.dtype], q.device.index or 0, _build.stream_ptr(q))


def _check_band_plan(plan, tiles):
    if plan.band is None or (plan.q_tile, plan.tile) != tiles:
        raise ValueError(f"band forward kernel: needs a band plan at tiles "
                         f"{tiles}, got {(plan.q_tile, plan.tile)}")


def _band_fwd_launch(q, k, v, plan, sm_scale):
    """K7-band on the WMMA body (64 x 64 tiles; the route takes it for
    fp32): (out, lse [B*H, T] log2 space)."""
    from deepspeed_tpu_torch.ops import _build
    _check_kernel_args(q, plan.block, ("q", q), ("k", k), ("v", v))
    _check_band_plan(plan, (TILE, TILE))
    out, lse = _fwd_outputs(q)
    fn = _build.function("block_sparse_attention", "ds_bs_attn_band_fwd",
                         _BAND_ARGTYPES)
    err = fn(*_band_args(q, k, v, out, lse, plan, sm_scale))
    _build.check(err, "block-sparse band forward kernel")
    _band_fwd_launch.launches += 1
    return out, lse


_band_fwd_launch.launches = 0


def _band_fwd_sm90_launch(q, k, v, plan, sm_scale):
    """K7-band on the Hopper body (bf16 or fp16 at head dims 64 and 128,
    the plan at `_SM90_TILES`): (out, lse [B*H, T] log2 space)."""
    from deepspeed_tpu_torch.ops import _build
    _check_kernel_args(q, plan.block, ("q", q), ("k", k), ("v", v),
                       hopper=True)
    if not _on_sm90(q.dtype, q.shape[-1]):
        raise ValueError(f"Hopper band forward kernel: bf16 or fp16 at head "
                         f"dims 64 and 128, got {q.dtype}, {q.shape[-1]}")
    _check_band_plan(plan, _SM90_TILES)
    out, lse = _fwd_outputs(q)
    fn = _build.function("block_sparse_attention", "ds_bs_attn_band_fwd_sm90",
                         _BAND90_ARGTYPES)
    # the kernel lays its walk out in shared memory: the longest one
    err = fn(*_band_args(q, k, v, out, lse, plan, sm_scale,
                         plan.walks[0].shape[1]))
    _build.check(err, "block-sparse Hopper band forward kernel")
    _band_fwd_sm90_launch.launches += 1
    return out, lse


_band_fwd_sm90_launch.launches = 0


def _bs_bwd_dkv_launch(q, k, v, out, lse, dout, plan, sm_scale):
    """K7-dkv on the card, after its delta pre-pass: (dk, dv, delta)."""
    from deepspeed_tpu_torch.ops import _build
    _check_kernel_args(q, plan.block, ("q", q), ("k", k), ("v", v),
                       ("out", out), ("dout", dout))
    b, t, h, d = q.shape
    dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
              for _ in range(2))
    delta = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    tab = plan.dev
    fn = _build.function("block_sparse_attention", "ds_bs_attn_bwd_dkv",
                         _DKV_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, t, h, d,
             _strides(q, k, v, out, dout), float(sm_scale * LOG2E),
             float(sm_scale), int(plan.causal), tab["head_map"].data_ptr(),
             tab["qidx"].data_ptr(), tab["qcnt"].data_ptr(),
             tab["qmask"].data_ptr(), plan.qmax, plan.sub_shift, plan.rr,
             _DTYPE_CODE[q.dtype], q.device.index or 0,
             _build.stream_ptr(q))
    _build.check(err, "block-sparse dK/dV kernel")
    _bs_bwd_dkv_launch.launches += 1
    return dk, dv, delta


_bs_bwd_dkv_launch.launches = 0


def _bs_bwd_dq_launch(q, k, v, out, lse, dout, delta, plan, sm_scale):
    """K7-dq on the card, reading the delta the dK/dV launch wrote."""
    from deepspeed_tpu_torch.ops import _build
    _check_kernel_args(q, plan.block, ("q", q), ("k", k), ("v", v),
                       ("out", out), ("dout", dout))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    tab = plan.dev
    fn = _build.function("block_sparse_attention", "ds_bs_attn_bwd_dq",
                         _DQ_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *q.shape,
             _strides(q, k, v, out, dout), float(sm_scale * LOG2E),
             float(sm_scale), int(plan.causal), tab["head_map"].data_ptr(),
             tab["kidx"].data_ptr(), tab["kcnt"].data_ptr(),
             tab["kmask"].data_ptr(), plan.kmax, plan.sub_shift, plan.rr,
             _DTYPE_CODE[q.dtype], q.device.index or 0,
             _build.stream_ptr(q))
    _build.check(err, "block-sparse dQ kernel")
    _bs_bwd_dq_launch.launches += 1
    return dq


_bs_bwd_dq_launch.launches = 0


def _pair_args(q, plan, name, what="backward"):
    """The Hopper table kernels' arguments for the pair table `name`
    ("dq": the forward table, which the table forward walks too; "dkv":
    the transpose table), after the checks of their route."""
    if not _on_sm90(q.dtype, q.shape[-1]):
        raise ValueError(f"Hopper block-sparse {what} kernel: bf16 or fp16 "
                         f"at head dims 64 and 128, got {q.dtype}, "
                         f"{q.shape[-1]}")
    if (plan.q_tile, plan.tile) != _SM90_TILES:
        raise ValueError(f"Hopper block-sparse {what} kernel: needs a plan "
                         f"at tiles {_SM90_TILES}, got "
                         f"{(plan.q_tile, plan.tile)}")
    width = plan.pairs[name][2]
    if width > _SM90_MAX_STEPS:
        raise ValueError(f"Hopper block-sparse {what} kernel: a walk of "
                         f"{width} steps exceeds the {_SM90_MAX_STEPS} its "
                         "shared memory holds")
    t = plan.dev
    return (t["head_map"].data_ptr(), t[f"{name}_steps"].data_ptr(),
            t[f"{name}_count"].data_ptr(), t[f"{name}_order"].data_ptr(),
            width, plan.sub_shift)


def _bs_fwd_sm90_launch(q, k, v, plan, sm_scale):
    """K7-fwd on the Hopper body (bf16 or fp16 at head dims 64 and 128,
    the plan at `_SM90_TILES`): 128-row q tiles over the forward pair
    table, CTAs longest walk first; (out, lse [B*H, T] log2 space)."""
    from deepspeed_tpu_torch.ops import _build
    _check_kernel_args(q, plan.block, ("q", q), ("k", k), ("v", v),
                       grid_y=False, hopper=True)
    tables = _pair_args(q, plan, "dq", "table forward")
    out, lse = _fwd_outputs(q)
    fn = _build.function("block_sparse_attention", "ds_bs_attn_fwd_sm90",
                         _FWD90_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), *q.shape, _strides(q, k, v),
             float(sm_scale * LOG2E), int(plan.causal), *tables,
             _DTYPE_CODE[q.dtype], q.device.index or 0, _build.stream_ptr(q))
    _build.check(err, "block-sparse Hopper table forward kernel")
    _bs_fwd_sm90_launch.launches += 1
    return out, lse


_bs_fwd_sm90_launch.launches = 0


def _bs_bwd_dkv_sm90_launch(q, k, v, out, lse, dout, plan, sm_scale):
    """K7-dkv on the Hopper sweep (bf16 or fp16 at head dims 64 and 128,
    the plan at `_SM90_TILES`), after its delta pre-pass: (dk, dv,
    delta)."""
    from deepspeed_tpu_torch.ops import _build
    _check_kernel_args(q, plan.block, ("q", q), ("k", k), ("v", v),
                       ("out", out), ("dout", dout), grid_y=False,
                       hopper=True)
    tables = _pair_args(q, plan, "dkv")
    if lse.data_ptr() % 16:     # the sweep bulk-copies lse rows
        lse = lse.clone()
    b, t, h, d = q.shape
    dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
              for _ in range(2))
    delta = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    fn = _build.function("block_sparse_attention", "ds_bs_attn_bwd_dkv_sm90",
                         _DKV90_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d,
             _strides(q, k, v, out, dout), float(sm_scale * LOG2E),
             float(sm_scale), int(plan.causal), *tables,
             _DTYPE_CODE[q.dtype], q.device.index or 0,
             _build.stream_ptr(q))
    _build.check(err, "block-sparse Hopper dK/dV kernel")
    _bs_bwd_dkv_sm90_launch.launches += 1
    return dk, dv, delta


_bs_bwd_dkv_sm90_launch.launches = 0


def _bs_bwd_dq_sm90_launch(q, k, v, out, lse, dout, delta, plan, sm_scale):
    """K7-dq on the Hopper sweep, reading the delta the dK/dV launch
    wrote."""
    from deepspeed_tpu_torch.ops import _build
    _check_kernel_args(q, plan.block, ("q", q), ("k", k), ("v", v),
                       ("out", out), ("dout", dout), grid_y=False,
                       hopper=True)
    tables = _pair_args(q, plan, "dq")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _build.function("block_sparse_attention", "ds_bs_attn_bwd_dq_sm90",
                         _DQ90_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *q.shape,
             _strides(q, k, v, out, dout), float(sm_scale * LOG2E),
             float(sm_scale), int(plan.causal), *tables,
             _DTYPE_CODE[q.dtype], q.device.index or 0,
             _build.stream_ptr(q))
    _build.check(err, "block-sparse Hopper dQ kernel")
    _bs_bwd_dq_sm90_launch.launches += 1
    return dq


_bs_bwd_dq_sm90_launch.launches = 0


def reset_launch_counts():
    """Zero the K7 launch counters."""
    for fn in (_bs_fwd_launch, _bs_fwd_sm90_launch, _band_fwd_launch,
               _band_fwd_sm90_launch, _bs_bwd_dkv_launch, _bs_bwd_dq_launch,
               _bs_bwd_dkv_sm90_launch, _bs_bwd_dq_sm90_launch):
        fn.launches = 0


# ----------------------------------------------------------------------
# routing and autograd
# ----------------------------------------------------------------------
def _forward(q, k, v, plan, sm_scale):
    """(out, lse): a band kernel where the layout decomposes, else the
    table kernel, each on the Hopper body for a plan at its tile pair
    and on the WMMA body for a square plan; the twins (the same walk)
    for CPU tensors."""
    hopper = plan.q_tile != plan.tile
    if plan.band is None:
        launch = _bs_fwd_sm90_launch if hopper else _bs_fwd_launch
        plain = _bs_fwd_plain
    else:
        launch = _band_fwd_sm90_launch if hopper else _band_fwd_launch
        plain = _band_fwd_plain
    return kernel_call(
        "K7-fwd" if plan.band is None else "K7-band",
        "block_sparse_attention", "block_sparse_attention",
        lambda: _k7_cost(q, plan, 2, 4, 1),
        lambda: (launch if q.is_cuda else plain)(q, k, v, plan, sm_scale))


def _dkv_cost(q, plan):
    """K7-dkv: S and dP recomputed, dV and dK (4 products); q, k, v,
    out, dout read, dk, dv written; lse read."""
    return _k7_cost(q, plan, 4, 7, 1)


def _dq_cost(q, plan):
    """K7-dq: S and dP recomputed, dQ (3 products); q, k, v, dout read,
    dq written; lse and delta read."""
    return _k7_cost(q, plan, 3, 5, 2)


def _backward(q, k, v, out, lse, dout, plan, sm_scale):
    """(dq, dk, dv): K7-dkv, then K7-dq on its delta, on the Hopper
    sweeps for a plan at the Hopper pair (bf16 or fp16 at head dims 64
    and 128),
    else on the WMMA bodies; the twin for CPU tensors."""
    src, op = "block_sparse_attention", "block_sparse_attention_backward"
    if not q.is_cuda:
        # the twin runs both sweeps at once: both kernels' rows
        return kernel_call(
            "K7-dkv", src, op, lambda: _dkv_cost(q, plan),
            lambda: kernel_call(
                "K7-dq", src, op, lambda: _dq_cost(q, plan),
                lambda: _bs_bwd_plain(q, k, v, out, lse, dout, plan,
                                      sm_scale)))
    if not _kernel_readable(dout):
        dout = dout.contiguous()
    if plan.q_tile != plan.tile:
        dkv, dq_launch = _bs_bwd_dkv_sm90_launch, _bs_bwd_dq_sm90_launch
    else:
        dkv, dq_launch = _bs_bwd_dkv_launch, _bs_bwd_dq_launch
    dk, dv, delta = kernel_call(
        "K7-dkv", src, op, lambda: _dkv_cost(q, plan),
        lambda: dkv(q, k, v, out, lse, dout, plan, sm_scale))
    dq = kernel_call(
        "K7-dq", src, op, lambda: _dq_cost(q, plan),
        lambda: dq_launch(q, k, v, out, lse, dout, delta, plan, sm_scale))
    return dq, dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    """out = block-sparse attention of (q, k, v): the forward kernel (or
    twin), then the backward kernels (or twin) off the saved (q, k, v,
    out, lse), all under one plan — the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, plan, sm_scale):
        out, lse = _forward(q, k, v, plan, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan, ctx.sm_scale = plan, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g, ctx.plan, ctx.sm_scale)
        return dq, dk, dv, None, None


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------
def _tile_for(t, block):
    """The kernels' 64-row tile where it fits the sequence and the
    block; else (the twins only) the block itself. Blocks under 16 take
    their own tile: 64 rows of them would need rr * rr >= 64 sub-block
    mask bits, more than the int32 tables hold."""
    if t % TILE == 0 and (block % TILE == 0 or block in _KERNEL_BLOCKS):
        return TILE
    return block


def _hopper_tiles(dtype, d, tile):
    """The (resident rows, streamed rows) of every K7 kernel for inputs
    of `dtype` and head dim d whose kernels walk `tile`-row tiles: the
    Hopper bodies' 128 x 64 where the tile is 64 and (dtype, d) runs them
    (bf16 or fp16 at head dims 64 and 128, as for K1 and K2), else tile x
    tile."""
    if tile == TILE and _on_sm90(dtype, d):
        return _SM90_TILES
    return (tile, tile)


def _pad_for_kernel(q, k, v, layout, block):
    """The kernels' shapes for a call on the card: T padded up to a
    multiple of TILE with layout blocks that no row sees and whose rows
    see nothing (zero rows and columns of the layout), D padded with
    zeros up to 64 or 128. Shapes the kernels reject otherwise (a head
    dim above 128, a block they do not take) are left for the launch to
    raise on."""
    b, t, h, d = q.shape
    if block not in _KERNEL_BLOCKS or d > max(_KERNEL_HEAD_DIMS):
        return q, k, v, layout
    tp = -(-t // TILE) * TILE
    dp = next(x for x in _KERNEL_HEAD_DIMS if x >= d)
    if (tp, dp) == (t, d):
        return q, k, v, layout
    q, k, v = (torch.nn.functional.pad(x, (0, dp - d, 0, 0, 0, tp - t))
               for x in (q, k, v))
    nb, nbp = layout.shape[-1], tp // block
    padded = np.zeros((layout.shape[0], nbp, nbp), layout.dtype)
    padded[:, :nb, :nb] = layout
    return q, k, v, padded


def block_sparse_attention(q, k, v, layout, block, causal=False,
                           sm_scale=None, head_packing="auto"):
    """Block-sparse attention over [B, T, H, D]; returns [B, T, H, D].

    layout: [H, T/block, T/block] 0/1 matrix from a SparsityConfig
    (concrete: it is compiled into visible-tile tables on the host).
    CUDA tensors launch kernel K7-band (layouts `_band_decompose`
    accepts) or K7-fwd, and K7-dkv/K7-dq in the backward (on the Hopper
    bodies in bf16 and fp16 at head dims 64 and 128); CPU tensors take
    the plain twins at the same tile pairs.

    head_packing: accepted for signature parity with the dense flash
    kernel ("auto"|"packed"|"off"), but the sparse kernels always run
    unpacked — the visible-tile tables are per head, so pairing two
    heads into one contraction would force both onto the union of their
    layouts. "auto"/"off" take the unpacked kernels; "packed" raises.
    """
    b, t, h, d = q.shape
    if head_packing in ("packed", True, 1):
        raise ValueError(
            "head_packing='packed' is not supported by the block-sparse "
            "kernels (per-head visible-block tables don't pair); use "
            "'auto'/'off', or the dense flash kernel for packed "
            "attention")
    if head_packing not in ("auto", "off", None, False, 0):
        raise ValueError(
            f"head_packing={head_packing!r}: expected 'auto' or 'off'")
    layout = np.asarray(layout)
    if layout.shape != (h, t // block, t // block) or t % block:
        raise ValueError(f"layout shape {layout.shape} != "
                         f"{(h, t // block, t // block)} (T={t}, "
                         f"block={block})")
    # every query block must see at least one key block (the diagonal in
    # all shipped patterns) or its softmax is over the empty set
    if causal:
        diag = layout[:, np.arange(t // block), np.arange(t // block)]
        if not diag.all():
            raise ValueError("causal layouts must include the diagonal")
    elif not (layout.sum(-1) > 0).all():
        raise ValueError("every query block needs >= 1 visible key block")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(d)
    if q.is_cuda:
        q, k, v, layout = _pad_for_kernel(q, k, v, layout, block)
    tile = _tile_for(q.shape[1], block)
    plan = _plan(layout, causal, block,
                 _hopper_tiles(q.dtype, q.shape[-1], tile), q.device)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = _BlockSparseAttention.apply(q, k, v, plan, float(sm_scale))
    else:
        out = _forward(q, k, v, plan, float(sm_scale))[0]
    return out[:, :t, :, :d] if out.shape != (b, t, h, d) else out


def block_sparse_attention_dense_fallback(q, k, v, layout, block,
                                          causal=False, sm_scale=None):
    """Dense reference: same math via an expanded additive mask."""
    t = q.shape[1]
    mask = layout_to_dense_mask(layout, t, block)         # [H, T, T]
    additive = torch.where(torch.as_tensor(mask, device=q.device),
                           torch.zeros((), device=q.device),
                           torch.full((), NEG_INF, device=q.device))
    return dense_attention(q, k, v, mask=additive[None], causal=causal,
                           sm_scale=sm_scale)
