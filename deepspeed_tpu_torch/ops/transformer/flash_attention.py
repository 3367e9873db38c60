"""Flash attention: forward (kernel K1-fwd), backward (kernels K2-fused
and K2) and the forward merged with a prior softmax partial (kernel K5).

Port of deepspeed_tpu/ops/transformer/flash_attention.py. The Pallas
forward kernels `_fwd_kernel` / `_fwd_kernel_packed` become the
hand-written CUDA kernel `ops/csrc/flash_attention_fwd.cu` (K1-fwd, and
K5 in their merge mode: `flash_attention_merge`, the ring-attention
step). The one-pass backward `_bwd_fused_kernel` / `_bwd_fused_kernel_packed`,
which the JAX package runs whenever the whole sequence is one tile of
its 1024-row default block (every T <= 1024), becomes
`ops/csrc/flash_attention_bwd_fused.cu` (K2-fused: a cluster of up to
ceil(T / 128) CTAs per head, S, P, dP and dS formed once per tile pair,
delta computed in the launch, dQ's partials added in the plan's order). The two-sweep backward `_bwd_dkv_kernel` /
`_bwd_dq_kernel` and their packed twins become
`ops/csrc/flash_attention_bwd.cu` (K2: a delta pre-pass, then the dK/dV
and dQ sweeps, with a given-delta entry for K5's backward). The backward
routes as the JAX package's `_bwd` does: K2-fused at T <= 1024 in bf16
and fp16 at head dims 64 and 128, K2's sweeps at longer T; fp32 and head
dims 192/256 keep the sweeps at every T (the fused forms there are not
ported: ROADMAP Queue 2). bf16 and fp16 at head dims 64 and 128 run the
Hopper bodies (`ops/csrc/attention_hopper.cuh`: TMA and wgmma, 128-row q
tiles over 64-row K/V tiles forward, the backward's 64-row steps past
128-row resident tiles); fp32 and head dims 192/256 the WMMA bodies of
`attention_tiles.cuh` (64 x 64 tiles). The plain PyTorch twins
`_flash_fwd_plain`, `_flash_merge_plain`, `_flash_bwd_fused_plain` and
`_flash_bwd_plain` below run the same tiled algorithms at the tiles of
the body the kernel would run (`_kernel_tiles`; log2 space, -1e30
masking, causal tiles above the diagonal skipped) and are what CPU
tensors take, on the same routes (`_flash_bwd_twin`).
`torch.autograd.Function`s join the halves, so `flash_attention`,
`flash_attention_with_lse` and `flash_attention_merge` are
differentiable in every input and output (the lse cotangent enters the
backward as a shift of delta, as in the JAX package). The kernels take
head dims 64, 128, 192 and 256; fp16 (the fp16 forms of K1-fwd, K5,
K2-fused and K2, their given-delta entries included, on the Hopper
bodies) head dims 64 and 128. fp16 at the wide head dims (on no model's
path) raises NotImplementedError naming ROADMAP Queue 2 item 7.

Layout: [B, T, H, D] at every public function, as in the JAX package.
The lse is returned as [B, H, T, 1] in LOG2 space (m + log2(l) over
log2(e)-scaled scores), the convention the backward and the ring merge
consume.

Head packing (two d=64 heads per grid step) was a device for the TPU's
128-wide matrix unit; it computes the same function, so every
`head_packing` value routes to the one kernel here.
`_resolve_head_packing` keeps the JAX package's validation ("packed"
with d != 64 raises).
"""

import ctypes
import functools

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import named_outputs

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# T must be a multiple of this; the WMMA bodies' tile (64 query rows x
# 64 key rows) and the backward's step on every body
KERNEL_BLOCK = 64
_KERNEL_HEAD_DIMS = (64, 128, 192, 256)
# the Hopper bodies (bf16 and fp16 at these head dims): 128-row q tiles over
# 64-row K/V tiles
_SM90_HEAD_DIMS = (64, 128)
_SM90_TILES = (128, 64)
# the WMMA bodies launch one CTA row per (b, h) on grid.y
_MAX_GRID_Y = 65535
LN2 = 0.6931471805599453
_DEFAULT_BLOCK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
FP16_LATER = ("the fp16 forms of the wide head dims 192/256 are not in "
              "the port yet: ROADMAP Queue 2 item 7")
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
    [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]
_MERGE_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
    [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + \
    [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]


def dropout(x, rate, generator):
    """flax nn.Dropout: keep each element with probability 1 - rate,
    scaled by 1 / (1 - rate), from `generator`'s uniform draws (a
    torch.Generator on x's device; the draws are torch's, not JAX's)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def dense_attention(q, k, v, mask=None, causal=False, sm_scale=None,
                    dropout_rate=0.0, dropout_gen=None):
    """Dense attention over [B, T, H, D]: the reference path for the
    flash kernel and the route where flash does not apply. fp32
    softmax. The score product comes out in the input dtype and is then
    widened, as the JAX einsum does. `mask` is additive, broadcastable
    to [B, H, Tq, Tk], and applies after the causal mask. With a
    `dropout_gen` and a rate > 0, dropout applies to the probabilities
    (the JAX package's attention dropout)."""
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores * sm_scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        tri = torch.ones((t_q, t_k), dtype=torch.bool,
                         device=q.device).tril()
        scores = torch.where(tri[None, None], scores,
                             torch.tensor(NEG_INF, dtype=torch.float32,
                                          device=q.device))
    if mask is not None:
        scores = scores + mask.to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    if dropout_gen is not None and dropout_rate > 0.0:
        probs = dropout(probs, dropout_rate, dropout_gen)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _fit_block(block, t):
    """Largest power-of-two shrink of `block` (floor 128) that divides
    t, after clamping to t."""
    block = min(block, t)
    while block > 128 and t % block:
        block //= 2
    return block


def flash_attention_usable(q, no_dropout: bool,
                           block_q=None, block_k=None):
    """The routing gate, identical to the JAX package's: [B, T, H, D]
    with T a multiple of 128 that the block sizes divide, D a multiple
    of 64, and no dropout. The model takes flash exactly where the JAX
    package does and `dense_attention` elsewhere."""
    if not no_dropout:
        return False
    if q.ndim != 4:
        return False
    t, d = q.shape[1], q.shape[3]
    block_q = _fit_block(block_q or _DEFAULT_BLOCK, t)
    block_k = _fit_block(block_k or _DEFAULT_BLOCK, t)
    return t % block_q == 0 and t % block_k == 0 and d % 64 == 0 and \
        t >= 128 and t % 128 == 0


def _resolve_head_packing(head_packing, d):
    """Head-packing mode -> bool, validated as in the JAX package. The
    value selects nothing on this device: packed and unpacked compute
    the same function, and both run the one kernel."""
    if head_packing in ("off", False, 0):
        return False
    if head_packing in ("packed", True, 1):
        if d != 64:
            raise ValueError(
                f"head_packing='packed' requires head_dim 64 (got {d}): "
                "packing pairs two 64-wide heads into one K=128 "
                "contraction")
        return True
    if head_packing in ("auto", None):
        return d == 64
    raise ValueError(
        f"head_packing={head_packing!r}: expected 'auto', 'packed' or "
        "'off'")


# ----------------------------------------------------------------------
# plain twins: the kernels' tiled algorithms in PyTorch
# ----------------------------------------------------------------------
def _on_sm90(dtype, d):
    """Whether (dtype, head dim) runs the Hopper bodies."""
    return dtype in (torch.bfloat16, torch.float16) and d in _SM90_HEAD_DIMS


def _kernel_tiles(dtype, d):
    """(q rows, k rows) of the forward kernel's tile pair at (dtype, d):
    128 x 64 on the Hopper body (bf16 or fp16, d 64 or 128), 64 x 64 on the WMMA
    bodies (fp32, d 192 and 256)."""
    return _SM90_TILES if _on_sm90(dtype, d) else (KERNEL_BLOCK,
                                                   KERNEL_BLOCK)


def _tile_slices(t, block):
    """Row slices of `block` rows over T, the last one ragged."""
    return [slice(i, min(i + block, t)) for i in range(0, t, block)]


def _flash_tiles_plain(q, k, v, sm_scale, causal, block_q=None,
                       block_k=None):
    """The kernel's walk, one q tile at a time: yields (rows, m, l, acc)
    with the running max m and sum l [B, H, rows, 1] and the fp32
    accumulator [B, H, rows, D] after the tile's last k tile (causal: up
    to the one holding its last row's key). Tiles are block_q x block_k
    (default `_kernel_tiles`); a last tile past T is cut at T, as the
    kernel masks the keys TMA zero-fills there. Scores are fp32 products
    scaled by sm_scale*log2(e) with masked entries at -1e30, the
    exponents of a row that has seen nothing visible use -5e29 (so
    masked p are 0), the sum l and the accumulator are rescaled once per
    k tile, and the P·V product takes p in v's dtype."""
    b, t, h, d = q.shape
    if block_q is None or block_k is None:
        block_q, block_k = _kernel_tiles(q.dtype, d)
    f32 = torch.float32
    scale = float(sm_scale * LOG2E)
    qh = q.permute(0, 2, 1, 3)                    # [B, H, T, D]
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    for rows in _tile_slices(t, block_q):
        n = rows.stop - rows.start
        qt = qh[:, :, rows].to(f32)
        m = torch.full((b, h, n, 1), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, h, n, 1), dtype=f32, device=q.device)
        acc = torch.zeros((b, h, n, d), dtype=f32, device=q.device)
        for cols in _tile_slices(t, block_k):
            if causal and cols.start >= rows.stop:
                break
            s = torch.matmul(qt, kh[:, :, cols].to(f32).transpose(-1, -2))
            s = s * scale
            if causal:
                qpos = torch.arange(rows.start, rows.stop, device=q.device)
                kpos = torch.arange(cols.start, cols.stop, device=q.device)
                s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            m_safe = m_new.clamp(min=NEG_INF / 2)
            p = torch.exp2(s - m_safe)
            alpha = torch.exp2((m - m_safe).clamp(max=0.0))
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = torch.matmul(p.to(v.dtype).to(f32), vh[:, :, cols].to(f32))
            acc = acc * alpha + pv
            m = m_new
        yield rows, m, l, acc


def _flash_fwd_plain(q, k, v, sm_scale, causal, block_q=None, block_k=None):
    """(out [B,T,H,D] in q.dtype, lse [B,H,T] fp32 log2 space) by the
    kernel's algorithm (`_flash_tiles_plain`): out = acc / l,
    lse = m + log2(l)."""
    b, t, h, d = q.shape
    out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    for rows, m, l, acc in _flash_tiles_plain(q, k, v, sm_scale, causal,
                                              block_q, block_k):
        out[:, :, rows] = (acc / l).to(q.dtype)
        lse[:, :, rows] = (m + torch.log2(l))[..., 0]
    return out.permute(0, 2, 1, 3), lse


def _flash_merge_plain(q, k, v, prev_out, prev_lse, sm_scale, causal,
                       block_q=None, block_k=None):
    """K5's algorithm: (out fp32 [B,T,H,D], lse [B,H,T], lse_n [B,H,T])
    of flash attention over (k, v) merged with the prior partial
    (prev_out [B,T,H,D], prev_lse [B,H,T] log2 space, -1e30 = empty) in
    the epilogue, as the JAX kernel's merge mode computes it: with the
    block's lse_n = m + log2(l) and mm = max(lse_n, prev_lse),
    out = (prev * 2^(prev_lse - mm) + acc * 2^(m - mm))
          / (2^(prev_lse - mm) + 2^(lse_n - mm)),
    lse = mm + log2(the denominator). A row of the block that saw
    nothing merges as an empty partial (lse_n = -inf) and returns
    lse_n = +inf, the kernel's mark for the backward. Tiles as in
    `_flash_tiles_plain`."""
    b, t, h, d = q.shape
    f32 = torch.float32
    inf = torch.tensor(float("inf"), dtype=f32, device=q.device)
    prev = prev_out.to(f32).permute(0, 2, 1, 3)   # [B, H, T, D]
    out = torch.empty((b, h, t, d), dtype=f32, device=q.device)
    lse = torch.empty((b, h, t), dtype=f32, device=q.device)
    lse_n = torch.empty((b, h, t), dtype=f32, device=q.device)
    for rows, m, l, acc in _flash_tiles_plain(q, k, v, sm_scale, causal,
                                              block_q, block_k):
        ln = torch.where(l > 0, m + torch.log2(l), -inf)
        plse = prev_lse[:, :, rows, None].to(f32)
        mm = torch.maximum(ln, plse)
        w_p = torch.exp2(plse - mm)
        w_sum = w_p + torch.exp2(ln - mm)
        out[:, :, rows] = (prev[:, :, rows] * w_p +
                           acc * torch.exp2(m - mm)) / w_sum
        lse[:, :, rows] = (mm + torch.log2(w_sum))[..., 0]
        lse_n[:, :, rows] = torch.where(l > 0, ln, inf)[..., 0]
    return out.permute(0, 2, 1, 3), lse, lse_n


def _delta(out, g, dlse, delta):
    """delta [B, H, T] fp32: rowsum(dO * O), or the given one, minus
    log2(e) * dlse."""
    if delta is None:
        delta = (g.to(torch.float32) * out.to(torch.float32)).sum(dim=-1) \
            .permute(0, 2, 1)
    else:
        delta = delta.to(torch.float32)
    if dlse is not None:
        delta = delta - LOG2E * dlse.to(torch.float32)
    return delta


def _fused_route(q):
    """Whether the backward of q's shape and dtype takes K2-fused: the
    whole sequence in one tile of `_fit_block(_DEFAULT_BLOCK, T)` (the
    JAX package's one-pass branch, every T <= 1024), on the Hopper
    bodies' dtypes and head dims."""
    t = q.shape[1]
    return _fit_block(_DEFAULT_BLOCK, t) == t and _on_sm90(q.dtype,
                                                           q.shape[-1])


def _fused_plan(nk, causal, d):
    """K2-fused's plan for nk 128-row key blocks: (rows, owner), rows[c]
    the (key block, q block) pairs CTA c of a head's cluster takes, in
    order (None pads the shorter rows), owner[j] the (CTA, slot) that
    computes q block j's delta rows. A q block's partials sit at distinct
    pair indices, and `_fused_order` adds them in that order.

    Causal at head dim 64 (two K/V blocks fit a CTA's shared memory):
    CTA c pairs key blocks c and nk - 1 - c, nk + 1 pairs for each of
    ceil(nk / 2) CTAs (an odd nk's middle key block alone in its CTA);
    key block c takes q blocks c up to nk/2 - 1, then nk - 1 down to
    nk/2 (or c), key block nk - 1 - c q blocks nk - 1 down to nk - 1 - c.
    Otherwise the rotation: CTA i holds key block i and takes q block
    (i + r) mod nk as its r-th pair (causal: while i + r < nk, so key
    block 0 takes nk pairs and key block nk - 1 one).
    """
    if causal and d == 64:
        half = nk // 2
        rows, owner = [], {}
        for c in range((nk + 1) // 2):
            owner[c] = (c, 0)
            row = [(c, j) for j in list(range(c, half)) +
                   list(range(nk - 1, max(half, c) - 1, -1))]
            if nk - 1 - c > c:
                owner[nk - 1 - c] = (c, 1)
                row += [(nk - 1 - c, j) for j in range(nk - 1, nk - 2 - c,
                                                        -1)]
            rows.append(row)
    else:
        rows = [[(i, (i + r) % nk) for r in range(nk)
                 if not causal or i + r < nk] for i in range(nk)]
        owner = {j: (j, 0) for j in range(nk)}
    rounds = max(len(row) for row in rows)
    return [row + [None] * (rounds - len(row)) for row in rows], owner


def _fused_order(rows):
    """{q block j: [(CTA c, pair index p), ...]}: the order in which the
    kernel adds q block j's dQ partials, by pair index (each of j's
    partials at another index). Each partial's warpgroup waits for the
    one before it and passes on to the one after it."""
    order = {}
    for c, row in enumerate(rows):
        for p, pair in enumerate(row):
            if pair is not None:
                order.setdefault(pair[1], []).append((p, c))
    for j, parts in order.items():
        if len({p for p, _ in parts}) != len(parts):
            raise ValueError(f"K2-fused plan: q block {j} has two partials "
                             "at one pair index")
        order[j] = [(c, p) for p, c in sorted(parts)]
    return order


class _FusedPlan(ctypes.Structure):
    """`_fused_plan` and `_fused_order` as the kernel's FusedPlan
    (flash_attention_bwd_fused.cu: up to 8 CTAs of up to 9 pairs; -1
    where there is none). For CTA c's p-th pair: its key and q blocks,
    whether it is its q block's first partial, and the (CTA, pair) of the
    next one (-1: the last); the CTA's key blocks in order; the owners of
    the q blocks' delta rows."""
    _fields_ = [("ctas", ctypes.c_int), ("pairs", ctypes.c_int),
                ("n", ctypes.c_byte * 8),
                ("kb", (ctypes.c_byte * 9) * 8),
                ("qb", (ctypes.c_byte * 9) * 8),
                ("first", (ctypes.c_byte * 9) * 8),
                ("next_cta", (ctypes.c_byte * 9) * 8),
                ("next_pair", (ctypes.c_byte * 9) * 8),
                ("kv", (ctypes.c_byte * 2) * 8),
                ("own", (ctypes.c_byte * 2) * 8),
                ("owner", ctypes.c_byte * 8), ("slot", ctypes.c_byte * 8)]

    @classmethod
    @functools.lru_cache(maxsize=None)
    def of(cls, nk, causal, d):
        """The plan of (nk, causal, d), built once (the kernel takes it
        by value, so one struct serves every launch)."""
        rows, owner = _fused_plan(nk, causal, d)
        plan = cls(ctas=len(rows), pairs=len(rows[0]))
        for c, row in enumerate(rows):
            pairs = [pair for pair in row if pair is not None]
            plan.n[c] = len(pairs)
            kvs = list(dict.fromkeys(kb for kb, _ in pairs))
            plan.kv[c][0], plan.kv[c][1] = (kvs + [-1])[:2]
            plan.own[c][0] = plan.own[c][1] = -1
            for p, (kb, j) in enumerate(pairs):
                plan.kb[c][p], plan.qb[c][p] = kb, j
                plan.next_cta[c][p] = plan.next_pair[c][p] = -1
        for parts in _fused_order(rows).values():
            for i, (c, p) in enumerate(parts):
                plan.first[c][p] = int(i == 0)
                if i + 1 < len(parts):
                    plan.next_cta[c][p], plan.next_pair[c][p] = parts[i + 1]
        for j, (c, sl) in owner.items():
            plan.own[c][sl] = j
            plan.owner[j], plan.slot[j] = c, sl
        return plan


def _flash_bwd_fused_plain(q, k, v, out, lse, g, dlse, sm_scale, causal,
                           delta=None):
    """(dq, dk, dv) [B,T,H,D] by K2-fused's algorithm, in its order: the
    128-row key blocks (the last one cut at T) pair with q blocks as
    `_fused_plan` lays them out, taken by pair index, each q block walked
    in 64-row q steps. Per step and 64-key half that sees the step (causal
    halves wholly above the diagonal are skipped, as the kernel's
    warpgroups skip them): P = exp2(S - lse), dP = dO V^T,
    dS = P (dP - delta) sm_scale; dV += P^T dO with P in dO's dtype and
    dK += dS^T Q with dS in q's dtype, fp32 sums over the walk. After
    both steps dQ of the q block gains dS K over the 128 keys (one
    product, the skipped halves' dS zero), summed in fp32 in the plan's
    order (`_fused_order`: by pair index). delta as in
    `_flash_bwd_plain`."""
    b, t, h, d = q.shape
    f32 = torch.float32
    rows, step = _SM90_TILES[0], KERNEL_BLOCK
    scale = float(sm_scale * LOG2E)
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3).to(f32) for x in (q, k, v, g))
    delta = _delta(out, g, dlse, delta)
    dq = torch.zeros((b, h, t, d), dtype=f32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    blocks = _tile_slices(t, rows)
    plan, _ = _fused_plan(len(blocks), causal, d)
    for r in range(len(plan[0])):
        for pair in (row[r] for row in plan):
            if pair is None:
                continue
            keys, qb = blocks[pair[0]], blocks[pair[1]]
            ds_rows = []
            for qs in _tile_slices(qb.stop - qb.start, step):
                qs = slice(qb.start + qs.start, qb.start + qs.stop)
                qt, gt = qh[:, :, qs], gh[:, :, qs]
                lse_t = lse[:, :, qs, None].to(f32)
                delta_t = delta[:, :, qs, None]
                ds_row = torch.zeros((b, h, qs.stop - qs.start,
                                      keys.stop - keys.start), dtype=f32,
                                     device=q.device)
                for half in _tile_slices(keys.stop - keys.start, step):
                    ks = slice(keys.start + half.start, keys.start + half.stop)
                    if causal and ks.start >= qs.stop:
                        continue
                    kt, vt = kh[:, :, ks], vh[:, :, ks]
                    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
                    if causal:
                        qpos = torch.arange(qs.start, qs.stop, device=q.device)
                        kpos = torch.arange(ks.start, ks.stop, device=q.device)
                        s = s.masked_fill(kpos[None, :] > qpos[:, None],
                                          NEG_INF)
                    p = torch.exp2(s - lse_t)
                    dp = torch.matmul(gt, vt.transpose(-1, -2))
                    ds = p * (dp - delta_t) * sm_scale
                    p_c = p.to(g.dtype).to(f32)
                    ds_c = ds.to(q.dtype).to(f32)
                    dv[:, :, ks] += torch.matmul(p_c.transpose(-1, -2), gt)
                    dk[:, :, ks] += torch.matmul(ds_c.transpose(-1, -2), qt)
                    ds_row[..., half] = ds_c
                ds_rows.append(ds_row)
            dq[:, :, qb] += torch.matmul(torch.cat(ds_rows, dim=2),
                                         kh[:, :, keys])
    return tuple(x.to(dtype).permute(0, 2, 1, 3)
                 for x, dtype in ((dq, q.dtype), (dk, k.dtype),
                                  (dv, v.dtype)))


def _flash_bwd_plain(q, k, v, out, lse, g, dlse, sm_scale, causal,
                     block_q=KERNEL_BLOCK, block_k=KERNEL_BLOCK,
                     delta=None):
    """(dq, dk, dv) [B,T,H,D] in the input dtype by the kernel's
    algorithm: delta = rowsum(dO * O) - log2(e) * dlse; per (q tile,
    k tile) pair at or below the diagonal, P = exp2(S - lse) from the
    log2(e)-scaled scores (masked at -1e30), dP = dO V^T,
    dS = P (dP - delta) sm_scale; dV += P^T dO with P in dO's dtype,
    dK += dS^T Q and dQ += dS K with dS in q's dtype, fp32 sums. The
    pairs are block_q x block_k: every body sums dK and dV over 64-row
    q steps and dQ over 64-row k steps (the Hopper sweeps stream 64-row
    tiles past 128-row resident ones, whose rows are independent), so
    the default 64 x 64 is each kernel's order. `lse` and `dlse` (or
    None) are [B, H, T] fp32. A given `delta` [B, H, T] (the given-delta
    entry: out may be None) takes the place of rowsum(dO * O)."""
    b, t, h, d = q.shape
    f32 = torch.float32
    scale = float(sm_scale * LOG2E)
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3).to(f32) for x in (q, k, v, g))
    delta = _delta(out, g, dlse, delta)
    dq = torch.zeros((b, h, t, d), dtype=f32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for rows in _tile_slices(t, block_q):
        qt, gt = qh[:, :, rows], gh[:, :, rows]
        lse_t = lse[:, :, rows, None].to(f32)
        delta_t = delta[:, :, rows, None]
        for cols in _tile_slices(t, block_k):
            if causal and cols.start >= rows.stop:
                break
            kt, vt = kh[:, :, cols], vh[:, :, cols]
            s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
            if causal:
                qpos = torch.arange(rows.start, rows.stop, device=q.device)
                kpos = torch.arange(cols.start, cols.stop, device=q.device)
                s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
            p = torch.exp2(s - lse_t)
            dp = torch.matmul(gt, vt.transpose(-1, -2))
            ds = p * (dp - delta_t) * sm_scale
            p_c = p.to(g.dtype).to(f32)
            ds_c = ds.to(q.dtype).to(f32)
            dv[:, :, cols] += torch.matmul(p_c.transpose(-1, -2), gt)
            dk[:, :, cols] += torch.matmul(ds_c.transpose(-1, -2), qt)
            dq[:, :, rows] += torch.matmul(ds_c, kt)
    return tuple(x.to(dtype).permute(0, 2, 1, 3)
                 for x, dtype in ((dq, q.dtype), (dk, k.dtype),
                                  (dv, v.dtype)))


def _flash_bwd_twin(q, k, v, out, lse, g, dlse, sm_scale, causal,
                    delta=None):
    """The plain twin of the backward kernel q's shape and dtype route
    to: `_flash_bwd_fused_plain` where `_fused_route`, else
    `_flash_bwd_plain` (the sweeps)."""
    twin = _flash_bwd_fused_plain if _fused_route(q) else _flash_bwd_plain
    return twin(q, k, v, out, lse, g, dlse, sm_scale, causal, delta=delta)


# ----------------------------------------------------------------------
# kernel launchers
# ----------------------------------------------------------------------
def _kernel_readable(x):
    """Whether the kernels' 16-byte row loads (and the Hopper bodies'
    TMA tensor maps) can read the [B, T, H, D] tensor x in place: a
    contiguous head dim and 16-byte aligned base and (b, t, h) strides."""
    itemsize = x.element_size()
    return x.stride(3) == 1 and not x.data_ptr() % 16 and not any(
        (x.stride(i) * itemsize) % 16 for i in range(3))


def _check_kernel_operand(name, x, like):
    """`like`'s shape, dtype and device, and readable in place."""
    if x.shape != like.shape:
        raise ValueError(f"{name} shape {tuple(x.shape)} != "
                         f"q shape {tuple(like.shape)}")
    if x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"{name}: q, k, v (and out, dout) must share "
                         "dtype and device")
    if not _kernel_readable(x):
        raise ValueError(f"{name}: head dim must be contiguous, base and "
                         "(b, t, h) strides 16-byte aligned for the "
                         "kernel's loads")


def _check_kernel_shape(q, any_t=False):
    """What every body takes: fp32, bf16 or fp16, a kernel head dim
    (fp16: 64 or 128), T a multiple of 64 (any T where `any_t`: K2-fused
    masks its last q step and key block itself); and B*H at most 65535
    where the WMMA bodies run (their grid carries B*H on y; the Hopper
    bodies fold it into x)."""
    b, t, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel: dtype {q.dtype} not supported "
                        "(float32, bfloat16 or float16)")
    if q.dtype == torch.float16 and d not in _SM90_HEAD_DIMS:
        raise NotImplementedError(f"flash kernel: fp16 at head dim {d}: "
                                  f"{FP16_LATER}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {d} not in "
                         f"{_KERNEL_HEAD_DIMS} (the CUDA kernels' head "
                         "dims; the CPU twins take any)")
    if t % KERNEL_BLOCK and not any_t:
        raise ValueError(f"flash kernel: T={t} is no multiple of "
                         f"{KERNEL_BLOCK}")
    if b * h > _MAX_GRID_Y and not _on_sm90(q.dtype, d):
        raise ValueError(f"flash kernel: B*H={b * h} exceeds {_MAX_GRID_Y} "
                         f"({q.dtype}, head dim {d}: the WMMA bodies)")


def _strides(*tensors):
    vals = [x.stride(i) for x in tensors for i in range(3)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _flash_fwd_launch(q, k, v, sm_scale, causal):
    from deepspeed_tpu_torch.ops import _build
    b, t, h, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, x, q)
    _check_kernel_shape(q)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_fwd", "ds_flash_attn_fwd",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, t, h, d, _strides(q, k, v),
             float(sm_scale * LOG2E), int(bool(causal)),
             _DTYPE_CODE[q.dtype], q.device.index or 0,
             _build.stream_ptr(q))
    _build.check(err, "flash_attention kernel")
    flash_attention_with_lse.launches += 1
    return out, lse


def _check_lse(name, x, b, h, t):
    if x is not None and (x.shape != (b, h, t) or
                          x.dtype != torch.float32 or not x.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous fp32 "
                         f"[{b}, {h}, {t}] tensor")


def _flash_merge_launch(q, k, v, prev_out, prev_lse, sm_scale, causal):
    """K5 on the card: (out fp32 [B,T,H,D], lse, lse_n [B,H,T])."""
    from deepspeed_tpu_torch.ops import _build
    b, t, h, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, x, q)
    _check_kernel_shape(q)
    if prev_out.shape != q.shape or prev_out.dtype != torch.float32 or \
            prev_out.device != q.device or prev_out.stride(3) != 1:
        raise ValueError("prev_out: expected an fp32 [B, T, H, D] tensor "
                         "on q's device with a contiguous head dim")
    _check_lse("prev_lse", prev_lse, b, h, t)
    if prev_out.data_ptr() % 8 or any(prev_out.stride(i) % 2
                                      for i in range(3)):
        # the Hopper body reads prev_out 8 bytes at a time
        prev_out = prev_out.clone(memory_format=torch.contiguous_format)
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    lse, lse_n = (torch.empty((b, h, t), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    fn = _build.function("flash_attention_fwd", "ds_flash_attn_fwd_merge",
                         _MERGE_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), prev_out.data_ptr(),
             prev_lse.data_ptr(), out.data_ptr(), lse.data_ptr(),
             lse_n.data_ptr(), b, t, h, d, _strides(q, k, v, prev_out),
             float(sm_scale * LOG2E), int(bool(causal)),
             _DTYPE_CODE[q.dtype], q.device.index or 0,
             _build.stream_ptr(q))
    _build.check(err, "flash_attention merge kernel")
    flash_attention_merge.launches += 1
    return out, lse, lse_n


def _check_bwd_args(q, k, v, out, lse, g, dlse, delta, any_t=False):
    """What both backward kernels take: `_check_kernel_shape`'s, out (when
    no delta is given) and dout like q, lse, dlse and delta contiguous
    fp32 [B, H, T]."""
    b, t, h, _ = q.shape
    operands = [("q", q), ("k", k), ("v", v), ("dout", g)]
    if delta is None:
        operands.append(("out", out))
    for name, x in operands:
        _check_kernel_operand(name, x, q)
    _check_kernel_shape(q, any_t)
    for name, x in (("lse", lse), ("dlse", dlse), ("delta", delta)):
        _check_lse(name, x, b, h, t)


def _flash_bwd_fused_launch(q, k, v, out, lse, g, dlse, sm_scale, causal,
                            delta=None):
    """K2-fused on the card: one launch, delta computed inside (or the
    given one read), at any T <= 1024; dQ's partials summed in an fp32
    [B*H, T, D] workspace where there is more than one key block."""
    from deepspeed_tpu_torch.ops import _build
    b, t, h, d = q.shape
    _check_bwd_args(q, k, v, out, lse, g, dlse, delta, any_t=True)
    if not _fused_route(q):
        raise ValueError(f"K2-fused: ({q.dtype}, T={t}, head dim {d}) is "
                         "not on its route (bf16 or fp16, head dim 64 or "
                         f"128, T <= {_DEFAULT_BLOCK})")
    dq, dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    ptr = (lambda x: None if x is None else x.data_ptr())
    fn = _build.function("flash_attention_bwd_fused",
                         "ds_flash_attn_bwd_fused",
                         _BWD_ARGTYPES + [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p])
    nk = -(-t // _SM90_TILES[0])
    plan = _FusedPlan.of(nk, bool(causal), d)
    ws = torch.empty((b * h, t, d), dtype=torch.float32,
                     device=q.device) if nk > 1 else None
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(out),
             g.data_ptr(), lse.data_ptr(), ptr(dlse), ptr(delta),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d,
             _strides(q, k, v, g if out is None else out, g),
             float(sm_scale * LOG2E), float(sm_scale), int(bool(causal)),
             _DTYPE_CODE[q.dtype], q.device.index or 0, _build.stream_ptr(q),
             ctypes.byref(plan), ctypes.sizeof(plan), ptr(ws))
    _build.check(err, "flash_attention fused backward kernel")
    _flash_bwd_fused_launch.launches += 1
    return dq, dk, dv


_flash_bwd_fused_launch.launches = 0


def _flash_bwd_launch(q, k, v, out, lse, g, dlse, sm_scale, causal,
                      delta=None):
    """K2's sweeps on the card: the delta pre-pass (or the given delta's
    shift) into a workspace, then the dK/dV and dQ sweeps."""
    from deepspeed_tpu_torch.ops import _build
    b, t, h, d = q.shape
    _check_bwd_args(q, k, v, out, lse, g, dlse, delta)
    if lse.data_ptr() % 16:     # the Hopper dK/dV sweep bulk-copies lse rows
        lse = lse.clone()
    dq, dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    work = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dlse_ptr = dlse.data_ptr() if dlse is not None else None
    tail = (b, t, h, d, _strides(q, k, v, g if out is None else out, g),
            float(sm_scale * LOG2E), float(sm_scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], q.device.index or 0, _build.stream_ptr(q))
    if delta is None:
        fn = _build.function("flash_attention_bwd", "ds_flash_attn_bwd",
                             _BWD_ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 g.data_ptr(), lse.data_ptr(), dlse_ptr, dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), work.data_ptr(), *tail)
    else:
        fn = _build.function("flash_attention_bwd", "ds_flash_attn_bwd_delta",
                             _BWD_ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), dlse_ptr, delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), work.data_ptr(), *tail)
    _build.check(err, "flash_attention backward kernel")
    flash_attention_backward.launches += 1
    return dq, dk, dv


def flash_attention_backward(q, k, v, out, lse, dout, dlse=None,
                             sm_scale=None, causal=True, delta=None):
    """(dq, dk, dv) of flash attention from the forward's (out, lse)
    (lse [B, H, T] fp32 in log2 space, as `_flash_fwd_launch` and
    `_flash_fwd_plain` write it), the output cotangent `dout` and an
    optional lse cotangent `dlse` [B, H, T]. With `delta` [B, H, T]
    given (K5's backward), out is not read and may be None. CUDA tensors
    launch kernel K2-fused where `_fused_route` (T <= 1024 in bf16 or
    fp16 at head dims 64 and 128; counted on
    `_flash_bwd_fused_launch.launches`) and K2's sweeps elsewhere
    (counted here, on `flash_attention_backward.launches`); CPU tensors
    take the route's plain twin (`_flash_bwd_twin`)."""
    if out is None and delta is None:
        raise ValueError("flash_attention_backward needs out or delta")
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    if dlse is not None:
        dlse = dlse.to(torch.float32).contiguous()
    if q.is_cuda:
        if not _kernel_readable(dout):
            dout = dout.contiguous()
        launch = _flash_bwd_fused_launch if _fused_route(q) else \
            _flash_bwd_launch
        return launch(q, k, v, out, lse, dout, dlse, float(sm_scale), causal,
                      delta)
    return _flash_bwd_twin(q, k, v, out, lse, dout, dlse, float(sm_scale),
                           causal, delta=delta)


flash_attention_backward.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(out, lse [B, H, T]) = flash attention of (q, k, v): the forward
    kernel (or twin), and the backward kernel (or twin) off the saved
    (q, k, v, out, lse) — the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, named=False):
        # `named`: (out, lse) carry the names "attn_out" / "attn_lse"
        # (`flash_attention_rematerializable`), so a remat recompute that
        # keeps them does not launch the forward kernel again
        if named:
            out, lse = named_outputs(
                ("attn_out", "attn_lse"),
                lambda: _flash_forward(q, k, v, sm_scale, causal))
        else:
            out, lse = _flash_forward(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, g_out, g_lse, ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None, None


def _merge_forward(q, k, v, prev_out, prev_lse, sm_scale, causal):
    if q.is_cuda:
        return _flash_merge_launch(q, k, v, prev_out, prev_lse, sm_scale,
                                   causal)
    if q.shape[1] % KERNEL_BLOCK:
        raise ValueError(f"flash attention: T={q.shape[1]} is no "
                         f"multiple of {KERNEL_BLOCK}")
    return _flash_merge_plain(q, k, v, prev_out, prev_lse, sm_scale, causal)


class _FlashMerge(torch.autograd.Function):
    """(out, lse [B, H, T]) = flash attention of (q, k, v) merged with
    (prev_out, prev_lse [B, H, T]): K5 (or its twin) forward, and the JAX
    package's `_flash_merge_bwd` backward. With the merge weights
    a_p = 2^(lse_p - lse), a_n = 2^(lse_n - lse) and the row sums
    R_x = sum_d(g_out * o_x):
        d prev_out = g_out a_p,          d o_n = g_out a_n
        d prev_lse = ln2 a_p (R_p - R_m) + g_lse a_p
        d lse_n    = ln2 a_p (R_m - R_p) + g_lse a_n
        delta_n    = R_m - a_p R_p
    from the saved tensors only (the block's own partial o_n is never
    rebuilt), then K2 (or its twin) on (d o_n, lse_n, d lse_n) with
    delta_n given. d o_n enters K2 in q's dtype, the kernel's dO type."""

    @staticmethod
    def forward(ctx, q, k, v, prev_out, prev_lse, sm_scale, causal):
        out, lse, lse_n = _merge_forward(q, k, v, prev_out, prev_lse,
                                         sm_scale, causal)
        ctx.save_for_backward(q, k, v, prev_out, prev_lse, out, lse, lse_n)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, prev_out, prev_lse, out_m, lse_m, lse_n = ctx.saved_tensors
        f32 = torch.float32
        go = torch.zeros_like(out_m) if g_out is None else g_out.to(f32)
        gl = torch.zeros_like(lse_m) if g_lse is None else g_lse.to(f32)
        # an empty row of the block (lse_n = +inf, K2's mark) has a_n = 0
        ln = torch.where(torch.isposinf(lse_n),
                         torch.full_like(lse_n, float("-inf")), lse_n)
        a_p = torch.exp2(prev_lse.to(f32) - lse_m)          # [B, H, T]
        a_n = torch.exp2(ln - lse_m)

        def rowsum(x, y):       # [B,T,H,D] x [B,T,H,D] -> [B,H,T]
            return (x * y.to(f32)).sum(dim=-1).transpose(1, 2)

        def per_row(x):         # [B,H,T] -> [B,T,H,1]
            return x.transpose(1, 2)[..., None]

        r_m = rowsum(go, out_m)
        r_p = rowsum(go, prev_out)
        d_prev_out = go * per_row(a_p)
        d_o_n = (go * per_row(a_n)).to(q.dtype)
        d_prev_lse = LN2 * a_p * (r_p - r_m) + gl * a_p
        d_lse_n = LN2 * a_p * (r_m - r_p) + gl * a_n
        delta_n = (r_m - a_p * r_p).contiguous()
        dq, dk, dv = flash_attention_backward(
            q, k, v, None, lse_n, d_o_n, d_lse_n, ctx.sm_scale, ctx.causal,
            delta=delta_n)
        return dq, dk, dv, d_prev_out, d_prev_lse, None, None


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------
def _normalize_flash_args(q, k, v, causal, sm_scale, head_packing):
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _resolve_head_packing(head_packing, q.shape[-1])
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    return float(sm_scale), bool(causal)


def _flash_forward(q, k, v, sm_scale, causal):
    if q.is_cuda:
        return _flash_fwd_launch(q, k, v, sm_scale, causal)
    if q.shape[1] % KERNEL_BLOCK:
        raise ValueError(f"flash attention: T={q.shape[1]} is no "
                         f"multiple of {KERNEL_BLOCK}")
    return _flash_fwd_plain(q, k, v, sm_scale, causal)


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None,
                             head_packing="auto", rematerializable=False):
    """Flash attention returning (out [B,T,H,D], lse [B,H,T,1]), lse in
    LOG2 space, differentiable in both. CUDA tensors launch kernels
    K1-fwd (and K2 in the backward); CPU tensors take the plain twins
    (T must be a multiple of 64 on either). `rematerializable`: the
    outputs carry the remat names "attn_out" / "attn_lse"."""
    sm_scale, causal = _normalize_flash_args(q, k, v, causal, sm_scale,
                                             head_packing)
    if _needs_grad(q, k, v):
        out, lse = _FlashAttention.apply(q, k, v, sm_scale, causal,
                                         rematerializable)
    else:
        out, lse = _flash_forward(q, k, v, sm_scale, causal)
    return out, lse[..., None]


flash_attention_with_lse.launches = 0


def flash_attention(q, k, v, causal=True, sm_scale=None,
                    head_packing="auto"):
    """Flash attention over [B, T, H, D] tensors; returns [B, T, H, D]."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    sm_scale=sm_scale,
                                    head_packing=head_packing)[0]


def flash_attention_rematerializable(q, k, v, causal=True, sm_scale=None,
                                     head_packing="auto"):
    """flash_attention whose (out, lse) carry the remat names "attn_out"
    / "attn_lse" (the JAX package's `flash_attention_rematerializable`):
    under a remat policy that keeps them (save_only_these_names:
    attn_out,attn_lse, save_fused_epilogues) the backward never launches
    the forward kernel again. The same numbers as `flash_attention`."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    sm_scale=sm_scale,
                                    head_packing=head_packing,
                                    rematerializable=True)[0]


def flash_attention_merge(q, k, v, prev_out, prev_lse, causal=True,
                          sm_scale=None, head_packing="auto"):
    """Flash attention over one K/V block, merged in the kernel's
    epilogue with a prior softmax partial over a disjoint key set (the
    JAX package's `flash_attention_merge`, the ring-attention step).

    prev_out [B,T,H,D] (any float dtype; promoted to fp32) and prev_lse
    [B,H,T,1] (log2 space, -1e30 rows = an empty partial) are the running
    carry; returns the merged (out fp32 [B,T,H,D], lse [B,H,T,1]),
    differentiable in q, k, v, prev_out and prev_lse. CUDA tensors launch
    kernel K5 (and K2 in the backward), which raises on a prev_lse whose
    [B,H,T] view is not contiguous; CPU tensors take the plain twins."""
    sm_scale, causal = _normalize_flash_args(q, k, v, causal, sm_scale,
                                             head_packing)
    b, t, h, _ = q.shape
    if prev_out.shape != q.shape or prev_lse.shape != (b, h, t, 1):
        raise ValueError(f"prev_out {tuple(prev_out.shape)} / prev_lse "
                         f"{tuple(prev_lse.shape)}: expected {tuple(q.shape)}"
                         f" / {(b, h, t, 1)}")
    prev_out = prev_out.to(torch.float32)
    prev_lse = prev_lse.to(torch.float32)[..., 0]
    if _needs_grad(q, k, v, prev_out, prev_lse):
        out, lse = _FlashMerge.apply(q, k, v, prev_out, prev_lse, sm_scale,
                                     causal)
    else:
        out, lse, _ = _merge_forward(q, k, v, prev_out, prev_lse, sm_scale,
                                     causal)
    return out, lse[..., None]


flash_attention_merge.launches = 0


def reset_launch_count():
    """Zero the forward (K1), backward (K2-fused and K2's sweeps) and
    merge (K5) launch counters."""
    flash_attention_with_lse.launches = 0
    flash_attention_backward.launches = 0
    _flash_bwd_fused_launch.launches = 0
    flash_attention_merge.launches = 0
