"""Sequence parallelism: ring attention and Ulysses all-to-all (port of
deepspeed_tpu/ops/sequence/ring_attention.py).

The JAX package runs both under `shard_map` over a `seq` mesh axis, on
global [B, T, H, D] arrays. The port is SPMD in torch's idiom: each rank
of a `torch.distributed` process group holds its own sequence chunk
[B, T/P, H, D] (rank r the r-th chunk) and calls the function with the
group (`group=None` is the default group, WORLD) in place of the mesh
and its axis name. The result is the rank's chunk of the output.

  ring_attention    q stays put; the K/V chunks rotate one rank on per
                    step (`dist.batch_isend_irecv`), and each step folds
                    the held block into the running softmax carry. On
                    the flash body that fold is `flash_attention_merge`
                    (kernel K5 on CUDA), which merges the carry in its
                    epilogue.
  ulysses_attention `dist.all_to_all_single` trades the sequence chunk
                    for a head shard, attention runs over the whole
                    sequence on H/P heads, and a second all-to-all
                    trades back (DeepSpeed-Ulysses); heads % P == 0.

Both are differentiable: the rotation and the all-to-all are autograd
Functions whose backward is the reverse hop or the inverse swap (JAX's
transposes of ppermute and all_to_all), so dK/dV reach the rank that
owns the chunk by the same ring.
"""

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    NEG_INF, dense_attention, flash_attention, flash_attention_merge,
    flash_attention_usable)


def _size_rank(group):
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "sequence parallelism needs an initialized torch.distributed "
            "process group (deepspeed_tpu_torch.init_distributed)")
    return dist.get_world_size(group), dist.get_rank(group)


def _global_rank(group, r):
    return r if group is None else dist.get_global_rank(group, r)


def _check_chunks(q, k, v, group, what):
    """Equal q/k/v shapes, and an equal chunk length on every rank (the
    JAX package's T % P check: the port never sees the global T)."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"{what}: q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    p, _ = _size_rank(group)
    if p == 1:
        return p
    mine = torch.tensor([q.shape[1]], dtype=torch.int64, device=q.device)
    lens = [torch.zeros_like(mine) for _ in range(p)]
    dist.all_gather(lens, mine, group=group)
    lens = [int(x) for x in lens]
    if len(set(lens)) != 1:
        raise ValueError(
            f"{what}: sequence length {sum(lens)} must be divisible by the "
            f"group size {p}, every rank holding an equal chunk (local "
            f"lengths {lens}); pad the sequence")
    return p


# ----------------------------------------------------------------------
# the ring's K/V rotation
# ----------------------------------------------------------------------
class _Hop:
    """One hop in flight: each tensor of `xs` goes to the rank `shift`
    places on around the group's ring, and a tensor of the same shape
    comes from the rank `shift` places back. `wait()` returns those."""

    def __init__(self, xs, group, shift):
        p, r = _size_rank(group)
        to = _global_rank(group, (r + shift) % p)
        frm = _global_rank(group, (r - shift) % p)
        self.sent = [x.contiguous() for x in xs]
        self.out = [torch.empty_like(x) for x in self.sent]
        ops = []
        for x, y in zip(self.sent, self.out):
            ops += [dist.P2POp(dist.isend, x, to, group),
                    dist.P2POp(dist.irecv, y, frm, group)]
        self.reqs = dist.batch_isend_irecv(ops)

    def wait(self):
        for req in self.reqs:
            req.wait()
        return self.out


class _RingHop(torch.autograd.Function):
    """(k, v) `shift` ranks on: the forward posts the hop, appends it to
    `pending` and returns its receive buffers, which hold the block once
    the caller has waited on the hop; the backward sends the cotangents
    `shift` ranks back."""

    @staticmethod
    def forward(ctx, group, pending, k, v, shift=1):
        ctx.group, ctx.shift = group, shift
        hop = _Hop((k, v), group, shift)
        pending.append(hop)
        return tuple(hop.out)

    @staticmethod
    def backward(ctx, dk, dv):
        dk, dv = _Hop((dk, dv), ctx.group, -ctx.shift).wait()
        return None, None, dk, dv, None


class _Anchor(torch.autograd.Function):
    """Identity on `out` whose backward also gives every rotated block a
    zero cotangent: each rank then runs every hop's backward (and its
    send), also where its own causal folds skipped the block."""

    @staticmethod
    def forward(ctx, out, *blocks):
        ctx.like = [(b.shape, b.dtype, b.device) for b in blocks]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d)
                     for s, t, d in ctx.like))


def _ring(k, v, group, causal, fold, carry):
    """JAX's ring scan under the `ring` overlap schedule (ops/overlap.py):
    at step s the held K/V block is rank (r - s) mod P's. Overlapped at
    issue distance d, the hop that brings block s + d is posted before
    block s is folded into `carry`, as JAX's pre-rotated window posts it
    (blocks 1 .. d-1 come straight from their owners, a shift of j ranks,
    then each block is the one before it one rank on); without overlap
    the hop is posted after the fold. The blocks and the fold order are
    the same either way, and at d = 2 so are the hops, so outputs and
    gradients match distance 1 bit for bit. Under `causal` the diagonal
    block (s = 0) folds with the causal mask, a block from a lower rank
    without one, and a block from a higher rank is skipped (the carry
    passes through, no launch). JAX's scan rotates P times and its last
    rotation is dead; here blocks come P - 1 times, so a group of one
    rank sends nothing. Returns the carry and the received blocks (for
    `_Anchor`)."""
    from deepspeed_tpu_torch.ops import overlap
    p, r = _size_rank(group)
    payload = 2 * k.numel() * k.element_size()
    sched = overlap.schedule(overlap.SITE_RING, payload_bytes=payload,
                             mesh={"seq": p})
    ahead = min(max(int(sched["issue_distance"]), 1), p) \
        if sched["overlap"] else 0
    overlap.record_inflight(overlap.SITE_RING, "seq", ahead * payload)
    blocks = {0: (k, v)}
    hops = {}
    rotated = []

    def post(t, src, shift):
        pending = []
        nk, nv = _RingHop.apply(group, pending, *src, shift)
        hops[t] = (pending[0], (nk, nv))
        rotated.extend([nk, nv])

    def block(t):
        if t not in blocks:
            hop, kv = hops.pop(t)
            hop.wait()
            blocks[t] = kv
        return blocks[t]

    for j in range(1, min(ahead, p)):
        post(j, (k, v), j)
    for step in range(p):
        t = step + ahead
        if ahead and t < p:
            post(t, block(t - 1), 1)
        kb, vb = block(step)
        src = (r - step) % p
        if not causal or src < r:
            carry = fold(kb, vb, carry, False)
        elif src == r:
            carry = fold(kb, vb, carry, True)
        if not ahead and step + 1 < p:
            post(step + 1, (kb, vb), 1)
        blocks.pop(step, None)
    return carry, rotated


# ----------------------------------------------------------------------
# ring bodies
# ----------------------------------------------------------------------
def _block_attn_partial(q, k, v, sm_scale, mask=None):
    """Unmerged partial of one K/V block in natural exp: (numerator
    [B,Tq,H,D] fp32, m [B,H,Tq,1], l [B,H,Tq,1]), the scores materialized
    (the fallback body). A row that sees nothing keeps m at -5e29."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * sm_scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    pr = torch.exp(s - m_safe)
    if mask is not None:
        pr = torch.where(mask, pr, 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    num = torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype), v)
    return num.to(torch.float32), m_safe, l


def _merge(acc, num, m_new, l_new):
    """Fold one block partial into the running (num, m, l)."""
    num_acc, m_acc, l_acc = acc
    m = torch.maximum(m_acc, m_new)
    a1 = torch.exp(m_acc - m)
    a2 = torch.exp(m_new - m)
    num_out = num_acc * a1.transpose(1, 2) + num * a2.transpose(1, 2)
    return num_out, m, l_acc * a1 + l_new * a2


def ring_attention_local(q, k, v, group=None, causal=True, sm_scale=None):
    """The fallback ring body on the rank's chunks [B, Tl, H, D]: each
    step's partial by `_block_attn_partial` (plain torch, not a kernel),
    merged by the online (m, l) recurrence. A skipped upper block would
    merge as the identity in the JAX body (its weight is exp(-5e29 - m)
    = 0), so skipping it gives the same numbers."""
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    b, tl, h, d = q.shape
    f32 = torch.float32
    carry = (torch.zeros((b, tl, h, d), dtype=f32, device=q.device),
             torch.full((b, h, tl, 1), NEG_INF, dtype=f32, device=q.device),
             torch.zeros((b, h, tl, 1), dtype=f32, device=q.device))
    tri = torch.ones((tl, tl), dtype=torch.bool, device=q.device).tril()

    def fold(kb, vb, acc, diag):
        part = _block_attn_partial(q, kb, vb, sm_scale,
                                   tri[None, None] if diag else None)
        return _merge(acc, *part)

    (num, _, l), rotated = _ring(k, v, group, causal, fold, carry)
    if rotated:
        num = _Anchor.apply(num, *rotated)
    out = num / l.clamp(min=1e-30).transpose(1, 2)
    return out.to(q.dtype)


def _ring_local_flash(q, k, v, group=None, causal=True, sm_scale=None,
                      head_packing="auto"):
    """The flash ring body: the carry (out fp32 [B,Tl,H,D], lse
    [B,H,Tl,1] log2) starts at zeros and -1e30 (an empty partial), and
    each step folds the held block in through `flash_attention_merge`
    (kernel K5 on CUDA, its twin on the CPU), the diagonal block with the
    causal kernel and a lower block with the full one."""
    b, tl, h, d = q.shape
    f32 = torch.float32
    carry = (torch.zeros((b, tl, h, d), dtype=f32, device=q.device),
             torch.full((b, h, tl, 1), NEG_INF, dtype=f32, device=q.device))

    def fold(kb, vb, acc, diag):
        return flash_attention_merge(q, kb, vb, *acc, causal=diag,
                                     sm_scale=sm_scale,
                                     head_packing=head_packing)

    (out, _), rotated = _ring(k, v, group, causal, fold, carry)
    if rotated:
        out = _Anchor.apply(out, *rotated)
    return out.to(q.dtype)


def ring_attention(q, k, v, group=None, causal=True, sm_scale=None,
                   use_flash=None, head_packing="auto"):
    """Ring attention over the rank's chunk [B, T/P, H, D] of a sequence
    split over `group` (None = WORLD) in rank order; returns the rank's
    chunk of the output.

    use_flash=None takes the flash body on CUDA tensors whose local
    chunk meets the kernel's contract (`flash_attention_usable`: chunk a
    multiple of 128, head dim a multiple of 64), else the fallback;
    True runs the flash body anywhere (its twins on the CPU, as the JAX
    package's interpret=True runs the Pallas kernel); False the
    fallback. Chunks of unequal length across the ranks raise."""
    _check_chunks(q, k, v, group, "ring_attention")
    if use_flash is None:
        use_flash = q.is_cuda and flash_attention_usable(q, True)
    if use_flash:
        return _ring_local_flash(q, k, v, group, causal, sm_scale,
                                 head_packing)
    return ring_attention_local(q, k, v, group, causal, sm_scale)


# ----------------------------------------------------------------------
# Ulysses
# ----------------------------------------------------------------------
def _seq_to_head(x, group):
    """[B, Tl, H, D] -> [B, Tl*P, H/P, D]: head shard j goes to rank j,
    and the chunks that come back concatenate in rank (= sequence)
    order (JAX's all_to_all with tiled=True)."""
    p, _ = _size_rank(group)
    b, tl, h, d = x.shape
    send = x.reshape(b, tl, p, h // p, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, p * tl, h // p, d)


def _head_to_seq(x, group):
    """[B, T, H/P, D] -> [B, T/P, H, D]: the inverse swap."""
    p, _ = _size_rank(group)
    b, t, hp, d = x.shape
    send = x.reshape(b, p, t // p, hp, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, t // p, p * hp, d)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_head(x, group)

    @staticmethod
    def backward(ctx, g):
        return _head_to_seq(g, ctx.group), None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _head_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_head(g, ctx.group), None


def ulysses_attention_local(q, k, v, group=None, causal=True, sm_scale=None,
                            attn_fn=None):
    """The Ulysses body on the rank's chunks: swap the sequence chunk for
    a head shard, attend over the whole sequence on H/P heads with
    `attn_fn` (default: dense attention), swap back."""
    qg, kg, vg = (_SeqToHead.apply(x, group) for x in (q, k, v))
    if attn_fn is None:
        out = dense_attention(qg, kg, vg, causal=causal, sm_scale=sm_scale)
    else:
        out = attn_fn(qg, kg, vg)
    return _HeadToSeq.apply(out, group)


def ulysses_attention(q, k, v, group=None, causal=True, sm_scale=None,
                      use_flash=None, head_packing="auto"):
    """Ulysses sequence-parallel attention over the rank's chunk
    [B, T/P, H, D] of a sequence split over `group` (None = WORLD);
    returns the rank's chunk of the output. The whole-sequence attention
    is flash (kernels K1/K2 on CUDA, the twins on the CPU with
    use_flash=True) where `flash_attention_usable` admits it, dense
    attention elsewhere; use_flash=None means flash on CUDA tensors."""
    p = _check_chunks(q, k, v, group, "ulysses_attention")
    h = q.shape[2]
    if h % p:
        raise ValueError(
            f"ulysses_attention needs heads {h} divisible by the group "
            f"size {p} (the all-to-all trades a head shard for the "
            "sequence chunk); use ring_attention for indivisible head "
            "counts")
    if use_flash is None:
        use_flash = q.is_cuda
    attn_fn = None
    if use_flash:
        def attn_fn(qg, kg, vg):
            if flash_attention_usable(qg, True):
                return flash_attention(qg, kg, vg, causal=causal,
                                       sm_scale=sm_scale,
                                       head_packing=head_packing)
            return dense_attention(qg, kg, vg, causal=causal,
                                   sm_scale=sm_scale)
    return ulysses_attention_local(q, k, v, group, causal, sm_scale,
                                   attn_fn)


# ----------------------------------------------------------------------
# a replicated sequence in and out of the group's chunks
# ----------------------------------------------------------------------
class _TakeChunk(torch.autograd.Function):
    """x [B, T, ...], the same on every rank -> the rank's chunk
    [B, T/P, ...]; the backward all-gathers the chunks' cotangents, so
    every rank gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        p, r = _size_rank(group)
        ctx.group = group
        tl = x.shape[1] // p
        return x.narrow(1, r * tl, tl)

    @staticmethod
    def backward(ctx, g):
        return _gather_chunks(g, ctx.group), None


class _GatherChunks(torch.autograd.Function):
    """The rank's chunk -> the whole sequence, the chunks in rank order;
    the backward takes the rank's own chunk of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_chunks(x, group)

    @staticmethod
    def backward(ctx, g):
        p, r = _size_rank(ctx.group)
        tl = g.shape[1] // p
        return g.narrow(1, r * tl, tl), None


def _gather_chunks(x, group):
    p, _ = _size_rank(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(p)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


def scatter_sequence(x, group=None):
    """The rank's chunk of a sequence [B, T, ...] that every rank of
    `group` holds whole (T % P == 0); differentiable."""
    p, _ = _size_rank(group)
    if x.shape[1] % p:
        raise ValueError(f"sequence length {x.shape[1]} must be divisible "
                         f"by the group size {p} (pad the sequence)")
    return _TakeChunk.apply(x, group)


def gather_sequence(x, group=None):
    """The whole sequence from the ranks' chunks, on every rank;
    differentiable."""
    return _GatherChunks.apply(x, group)
