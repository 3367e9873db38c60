"""Fused MoE dispatch and combine over capacity-indexed rows (kernel K8;
port of deepspeed_tpu/moe/fused_dispatch.py).

Routing in index form (`top_k_gating_indexed`: e_idx/slot/keep/w, each
[N, k]) drives two row gathers in place of the one-hot einsum pair:

  * ``fused_dispatch(x, src, dest, keep)`` — [N, H] tokens -> [E*C, H]
    rows: row s holds the token in slot s, zeros for an empty slot
    (`src` [E*C] maps slot -> token, N the empty-slot sentinel);
  * ``fused_combine(ye_flat, dest, keep, w)`` — [E*C, H] expert rows ->
    [N, H]: token n sums its k slots `dest[n]` scaled by keep * w, in
    fp32, written in ye's dtype.

The rows may be fp32, bf16 or fp16 (the fp16 engine's MoE layers): a
16-bit row is widened, scaled and summed in fp32 and rounded once to its
dtype, so an fp16 sum past 65504 is inf, as in the JAX kernel.

The Pallas kernels `_dispatch_kernel` / `_make_combine_kernel` become
the CUDA kernels of `ops/csrc/moe_dispatch.cu`, launched by
`gather_rows` and `combine_rows` (each counts its launches in
`.launches`). A CUDA tensor launches the kernel; a CPU tensor takes the
plain twin (`_gather_rows_plain`, `_combine_rows_plain`). There is no
fallback from a CUDA tensor to a twin.

Backward passes keep the JAX custom VJPs' contracts, computed as
gathers (no float atomics, so runs repeat bit for bit):

  dispatch:  dx[n] = sum of the token's <= k slot cotangents in fp32,
             i.e. `combine_rows(d_xe, dest, keep)`; this is why the
             port's dispatch takes `dest`/`keep` beside `src`;
  combine:   d_ye[s] = cw[n, j] * dy[n] for the one assignment (n, j)
             in slot s, i.e. `gather_rows(dy, src, slot weights)`;
             d_cw[n, j] = <ye[dest[n, j]], dy[n]> in fp32 (plain torch,
             as the JAX package leaves it to XLA).

No gradient reaches the integer maps or `keep`.
"""

import ctypes

import torch

from deepspeed_tpu_torch.profiling.flops_profiler.profiler import \
    kernel_call

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _to_slots(dest, keep, values, slots, fill):
    """[slots] tensor holding values[n, j] at slot dest[n, j] for each
    kept assignment and `fill` elsewhere. Kept assignments own distinct
    slots, so the scatter never collides; dropped ones go to a discarded
    extra slot."""
    idx = torch.where(keep > 0, dest, torch.full_like(dest, slots))
    out = torch.full((slots + 1,), fill, dtype=values.dtype,
                     device=dest.device)
    out[idx.reshape(-1).long()] = values.reshape(-1)
    return out[:slots]


def _tokens(dest):
    """[N, k] int32: the token of each assignment."""
    n, k = dest.shape
    return torch.arange(n, dtype=torch.int32,
                        device=dest.device)[:, None].expand(n, k)


def routing_slots(routing, num_experts, capacity):
    """Index-form routing -> (src [E*C] int32: slot -> token, N for an
    empty slot; dest [N, k] int32: (token, choice) -> slot, always in
    range, a dropped choice pointing at its expert's slot 0 and zeroed
    through keep)."""
    dest = routing["e_idx"].to(torch.int32) * int(capacity) + \
        routing["slot"].to(torch.int32)
    src = _to_slots(dest, routing["keep"], _tokens(dest),
                    int(num_experts) * int(capacity), dest.shape[0])
    return src, dest


# ----------------------------------------------------------------------
# plain twins (the kernels compute the same formulas)
# ----------------------------------------------------------------------
def _gather_rows_plain(x, src, slot_w=None):
    """out[s] = slot_w[s] * x[src[s]] (zeros where src[s] = N), fp32
    product, in x's dtype."""
    xp = torch.cat([x, torch.zeros((1, x.shape[1]), dtype=x.dtype,
                                   device=x.device)])
    out = xp.index_select(0, src.long())
    if slot_w is None:
        return out
    return (out.to(torch.float32) * slot_w[:, None]).to(x.dtype)


def _combine_rows_plain(ye, dest, cw):
    """out[n] = sum_j cw[n, j] * ye[dest[n, j]] in fp32, in ye's dtype."""
    n, k = dest.shape
    parts = ye.index_select(0, dest.reshape(-1).long()).reshape(
        n, k, ye.shape[1])
    acc = (cw.to(torch.float32)[:, :, None] * parts.to(torch.float32))
    return acc.sum(dim=1).to(ye.dtype)


# ----------------------------------------------------------------------
# kernel launchers
# ----------------------------------------------------------------------
def _check(name, t, dtype=None):
    if dtype is None and t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, "
                        "bfloat16 or float16)")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _vec(*tensors):
    """Rows move as 16-byte vectors when every row's bytes are a
    multiple of 16 and every base pointer is 16-byte aligned."""
    return int(all(t.data_ptr() % 16 == 0 and
                   (t.shape[-1] * t.element_size()) % 16 == 0
                   for t in tensors))


def _gather_rows_launch(x, src, slot_w):
    from deepspeed_tpu_torch.ops import _build
    _check("x", x)
    _check("src", src, torch.int32)
    if slot_w is not None:
        _check("slot weights", slot_w, torch.float32)
        if slot_w.shape != src.shape:
            raise ValueError(f"slot weights {tuple(slot_w.shape)} != src "
                             f"{tuple(src.shape)}")
    if src.device != x.device or (slot_w is not None and
                                  slot_w.device != x.device):
        raise ValueError("x, src and the slot weights must be on one device")
    n, h = x.shape
    out = torch.empty((src.shape[0], h), dtype=x.dtype, device=x.device)
    fn = _build.function("moe_dispatch", "ds_moe_gather_rows", _ARGTYPES)
    err = fn(x.data_ptr(), src.data_ptr(),
             slot_w.data_ptr() if slot_w is not None else None,
             out.data_ptr(), n, src.shape[0], h, _DTYPE_CODE[x.dtype],
             _vec(x, out), x.device.index or 0, _build.stream_ptr(x))
    _build.check(err, "moe gather_rows kernel")
    gather_rows.launches += 1
    return out


def _combine_rows_launch(ye, dest, cw):
    from deepspeed_tpu_torch.ops import _build
    _check("ye", ye)
    _check("dest", dest, torch.int32)
    _check("cw", cw, torch.float32)
    if cw.shape != dest.shape:
        raise ValueError(f"cw {tuple(cw.shape)} != dest {tuple(dest.shape)}")
    if dest.device != ye.device or cw.device != ye.device:
        raise ValueError("ye, dest and cw must be on one device")
    n, k = dest.shape
    h = ye.shape[1]
    out = torch.empty((n, h), dtype=ye.dtype, device=ye.device)
    fn = _build.function("moe_dispatch", "ds_moe_combine_rows", _ARGTYPES)
    err = fn(ye.data_ptr(), dest.data_ptr(), cw.data_ptr(), out.data_ptr(),
             n, k, h, _DTYPE_CODE[ye.dtype], _vec(ye, out),
             ye.device.index or 0, _build.stream_ptr(ye))
    _build.check(err, "moe combine_rows kernel")
    combine_rows.launches += 1
    return out


def gather_rows(x, src, slot_w=None):
    """out [S, H] with out[s] = slot_w[s] * x[src[s]] (w = 1 when
    `slot_w` is None), zeros where src[s] >= N. x [N, H] fp32/bf16/fp16,
    src [S] int32, slot_w [S] fp32. CUDA tensors launch K8's gather;
    CPU tensors take the plain twin. No gradient: the autograd Functions
    below call it."""
    def run():
        if x.is_cuda:
            return _gather_rows_launch(x.contiguous(), src.contiguous(),
                                       slot_w)
        return _gather_rows_plain(x, src, slot_w)
    return kernel_call("K8-dispatch", "moe_dispatch", "gather_rows",
                       lambda: gather_cost(x, src, slot_w), run)


def gather_cost(x, src, slot_w):
    """K8-dispatch's (flops, bytes, transcendentals) by shapes: every
    slot row written and (at most) read, the slot map and weights read;
    a multiply an element when weighted. (chip_smoke.py's bound counts
    the occupied slots of its data; a profile reads no data.)"""
    s, h = src.numel(), x.shape[-1]
    weighted = slot_w is not None
    return (s * h if weighted else 0,
            2 * s * h * x.element_size() + s * 4 * (2 if weighted else 1),
            0)


def combine_cost(ye, dest):
    """K8-combine's: a multiply-add an element of each kept assignment;
    the assignments' rows read, every token row written, dest and cw
    read."""
    n, k = dest.shape
    h = ye.shape[-1]
    return 2 * n * k * h, (n * k + n) * h * ye.element_size() + n * k * 8, 0


gather_rows.launches = 0


def combine_rows(ye, dest, cw):
    """out [N, H] with out[n] = sum_j cw[n, j] * ye[dest[n, j]], fp32
    accumulation, in ye's dtype. ye [S, H] fp32/bf16/fp16, dest [N, k] int32,
    cw [N, k] fp32. CUDA tensors launch K8's combine; CPU tensors take
    the plain twin. No gradient (see gather_rows)."""
    def run():
        if ye.is_cuda:
            return _combine_rows_launch(ye.contiguous(), dest.contiguous(),
                                        cw.contiguous())
        return _combine_rows_plain(ye, dest, cw)
    return kernel_call("K8-combine", "moe_dispatch", "combine_rows",
                       lambda: combine_cost(ye, dest), run)


combine_rows.launches = 0


def reset_launch_counts():
    """Zero K8's two launch counters."""
    gather_rows.launches = 0
    combine_rows.launches = 0


# ----------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------
class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dest, keep):
        ctx.save_for_backward(dest, keep)
        return gather_rows(x, src)

    @staticmethod
    def backward(ctx, g):
        dest, keep = ctx.saved_tensors
        dx = combine_rows(g.contiguous(), dest,
                          keep.to(torch.float32).contiguous())
        return dx, None, None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ye_flat, dest, keep, cw):
        ctx.save_for_backward(ye_flat, dest, keep, cw)
        return combine_rows(ye_flat, dest, cw)

    @staticmethod
    def backward(ctx, dy):
        ye_flat, dest, keep, cw = ctx.saved_tensors
        dy = dy.contiguous()
        d_ye = d_cw = None
        if ctx.needs_input_grad[0]:
            # each slot's one assignment: its token and combine weight
            slots = ye_flat.shape[0]
            src = _to_slots(dest, keep, _tokens(dest), slots, dest.shape[0])
            d_ye = gather_rows(dy, src, _to_slots(dest, keep, cw, slots, 0.0))
        if ctx.needs_input_grad[3]:
            n, k = dest.shape
            parts = ye_flat.index_select(0, dest.reshape(-1).long())
            d_cw = torch.einsum(
                "nkh,nh->nk", parts.reshape(n, k, -1).to(torch.float32),
                dy.to(torch.float32)).to(cw.dtype)
        return d_ye, None, None, d_cw


def fused_dispatch(x, src, dest=None, keep=None):
    """[N, H] tokens + slot map `src` [E*C] -> [E*C, H] capacity-indexed
    rows (reshape to [E, C, H] for the experts). Differentiable in x:
    the backward is the combine gather over `dest` [N, k] with weights
    `keep` [N, k], which a differentiable call must pass (the routing's
    `routing_slots` and `keep`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        if dest is None or keep is None:
            raise ValueError("fused_dispatch needs dest and keep to "
                             "differentiate (the backward gathers each "
                             "token's slots)")
        return _Dispatch.apply(x, src, dest.to(torch.int32),
                               keep.detach())
    return gather_rows(x, src)


def fused_combine(ye_flat, dest, keep, w):
    """[E*C, H] expert rows -> [N, H]: token n sums its k slots scaled by
    keep * w (fp32 accumulation). Differentiable in ye_flat and w (the
    gate-prob path); `keep` is the capacity mask (no gradient)."""
    dest = dest.to(torch.int32)
    keep = keep.detach()
    cw = keep.to(torch.float32) * w.to(torch.float32)
    if torch.is_grad_enabled() and (ye_flat.requires_grad or
                                    cw.requires_grad):
        return _Combine.apply(ye_flat, dest, keep, cw)
    return combine_rows(ye_flat, dest, cw)
