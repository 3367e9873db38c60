"""Dispatch/combine as one-hot einsums (port of
deepspeed_tpu/moe/dispatch.py at world size 1).

The `fused_dispatch: "off"` route, and the route `moe_mlp_reference`
takes: [N, H] tokens -> [E, C, H] buffers through the [N, E, C] dispatch
mask, and back through the combine weights. In the JAX package these
carry sharding constraints that XLA lowers to the all-to-alls of an
expert-parallel mesh; the port runs on one device, where the einsums
are the whole of it (the expert mesh and its all-to-all over NCCL come with world size > 1).
`record_dispatch_bytes` / `dispatch_bytes_per_layer` feed the memory
ledger's `moe_dispatch` category (monitor/memory.py).
"""

import threading

import torch

# process-global accounting: {key: (bytes, num_experts, width) of one
# MoE layer's dispatch buffers}, written by each layer's forward (a host
# dict write, no device work). Layers are uniform by construction, so
# consumers read the MAX over the entries matching their model's
# (num_experts, width) signature.
_DISPATCH_BYTES = {}
_LOCK = threading.Lock()


def record_dispatch_bytes(key, nbytes, num_experts=None, width=None):
    with _LOCK:
        _DISPATCH_BYTES[str(key)] = (int(nbytes), num_experts, width)


def dispatch_bytes_per_layer(mesh=None, num_experts=None, width=None):
    """Bytes of ONE MoE layer's dispatch buffers (0 until a forward
    ran); `num_experts`/`width` filter the recorded entries to this
    model's shape signature (None matches anything). A host dict read —
    fence-safe. `mesh` is the JAX signature's: one device holds all."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel meshes come with world size > 1 (ROADMAP "
            "Queue 1 item 6)")
    with _LOCK:
        vals = [b for b, e, h in _DISPATCH_BYTES.values()
                if (num_experts is None or e is None or
                    e == num_experts) and
                (width is None or h is None or h == width)]
    return int(max(vals, default=0))


def reset_dispatch_accounting():
    with _LOCK:
        _DISPATCH_BYTES.clear()


def dispatch_tokens(x, dispatch_mask, granularity=1):
    """[N, H] tokens -> [E, C, H] per-expert buffers. `granularity` > 1
    splits the einsum along the capacity axis into that many contiguous
    chunks (the `moe_dispatch` overlap schedule's knob, ops/overlap.py):
    each chunk contracts the same tokens, so the concatenation equals
    the single einsum bit for bit."""
    c = dispatch_mask.shape[-1]
    g = max(int(granularity), 1)
    mask = dispatch_mask.to(x.dtype)
    if g <= 1 or c < g:
        return torch.einsum("nec,nh->ech", mask, x)
    sizes = [c // g + (1 if i < c % g else 0) for i in range(g)]
    chunks = torch.split(mask, sizes, dim=2)
    return torch.cat([torch.einsum("nec,nh->ech", m, x) for m in chunks],
                     dim=1)


def combine_tokens(ye, combine_weights):
    """[E, C, H] expert outputs -> [N, H], weighted by the gate probs;
    dropped tokens get zeros (their residual carries them)."""
    return torch.einsum("nec,ech->nh", combine_weights.to(ye.dtype), ye)


def replicate_stats(stats, mesh=None):
    """The identity: without an expert mesh the stats vector is whole."""
    return stats


def dispatch_buffer_nbytes(num_experts, capacity, width, dtype, mesh=None):
    """Bytes of one MoE layer's dispatch buffers: the [E, C, H] send
    tensor and the [E, C, H] expert-output tensor (one device holds both
    at world size 1)."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel meshes come with world size > 1 (ROADMAP "
            "Queue 1 item 6)")
    return 2 * int(num_experts) * int(capacity) * int(width) * \
        dtype.itemsize
