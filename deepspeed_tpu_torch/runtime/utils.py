"""Runtime utilities: partitioning math, norms, memory reporting (port of
deepspeed_tpu/runtime/utils.py).

The pieces that carry over: `partition_uniform` / `partition_balanced`
(pipeline stage assignment, ref `utils.py:311,377`), the global-norm
helpers over a tree of gradients (dicts, lists and tuples of tensors;
the norms in fp32, on the device, with no host read), and device memory
reporting onto `torch.cuda.memory_stats`.
"""

import os

import torch

from deepspeed_tpu_torch.utils.logging import logger


def ensure_directory_exists(filename):
    dirname = os.path.dirname(filename)
    if dirname:
        os.makedirs(dirname, exist_ok=True)


def _leaves(tree):
    """The tensors of a tree of dicts, lists and tuples, in order (a
    dict's by sorted key)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


class CheckOverflow:
    """Overflow check over a tree of gradients: a device bool, no host
    read. At world size 1 there is no cross-rank vote."""

    def __init__(self, param_groups=None, mpu=None,
                 zero_reduce_scatter=False):
        self.mpu = mpu
        self.params = param_groups

    @staticmethod
    def has_overflow(grads):
        leaves = _leaves(grads)
        if not leaves:
            return torch.tensor(False)
        finite = torch.stack([torch.isfinite(g).all() for g in leaves])
        return ~finite.all()

    check = has_overflow


def get_grad_norm(tree, norm_type=2):
    """Global gradient norm in fp32 (a device scalar)."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.tensor(0.0, dtype=torch.float32)
    if norm_type == float("inf") or norm_type == "inf":
        return torch.stack([l.to(torch.float32).abs().max()
                            for l in leaves]).max()
    sq = [torch.sum(torch.square(l.to(torch.float32))) for l in leaves]
    return torch.sqrt(torch.sum(torch.stack(sq)))


get_weight_norm = get_grad_norm


def clip_grad_norm_(tree, max_norm, norm_type=2):
    """Return (clipped_tree, norm). Functional: the tree is not
    modified."""
    norm = get_grad_norm(tree, norm_type)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return _map(lambda g: g * factor.to(g.dtype), tree), norm


def partition_uniform(num_items, num_parts):
    """Evenly spread items over parts; returns part boundaries (len
    num_parts+1), ref `utils.py:311`."""
    parts = [0] * (num_parts + 1)
    chunksize = num_items // num_parts
    for p in range(num_parts):
        parts[p] = min(chunksize * p, num_items)
    parts[num_parts] = num_items
    return parts


def prefix_sum_inc(weights):
    """Inclusive prefix sum."""
    out = list(weights)
    for i in range(1, len(out)):
        out[i] += out[i - 1]
    return out


def _lprobe(weights, num_parts, bottleneck):
    """Greedy probe: can `weights` split into `num_parts` chunks each
    summing <= bottleneck? Returns (parts, success)."""
    parts = [0]
    total = 0
    for i, w in enumerate(weights):
        if total + w > bottleneck and total > 0:
            parts.append(i)
            total = 0
            if len(parts) > num_parts:
                return parts, False
        total += w
    while len(parts) < num_parts:
        parts.append(len(weights))
    parts.append(len(weights))
    return parts[:num_parts + 1], len(parts) <= num_parts + 1


def partition_balanced(weights, num_parts, eps=1e-3):
    """Binary-search the least bottleneck so each contiguous part's
    weight sum <= bottleneck (ref `utils.py:377`). Returns boundaries of
    length num_parts+1."""
    weights = list(weights)
    num_items = len(weights)
    if num_items <= num_parts:
        return partition_uniform(num_items, num_parts)

    lo = max(weights)
    hi = sum(weights)
    while hi - lo > eps * max(1.0, hi):
        mid = (lo + hi) / 2
        _, ok = _lprobe(weights, num_parts, mid)
        if ok:
            hi = mid
        else:
            lo = mid
    parts, ok = _lprobe(weights, num_parts, hi)
    assert ok
    return parts


def device_memory_stats():
    """{in_use_bytes, peak_bytes, reserved_bytes, device_count} summed
    (peak: max) over the visible CUDA devices, from
    `torch.cuda.memory_stats`; device_count 0 without a card."""
    if not torch.cuda.is_available():
        return {"in_use_bytes": 0, "peak_bytes": 0, "reserved_bytes": 0,
                "device_count": 0}
    in_use = peak = reserved = 0
    n = torch.cuda.device_count()
    for d in range(n):
        st = torch.cuda.memory_stats(d)
        in_use += st.get("allocated_bytes.all.current", 0)
        reserved += st.get("reserved_bytes.all.current", 0)
        peak = max(peak, st.get("allocated_bytes.all.peak", 0))
    return {"in_use_bytes": in_use, "peak_bytes": peak,
            "reserved_bytes": reserved, "device_count": n}


def see_memory_usage(message, force=False):
    """Log the device-memory picture (in use and peak over the visible
    CUDA devices). Without a card it says so."""
    if not force:
        return
    gib = 1024 ** 3
    stats = device_memory_stats()
    if stats["device_count"]:
        logger.info(
            f"{message} | DeviceMem in-use "
            f"{stats['in_use_bytes'] / gib:.2f} GB "
            f"peak {stats['peak_bytes'] / gib:.2f} GB "
            f"reserved {stats['reserved_bytes'] / gib:.2f} GB "
            f"(over {stats['device_count']} local devices)")
    else:
        logger.info(f"{message} | device memory stats unavailable")


def memory_status(msg, print_rank=-1, reset_max=False):
    see_memory_usage(msg, force=True)
    if reset_max and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def global_norm_squared(tree):
    return get_grad_norm(tree) ** 2


def call_to_str(base, *args, **kwargs):
    """Construct a string representation of a call (ref `utils.py`)."""
    name = f"{base}("
    if args:
        name += ", ".join(repr(arg) for arg in args)
        if kwargs:
            name += ", "
    if kwargs:
        name += ", ".join(f"{key}={repr(arg)}"
                          for key, arg in kwargs.items())
    name += ")"
    return name
