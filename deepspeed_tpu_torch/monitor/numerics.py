"""Device-side numerics health: per-layer/per-group accumulators with
first-NaN attribution (port of deepspeed_tpu/monitor/numerics.py).

A loss blow-up's post-mortem question is never "did it NaN" (the
overflow flag says so) but "WHERE did it first NaN" — which layer's
activations, which parameter group's gradients. Answering that with
host-side inspection would re-synchronize the hot path per step;
instead the stats are computed on the device inside the step, on
tensors the step already materializes:

  * activation stats — (abs-max, mean|x|, nonfinite count) at every
    layer boundary of layer-exposing models (the JAX package's
    PipelineModule taps each boundary; this package has no pipeline
    engine yet, ROADMAP Queue 1 item 6, so no model here taps them and
    `act` stays None);
  * gradient stats — (L2 norm, abs-max, nonfinite count) per group of
    parameters (the JAX tree's first two path components,
    `group_paths(tree, depth=2)`, on the model's `params_to_jax` tree),
    computed on the unscaled gradients right before the overflow vote —
    the "overflow source" per group.

The per-step cost is a few reductions over tensors already on the
device, and the outputs are tiny device tensors ([L,3]/[G,3]) the
registry RETAINS exactly like the loss scalar — a list append, no
launch, no sync — and drains in the same single per-fence copy (the
guard test pins zero new per-step syncs). Long windows compact through
`fold_entries` (a handful of launches alongside the registry's scalar
compaction), which preserves the first-nonfinite (window-step, kind,
index) candidate on the device before per-step granularity is
discarded.

Stats layout (always float32):
  activation rows: [absmax, mean_abs, nonfinite_count]
  gradient rows:   [l2_norm, absmax, nonfinite_flag]  (0/1 per step;
                   window-summed it counts affected steps — the flag
                   derives free from the two reductions, see
                   grad_group_stats)
"""

import numpy as np
import torch

KIND_ACT = 0
KIND_GRAD = 1

ACT_COLS = ("absmax", "mean_abs", "nonfinite")
GRAD_COLS = ("norm", "absmax", "nonfinite")


# ----------------------------------------------------------------------
# in-step stat computation (device tensors, no host read)
# ----------------------------------------------------------------------
def tensor_stats(x):
    """[3] f32 activation stats for one boundary tensor: abs-max,
    mean|x|, nonfinite count. Reductions only — no data-dependent
    control flow."""
    xf = x.to(torch.float32)
    ax = torch.abs(xf)
    return torch.stack([
        torch.amax(ax),
        torch.mean(ax),
        torch.sum(~torch.isfinite(xf)).to(torch.float32),
    ])


def stack_act_stats(per_layer):
    """[L, 3] from a list of per-boundary tensor_stats vectors."""
    return torch.stack(per_layer)


def combine_act_microbatches(acts):
    """Reduce [gas, L, 3] per-microbatch activation stats to [L, 3]:
    absmax -> max, mean_abs -> mean, nonfinite -> sum."""
    return torch.stack([
        torch.amax(acts[..., 0], dim=0),
        torch.mean(acts[..., 1], dim=0),
        torch.sum(acts[..., 2], dim=0),
    ], dim=-1)


def _children(node):
    """[(key string, child)] in JAX's tree order (dict keys sorted,
    named-tuple fields, sequence indices), or None for a leaf; the key
    strings are `jax.tree_util.keystr` of one path entry."""
    from deepspeed_tpu_torch.runtime.checkpoint import _children as kids
    return kids(node)


def _flatten_with_path(tree, path=()):
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, child in kids:
        out += _flatten_with_path(child, path + (key,))
    return out


def _path_prefix(path, depth):
    parts = [p.strip("[]'\"") for p in path[:depth]]
    return "/".join(parts) if parts else "<root>"


def group_paths(tree, depth=2):
    """Ordered leaf-group names: leaves grouped by the first `depth`
    path components of a JAX-layout tree (host-side; the names equal
    the JAX package's `group_paths` of the same tree)."""
    names, seen = [], set()
    for path, _leaf in _flatten_with_path(tree):
        name = _path_prefix(path, depth)
        if name not in seen:
            seen.add(name)
            names.append(name)
    return names


def group_index(tree, depth=2):
    """(group names, {leaf value: group index}) of a JAX-layout tree
    whose leaves are the port's parameter names (a Stacked leaf holds
    one name per layer): the map from a flat parameter to its group."""
    names = group_paths(tree, depth)
    index = {n: i for i, n in enumerate(names)}
    of = {}
    for path, leaf in _flatten_with_path(tree):
        g = index[_path_prefix(path, depth)]
        for name in (leaf if isinstance(leaf, tuple) else (leaf,)):
            of[name] = g
    return names, of


def leaf_sumsq(grads):
    """Per-leaf fp32 sum of squares, the engine's global-norm
    expression: computed ONCE in a step that takes the norm (clipping,
    fp16) and shared between that norm and the per-group stats below,
    so the norm's bits do not move when numerics is on."""
    return [torch.sum(torch.square(g.to(torch.float32))) for g in grads]


def group_mask(groups, n_groups, device):
    """[G, N] bool: leaf i belongs to group groups[i] (built once)."""
    idx = torch.as_tensor(groups, dtype=torch.long)
    mask = torch.zeros((n_groups, len(groups)), dtype=torch.bool)
    mask[idx, torch.arange(len(groups))] = True
    return mask.to(device)


def grad_group_stats(grads, mask, sq=None):
    """[G, 3] f32 per-group gradient stats: L2 norm, abs-max, nonfinite
    FLAG (0/1 — summed over a window it counts affected steps); `mask`
    is `group_mask`'s [G, N]. Run on the unscaled grads.

    Cost discipline: the leaves' squared norms are the engine's sums of
    squares (`sq` = leaf_sumsq output) where the step takes a norm, and
    otherwise one multi-tensor L2 reduction over every leaf
    (`torch._foreach_norm`, a few launches for the whole model instead
    of several per leaf); the abs-max is one more multi-tensor pass
    (order inf: no fp32 copy of a bf16 leaf). NaN and inf propagate
    through both reductions, so the nonfinite flag is a free scalar
    derivation instead of a third sweep over every parameter. Group
    sums reduce over the [G, N] mask: deterministic."""
    if sq is None:
        l2 = torch.stack(torch._foreach_norm(grads, 2,
                                             dtype=torch.float32))
        sq = l2 * l2
    else:
        sq = torch.stack(sq)
    absmax = torch.stack(torch._foreach_norm(grads, float("inf"),
                                             dtype=torch.float32))
    zero = torch.zeros((), dtype=torch.float32, device=sq.device)
    g_sq = torch.where(mask, sq[None], zero).sum(dim=1)
    g_max = torch.where(mask, absmax[None], zero).amax(dim=1)
    bad = (~(torch.isfinite(g_sq) & torch.isfinite(g_max))) \
        .to(torch.float32)
    return torch.stack([torch.sqrt(g_sq), g_max, bad], dim=1)


# ----------------------------------------------------------------------
# window compaction (on the device; runs with the registry's scalar
# compaction every _COMPACT_AT retained steps)
# ----------------------------------------------------------------------
def _first_bad_of_block(steps, acts, grads):
    """Device [3] i32 candidate (win_step, kind, index) for the first
    nonfinite in a block of retained entries; win_step == -1 when the
    whole block is finite. Activations outrank gradients within a step
    (the forward runs first)."""
    ref = acts if acts is not None else grads
    dev = ref.device
    n = len(steps)
    steps = torch.as_tensor(steps, dtype=torch.int32)
    # a non-blocking copy from pinned memory: no host sync
    steps = steps.pin_memory().to(dev, non_blocking=True) \
        if dev.type == "cuda" else steps.to(dev)
    act_bad = torch.zeros((n,), dtype=torch.bool, device=dev) \
        if acts is None else torch.any(acts[..., 2] > 0, dim=-1)
    grad_bad = torch.zeros((n,), dtype=torch.bool, device=dev) \
        if grads is None else torch.any(grads[..., 2] > 0, dim=-1)
    any_bad = act_bad | grad_bad
    has = torch.any(any_bad)
    n0 = torch.argmax(any_bad.to(torch.int32))          # first True
    kind = torch.where(act_bad[n0], KIND_ACT, KIND_GRAD)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    idx_act = zero if acts is None else \
        torch.argmax((acts[n0, :, 2] > 0).to(torch.int32)).to(torch.int32)
    idx_grad = zero if grads is None else \
        torch.argmax((grads[n0, :, 2] > 0).to(torch.int32)).to(torch.int32)
    idx = torch.where(kind == KIND_ACT, idx_act, idx_grad)
    return torch.where(
        has,
        torch.stack([steps[n0], kind.to(torch.int32), idx]),
        torch.full((3,), -1, dtype=torch.int32, device=dev))


def fold_entries(steps, healths, acc):
    """Reduce a block of retained (win_step, health) entries into the
    running device accumulator. health = {"act": [L,3]|None,
    "grad": [G,3]|None} with constant presence within one engine run.
    Device launches only — async like the step, never a sync."""
    acts = None
    grads = None
    if healths and healths[0].get("act") is not None:
        acts = torch.stack([h["act"] for h in healths])
    if healths and healths[0].get("grad") is not None:
        grads = torch.stack([h["grad"] for h in healths])
    new = {
        "act_last": None if acts is None else acts[-1],
        "act_absmax": None if acts is None
        else torch.amax(acts[..., 0], dim=0),
        "act_nonfinite": None if acts is None
        else torch.sum(acts[..., 2], dim=0),
        "grad_last": None if grads is None else grads[-1],
        "grad_absmax": None if grads is None
        else torch.amax(grads[..., 1], dim=0),
        "grad_nonfinite": None if grads is None
        else torch.sum(grads[..., 2], dim=0),
        "first_bad": _first_bad_of_block(steps, acts, grads),
    }
    if acc is None:
        return new
    out = dict(new)
    for key in ("act_absmax", "grad_absmax"):
        if acc.get(key) is not None and new.get(key) is not None:
            out[key] = torch.maximum(acc[key], new[key])
    for key in ("act_nonfinite", "grad_nonfinite"):
        if acc.get(key) is not None and new.get(key) is not None:
            out[key] = acc[key] + new[key]
    # the EARLIER candidate wins (acc covers earlier window steps)
    prev = acc["first_bad"]
    out["first_bad"] = torch.where(prev[0] >= 0, prev, new["first_bad"])
    return out


# ----------------------------------------------------------------------
# host-side fence summary (runs on fetched numpy, after the one
# per-fence copy)
# ----------------------------------------------------------------------
def _named(names, values, as_int=False):
    if values is None:
        return None
    vals = np.asarray(values)
    names = list(names) if names else \
        [f"group{i}" for i in range(len(vals))]
    cast = int if as_int else float
    return {names[i] if i < len(names) else f"group{i}": cast(vals[i])
            for i in range(len(vals))}


def summarize_window(entries, acc, grad_names=None, act_names=None):
    """The fence's numerics event fields, from the fetched (numpy)
    pending entries + compacted accumulator. Returns None when the
    window held no health data."""
    if not entries and acc is None:
        return None
    steps = [s for s, _ in entries]
    acts = [h["act"] for _, h in entries
            if h.get("act") is not None]
    grads = [h["grad"] for _, h in entries
            if h.get("grad") is not None]
    acts = np.stack(acts) if acts else None
    grads = np.stack(grads) if grads else None

    def _merge(tail_last, tail_red, acc_last, acc_red, how):
        """tail (post-compaction entries) takes `last`; reductions
        merge with the accumulated block."""
        last = tail_last if tail_last is not None else acc_last
        reds = [r for r in (tail_red, acc_red) if r is not None]
        red = None if not reds else \
            (np.maximum.reduce(reds) if how == "max" else sum(reds))
        return last, red

    act_last, act_absmax = _merge(
        None if acts is None else acts[-1],
        None if acts is None else acts[..., 0].max(axis=0),
        None if acc is None else acc.get("act_last"),
        None if acc is None else acc.get("act_absmax"), "max")
    _, act_bad = _merge(
        None,
        None if acts is None else acts[..., 2].sum(axis=0),
        None,
        None if acc is None else acc.get("act_nonfinite"), "sum")
    grad_last, grad_absmax = _merge(
        None if grads is None else grads[-1],
        None if grads is None else grads[..., 1].max(axis=0),
        None if acc is None else acc.get("grad_last"),
        None if acc is None else acc.get("grad_absmax"), "max")
    _, grad_bad = _merge(
        None,
        None if grads is None else grads[..., 2].sum(axis=0),
        None,
        None if acc is None else acc.get("grad_nonfinite"), "sum")

    # first-nonfinite: the compacted candidate covers earlier steps
    first = None
    if acc is not None and acc.get("first_bad") is not None:
        fb = np.asarray(acc["first_bad"])
        if fb[0] >= 0:
            first = (int(fb[0]), int(fb[1]), int(fb[2]))
    if first is None and entries:
        for (step, h) in entries:
            a = h.get("act")
            if a is not None and (np.asarray(a)[:, 2] > 0).any():
                first = (int(step), KIND_ACT,
                         int(np.argmax(np.asarray(a)[:, 2] > 0)))
                break
            g = h.get("grad")
            if g is not None and (np.asarray(g)[:, 2] > 0).any():
                first = (int(step), KIND_GRAD,
                         int(np.argmax(np.asarray(g)[:, 2] > 0)))
                break

    out = {
        "grad_norm": _named(grad_names,
                            None if grad_last is None
                            else np.asarray(grad_last)[:, 0]),
        "grad_absmax": _named(grad_names, grad_absmax),
        "grad_nonfinite": _named(grad_names, grad_bad, as_int=True),
        "act_absmax": _named(act_names, act_absmax),
        "act_mean": _named(act_names,
                           None if act_last is None
                           else np.asarray(act_last)[:, 1]),
        "act_nonfinite": _named(act_names, act_bad, as_int=True),
        "window_steps": len(steps),
    }
    if first is not None:
        step, kind, idx = first
        names = act_names if kind == KIND_ACT else grad_names
        name = names[idx] if names and idx < len(names) else str(idx)
        out["first_nonfinite"] = {
            "kind": "activation" if kind == KIND_ACT else "gradient",
            "name": name, "index": idx, "window_step": step,
        }
    else:
        out["first_nonfinite"] = None
    return out
