"""Launch-plan autotuner for the port's kernels (port of
deepspeed_tpu/ops/autotune.py: the same names, table layout, events and
never-slower floor).

The JAX package tunes its Pallas kernels' block shapes. The port's
kernels take their launch geometry at run time where they can, and
those are the knobs here:

  * `fused_ln` (K3-fwd, K3-bwd) and `fused_gelu` (K4-fwd, K4-bwd): the
    plans of `ops/transformer/fused_ops.py` (`ln_fwd_plan`: row groups
    per CTA and the grid; `ln_bwd_plan`: row groups, the grid and the
    fold of the CTAs' partial sums; `gelu_plan`: CTAs per group). They
    are arguments of the kernels' C entries, so a candidate needs no
    rebuild; the hand-picked plan is the default. The forward and the
    backward kernel of a family take different plans: their entries'
    shape classes end in `_fwd` / `_bwd`;
  * `flash_fwd`, `flash_fwd_packed`, `quantized_matmul`: the tile
    shapes the CUDA sources instantiate for the dtype and head dim
    (`flash_tile_candidates`, `qmm_tile_candidates`): one each, so a
    search measures the default alone and returns it, speedup 1.0;
  * `collective_schedule` (and the `moe_dispatch` family's sources):
    the overlap runtime's schedule knobs per site, read by
    `ops/overlap.py`'s `schedule` when `overlap.sites` is "auto".

`search` measures the default and every candidate (CUDA events on the
card: warm-up, then interleaved best-of-N rounds) and keeps a winner
ONLY if it beats the default. The table is one versioned JSON
(`TABLE_VERSION` 2, replaced atomically) under the kernels' build cache,
`build/torch_kernels/autotune_table_v2.json` (`autotune.table_path` or
`DS_TPU_AUTOTUNE_TABLE` override it). Each entry records the SHA-256 of
what defines its family: the wrapper module's source and the `.cu` /
`.cuh` files it builds, so an edit to either invalidates the family's
entries (they fall back to the default with one warning).

`lookup` is what a wrapper consults where its caller fixed nothing: a
host dict read after one lazy table load, no device sync. A table entry
the kernel cannot take raises in the plan; nothing clips it.

Monitor events (attach a monitor with `configure(monitor=...)`, as the
engine does when its monitor is on): `autotune_search` per completed
search, `autotune_hit` once per key the first time a wrapper picks up a
tuned plan; their keys are the JAX package's.
"""

import hashlib
import importlib.util
import json
import os
import threading
import time

from deepspeed_tpu_torch.utils.logging import logger

# v2: adds the collective-schedule family (overlap on/off, issue
# distance, dispatch granularity per site/mesh/payload class) and the
# fused MoE dispatch kernel family. v1 tables are ignored with one
# warning and repopulate on the next search.
TABLE_VERSION = 2
TABLE_BASENAME = f"autotune_table_v{TABLE_VERSION}.json"

# kernel family -> defining wrapper module (its source, and the CUDA
# sources below, key the family's entries)
KERNEL_MODULES = {
    "flash_fwd": "deepspeed_tpu_torch.ops.transformer.flash_attention",
    "flash_fwd_packed":
        "deepspeed_tpu_torch.ops.transformer.flash_attention",
    "fused_ln": "deepspeed_tpu_torch.ops.transformer.fused_ops",
    "fused_gelu": "deepspeed_tpu_torch.ops.transformer.fused_ops",
    "quantized_matmul":
        "deepspeed_tpu_torch.ops.transformer.quantized_matmul",
    "moe_dispatch": "deepspeed_tpu_torch.moe.fused_dispatch",
    # collective-schedule entries describe the overlap runtime's
    # behavior, so its module source is the invalidation key
    "collective_schedule": "deepspeed_tpu_torch.ops.overlap",
}
# kernel family -> the CUDA sources (ops/csrc/) its kernels build from;
# every .cuh header there is hashed too (a source may include any)
KERNEL_SOURCES = {
    "flash_fwd": ("flash_attention_fwd.cu",),
    "flash_fwd_packed": ("flash_attention_fwd.cu",),
    "fused_ln": ("fused_ln_fwd.cu", "fused_ln_bwd.cu"),
    "fused_gelu": ("fused_gelu_fwd.cu", "fused_gelu_bwd.cu"),
    "quantized_matmul": ("quantized_matmul.cu",),
    "moe_dispatch": ("moe_dispatch.cu",),
}
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

_lock = threading.Lock()
_state = {
    "enabled": True,
    "path": None,          # explicit table path (configure/config key)
    "table": None,         # loaded entries dict
    "loaded_from": None,   # path the current table came from
    "monitor": None,
    "dirty_warned": set(),  # one warning per failure class
    "hit_emitted": set(),   # one autotune_hit event per key
    "hashes": {},           # family -> source hash, computed once
}


def configure(enabled=None, table_path=None, monitor=None):
    """Engine wiring: toggle lookups, point at a table file, and attach
    a monitor for `autotune_search`/`autotune_hit` events (monitor=False
    detaches). Changing the path drops the in-memory table so the next
    lookup reloads."""
    with _lock:
        if enabled is not None:
            _state["enabled"] = bool(enabled)
        if table_path is not None:
            path = table_path or None
            if path != _state["path"]:
                _state["path"] = path
                _state["table"] = None
                _state["loaded_from"] = None
                _state["hit_emitted"] = set()
        if monitor is False:
            _state["monitor"] = None
        elif monitor is not None:
            _state["monitor"] = monitor


def reset(drop_monitor=True):
    """Forget the loaded table, warnings, hashes and config."""
    with _lock:
        _state["enabled"] = True
        _state["path"] = None
        _state["table"] = None
        _state["loaded_from"] = None
        _state["dirty_warned"] = set()
        _state["hit_emitted"] = set()
        _state["hashes"] = {}
        if drop_monitor:
            _state["monitor"] = None


def table_path():
    """Resolution order: configure()/autotune.table_path config key >
    DS_TPU_AUTOTUNE_TABLE env > the kernels' build cache."""
    if _state["path"]:
        return _state["path"]
    env = os.environ.get("DS_TPU_AUTOTUNE_TABLE")
    if env:
        return env
    from deepspeed_tpu_torch.ops import _build
    return os.path.join(_build.BUILD_DIR, TABLE_BASENAME)


def _backend():
    """The card's name (`torch.cuda.get_device_name`), or "cpu". Read
    once a process per device: the wrappers call it on every launch."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    dev = torch.cuda.current_device()
    name = _backend_names.get(dev)
    if name is None:
        name = _backend_names[dev] = torch.cuda.get_device_name(dev)
    return name


_backend_names = {}


def kernel_source_hash(kernel):
    """SHA-256 over what defines a family's kernels: the wrapper module's
    source, the family's .cu sources and every .cuh header of
    ops/csrc/. Computed once a process. Unknown families hash their own
    name (so tests can register synthetic families)."""
    h = _state["hashes"].get(kernel)
    if h is not None:
        return h
    mod_name = KERNEL_MODULES.get(kernel)
    if mod_name is None:
        h = hashlib.sha256(kernel.encode()).hexdigest()
    else:
        digest = hashlib.sha256()
        spec = importlib.util.find_spec(mod_name)
        files = [spec.origin] + [os.path.join(_CSRC, f) for f in
                                 KERNEL_SOURCES.get(kernel, ())]
        if kernel in KERNEL_SOURCES:
            files += [os.path.join(_CSRC, f) for f in
                      sorted(os.listdir(_CSRC)) if f.endswith(".cuh")]
        for path in files:
            digest.update(os.path.basename(path).encode())
            with open(path, "rb") as f:
                digest.update(f.read())
        h = digest.hexdigest()
    _state["hashes"][kernel] = h
    return h


def pow2_bucket(n):
    """Shape-class bucketing: next power of two >= n (floor 1), so one
    measured entry covers the whole bucket instead of every exact row
    count re-searching."""
    n = max(int(n), 1)
    b = 1
    while b < n:
        b *= 2
    return b


def _dtype_str(dtype):
    """Canonical dtype spelling for keys ("float32", "bfloat16", ...):
    torch dtypes lose their "torch." prefix, numpy dtypes and strings
    pass through as numpy spells them."""
    import numpy as _np
    text = str(dtype)
    if text.startswith("torch."):
        return text[len("torch."):]
    try:
        return str(_np.dtype(dtype))
    except TypeError:
        return text


def entry_key(kernel, shape_class, dtype, backend=None):
    backend = backend or _backend()
    return f"{kernel}|{backend}|{_dtype_str(dtype)}|{shape_class}"


def _warn_once(tag, msg):
    if tag in _state["dirty_warned"]:
        return
    _state["dirty_warned"] = _state["dirty_warned"] | {tag}
    logger.warning(msg)


def _load_table_locked():
    """Load + validate the JSON table (call with _lock held). Any
    failure — unreadable file, bad JSON, wrong version, non-dict
    schema — degrades to an empty table with ONE warning."""
    if _state["table"] is not None:
        return _state["table"]
    path = table_path()
    entries = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or \
                    not isinstance(doc.get("entries"), dict):
                raise ValueError("not an autotune table document")
            if doc.get("version") != TABLE_VERSION:
                _warn_once(
                    "version",
                    f"autotune table {path} has version "
                    f"{doc.get('version')!r} != {TABLE_VERSION}; "
                    "ignoring it (kernels use their default launch "
                    "plans until a new search repopulates it)")
            else:
                entries = doc["entries"]
        except (OSError, ValueError) as e:
            _warn_once(
                "corrupt",
                f"autotune table {path} is unreadable "
                f"({type(e).__name__}: {e}); kernels use their default "
                "launch plans")
            entries = {}
    _state["table"] = entries
    _state["loaded_from"] = path
    return entries


def lookup(kernel, shape_class, dtype, backend=None):
    """Tuned params dict for (kernel, backend, dtype, shape_class), or
    None (no entry / autotune disabled / stale source hash). One
    `autotune_hit` event per key when a monitor is attached."""
    if not _state["enabled"]:
        return None
    backend = backend or _backend()
    key = entry_key(kernel, shape_class, dtype, backend)
    with _lock:
        entries = _load_table_locked()
        entry = entries.get(key)
        if entry is None:
            return None
        if entry.get("source_hash") != kernel_source_hash(kernel):
            # the kernel changed since the measurement: measurements on
            # old kernel code must not silently steer the new one
            del entries[key]
            _warn_once(
                f"stale:{kernel}",
                f"autotune entries for kernel {kernel!r} were measured "
                "on different kernel source; using the default launch "
                "plan until a new search runs")
            return None
        params = dict(entry.get("params") or {})
        first_hit = key not in _state["hit_emitted"]
        if first_hit:
            _state["hit_emitted"] = _state["hit_emitted"] | {key}
        mon = _state["monitor"]
    if first_hit and mon is not None:
        mon.event("autotune_hit", kernel=kernel,
                  shape_class=shape_class, dtype=_dtype_str(dtype),
                  backend=backend, params=params)
    return params or None


def record(kernel, shape_class, dtype, params, best_us, default_us,
           candidates_tried, backend=None, persist=True):
    """Store a search result and (optionally) persist the table
    atomically (tmp + os.replace, no partial table ever visible)."""
    key = entry_key(kernel, shape_class, dtype, backend)
    entry = {
        "params": dict(params),
        "best_us": round(float(best_us), 3),
        "default_us": round(float(default_us), 3),
        "candidates_tried": int(candidates_tried),
        "source_hash": kernel_source_hash(kernel),
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    with _lock:
        entries = _load_table_locked()
        entries[key] = entry
        path = _state["loaded_from"] or table_path()
        doc = {"version": TABLE_VERSION, "entries": dict(entries)}
    if persist:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    return entry


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _Clock:
    """Seconds of `inner` calls of a callable: CUDA events on the card
    (the calls' device time), the host clock on the CPU."""

    def __init__(self):
        import torch
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def time(self, fn, inner=1):
        if self.cuda:
            self.start.record()
            for _ in range(inner):
                fn()
            self.end.record()
            self.end.synchronize()
            return self.start.elapsed_time(self.end) / 1e3 / inner
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        return (time.perf_counter() - t0) / inner


def measure_callable(fn, warmup=2, reps=3, inner=1):
    """Bench-harness timing for one candidate: `warmup` calls, then the
    best of `reps` windows of `inner` calls. Returns seconds per call."""
    for _ in range(max(warmup, 1)):
        fn()
    _sync()
    clock = _Clock()
    return min(clock.time(fn, inner) for _ in range(max(reps, 1)))


def search(kernel, shape_class, dtype, candidates, default_params,
           measure=None, build=None, warmup=2, reps=3, inner=10,
           backend=None, persist=True):
    """Enumerate `candidates` (list of params dicts; `default_params`
    is measured too and acts as the floor), measure each, keep the
    winner ONLY if it beats the default — so applying the table is
    never slower than the hand-picked plan.

    Measurement comes either from `measure(params) -> seconds` or from
    `build(params) -> zero-arg callable`, timed in rounds that
    INTERLEAVE the candidates (every candidate warmed first, then
    best-of-`reps` windows of `inner` calls each, round-robin), so load
    drift lands on every candidate equally.

    Returns {params, best_us, default_us, speedup_vs_default,
    candidates_tried}. With no candidate but the default, the default
    is measured and returned (speedup 1.0) and the log says so."""
    if measure is None and build is None:
        raise ValueError("search() needs measure= or build=")
    all_params = [dict(default_params)] + \
        [dict(c) for c in candidates
         if dict(c) != dict(default_params)]
    if len(all_params) == 1:
        logger.info(f"autotune: {kernel} {shape_class}: the default "
                    f"{all_params[0]} is the only candidate (speedup 1.0)")
    if measure is not None:
        times = [measure(p) for p in all_params]
    else:
        fns = [build(p) for p in all_params]
        for fn in fns:
            for _ in range(max(warmup, 1)):
                fn()
        _sync()
        clock = _Clock()
        times = [float("inf")] * len(fns)
        for _ in range(max(reps, 1)):
            for i, fn in enumerate(fns):
                times[i] = min(times[i], clock.time(fn, inner))
    default_s = times[0]
    best_i = min(range(len(all_params)), key=lambda i: times[i])
    best_params, best_s = all_params[best_i], times[best_i]
    if best_s > default_s:   # never-slower floor
        best_params, best_s = all_params[0], default_s
    entry = record(kernel, shape_class, dtype, best_params,
                   best_s * 1e6, default_s * 1e6, len(all_params),
                   backend=backend, persist=persist)
    result = {
        "params": best_params,
        "best_us": entry["best_us"],
        "default_us": entry["default_us"],
        "speedup_vs_default": round(default_s / max(best_s, 1e-12), 4),
        "candidates_tried": len(all_params),
    }
    mon = _state["monitor"]
    if mon is not None:
        mon.event("autotune_search", kernel=kernel,
                  shape_class=shape_class, dtype=_dtype_str(dtype),
                  backend=backend or _backend(),
                  params=best_params,
                  best_us=result["best_us"],
                  default_us=result["default_us"],
                  speedup_vs_default=result["speedup_vs_default"],
                  candidates_tried=result["candidates_tried"])
    return result


# ----------------------------------------------------------------------
# kernel families: shape classes (the JAX package's), the port's
# candidate plans, and the lookups the wrappers make
# ----------------------------------------------------------------------
def flash_shape_class(t, d, causal, packed):
    return f"t{t}_d{d}_{'causal' if causal else 'bidir'}" + \
        ("_packed" if packed else "")


def flash_tile_candidates(dtype, d):
    """(block_q, block_k) of the forward kernel's tile pair the CUDA
    source instantiates at (dtype, d): one (`flash_attention._kernel_
    tiles`), so the default is the only candidate."""
    from deepspeed_tpu_torch.ops.transformer.flash_attention import \
        _kernel_tiles
    bq, bk = _kernel_tiles(dtype, d)
    return [{"block_q": bq, "block_k": bk}]


def row_kernel_shape_class(n, h_padded):
    return f"rows{pow2_bucket(n)}_h{h_padded}"


def row_plan_shape_class(n, h, direction):
    """A fused_ln / fused_gelu entry's shape class: the JAX package's
    row-kernel class and the kernel's direction ("fwd" or "bwd"), whose
    plans differ."""
    return f"{row_kernel_shape_class(n, h)}_{direction}"


def row_plan(kernel, n, h, direction, dtype):
    """Tuned plan params for a fused_ln / fused_gelu launch, or None."""
    return lookup(kernel, row_plan_shape_class(n, h, direction), dtype)


def _dedupe(cands):
    out = []
    for c in cands:
        if c not in out:
            out.append(c)
    return out


def ln_fwd_candidates(n, h, sms):
    """K3-fwd's plans: row groups per CTA (CTAs of at most 20 warps, 15
    groups when a row takes more than one warp) and grids of 1 .. the
    default's CTAs per SM (each at most one row group per row's worth
    of work)."""
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    wpr = fo.ln_fwd_plan(n, h, sms).warps_per_row
    cands = []
    for groups in (1, 2, 3, 4, 8):
        if 32 * wpr * groups > 32 * fo._LN_FWD_MAX_WARPS or \
                (wpr > 1 and groups > 15):
            continue
        for per_sm in range(1, max(1, fo._LN_FWD_SM_WARPS //
                                   (groups * wpr)) + 1):
            grid = min(sms * per_sm, -(-n // groups))
            cands.append({"groups": groups, "grid": max(grid, 1)})
    return _dedupe(cands)


def ln_bwd_candidates(n, h, sms):
    """K3-bwd's plans: row groups per CTA, grids of half, one and two
    CTAs per SM, and folds of the CTAs' partial rows by the default rule
    (sqrt of the grid), by 4 and by 16."""
    import math
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    base = fo.ln_bwd_plan(n, h, sms)
    limit = fo._LN_BWD_MAX_WARPS if base.vpt == 1 else \
        fo._LN_BWD_MAX_WARPS // 2
    cands = []
    for groups in range(1, limit // base.warps_per_row + 1):
        for grid in (max(sms // 2, 1), sms, 2 * sms):
            grid = max(1, min(grid, -(-n // groups)))
            for fold in (math.isqrt(grid - 1) + 1, 4, 16):
                cands.append({"groups": groups, "grid": grid,
                              "fold": min(fold, grid)})
    return _dedupe(cands)


def gelu_candidates(n, w, groups, sms):
    """K4's plans: CTAs per group at half, one, two and four times the
    default's, and one per block of rows."""
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    base = fo.gelu_plan(n, w, groups, sms)
    blocks = max(1, -(-(n // max(groups, 1)) // fo._GELU_BLOCK_ROWS))
    cpg = max(base.ctas_per_group, 1)
    return _dedupe([{"ctas_per_group": max(1, min(c, blocks))}
                    for c in (cpg // 2, cpg, 2 * cpg, 4 * cpg, blocks)])


def row_search_space(kernel, direction, n, h, sms, groups=1):
    """(default params, candidates) of a fused_ln / fused_gelu plan for
    n rows of width h ("fwd" or "bwd") on a card of `sms` SMs: the
    hand-picked plan's params (a candidate too: the never-slower floor)
    and the enumerators' plans."""
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
    if kernel == "fused_ln" and direction == "fwd":
        p = fo.ln_fwd_plan(n, h, sms)
        return ({"groups": p.groups, "grid": p.grid},
                ln_fwd_candidates(n, h, sms))
    if kernel == "fused_ln" and direction == "bwd":
        p = fo.ln_bwd_plan(n, h, sms)
        return ({"groups": p.groups, "grid": p.grid, "fold": p.fold},
                ln_bwd_candidates(n, h, sms))
    if kernel == "fused_gelu" and direction in ("fwd", "bwd"):
        p = fo.gelu_plan(n, h, groups, sms)
        return ({"ctas_per_group": p.ctas_per_group},
                gelu_candidates(n, h, groups, sms))
    raise ValueError(f"no launch plan for {kernel!r} {direction!r}")


def search_row_plan(kernel, direction, n, h, dtype, build, sms, groups=1,
                    **kwargs):
    """`search` over a fused_ln / fused_gelu kernel's launch plans at
    (n, h, dtype): `build(params)` returns a zero-arg callable that
    launches the kernel at that plan (the wrappers' `tuned=`). Records
    the winner under the row shape class of `direction`."""
    default, cands = row_search_space(kernel, direction, n, h, sms, groups)
    return search(kernel, row_plan_shape_class(n, h, direction), dtype,
                  cands, default, build=build, **kwargs)


def qmm_shape_class(m, k, n):
    return f"m{pow2_bucket(m)}_k{k}_n{n}"


def qmm_tile_candidates():
    """K6's output tile (rows, columns) per CTA: the one
    `quantized_matmul.cu` instantiates (kBM x kBN, 128 x 128)."""
    return [{"block_m": 128, "block_n": 128}]


# ----------------------------------------------------------------------
# collective-schedule family: per-(site, mesh-shape, payload-bytes)
# overlap variants, searched with the same never-slower discipline and
# persisted in the same versioned table. Consulted by ops/overlap.py
# `schedule()` when `overlap.sites == "auto"`.
# ----------------------------------------------------------------------
# entries are schedules, not kernels: this string fills the key's
# dtype slot (_dtype_str passes non-dtypes through verbatim)
COLLECTIVE_DTYPE = "schedule"

COLLECTIVE_DEFAULT = {"overlap": True, "issue_distance": 1,
                      "granularity": 1}


def mesh_shape_class(mesh):
    """Axis-signature string for a mesh ("p1.d8.e1.m1"); accepts an
    object with a `shape` dict, a {name: size} dict, or None
    ("nomesh")."""
    if mesh is None:
        return "nomesh"
    try:
        items = list(mesh.shape.items())
    except AttributeError:
        items = list(dict(mesh).items())
    return ".".join(f"{str(n)[:1]}{int(s)}" for n, s in items) or "nomesh"


def collective_shape_class(site, mesh, payload_bytes):
    """Shape class for a collective site: mesh axis signature plus the
    pow2 KiB bucket of the per-shard payload."""
    kb = pow2_bucket(max(int(payload_bytes), 1024) // 1024)
    return f"{site}|{mesh_shape_class(mesh)}|kb{kb}"


def collective_candidates(site):
    """Schedule candidates per site. MoE varies dispatch granularity,
    ring varies how many hops stay in flight, the ZeRO-3 leaf fence is a
    pure on/off decision."""
    if site == "moe_dispatch":
        return [{"overlap": o, "issue_distance": 1, "granularity": g}
                for o in (True, False) for g in (1, 2, 4)]
    if site == "ring":
        return [{"overlap": o, "issue_distance": d, "granularity": 1}
                for o in (True, False) for d in (1, 2)]
    return [{"overlap": o, "issue_distance": 1, "granularity": 1}
            for o in (True, False)]


def collective_schedule(site, mesh, payload_bytes):
    """Tuned schedule params for a collective site, or None."""
    return lookup("collective_schedule",
                  collective_shape_class(site, mesh, payload_bytes),
                  COLLECTIVE_DTYPE)


def search_collective_schedule(site, mesh, payload_bytes, measure,
                               backend=None, persist=True):
    """Search the schedule variants for one site with `measure(params)
    -> seconds`. The un-tuned behavior (overlap on, distance 1,
    granularity 1) is the default and the never-slower floor."""
    return search("collective_schedule",
                  collective_shape_class(site, mesh, payload_bytes),
                  COLLECTIVE_DTYPE, collective_candidates(site),
                  dict(COLLECTIVE_DEFAULT), measure=measure,
                  backend=backend, persist=persist)
