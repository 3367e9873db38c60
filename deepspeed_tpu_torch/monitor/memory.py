"""Memory ledger: live device/host byte accounting with attribution
(port of deepspeed_tpu/monitor/memory.py; the category names keep the
JAX package's "hbm" for the card's memory).

The monitor stack sees time (spans, pipeline timelines) and values
(loss, numerics health); this module makes it see MEMORY — the
resource ZeRO exists to manage. Every long-lived allocation site
registers its logical buffers here by category, with bytes computed
from shapes and dtypes (`numel() * element_size()`; at world size 1 a
device holds whole tensors) — NO device sync anywhere in this module:

  params          compute-dtype parameters (engine / pipe flat layout)
  master          device fp32 master copies (mixed precision)
  opt_state       optimizer moments (device)
  grads           the persistent fp32 grad accumulator (gas > 1)
  zero3_gather    the stage-3 scheduler's live gathered-param window
                  (no ZeRO-3 in this package yet: never registered)
  moe_dispatch    the MoE layers' dispatch buffers — the [E, C, H]
                  send + expert-output pair per MoE layer (a DYNAMIC
                  entry learned at the first forward; moe/dispatch.py)
  host_master     ZeRO-Offload fp32 masters in host RAM
  host_opt_state  ZeRO-Offload CPU-Adam moments in host RAM
  wire            compressed-wire state: device residual / device flat
                  param copy / host shadow
  kv_cache        the serving engine's preallocated paged KV pool —
                  one DYNAMIC entry per live request (its allocated
                  pages) plus the unallocated remainder, so the
                  category total is always the true pool bytes
                  (inference/kv_cache.py)
  kv_cache_draft  the speculative-decoding draft model's KV pool —
                  same page tables and allocator as `kv_cache`, fewer
                  layers; same unallocated + per-request split so the
                  category total is the true draft pool bytes
                  (inference/kv_cache.py attach_draft)
  ckpt_snapshot   checkpoint snapshot double-buffers — alive only
                  between the jitted snapshot and the writer's commit
  prefetch        staged batches queued ahead of the step loop
                  (a DYNAMIC entry: occupancy x staged bytes)
  pipe_buffers    the 1F1B executor's saved-input/ring buffers (no
                  pipeline engine in this package yet)

Views count once: `tree_nbytes` counts a tensor that appears twice in a
tree (the same view of the same storage) once, and allocation sites
whose tensors are views of one buffer register the views, not the
buffer as well — ZeRO-Offload's device parameters (views of one flat
buffer at 64-element offsets) register as `params` only, and the
speculative draft model, whose weights are views of the flagship's
cast kernels, registers only its own KV pool (`kv_cache_draft`).

At each existing telemetry fence the Monitor calls `reconcile`, which
samples the allocator (`device_memory_stats`: torch's caching
allocator's `allocated_bytes.all.current` and `.peak`, not the larger
reserved pool) and host RSS and splits the measured numbers into
ledger-known bytes and a RESIDUAL — the activations and temporaries no
registry can see. The residual is reported, never folded into a
category. The peak watermark
keeps the attribution snapshot taken AT the fence that observed the
peak: an OOM post-mortem needs to know what was alive when memory
crested, not what is alive now.

`classify_oom` + `oom_hints` turn an out-of-memory crash
(`torch.OutOfMemoryError`, or the JAX package's RESOURCE_EXHAUSTED
strings) into an attributed flight-recorder dump with actionable knobs;
`plan_vs_measured` scores a ZeRO memory plan ({component: bytes})
against the ledger per component.

Everything here is host-side arithmetic over shape metadata; the
per-fence cost is a dict walk, guard-tested to add zero per-step
host<->device syncs.
"""

import os
import re
import threading

import numpy as np
import torch

MEMORY_SCHEMA_VERSION = 1

SPACE_HBM = "hbm"
SPACE_HOST = "host"

CAT_PARAMS = "params"
CAT_MASTER = "master"
CAT_OPT = "opt_state"
CAT_GRADS = "grads"
CAT_ZERO3 = "zero3_gather"
CAT_HOST_MASTER = "host_master"
CAT_HOST_OPT = "host_opt_state"
CAT_WIRE = "wire"
CAT_CKPT = "ckpt_snapshot"
CAT_PREFETCH = "prefetch"
CAT_PIPE = "pipe_buffers"
CAT_KV = "kv_cache"
CAT_KV_DRAFT = "kv_cache_draft"
CAT_MOE = "moe_dispatch"
CAT_OVERLAP = "overlap_inflight"

# canonical ordering for stacked rendering (Perfetto counter tracks,
# event dicts): state groups first, transients last (zero3_gather —
# the stage-3 scheduler's live gathered-param prefetch window — sits
# with the state groups: it is persistent working memory of the step;
# kv_cache — the serving engine's preallocated page pool — likewise:
# the pool is resident for the engine's lifetime, with per-request
# entries carving it up; moe_dispatch — the MoE layers' all-to-all
# send/recv capacity buffers [E, C, H] — is per-step working memory
# like zero3_gather: a DYNAMIC entry learned at first trace;
# overlap_inflight — the comm/compute overlap runtime's in-flight
# collective staging windows (MoE dispatch pair + ring send/recv
# rotations, ops/overlap.py) — likewise: per-step working memory that
# scales with overlap.issue_distance)
CATEGORIES = (CAT_PARAMS, CAT_MASTER, CAT_OPT, CAT_GRADS, CAT_ZERO3,
              CAT_MOE, CAT_OVERLAP, CAT_KV, CAT_KV_DRAFT, CAT_HOST_MASTER,
              CAT_HOST_OPT, CAT_WIRE, CAT_CKPT, CAT_PREFETCH,
              CAT_PIPE)


# ----------------------------------------------------------------------
# byte arithmetic (shape/dtype metadata only — never a device value)
# ----------------------------------------------------------------------
def host_rss_bytes():
    """Resident set size of this process from /proc/self/statm
    (stdlib-only; None where /proc is unavailable). The host-space twin
    of the device allocator gauge: without a card (device_count == 0)
    the ledger reconciles against THIS, so CPU rehearsal runs keep a
    meaningful memory signal — the peak_flops_override precedent."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        # no /proc (non-Linux) or malformed statm: gauge degrades
        return None


def leaf_nbytes(leaf, per_device=True):
    """Logical bytes of one array-like leaf from shape/dtype metadata:
    `numel() * element_size()` for a tensor, `nbytes` for a numpy
    array. `per_device` is the JAX signature's: at world size 1 a
    device holds the whole tensor, so it changes nothing."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, (list, tuple)):     # a Stacked leaf
        return sum(leaf_nbytes(x, per_device) for x in leaf)
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return 0
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_nbytes(tree, per_device=True):
    """Summed `leaf_nbytes` over a tree (dicts, lists, tuples, named
    tuples of tensors or numpy arrays); a tensor that appears twice
    (the same view of the same storage) counts once."""
    seen = set()
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            key = (leaf.data_ptr(), tuple(leaf.shape), leaf.dtype)
            if leaf.numel() and key in seen:
                continue
            seen.add(key)
        total += leaf_nbytes(leaf, per_device=per_device)
    return total


# ----------------------------------------------------------------------
# the ledger
# ----------------------------------------------------------------------
class MemoryLedger:
    """Registry of long-lived logical buffers by (category, name).

    Thread-safe: the checkpoint writer registers/releases snapshot
    entries from its own thread while the fence reconciles. `register`
    replaces an existing (category, name) entry — a fresh prefetch
    loader or a resaved checkpoint tag supersedes its predecessor.
    Dynamic entries hold a zero-arg callable sampled at reconcile time
    (host-side ints only — e.g. prefetch occupancy x staged bytes).
    """

    def __init__(self):
        self._entries = {}       # (category, name) -> entry dict
        self._lock = threading.Lock()
        self._peak = None        # attribution snapshot AT the peak
        self._plan = None        # {component: planned bytes} (hbm)

    # -- registration ---------------------------------------------------
    def register(self, category, name, nbytes, space=SPACE_HBM,
                 meta=None):
        """Register a static entry; returns the token `release` takes."""
        key = (str(category), str(name))
        with self._lock:
            self._entries[key] = {
                "category": key[0], "name": key[1], "space": space,
                "bytes": int(nbytes), "fn": None, "meta": meta or {}}
        return key

    def register_tree(self, category, name, tree, space=SPACE_HBM,
                      per_device=True, meta=None):
        """Register a tree's bytes (metadata only)."""
        try:
            nbytes = tree_nbytes(tree, per_device=per_device)
        except Exception:  # ds-lint: allow[BROADEXC] ledger registration over arbitrary client trees must never kill engine init
            nbytes = 0
        return self.register(category, name, nbytes, space=space,
                             meta=meta)

    def register_dynamic(self, category, name, fn, space=SPACE_HBM,
                         meta=None):
        """Register a callable sampled at reconcile time. The callable
        must be host-side only (no device access) and may return None
        (counted as 0)."""
        key = (str(category), str(name))
        with self._lock:
            self._entries[key] = {
                "category": key[0], "name": key[1], "space": space,
                "bytes": 0, "fn": fn, "meta": meta or {}}
        return key

    def release(self, token):
        """Drop an entry by the token `register` returned (or a
        (category, name) tuple). Unknown tokens are a no-op — release
        paths run in finally blocks and must never raise."""
        try:
            key = (str(token[0]), str(token[1]))
        except (TypeError, IndexError, KeyError):
            return
        with self._lock:
            self._entries.pop(key, None)

    # -- queries --------------------------------------------------------
    def _sampled(self):
        """[(entry, bytes)] with dynamic entries sampled; failures are
        swallowed (telemetry must never kill training)."""
        with self._lock:
            entries = list(self._entries.values())
        out = []
        for e in entries:
            b = e["bytes"]
            if e["fn"] is not None:
                try:
                    b = int(e["fn"]() or 0)
                except Exception:  # ds-lint: allow[BROADEXC] dynamic gauges are client callables; telemetry must never kill training
                    b = 0
            out.append((e, b))
        return out

    def totals(self):
        """{space: {category: bytes}} over the live entries."""
        out = {SPACE_HBM: {}, SPACE_HOST: {}}
        for e, b in self._sampled():
            space = out.setdefault(e["space"], {})
            space[e["category"]] = space.get(e["category"], 0) + b
        return out

    def top_buffers(self, n=8):
        """The n largest live buffers, for the OOM dump."""
        rows = sorted(self._sampled(), key=lambda t: -t[1])[:max(n, 0)]
        return [{"category": e["category"], "name": e["name"],
                 "space": e["space"], "bytes": b} for e, b in rows]

    def category_breakdown(self, category, space=SPACE_HBM):
        """{entry name: sampled bytes} for ONE category's live entries
        (all of them — `top_buffers` truncates). The serving tracker
        reads the `kv_cache` split (per-request entries vs
        `pool.unallocated`) from here to derive page utilization."""
        out = {}
        for e, b in self._sampled():
            if e["category"] == str(category) and e["space"] == space:
                out[e["name"]] = out.get(e["name"], 0) + b
        return out

    def set_plan(self, plan):
        """Attach a per-component memory plan ({component: planned
        bytes per device}, hbm space); `reconcile` reports
        plan-vs-ledger deltas from then on."""
        self._plan = dict(plan) if plan else None

    @property
    def plan(self):
        return dict(self._plan) if self._plan else None

    @property
    def peak(self):
        with self._lock:
            return dict(self._peak) if self._peak else None

    # -- fence reconciliation -------------------------------------------
    def reconcile(self, device_stats=None, rss=None, step=None,
                  top_n=8):
        """Ledger vs measured at a fence. `device_stats` is the
        `device_memory_stats()` dict (or None), `rss` the host RSS (or
        None). Returns the JSON-able `memory` event payload; updates
        the peak watermark WITH the attribution snapshot at the fence
        that observed it. Pure host arithmetic — zero device syncs."""
        totals = self.totals()
        hbm_cats = totals.get(SPACE_HBM, {})
        host_cats = totals.get(SPACE_HOST, {})
        hbm_ledger = int(sum(hbm_cats.values()))
        host_ledger = int(sum(host_cats.values()))

        dev_count = int((device_stats or {}).get("device_count", 0))
        in_use = (device_stats or {}).get("in_use_bytes")
        dev_peak = (device_stats or {}).get("peak_bytes")
        if not dev_count:
            in_use = dev_peak = None
        if rss is None:
            rss = (device_stats or {}).get("host_rss_bytes")

        # the ledger counts what ONE device holds; the allocator's
        # in_use is summed over ALL local devices — compare in
        # per-device terms or a D-device host inflates the residual by
        # (D-1)x the ledger and every OOM hint blames activations
        in_use_per_dev = None if in_use is None \
            else int(in_use) // max(dev_count, 1)
        payload = {
            "schema": MEMORY_SCHEMA_VERSION,
            "hbm": {
                "categories": dict(hbm_cats),
                "ledger_bytes": hbm_ledger,
                "measured_in_use": None if in_use is None
                else int(in_use),
                "measured_in_use_per_device": in_use_per_dev,
                "measured_peak": None if dev_peak is None
                else int(dev_peak),
                # residual = activations + temporaries + allocator
                # overhead: what one device's measured allocation holds
                # beyond every registered long-lived buffer (per-device,
                # like the ledger and the per-chip peak)
                "residual_bytes": None if in_use_per_dev is None
                else in_use_per_dev - hbm_ledger,
                "device_count": dev_count,
            },
            "host": {
                "categories": dict(host_cats),
                "ledger_bytes": host_ledger,
                "rss_bytes": None if rss is None else int(rss),
                "residual_bytes": None if rss is None
                else int(rss) - host_ledger,
            },
            "top_buffers": self.top_buffers(top_n),
        }
        # watermark: the binding pressure number is the allocator peak
        # on the card; host RSS stands in without one (device_count 0)
        watermark = dev_peak if dev_peak is not None else rss
        if watermark is not None:
            with self._lock:
                if self._peak is None or \
                        watermark > self._peak["bytes"]:
                    self._peak = {
                        "bytes": int(watermark),
                        "space": SPACE_HBM if dev_peak is not None
                        else SPACE_HOST,
                        "step": step,
                        "categories": dict(
                            hbm_cats if dev_peak is not None
                            else host_cats),
                        "residual_bytes":
                            payload["hbm"]["residual_bytes"]
                            if dev_peak is not None
                            else payload["host"]["residual_bytes"],
                    }
                peak = dict(self._peak)
        else:
            peak = self.peak
        payload["peak"] = peak
        if self._plan:
            payload["plan"] = plan_vs_measured(self._plan, hbm_cats)
        return payload


# ----------------------------------------------------------------------
# plan-vs-measured validation
# ----------------------------------------------------------------------
def plan_vs_measured(plan, measured_categories):
    """Per-component deltas between a memory plan ({component:
    planned bytes per device}) and measured/ledger category bytes.
    delta_pct is signed relative to the plan; None planned-or-measured
    components report a None delta rather than fabricating 0."""
    out = {}
    for comp in sorted(set(plan) | set(measured_categories)):
        planned = plan.get(comp)
        got = measured_categories.get(comp)
        row = {"planned_bytes": None if planned is None
               else int(planned),
               "measured_bytes": None if got is None else int(got)}
        if planned and got is not None:
            row["delta_pct"] = round(
                (got - planned) / planned * 100.0, 3)
        else:
            row["delta_pct"] = None
        out[comp] = row
    return out


# ----------------------------------------------------------------------
# OOM forensics
# ----------------------------------------------------------------------
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                "OUT OF MEMORY", "ALLOCATION FAILURE",
                "FAILED TO ALLOCATE")
# "OOM" needs word boundaries: "room"/"zoom"/"bloom" in an ordinary
# error message must not trigger memory forensics
_OOM_WORD = re.compile(r"\bOOM\b")


def classify_oom(exc):
    """True when an exception out of the step loop is an allocator
    failure (`torch.OutOfMemoryError`, host MemoryError, or any error
    whose message carries an out-of-memory marker: the JAX package's
    RESOURCE_EXHAUSTED, CUDA's "out of memory"). The message test is
    textual by design: an error re-raised through a wrapper keeps only
    its message."""
    oom_type = getattr(torch, "OutOfMemoryError", None)
    if isinstance(exc, MemoryError) or \
            (oom_type is not None and isinstance(exc, oom_type)):
        return True
    try:
        text = f"{type(exc).__name__}: {exc}".upper()
    except Exception:  # ds-lint: allow[BROADEXC] classifying an exception whose __str__ itself raises; must not mask the original failure
        return False
    return any(m in text for m in _OOM_MARKERS) or \
        bool(_OOM_WORD.search(text))


def oom_hints(payload):
    """Actionable knobs ranked by what the reconciled payload says
    actually dominates. Every hint names the config key to turn."""
    hints = []
    hbm = payload.get("hbm", {})
    cats = hbm.get("categories", {})
    ledger = hbm.get("ledger_bytes") or 0
    # per-device, like the ledger and the residual
    measured = hbm.get("measured_in_use_per_device")
    residual = hbm.get("residual_bytes")
    if measured and residual is not None and residual > 0.5 * measured:
        hints.append(
            "activations/temporaries dominate (residual "
            f"{residual / 2**30:.2f} GiB of {measured / 2**30:.2f} GiB "
            "in use): tighten remat — set activation checkpointing / "
            '"checkpoint_policy": "save_fused_epilogues" — or reduce '
            "train_micro_batch_size_per_gpu")
    if cats.get(CAT_CKPT):
        hints.append(
            "a checkpoint snapshot double-buffer was alive "
            f"({cats[CAT_CKPT] / 2**30:.2f} GiB): lower "
            "checkpoint.writer_queue_depth / keep_last, save less "
            "often, or set checkpoint.async_save false (inline saves "
            "skip the snapshot copy)")
    if cats.get(CAT_PREFETCH) and ledger and \
            cats[CAT_PREFETCH] > 0.1 * ledger:
        hints.append(
            "prefetch staging holds "
            f"{cats[CAT_PREFETCH] / 2**30:.2f} GiB: reduce "
            "async_dispatch.prefetch_depth")
    if cats.get(CAT_ZERO3) and ledger and \
            cats[CAT_ZERO3] > 0.15 * ledger:
        hints.append(
            "the ZeRO-3 gathered-param prefetch window holds "
            f"{cats[CAT_ZERO3] / 2**30:.2f} GiB: lower "
            "zero_optimization.stage3.prefetch_layers (live full-param "
            "bytes scale with prefetch_layers + 1), or set "
            "stage3.release_after_use true if the naive up-front "
            "gather mode is on")
    if cats.get(CAT_MOE) and ledger and \
            cats[CAT_MOE] > 0.15 * ledger:
        hints.append(
            "MoE dispatch buffers (all-to-all send/recv + capacity "
            f"slots) hold {cats[CAT_MOE] / 2**30:.2f} GiB of "
            f"{ledger / 2**30:.2f} GiB ledgered: lower "
            "moe.capacity_factor (buffer rows scale linearly with it) "
            "or raise moe.num_experts only together with the mesh "
            "expert axis (per-device buffer bytes scale with "
            "num_experts / expert-axis size)")
    if cats.get(CAT_OVERLAP) and ledger and \
            cats[CAT_OVERLAP] > 0.15 * ledger:
        hints.append(
            "comm/compute overlap in-flight staging (MoE dispatch "
            "window + ring send/recv rotations) holds "
            f"{cats[CAT_OVERLAP] / 2**30:.2f} GiB of "
            f"{ledger / 2**30:.2f} GiB ledgered: lower "
            "overlap.issue_distance (the ring window scales linearly "
            "with it), pin overlap.sites to fewer sites, or set "
            '"overlap": {"enabled": false} to trade the hidden '
            "collective latency back for the staging bytes")
    if cats.get(CAT_KV) and ledger and \
            cats[CAT_KV] > 0.3 * ledger:
        hints.append(
            "the serving KV-cache page pool holds "
            f"{cats[CAT_KV] / 2**30:.2f} GiB of {ledger / 2**30:.2f} "
            "GiB ledgered: lower inference.kv_cache.num_pages (the "
            "pool is preallocated — every page counts against HBM "
            "whether or not a request holds it), shrink "
            "inference.max_slots / max_seq_len, or serve int8 weights "
            '("inference": {"weight_bits": 8}) to free headroom')
    state = (cats.get(CAT_MASTER, 0) + cats.get(CAT_OPT, 0) +
             cats.get(CAT_GRADS, 0))
    if ledger and state > 0.5 * ledger:
        hints.append(
            "optimizer state (master+moments+accumulator) is "
            f"{state / 2**30:.2f} GiB of {ledger / 2**30:.2f} GiB "
            "ledgered: raise zero_optimization.stage, or offload "
            'masters to host ("cpu_offload": true)')
    if not hints:
        hints.append(
            "no single ledger category dominates: compare the "
            "per-category bytes in this dump against the memory plan "
            "(ZeroShardingPolicy.memory_plan) to find what grew")
    return hints
