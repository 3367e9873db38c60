"""Communication/compute overlap runtime (port of
deepspeed_tpu/ops/overlap.py).

The JAX package phrases *when* a collective issues through
`jax.lax.optimization_barrier` groups: `tie` and `async_collective`
co-schedule an issued collective with the compute meant to hide it,
`fence` keeps a value from being hoisted above its dependencies. Eager
PyTorch issues every operation in program order, so the port's sites
order their collectives by where they call them, and `tie`, `fence`
(alias `overlap_fence`) and `async_collective` are identities on their
values, kept so a site reads as the JAX site reads.

Sites, the names `overlap.sites` accepts:

  * ``moe_dispatch`` -- the MoE dispatch/combine pair (moe/layer.py):
    ``granularity`` > 1 splits the einsum dispatch along the capacity
    axis into that many chunks (bit-exact: the token contraction is
    untouched);
  * ``ring`` -- ring attention (ops/sequence/ring_attention.py):
    ``issue_distance`` hops of K/V stay in flight;
  * ``zero3_leaf`` -- ZeRO-3 leaf gathers, which come with ZeRO-3
    (ROADMAP Queue 1 item 6).

Schedule resolution (`schedule(site, ...)`, a host dict read):

  1. ``overlap.enabled`` off -> overlap off everywhere;
  2. an explicit ``overlap.sites`` list -> overlap on exactly those
     sites, at the configured ``issue_distance``;
  3. ``sites="auto"`` (the default) -> the measured collective-schedule
     entry of ops/autotune.py's table for (site, mesh, payload class),
     where there is one; without one, overlap on, at the configured
     issue distance, granularity 1.

In-flight bytes: each site records its staging window
(`record_inflight`); `inflight_bytes` is the sum over sites of each
site's largest window.
"""

import threading

SITE_MOE = "moe_dispatch"
SITE_RING = "ring"
SITE_ZERO3_LEAF = "zero3_leaf"
SITES = (SITE_MOE, SITE_RING, SITE_ZERO3_LEAF)

DEFAULT_ISSUE_DISTANCE = 1

_lock = threading.Lock()
_state = {
    "enabled": True,
    "sites": "auto",     # "auto" | frozenset of SITES members
    "issue_distance": DEFAULT_ISSUE_DISTANCE,
    "inflight": {},      # (site, key) -> staging bytes
}


# ----------------------------------------------------------------------
# primitives: identities in eager program order
# ----------------------------------------------------------------------
def tie(*trees):
    """The JAX package's barrier group; in eager order the trees come
    back as they are (one tree when called with one)."""
    return trees[0] if len(trees) == 1 else trees


def fence(value, *deps):
    """`value` may not start before `deps`: eager order already holds
    it, so `value` comes back as it is."""
    return value


overlap_fence = fence


def async_collective(collective, compute):
    """Co-schedule an issued collective with the compute that hides it:
    (collective, compute) as they are."""
    return collective, compute


# ----------------------------------------------------------------------
# configuration (the engine's wiring; process-global, as in JAX)
# ----------------------------------------------------------------------
def _normalize_sites(sites):
    if isinstance(sites, str):
        if sites == "auto":
            return "auto"
        sites = [s.strip() for s in sites.split(",") if s.strip()]
    names = tuple(sites)
    for s in names:
        if s not in SITES:
            raise ValueError(
                f"overlap.sites: unknown site {s!r} "
                f"(valid: {', '.join(SITES)}, or 'auto')")
    return frozenset(names)


def configure(enabled=None, sites=None, issue_distance=None):
    """Toggle the discipline, pin the overlapped site set ('auto' = the
    autotune table's schedules), set the issue distance."""
    if sites is not None:
        sites = _normalize_sites(sites)
    if issue_distance is not None:
        issue_distance = int(issue_distance)
        if issue_distance < 1:
            raise ValueError(
                "overlap.issue_distance must be >= 1, got "
                f"{issue_distance}")
    with _lock:
        if enabled is not None:
            _state["enabled"] = bool(enabled)
        if sites is not None:
            _state["sites"] = sites
        if issue_distance is not None:
            _state["issue_distance"] = issue_distance


def reset():
    """Restore the defaults and drop the in-flight accounting."""
    with _lock:
        _state["enabled"] = True
        _state["sites"] = "auto"
        _state["issue_distance"] = DEFAULT_ISSUE_DISTANCE
        _state["inflight"] = {}


def enabled():
    return _state["enabled"]


def schedule(site, payload_bytes=0, mesh=None):
    """The overlap schedule of one site: {"overlap": bool,
    "issue_distance": int, "granularity": int}: a host dict read, no
    device sync. An explicit `overlap.sites` list wins; only "auto"
    reads the autotune table's collective-schedule entry, keyed by
    `site`, `mesh` and `payload_bytes`."""
    if site not in SITES:
        raise ValueError(
            f"unknown overlap site {site!r} (valid: {', '.join(SITES)})")
    base = {"overlap": True, "issue_distance": _state["issue_distance"],
            "granularity": 1}
    if not _state["enabled"]:
        base["overlap"] = False
        return base
    sites = _state["sites"]
    if sites != "auto":
        base["overlap"] = site in sites
        return base
    from deepspeed_tpu_torch.ops import autotune
    params = autotune.collective_schedule(site, mesh, payload_bytes)
    if params:
        for k in ("overlap", "issue_distance", "granularity"):
            if k in params:
                base[k] = params[k]
        base["overlap"] = bool(base["overlap"])
        base["issue_distance"] = max(int(base["issue_distance"]), 1)
        base["granularity"] = max(int(base["granularity"]), 1)
    return base


# ----------------------------------------------------------------------
# in-flight byte accounting
# ----------------------------------------------------------------------
def record_inflight(site, key, nbytes):
    """One site's staging bytes in flight, keyed so a repeat overwrites
    rather than adds."""
    with _lock:
        _state["inflight"][(str(site), str(key))] = int(nbytes)


def inflight_bytes():
    """The sum over sites of each site's largest registered window
    (layers run one at a time within a site; sites may overlap)."""
    with _lock:
        items = list(_state["inflight"].items())
    per_site = {}
    for (site, _key), nbytes in items:
        per_site[site] = max(per_site.get(site, 0), int(nbytes))
    return int(sum(per_site.values()))


def reset_inflight():
    with _lock:
        _state["inflight"] = {}
