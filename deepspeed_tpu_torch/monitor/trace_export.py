"""Perfetto/Chrome trace-event export.

Renders the monitor's forensic timeline into the Chrome trace-event
JSON format (the `{"traceEvents": [...]}` object form) that opens
directly in Perfetto (ui.perfetto.dev) or chrome://tracing:

  * the fence-aligned host spans (forward/backward/step/ckpt) become
    complete ("X") events on one track per span name — the StepTrace
    feeds them through its export sink, so span timing is recorded
    once and rendered everywhere;
  * host subsystems (checkpoint writer commits, prefetch staging,
    offload host steps) get their own tracks, stamped from the threads
    that actually did the work;
  * the pipeline timeline: the 1F1B / interleaved clock tables
    (the JAX package's `runtime/pipe/schedule.py`) are the executor's
    exact per-tick (stage, microbatch, chunk) placement; each
    `train_batch` dispatch stamps them with its real host dispatch
    window, and the exporter lays the
    ticks out uniformly across that window — one track per stage, one
    "X" event per busy (tick, stage) carrying mb/chunk args, idle
    ticks left empty so the fill/drain bubble is VISIBLE as white
    space. The computed bubble fraction (1 - busy/(ticks*stages))
    rides in the trace metadata next to the schedule's analytic
    (p-1)/(v*m+p-1).

Events use the documented trace-format keys: `name`, `ph`, `ts`
(microseconds), `dur` ("X" only), `pid`, `tid`, `cat`, `args`.
`pid` is the process rank, so per-rank shards merge into
one multi-rank timeline (`ds_trace merge`, monitor/trace_cli.py).
This package has no pipeline engine yet (ROADMAP Queue 1 item 6), so
nothing stamps the pipeline timeline here; the helpers build it from
the tables alone. Track naming rides
"M"/thread_name metadata events.

The buffer is a bounded deque (`monitor.trace.max_events`): a run that
traces forever retains the LAST window, which is exactly the forensic
slice a post-mortem needs. `write(path)` is atomic
(tmp + fsync + rename — the checkpoint writer's discipline): a dump racing a
reader or a kill never leaves a torn JSON.
"""

import collections
import json
import os
import threading
import time

TRACE_SCHEMA_VERSION = 1

# Perfetto renders these category colors distinctly; they also make
# programmatic filtering (ds_trace summary) unambiguous.
CAT_SPAN = "host_span"
CAT_SUBSYSTEM = "subsystem"
CAT_PIPE_FWD = "pipe_fwd"
CAT_PIPE_BWD = "pipe_bwd"
CAT_MARK = "mark"
# the serving timeline (monitor/serving.py): one track per
# decode slot; queue-wait, prefill chunks and decode windows are
# distinct slice types, and each finished request leaves one instant
# carrying its lifecycle stats (the `ds_trace summary --serving` rows)
CAT_SERVE_QUEUE = "serving_queue"
CAT_SERVE_PREFILL = "serving_prefill"
CAT_SERVE_DECODE = "serving_decode"
CAT_SERVE_REQUEST = "serving_request"


def analytic_bubble_fraction(stages, micro_batches, num_virtual_stages=1):
    """The schedule's fill/drain bubble: (p-1)/(v*m+p-1) stage-time
    units idle per stage (Megatron interleaved-1F1B formula; v=1 gives
    plain 1F1B's (p-1)/(m+p-1))."""
    p, m, v = stages, micro_batches, num_virtual_stages
    return (p - 1) / float(v * m + p - 1)


def tables_bubble_fraction(tables):
    """Measured bubble of a clock-table set: the fraction of
    (tick, stage) slots executing neither a forward nor a backward."""
    fwd, bwd = tables["fwd_mb"], tables["bwd_mb"]
    total = fwd.shape[0] * fwd.shape[1]
    busy = int((fwd >= 0).sum() + (bwd >= 0).sum())
    return 1.0 - busy / float(total)


class TraceExporter:
    """Bounded trace-event buffer with atomic JSON export.

    Thread-safe: the checkpoint writer and prefetch worker stamp their
    tracks from their own threads. Appends are deque ops under a lock;
    nothing here touches the device.
    """

    def __init__(self, rank=0, max_events=200000, meta=None):
        self.rank = int(rank)
        self._events = collections.deque(maxlen=int(max_events))
        self._lock = threading.Lock()
        self._tracks = {}            # name -> tid
        self._track_meta = []        # emitted thread_name records
        self._meta = dict(meta or {})
        self._pipeline = None        # bubble/occupancy metadata
        self._t0 = time.perf_counter()
        self._epoch = time.time() - self._t0   # perf_counter -> unix

    # ------------------------------------------------------------------
    # track + event primitives
    # ------------------------------------------------------------------
    def set_meta(self, **kv):
        """Attach JSON-able metadata to the trace's otherData (e.g. a
        memory plan for `ds_trace summary`'s plan-vs-measured)."""
        with self._lock:
            self._meta.update(kv)

    def _tid(self, track):
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks)
            self._track_meta.append({
                "name": "thread_name", "ph": "M", "pid": self.rank,
                "tid": tid, "args": {"name": track}})
        return tid

    def _us(self, t_perf):
        # trace `ts` is microseconds; anchor on the unix clock so
        # shards from different processes merge on one axis
        return (t_perf + self._epoch) * 1e6

    def complete(self, track, name, t_start, dur, cat=CAT_SPAN,
                 args=None):
        """One complete ("X") slice. `t_start` is a time.perf_counter()
        stamp; `dur` seconds."""
        with self._lock:
            ev = {"name": name, "ph": "X", "cat": cat,
                  "ts": round(self._us(t_start), 3),
                  "dur": round(dur * 1e6, 3),
                  "pid": self.rank, "tid": self._tid(track)}
            if args:
                ev["args"] = args
            self._events.append(ev)

    def instant(self, track, name, t_at=None, cat=CAT_MARK, args=None):
        with self._lock:
            ev = {"name": name, "ph": "i", "s": "t", "cat": cat,
                  "ts": round(self._us(
                      time.perf_counter() if t_at is None else t_at), 3),
                  "pid": self.rank, "tid": self._tid(track)}
            if args:
                ev["args"] = args
            self._events.append(ev)

    def counter(self, track, name, values, t_at=None):
        with self._lock:
            self._events.append({
                "name": name, "ph": "C",
                "ts": round(self._us(
                    time.perf_counter() if t_at is None else t_at), 3),
                "pid": self.rank, "tid": self._tid(track),
                "args": {k: float(v) for k, v in values.items()}})

    # ------------------------------------------------------------------
    # pipeline timeline
    # ------------------------------------------------------------------
    def add_pipeline_step(self, tables, meta, t_start, t_end, step=None):
        """Lay one train_batch dispatch window out over the clock
        tables: tick t of T occupies
        [t_start + t*dt, t_start + (t+1)*dt), dt = (t_end-t_start)/T.
        Real per-tick device time is not host-observable without a
        fence; the uniform layout preserves exactly what the tables
        guarantee — order, concurrency and the bubble — which is what
        a bubble post-mortem needs.

        `tables`: build_clock_tables output (numpy). `meta`:
        {"stages", "micro_batches", "num_virtual_stages"}."""
        fwd_mb, bwd_mb = tables["fwd_mb"], tables["bwd_mb"]
        fwd_ch, bwd_ch = tables["fwd_chunk"], tables["bwd_chunk"]
        T, S = fwd_mb.shape
        dt = max((t_end - t_start), 1e-9) / T
        s_args = None if step is None else {"step": int(step)}
        for t in range(T):
            ts = t_start + t * dt
            for s in range(S):
                if fwd_mb[t, s] >= 0:
                    args = {"mb": int(fwd_mb[t, s]),
                            "chunk": int(fwd_ch[t, s]), "tick": t}
                    if s_args:
                        args.update(s_args)
                    self.complete(
                        f"pipe/stage{s}",
                        f"F mb{int(fwd_mb[t, s])} c{int(fwd_ch[t, s])}",
                        ts, dt, cat=CAT_PIPE_FWD, args=args)
                if bwd_mb[t, s] >= 0:
                    args = {"mb": int(bwd_mb[t, s]),
                            "chunk": int(bwd_ch[t, s]), "tick": t}
                    if s_args:
                        args.update(s_args)
                    self.complete(
                        f"pipe/stage{s}",
                        f"B mb{int(bwd_mb[t, s])} c{int(bwd_ch[t, s])}",
                        ts, dt, cat=CAT_PIPE_BWD, args=args)
        if self._pipeline is None:
            p = int(meta["stages"])
            m = int(meta["micro_batches"])
            v = int(meta.get("num_virtual_stages", 1))
            self._pipeline = {
                "stages": p, "micro_batches": m,
                "num_virtual_stages": v, "ticks": int(T),
                "bubble_fraction": round(tables_bubble_fraction(tables),
                                         6),
                "analytic_bubble_fraction": round(
                    analytic_bubble_fraction(p, m, v), 6),
            }

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def to_dict(self):
        with self._lock:
            events = self._track_meta + list(self._events)
            other = {"schema": TRACE_SCHEMA_VERSION, "rank": self.rank,
                     **self._meta}
            if self._pipeline is not None:
                other["pipeline"] = dict(self._pipeline)
        # exported order is ts order (metadata first, like merge):
        # some slices are stamped retroactively — the serving tracker
        # back-dates a request's queue-wait to its arrival when the
        # slot is granted — and the Chrome format (and our validator)
        # wants per-track monotonic ts regardless of append order
        events.sort(key=lambda e: (e.get("ph") != "M",
                                   e.get("ts", 0)))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": other}

    def write(self, path):
        """Atomic dump: serialize to `<path>.tmp`, fsync, rename —
        a concurrent reader or a kill mid-write never sees torn JSON."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


# ----------------------------------------------------------------------
# shard merge + summary (the ds_trace CLI core, monitor/trace_cli.py)
# ----------------------------------------------------------------------
def load_trace(path):
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):          # bare-array trace format
        doc = {"traceEvents": doc, "otherData": {}}
    return doc


def merge_traces(docs):
    """Merge per-rank trace shards into one document. Events already
    carry their rank as `pid` and absolute unix-anchored `ts`, so the
    merge is concatenation + a stable ts sort; per-rank otherData nests
    under "ranks"."""
    events = []
    ranks = {}
    pipeline = None
    memory_plan = None
    for doc in docs:
        events.extend(doc.get("traceEvents", []))
        other = doc.get("otherData", {}) or {}
        ranks[str(other.get("rank", len(ranks)))] = other
        pipeline = pipeline or other.get("pipeline")
        memory_plan = memory_plan or other.get("memory_plan")
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    other = {"schema": TRACE_SCHEMA_VERSION, "merged_ranks": len(docs),
             "ranks": ranks}
    if pipeline:
        other["pipeline"] = pipeline
    if memory_plan:
        # promoted like `pipeline`: summary of a merged doc must keep
        # plan-vs-measured working
        other["memory_plan"] = memory_plan
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def summarize_trace(doc):
    """Occupancy per track + pipeline bubble, computed FROM THE EVENTS
    (not the metadata), so a merged/filtered trace still summarizes
    honestly. Returns a JSON-able dict."""
    tracks = {}      # (pid, tid) -> {"busy_us", "t0", "t1", "events"}
    names = {}
    pipe_busy = {}
    mem_counters = {}   # series name -> {key: {"last", "peak"}}
    serving_reqs = []   # args of serving_request finish instants
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "M" and ev.get("name") == "thread_name":
            names[(ev.get("pid"), ev.get("tid"))] = \
                ev.get("args", {}).get("name")
            continue
        if ph in ("i", "I") and ev.get("cat") == CAT_SERVE_REQUEST:
            # one instant per finished request, args = its lifecycle
            # stats (monitor/serving.py) — the summary recomputes the
            # percentiles FROM these, so merged/filtered traces still
            # summarize honestly (the pipeline-bubble convention)
            serving_reqs.append(ev.get("args") or {})
            continue
        if ph == "C" and ev.get("name") in ("hbm_bytes", "host_bytes"):
            # the memory ledger's per-category counter tracks, keyed
            # per RANK (pid): events are ts-ordered within a rank, so
            # "last wins" + running max give that rank's final
            # composition and per-category peak — mixing ranks here
            # would interleave unrelated series
            series = mem_counters.setdefault(
                (ev.get("pid"), ev["name"]), {})
            for k, v in (ev.get("args") or {}).items():
                row = series.setdefault(k, {"last": 0.0, "peak": 0.0})
                row["last"] = float(v)
                row["peak"] = max(row["peak"], float(v))
            continue
        if ph != "X":
            continue
        key = (ev.get("pid"), ev.get("tid"))
        tr = tracks.setdefault(
            key, {"busy_us": 0.0, "t0": float("inf"), "t1": 0.0,
                  "events": 0})
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        tr["busy_us"] += dur
        tr["t0"] = min(tr["t0"], ts)
        tr["t1"] = max(tr["t1"], ts + dur)
        tr["events"] += 1
        if ev.get("cat") in (CAT_PIPE_FWD, CAT_PIPE_BWD):
            # group by dispatch window (the "step" arg every pipeline
            # event carries): the gap BETWEEN train_batch dispatches is
            # host time, not pipeline bubble — a global span would bill
            # it to the schedule
            win = (ev.get("pid"), (ev.get("args") or {}).get("step"))
            pb = pipe_busy.setdefault(
                win, {"busy": 0.0, "t0": float("inf"), "t1": 0.0,
                      "stages": set()})
            pb["busy"] += dur
            pb["t0"] = min(pb["t0"], ts)
            pb["t1"] = max(pb["t1"], ts + dur)
            pb["stages"].add(key)
    out = {"tracks": {}}
    for key, tr in sorted(tracks.items()):
        span = max(tr["t1"] - tr["t0"], 1e-9)
        name = names.get(key) or f"pid{key[0]}/tid{key[1]}"
        out["tracks"][name] = {
            "events": tr["events"],
            "busy_ms": round(tr["busy_us"] / 1e3, 3),
            "span_ms": round(span / 1e3, 3),
            "occupancy": round(tr["busy_us"] / span, 4),
        }
    if pipe_busy:
        busy = wall = 0.0
        stages = 0
        for pb in pipe_busy.values():
            stages = max(stages, len(pb["stages"]))
            busy += pb["busy"]
            wall += max(pb["t1"] - pb["t0"], 1e-9) * len(pb["stages"])
        out["pipeline"] = {
            "stages": stages,
            "dispatch_windows": len(pipe_busy),
            "busy_ms": round(busy / 1e3, 3),
            "wall_stage_ms": round(wall / 1e3, 3),
            "occupancy": round(busy / wall, 4),
            "bubble_fraction": round(1.0 - busy / wall, 4),
        }
        analytic = (doc.get("otherData", {}) or {}).get("pipeline", {})
        if analytic:
            out["pipeline"]["analytic_bubble_fraction"] = \
                analytic.get("analytic_bubble_fraction")
            out["pipeline"]["schedule"] = {
                k: analytic.get(k) for k in
                ("stages", "micro_batches", "num_virtual_stages",
                 "ticks")}
    if mem_counters:
        # merge ranks by MAX: ledger values are per-device, so the
        # cross-rank max is the binding pressure number (under SPMD
        # the ranks are near-identical anyway); `ranks` says how many
        # were merged so an asymmetric fleet is visible
        merged = {}
        pids = set()
        for (pid, name), rows in mem_counters.items():
            pids.add(pid)
            series = merged.setdefault(name, {})
            for k, v in rows.items():
                row = series.setdefault(k, {"last": 0.0, "peak": 0.0})
                row["last"] = max(row["last"], v["last"])
                row["peak"] = max(row["peak"], v["peak"])
        mem = {name: {k: {"last_bytes": int(v["last"]),
                          "peak_bytes": int(v["peak"])}
                      for k, v in sorted(rows.items())}
               for name, rows in merged.items()}
        if len(pids) > 1:
            mem["ranks"] = len(pids)
        plan = (doc.get("otherData", {}) or {}).get("memory_plan")
        if plan:
            from deepspeed_tpu_torch.monitor.memory import plan_vs_measured
            peaks = {k: v["peak_bytes"]
                     for k, v in mem.get("hbm_bytes", {}).items()
                     if k != "residual"}
            mem["plan_vs_measured"] = plan_vs_measured(plan, peaks)
        out["memory"] = mem
    if serving_reqs:
        out["serving"] = summarize_serving_requests(serving_reqs)
    return out


def _weighted_percentile(pairs, p):
    """Percentile over (value, weight) pairs (weight = token count for
    per-token latencies; 1 for per-request stats). None when empty."""
    pairs = sorted((float(v), max(int(w), 0)) for v, w in pairs
                   if v is not None)
    total = sum(w for _, w in pairs)
    if total <= 0:
        return None
    target = p * total
    acc = 0
    for v, w in pairs:
        acc += w
        if acc >= target:
            return v
    return pairs[-1][0]


def summarize_serving_requests(rows):
    """Per-request serving stats from the `serving_request` finish
    instants: p50/p99 queue-wait, TTFT and per-token decode latency
    (token-weighted), plus goodput vs throughput (tokens from requests
    that met every configured SLO target vs all tokens) and the
    queue-wait share of end-to-end latency — the saturation signal."""
    def pcts(key, weighted=False):
        pairs = [(r.get(key), r.get("new_tokens", 1) if weighted else 1)
                 for r in rows]
        return {"p50": _weighted_percentile(pairs, 0.50),
                "p99": _weighted_percentile(pairs, 0.99)}

    tokens = sum(int(r.get("new_tokens") or 0) for r in rows)
    goodput = sum(int(r.get("new_tokens") or 0) for r in rows
                  if r.get("slo_ok"))
    queued = sum(float(r.get("queued_ms") or 0.0) for r in rows)
    e2e = queued + sum(float(r.get("wall_ms") or 0.0) for r in rows)
    return {
        "requests": len(rows),
        "new_tokens": tokens,
        "queued_ms": pcts("queued_ms"),
        "ttft_ms": pcts("ttft_ms"),
        "token_ms": pcts("token_ms", weighted=True),
        "goodput_tokens": goodput,
        "goodput_fraction": round(goodput / tokens, 4) if tokens else None,
        "queue_wait_share": round(queued / e2e, 4) if e2e > 0 else None,
    }
