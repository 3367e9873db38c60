"""Request-level serving observability.

The training side has Perfetto timelines, a flight recorder and a
byte-attributed memory ledger; this module extends that forensic stack
to the serving engine. One `ServingTracker` per `InferenceEngine`
stamps every request's lifecycle phases

    queued -> admitted -> prefill chunk(s) -> decode -> finished

from **host dispatch timestamps captured at the existing serving
hooks only** — admission, prefill-chunk dispatch, and the serving
fence (`fetch_state` already carries every slot's progress counters,
so per-token attribution needs ZERO new host<->device syncs; the
serving loop's fence discipline, pinned by the sync-counter guards of
the serving tests).

From those records it derives three things:

  * a **Perfetto serving timeline** through the TraceExporter:
    one track per decode slot (`serve/slot<N>`) with queue-wait,
    per-chunk prefill and per-fence decode windows as distinct slice
    types (request-id / prompt-len / token-count args), one
    `serving_request` instant per finished request carrying its full
    lifecycle stats, and counter tracks for queue depth, batch
    occupancy, KV-page utilization (read from the memory ledger's
    `kv_cache` category) and tokens/s. `ds_trace summary --serving`
    recomputes per-request p50/p99 queue-wait / TTFT / per-token
    latency and goodput-vs-throughput from the instants.
  * **live SLO metrics** at each serving fence: a `serving_slo` event
    with streaming TTFT / per-token-latency / queue-wait histograms
    (FIXED log-spaced bucket edges — `HIST_EDGES_MS` — so the JSONL
    payload stays schema-stable), admission-rejection and
    eviction-reason counters, and the saturation signal (queue-wait
    share of end-to-end latency).
  * **serving forensics**: the flight recorder's sticky context gains
    the live request table (per slot: request id, phase, tokens
    emitted, pages held), so an OOM/crash/stall dump names exactly
    which requests were in flight, and `serving_oom_hints` ranks the
    serving knobs (kv_cache.num_pages vs max_slots vs prefill_chunk)
    by what the reconciled ledger says actually dominates.

Granularity caveat: timestamps are
host dispatch stamps at fence granularity. TTFT is an upper bound by
at most one fence window (`sync_every` decode iterations), and a
request's per-token decode latency is its decode wall time divided by
its token count — the inter-token latency its streaming client feels,
not a per-kernel device measurement (that belongs to the profiler).

Everything here is host-side arithmetic on small per-slot tables:
no device access, no new syncs, thread-safe where the flight
recorder's off-thread dumps can observe it.
"""

import threading
import time
from bisect import bisect_right

from deepspeed_tpu_torch.monitor import memory as memory_mod
from deepspeed_tpu_torch.monitor.trace_export import (CAT_SERVE_DECODE,
                                                CAT_SERVE_PREFILL,
                                                CAT_SERVE_QUEUE,
                                                CAT_SERVE_REQUEST)

HIST_SCHEMA_VERSION = 1
# Fixed log-spaced bucket edges in milliseconds: 0.02 ms .. ~20.9 s,
# factor 2^(1/3) per bucket (61 edges). Fixed by constant — not by
# config — so `serving_slo` JSONL payloads stay schema-stable across
# runs and readers can diff histograms bucket-for-bucket. Values below
# the first edge land in bucket 0; values past the last edge land in
# the final (overflow) bucket. A percentile read off the histogram is
# accurate to one bucket (~26% relative), which is the trade for a
# bounded, mergeable payload.
HIST_EDGES_MS = tuple(round(0.02 * 2.0 ** (i / 3.0), 6)
                      for i in range(61))
_HIST_FACTOR = 2.0 ** (1.0 / 3.0)


class LatencyHistogram:
    """Streaming latency histogram over the fixed `HIST_EDGES_MS`
    edges. `record` is O(log buckets); `percentile` answers from the
    counts (bucket-resolution accurate, never a sorted-sample sync)."""

    edges_ms = HIST_EDGES_MS

    def __init__(self):
        self._counts = [0] * len(HIST_EDGES_MS)
        self._n = 0
        self._sum_ms = 0.0

    def record(self, ms, count=1):
        if count <= 0:
            return
        i = bisect_right(HIST_EDGES_MS, float(ms)) - 1
        i = min(max(i, 0), len(self._counts) - 1)
        self._counts[i] += int(count)
        self._n += int(count)
        self._sum_ms += float(ms) * int(count)

    @property
    def count(self):
        return self._n

    def percentile(self, p):
        """The p-quantile (p in (0, 1]) as the geometric midpoint of
        the bucket holding it; None while empty."""
        if self._n <= 0:
            return None
        target = p * self._n
        acc = 0
        for i, c in enumerate(self._counts):
            acc += c
            if acc >= target:
                lo = HIST_EDGES_MS[i]
                return lo * (_HIST_FACTOR ** 0.5)
        return HIST_EDGES_MS[-1] * (_HIST_FACTOR ** 0.5)

    def to_event(self):
        """The schema-stable JSONL payload: version, unit, total count
        and sum, and the full fixed-width counts vector."""
        return {"v": HIST_SCHEMA_VERSION, "unit": "ms",
                "count": self._n, "sum_ms": round(self._sum_ms, 3),
                "counts": list(self._counts)}


class ServingTracker:
    """Per-request lifecycle tracker for one InferenceEngine.

    The ServingLoop calls the hooks below from its (single) serving
    thread at the phases it already executes host-side; the lock only
    guards the live table and counters against the flight recorder's
    off-thread snapshot reads. Sink emission and trace stamping happen
    OUTSIDE the lock (the LOCKBLOCK discipline)."""

    def __init__(self, monitor, cache, config):
        self._monitor = monitor
        self._cache = cache
        self._max_slots = int(config.max_slots)
        self._prefill_chunk = int(config.prefill_chunk)
        self._slo_ttft_ms = float(config.slo_ttft_ms or 0.0)
        self._slo_token_ms = float(config.slo_token_ms or 0.0)
        self._lock = threading.Lock()
        self.hist_queue_ms = LatencyHistogram()
        self.hist_ttft_ms = LatencyHistogram()
        self.hist_token_ms = LatencyHistogram()
        self._live = {}          # slot -> lifecycle row
        self._queue_depth = 0
        self.counters = {
            "finished_eos": 0, "finished_max_tokens": 0,
            "rejected_submit": 0, "admission_deferred": 0,
        }
        self.total_tokens = 0
        self.goodput_tokens = 0
        self._queue_wait_s = 0.0     # over finished requests
        self._e2e_s = 0.0            # queued + wall over finished
        # speculative decoding: cumulative draft/verify
        # split. The times are host DISPATCH spans (the zero-sync loop
        # cannot time device execution per program; everything settles
        # at the fence), handed over by the scheduler each fence.
        self.spec = {"draft_dispatch_s": 0.0, "verify_dispatch_s": 0.0,
                     "drafted_tokens": 0, "accepted_tokens": 0,
                     "verified_rounds": 0, "rollback_events": 0}
        self._armed = False

    # ------------------------------------------------------------------
    # lifecycle hooks (serving-loop thread; host-side only)
    # ------------------------------------------------------------------
    def on_rejected(self):
        """A submit-time rejection (never-fits pool / too long / bad
        sampling params): counted, since a production front-end's
        admission-rejection rate is an SLO of its own."""
        with self._lock:
            self.counters["rejected_submit"] += 1

    def on_admission_deferred(self):
        """A ready request could not take a free slot because the page
        pool cannot cover its worst case yet — one count per serving
        iteration it head-of-line blocks (the pool-pressure signal)."""
        with self._lock:
            self.counters["admission_deferred"] += 1

    def on_admitted(self, slot, request_id, prompt_tokens,
                    max_new_tokens, queued_s, pages_reserved):
        now = time.perf_counter()
        row = {
            "slot": int(slot), "request_id": str(request_id),
            "phase": "prefill",
            "prompt_tokens": int(prompt_tokens),
            "max_new_tokens": int(max_new_tokens),
            "tokens_emitted": 0, "pages_held": 0,
            "queued_s": float(max(queued_s, 0.0)),
            "admitted_t": now, "live_t": None, "ttft_ms": None,
        }
        with self._lock:
            self._live[int(slot)] = row
        self.hist_queue_ms.record(row["queued_s"] * 1e3)
        tr = self._monitor.trace_export
        if tr is not None:
            # back-dated to the arrival: the wait is VISIBLE as its own
            # slice type ahead of the prefill/decode slices (export
            # sorts by ts, so retroactive stamps stay valid)
            tr.complete(
                f"serve/slot{int(slot)}", f"queued {row['request_id']}",
                now - row["queued_s"], row["queued_s"],
                cat=CAT_SERVE_QUEUE,
                args={"request_id": row["request_id"],
                      "prompt_tokens": row["prompt_tokens"],
                      "queued_ms": round(row["queued_s"] * 1e3, 3)})
        self._update_flight()

    def on_prefill_chunk(self, slot, t_start, dur, start, end):
        """One prefill program dispatch for `slot` covering prompt
        positions [start, end) — a host dispatch window (the program
        itself runs async; the span semantics of monitor/trace.py)."""
        with self._lock:
            row = self._live.get(int(slot))
            if row is not None:
                row["pages_held"] = self._cache.allocated_pages(slot)
        tr = self._monitor.trace_export
        if tr is not None and row is not None:
            tr.complete(
                f"serve/slot{int(slot)}",
                f"prefill {row['request_id']} [{int(start)}:{int(end)}]",
                t_start, max(dur, 0.0), cat=CAT_SERVE_PREFILL,
                args={"request_id": row["request_id"],
                      "tokens": int(end) - int(start),
                      "start": int(start)})

    def on_live(self, slot):
        """The slot's prompt is fully cached: it joins the decode
        batch."""
        with self._lock:
            row = self._live.get(int(slot))
            if row is not None:
                row["phase"] = "decode"
                row["live_t"] = time.perf_counter()
                row["pages_held"] = self._cache.allocated_pages(slot)
        self._update_flight()

    def on_fence_progress(self, decode_t0, iterations, slot_tokens):
        """Per-slot progress from the fence's fetched counters:
        `slot_tokens` maps live slots to tokens generated this window.
        First-token fences record TTFT; decode windows land on the
        timeline per slot."""
        now = time.perf_counter()
        slices = []
        with self._lock:
            for slot, delta in slot_tokens.items():
                row = self._live.get(int(slot))
                if row is None:
                    continue
                row["tokens_emitted"] += int(delta)
                row["pages_held"] = self._cache.allocated_pages(slot)
                if delta > 0 and row["ttft_ms"] is None:
                    # fence-granularity upper bound: the token appeared
                    # somewhere inside this window
                    row["ttft_ms"] = (now - row["admitted_t"]) * 1e3
                    self.hist_ttft_ms.record(row["ttft_ms"])
                if delta > 0 and decode_t0 is not None:
                    slices.append((int(slot), row["request_id"],
                                   int(delta)))
        tr = self._monitor.trace_export
        if tr is not None:
            for slot, rid, delta in slices:
                tr.complete(
                    f"serve/slot{slot}", f"decode {rid} +{delta}",
                    decode_t0, max(now - decode_t0, 0.0),
                    cat=CAT_SERVE_DECODE,
                    args={"request_id": rid, "tokens": delta,
                          "iterations": int(iterations)})

    def on_finished(self, slot, reason):
        """Eviction (EOS / max-tokens) at the fence: close the row,
        fold its stats into the streaming histograms and counters, and
        leave the per-request record on the timeline."""
        now = time.perf_counter()
        with self._lock:
            row = self._live.pop(int(slot), None)
            if row is None:
                return
            live_t = row["live_t"] if row["live_t"] is not None \
                else row["admitted_t"]
            prefill_s = max(live_t - row["admitted_t"], 0.0)
            decode_s = max(now - live_t, 1e-9)
            n = max(row["tokens_emitted"], 1)
            token_ms = decode_s * 1e3 / n
            self.hist_token_ms.record(token_ms, count=n)
            key = "finished_eos" if reason == "eos" \
                else "finished_max_tokens"
            self.counters[key] += 1
            slo_ok = True
            if self._slo_ttft_ms > 0:
                slo_ok = slo_ok and row["ttft_ms"] is not None and \
                    row["ttft_ms"] <= self._slo_ttft_ms
            if self._slo_token_ms > 0:
                slo_ok = slo_ok and token_ms <= self._slo_token_ms
            self.total_tokens += row["tokens_emitted"]
            if slo_ok:
                self.goodput_tokens += row["tokens_emitted"]
            wall_s = max(now - row["admitted_t"], 0.0)
            self._queue_wait_s += row["queued_s"]
            self._e2e_s += row["queued_s"] + wall_s
        tr = self._monitor.trace_export
        if tr is not None:
            tr.instant(
                f"serve/slot{int(slot)}", f"finished {row['request_id']}",
                t_at=now, cat=CAT_SERVE_REQUEST,
                args={"request_id": row["request_id"],
                      "reason": str(reason),
                      "prompt_tokens": row["prompt_tokens"],
                      "new_tokens": row["tokens_emitted"],
                      "queued_ms": round(row["queued_s"] * 1e3, 3),
                      "ttft_ms": None if row["ttft_ms"] is None
                      else round(row["ttft_ms"], 3),
                      "token_ms": round(token_ms, 3),
                      "prefill_ms": round(prefill_s * 1e3, 3),
                      "decode_ms": round(decode_s * 1e3, 3),
                      "wall_ms": round(wall_s * 1e3, 3),
                      "slo_ok": bool(slo_ok)})
        self._update_flight()

    def on_fence_metrics(self, window_s, window_tokens, queue_depth,
                         active_slots, prefilling_slots):
        """The fence's SLO rendezvous: one `serving_slo` event + the
        counter tracks, after evictions settled (so the counts include
        this fence's finishes)."""
        with self._lock:
            self._queue_depth = int(queue_depth)
            c = dict(self.counters)
            total = self.total_tokens
            good = self.goodput_tokens
            qw, e2e = self._queue_wait_s, self._e2e_s
        in_use, free, util = self._kv_pages()
        window_s = max(window_s, 1e-9)
        tps = window_tokens / window_s
        self._monitor.event(
            "serving_slo",
            window_ms=round(window_s * 1e3, 3),
            window_tokens=int(window_tokens),
            tokens_per_sec=round(tps, 3),
            active_slots=int(active_slots),
            prefilling_slots=int(prefilling_slots),
            queue_depth=int(queue_depth),
            kv_pages_in_use=in_use,
            kv_pages_free=free,
            kv_page_utilization=round(util, 4),
            queue_wait_share=round(qw / e2e, 4) if e2e > 0 else None,
            ttft_ms=self.hist_ttft_ms.to_event(),
            token_ms=self.hist_token_ms.to_event(),
            queue_ms=self.hist_queue_ms.to_event(),
            ttft_p50_ms=_r(self.hist_ttft_ms.percentile(0.50)),
            ttft_p99_ms=_r(self.hist_ttft_ms.percentile(0.99)),
            token_p50_ms=_r(self.hist_token_ms.percentile(0.50)),
            token_p99_ms=_r(self.hist_token_ms.percentile(0.99)),
            queue_p50_ms=_r(self.hist_queue_ms.percentile(0.50)),
            queue_p99_ms=_r(self.hist_queue_ms.percentile(0.99)),
            finished_eos=c["finished_eos"],
            finished_max_tokens=c["finished_max_tokens"],
            rejected_submit=c["rejected_submit"],
            admission_deferred=c["admission_deferred"],
            total_tokens=int(total),
            goodput_tokens=int(good),
            goodput_fraction=round(good / total, 4) if total else None)
        tr = self._monitor.trace_export
        if tr is not None:
            tr.counter("serving", "queue_depth",
                       {"queued": int(queue_depth)})
            tr.counter("serving", "batch_occupancy",
                       {"decoding": int(active_slots),
                        "prefilling": int(prefilling_slots)})
            tr.counter("serving", "kv_page_utilization",
                       {"in_use": in_use, "free": free})
            tr.counter("serving", "tokens_per_sec",
                       {"tokens_per_sec": round(tps, 3)})
        if not self._armed:
            # the engine actually served: an abnormal exit from here on
            # leaves a flight dump naming the in-flight requests (the
            # training loop arms on its first on_step; serving arms on
            # its first fence)
            self._armed = True
            if self._monitor.flight is not None:
                self._monitor.flight.arm()
        self._update_flight()

    def on_speculative(self, draft_s, verify_s, drafted, accepted,
                       verified, rollbacks):
        """Per-fence speculative accounting from the scheduler: the
        drafted-vs-verified dispatch-time split plus the round
        counters (cumulative — they describe the run)."""
        with self._lock:
            sp = self.spec
            sp["draft_dispatch_s"] += float(draft_s)
            sp["verify_dispatch_s"] += float(verify_s)
            sp["drafted_tokens"] += int(drafted)
            sp["accepted_tokens"] += int(accepted)
            sp["verified_rounds"] += int(verified)
            sp["rollback_events"] += int(rollbacks)

    def on_reset(self):
        """engine.reset() dropped every slot (bench A/B hygiene): the
        live table empties; cumulative histograms/counters survive —
        they describe the run, not the batch."""
        with self._lock:
            self._live.clear()
            self._queue_depth = 0
        self._update_flight()

    # ------------------------------------------------------------------
    # forensics
    # ------------------------------------------------------------------
    def live_table(self):
        """The JSON-able per-slot request table: who is in flight
        right now (the flight-recorder context and the crash extra)."""
        with self._lock:
            rows = [{"slot": r["slot"], "request_id": r["request_id"],
                     "phase": r["phase"],
                     "prompt_tokens": r["prompt_tokens"],
                     "tokens_emitted": r["tokens_emitted"],
                     "pages_held": r["pages_held"]}
                    for _, r in sorted(self._live.items())]
            depth = self._queue_depth
        return {"queue_depth": depth, "requests": rows}

    def snapshot(self):
        """Forensic snapshot: the live table plus pool geometry,
        utilization, counters and the current percentiles — what
        `Monitor.on_crash` attaches and `serving_oom_hints` ranks."""
        in_use, free, util = self._kv_pages()
        table = self.live_table()
        with self._lock:
            c = dict(self.counters)
        table.update(
            max_slots=self._max_slots,
            prefill_chunk=self._prefill_chunk,
            num_pages=self._cache.num_pages,
            kv_pages_in_use=in_use, kv_pages_free=free,
            kv_page_utilization=round(util, 4),
            counters=c,
            ttft_p50_ms=_r(self.hist_ttft_ms.percentile(0.50)),
            ttft_p99_ms=_r(self.hist_ttft_ms.percentile(0.99)),
            token_p50_ms=_r(self.hist_token_ms.percentile(0.50)),
            token_p99_ms=_r(self.hist_token_ms.percentile(0.99)))
        with self._lock:
            sp = dict(self.spec)
        if sp["verified_rounds"] > 0:
            d = sp["drafted_tokens"]
            table["speculative"] = dict(
                sp,
                acceptance_rate=round(sp["accepted_tokens"] / d, 4)
                if d > 0 else None,
                tokens_per_verify=round(
                    (sp["accepted_tokens"] + sp["verified_rounds"]) /
                    sp["verified_rounds"], 3))
        return table

    def _update_flight(self):
        if self._monitor.flight is not None:
            self._monitor.flight.set_context(serving=self.live_table())

    def _kv_pages(self):
        """(pages in use, pages free, utilization) derived from the
        memory ledger's `kv_cache` category: the per-request dynamic
        entries are the in-use bytes, `pool.unallocated` the rest —
        pure host reads of registered shape math."""
        rows = self._monitor.ledger.category_breakdown(memory_mod.CAT_KV)
        in_use_bytes = sum(b for name, b in rows.items()
                           if name != "pool.unallocated")
        page_bytes = max(self._cache.page_bytes, 1)
        allocatable = max(self._cache.num_pages - 1, 1)
        in_use = int(in_use_bytes // page_bytes)
        free = max(allocatable - in_use, 0)
        return in_use, free, in_use / allocatable


def _r(v, nd=3):
    return None if v is None else round(v, nd)


def serving_oom_hints(payload, snapshot):
    """Serving-aware OOM hint ranking: which of the three serving
    knobs — `inference.kv_cache.num_pages`, `inference.max_slots`,
    `inference.prefill_chunk` — to turn, ordered by what the
    reconciled memory payload and the live request table say actually
    dominates. Appended ahead of the generic `oom_hints` by
    `Monitor.on_crash` when a tracker is attached."""
    snapshot = snapshot or {}
    hbm = (payload or {}).get("hbm", {}) or {}
    cats = hbm.get("categories", {}) or {}
    ledger = hbm.get("ledger_bytes") or 0
    kv = cats.get(memory_mod.CAT_KV, 0)
    util = float(snapshot.get("kv_page_utilization") or 0.0)
    reqs = snapshot.get("requests") or []
    prefilling = sum(1 for r in reqs if r.get("phase") == "prefill")
    scored = []
    if kv and ledger:
        share = kv / ledger
        if share > 0.2 and util < 0.5:
            scored.append((
                share * (1.0 - util),
                f"the kv_cache pool holds {kv / 2**30:.2f} GiB but only "
                f"{util:.0%} of its pages are in use: lower "
                "inference.kv_cache.num_pages — the pool is "
                "preallocated, every page costs HBM whether or not a "
                "request holds it"))
        elif share > 0.2:
            scored.append((
                share * util,
                f"the kv_cache pool is {util:.0%} utilized with "
                f"{len(reqs)} request(s) in flight: lower "
                "inference.max_slots (admission reserves each "
                "request's worst case, so fewer slots cap the "
                "reserved pages) or shorten max_new_tokens; raise "
                "inference.kv_cache.num_pages only if HBM headroom "
                "allows"))
    residual = hbm.get("residual_bytes")
    measured = hbm.get("measured_in_use_per_device")
    if prefilling and residual and measured and \
            residual > 0.3 * measured:
        scored.append((
            residual / measured,
            f"{prefilling} slot(s) were mid-prefill with "
            f"activations/temporaries at {residual / 2**30:.2f} "
            "GiB: lower inference.prefill_chunk — the prefill "
            "program's activation footprint scales with the chunk"))
    return [text for _, text in
            sorted(scored, key=lambda t: -t[0])]
