"""Continuous batching over the sync-free dispatch loop (port of
deepspeed_tpu/inference/scheduler.py).

The unit of scheduling is one **serving iteration**:

  1. admission — queued requests whose arrival time has passed take
     free decode slots, IF the paged cache can cover their worst case;
  2. chunked prefill — every admitted-but-not-yet-live slot advances
     by ONE prompt chunk, so a long prompt shares the loop with the
     decode batch instead of stalling it; a slot whose prompt is fully
     cached flips live;
  3. decode block — `sync_every` single-token decode steps for the
     whole slot batch, enqueued with no host sync (with speculative
     decoding, `sync_every` speculative rounds: engine.spec_block);
  4. the fence — ONE device->host copy (engine.fetch_state) reads
     every slot's progress; finished requests (EOS / max-tokens,
     decided on the device) are evicted and their pages freed, and
     with speculation each live slot's pages are trimmed to its
     committed length and the round counters are diffed per fence.

With the engine's monitor on, the loop emits the JAX loop's events
(`request_admitted`, `decode_batch`, `speculative`, `request_finished`,
the fence's `memory`) and, with `inference.observability`, feeds the
engine's ServingTracker (monitor/serving.py) at the phases it already
runs on the host: no hook reads the device.
"""

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request. `tokens` is the int32 prompt;
    `arrival_time` is seconds after the loop's clock zero (0 = already
    waiting). Result fields are filled by the loop."""
    rid: Any
    tokens: np.ndarray
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    eos_token_id: Optional[int] = None
    arrival_time: float = 0.0
    # -- results ----------------------------------------------------
    out_tokens: Optional[np.ndarray] = None
    finish_reason: Optional[str] = None
    admitted_at: Optional[float] = None
    live_at: Optional[float] = None     # prompt fully cached, decoding
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class ServingLoop:
    """Drives one InferenceEngine; owns the request queue, the slot
    table, and the serving fence."""

    def __init__(self, engine):
        self._infer = engine
        self.queue = deque()
        self.live = {}        # slot -> Request (decoding)
        self.prefilling = {}  # slot -> [Request, next_prefill_pos]
        self.results = []
        self._t0 = None
        self._last_fence_t = None
        # host dispatch stamp of the current decode block (the serving
        # tracker's per-fence decode window; None = no block in flight)
        self._decode_t0 = None
        s = engine.config.max_slots
        self._last_n_gen = np.zeros((s,), np.int64)
        # host mirror of each live slot's position as of the last fence
        self._last_pos = np.zeros((s,), np.int64)
        # speculative decoding: the device counters are cumulative per
        # slot, so each fence diffs them against these mirrors
        self._spec = bool(getattr(engine, "speculative_enabled", False))
        self._last_spec = {key: np.zeros((s,), np.int64) for key in
                           ("drafted", "accepted", "verified", "rollbacks")}
        self._last_rounds = 0
        # the last fence's speculative window (rounds, drafted, accepted,
        # verified, rollbacks, rollback_pages, draft_dispatch_s,
        # verify_dispatch_s: what the `speculative` monitor event
        # reports) and their sums over the fences
        self.spec_window = None
        self.spec_stats = {"fences": 0}

    # -- submission -----------------------------------------------------
    def submit(self, req):
        try:
            self._check_submit(req)
        except ValueError:
            trk = self._infer.tracker
            if trk is not None:
                trk.on_rejected()
            raise
        self.queue.append(req)

    def _check_submit(self, req):
        req.tokens = np.asarray(req.tokens, np.int32).reshape(-1)
        if len(req.tokens) < 1:
            raise ValueError(f"request {req.rid!r}: empty prompt")
        if req.eos_token_id is None:
            req.eos_token_id = self._infer.config.eos_token_id
        total = len(req.tokens) + req.max_new_tokens
        if total > self._infer.max_seq_len:
            raise ValueError(
                f"request {req.rid!r}: prompt ({len(req.tokens)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_seq_len {self._infer.max_seq_len}")
        if req.max_new_tokens > self._infer.config.max_new_tokens:
            raise ValueError(
                f"request {req.rid!r}: max_new_tokens "
                f"{req.max_new_tokens} exceeds the engine buffer width "
                f"inference.max_new_tokens="
                f"{self._infer.config.max_new_tokens}")
        cache = self._infer.cache
        usable = min(cache.max_pages_per_slot, cache.num_pages - 1)
        if cache.pages_for_tokens(total) > usable:
            # a request that can NEVER fit the pool is rejected here:
            # admission would wait forever for an eviction that cannot
            # help, starving everything queued behind it
            raise ValueError(
                f"request {req.rid!r}: worst case "
                f"{cache.pages_for_tokens(total)} pages exceeds the "
                f"pool's {usable} usable pages "
                "(raise inference.kv_cache.num_pages)")
        if req.top_k > self._infer.config.top_k_max:
            raise ValueError(
                f"request {req.rid!r}: top_k {req.top_k} exceeds the "
                "sampling cap inference.top_k_max="
                f"{self._infer.config.top_k_max}")

    def serve(self, requests, clock_zero=None):
        """Submit `requests` and run until everything finished.
        Returns them in completion order (each with results filled)."""
        for r in requests:
            self.submit(r)
        self.run(clock_zero=clock_zero)
        return self.results

    # -- the loop -------------------------------------------------------
    def _now(self):
        return time.monotonic() - self._t0

    def run(self, clock_zero=None):
        self._t0 = clock_zero if clock_zero is not None \
            else time.monotonic()
        self._last_fence_t = self._now()
        while self.queue or self.live or self.prefilling:
            try:
                progressed = self.step()
            except Exception as exc:
                # serving forensics: the flight dump (with the live
                # request table in its context) survives the process;
                # the exception still propagates
                self._infer.monitor.on_crash(exc)
                raise
            if not progressed:
                # idle: everything queued is in the future
                time.sleep(0.0005)

    def step(self):
        """One serving iteration (admit -> prefill chunk -> decode
        block -> fence). Returns False when there was nothing to do
        but wait for arrivals."""
        self._admit(self._now())
        self._prefill_turn()
        if not self.live and not self.prefilling:
            return False
        if self.live:
            rounds = self._infer.config.sync_every
            # a speculative round can commit up to (draft steps + 1)
            # tokens a slot, so the block's capacity window widens from
            # sync_every steps to sync_every rounds of that worst case
            per_round = (self._infer.spec_next_draft() + 1) \
                if self._spec else 1
            for slot in self.live:
                self._infer.ensure_decode_capacity(
                    slot, int(self._last_pos[slot]), rounds * per_round)
            self._infer.push_tables()
            self._decode_t0 = time.perf_counter()
            if self._spec:
                self._infer.spec_block(rounds)
            else:
                self._infer.decode_block(rounds)
        else:
            self._decode_t0 = None
        self._fence(self._infer.config.sync_every if self.live else 0)
        return True

    # -- phases ---------------------------------------------------------
    def _free_slots(self):
        busy = set(self.live) | set(self.prefilling)
        return [s for s in range(self._infer.config.max_slots)
                if s not in busy]

    def _admit(self, now):
        """FIFO admission over the ARRIVED requests: not-yet-arrived
        entries are skipped, but a ready request the cache cannot cover
        yet blocks the ready ones behind it (head-of-line FIFO
        fairness)."""
        free = self._free_slots()
        future = []
        trk = self._infer.tracker
        while free and self.queue:
            req = self.queue.popleft()
            if req.arrival_time > now:
                future.append(req)
                continue
            worst = len(req.tokens) + req.max_new_tokens
            if not self._infer.cache.can_admit(worst):
                # pages exhausted: wait for an eviction
                self.queue.appendleft(req)
                if trk is not None:
                    trk.on_admission_deferred()
                break
            slot = free.pop(0)
            self._infer.cache.admit(slot, worst, name=str(req.rid))
            req.admitted_at = now
            self.prefilling[slot] = [req, 0]
            pages_reserved = self._infer.cache.pages_for_tokens(worst)
            if trk is not None:
                trk.on_admitted(
                    slot, str(req.rid), len(req.tokens),
                    req.max_new_tokens,
                    queued_s=max(now - req.arrival_time, 0.0),
                    pages_reserved=pages_reserved)
            self._infer.monitor.event(
                "request_admitted",
                request_id=str(req.rid), slot=int(slot),
                prompt_tokens=int(len(req.tokens)),
                max_new_tokens=int(req.max_new_tokens),
                queue_depth=len(self.queue),
                queued_ms=round((now - req.arrival_time) * 1e3, 3),
                kv_pages_reserved=int(pages_reserved))
        # not-yet-arrived requests go back in their original order
        for req in reversed(future):
            self.queue.appendleft(req)

    def _prefill_turn(self):
        """ONE chunk per prefilling slot, then flip completed slots
        live."""
        chunk = self._infer.config.prefill_chunk
        trk = self._infer.tracker
        for slot in list(self.prefilling):
            req, start = self.prefilling[slot]
            t = len(req.tokens)
            n_prefill = t - 1
            if start < n_prefill:
                end = min(start + chunk, n_prefill)
                # prefill reads its table ROW from the host copy
                self._infer.cache.ensure(slot, end)
                t0 = time.perf_counter()
                self._infer.prefill_chunk(slot, req.tokens[start:end],
                                          start)
                if trk is not None:
                    trk.on_prefill_chunk(
                        slot, t0, time.perf_counter() - t0, start, end)
                self.prefilling[slot][1] = end
                start = end
            if start >= n_prefill:
                # decode writes the last prompt token's KV at t-1
                self._infer.cache.ensure(slot, max(t - 1, 1))
                self._infer.activate_slot(
                    slot, req.tokens[-1], t - 1, req.max_new_tokens,
                    req.temperature, req.top_k, req.eos_token_id)
                req.live_at = self._now()
                self.live[slot] = req
                self._last_pos[slot] = t - 1
                del self.prefilling[slot]
                if trk is not None:
                    trk.on_live(slot)

    def _fence(self, iterations):
        """The serving rendezvous: one fetch_state, then eviction and
        the monitor's events (host-only work: the tracker hooks are
        host dict and timestamp arithmetic)."""
        snap = self._infer.fetch_state()
        now = self._now()
        window_s = max(now - self._last_fence_t, 1e-9)
        trk = self._infer.tracker
        new_tokens = 0
        deltas = {}
        finished = []
        for slot, req in list(self.live.items()):
            gen = int(snap["n_gen"][slot])
            delta = gen - int(self._last_n_gen[slot])
            deltas[slot] = delta
            new_tokens += delta
            if delta > 0 and req.first_token_at is None:
                req.first_token_at = now
            self._last_pos[slot] = int(snap["pos"][slot])
            self._last_n_gen[slot] = gen
            if not snap["active"][slot]:
                finished.append((slot, req))
        if trk is not None:
            # TTFT and the per-slot decode windows BEFORE evictions, so
            # a request that got its first token and finished inside the
            # same window records both
            trk.on_fence_progress(self._decode_t0, iterations, deltas)
        for slot, req in finished:
            self._finish(slot, req, snap, now)
        if self._spec:
            # rejected-suffix rollback, host side: trim each live slot's
            # pages to its committed length (verify rewound the device
            # position; no page data moves), so the freed pages fund
            # this fence's admissions
            pages = sum(self._infer.cache.rollback(
                slot, int(snap["pos"][slot]) + 1) for slot in self.live)
            self._spec_fence(snap, pages)
        self._last_fence_t = now
        mon = self._infer.monitor
        mon.event(
            "decode_batch",
            iterations=int(iterations),
            active_slots=len(self.live),
            prefilling_slots=len(self.prefilling),
            queue_depth=len(self.queue),
            window_ms=round(window_s * 1e3, 3),
            window_tokens=int(new_tokens),
            tokens_per_sec=round(new_tokens / window_s, 3),
            kv_pages_in_use=int(self._infer.cache.pages_in_use()),
            kv_pages_free=int(self._infer.cache.free_pages()))
        if trk is not None:
            # SLO metrics AFTER evictions: this fence's finishes are in
            # the histograms and counters the event reports
            trk.on_fence_metrics(window_s, new_tokens, len(self.queue),
                                 len(self.live), len(self.prefilling))
        if mon.memory_enabled:
            mon._emit_memory_event(self._infer._host_steps)

    def _spec_fence(self, snap, rollback_pages):
        """Per-fence speculative accounting: diff the cumulative device
        counters (read in the fence's one copy) against the host mirrors
        and keep the window, with the drafted-vs-verified dispatch split,
        and its sums; hand the split to the serving tracker and emit the
        `speculative` monitor event."""
        sp = snap["speculative"]
        window = {"rounds": sp["rounds"] - self._last_rounds}
        self._last_rounds = sp["rounds"]
        for key, last in self._last_spec.items():
            now = sp[key].astype(np.int64)
            window[key] = int((now - last).sum())
            self._last_spec[key] = now
        window["rollback_pages"] = int(rollback_pages)
        window["draft_dispatch_s"], window["verify_dispatch_s"] = \
            self._infer.spec_dispatch_split()
        trk = self._infer.tracker
        if trk is not None:
            trk.on_speculative(
                window["draft_dispatch_s"], window["verify_dispatch_s"],
                window["drafted"], window["accepted"], window["verified"],
                window["rollbacks"])
        if window["rounds"] <= 0 and window["drafted"] == 0:
            return
        self.spec_window = window
        self.spec_stats["fences"] += 1
        for key, value in window.items():
            self.spec_stats[key] = self.spec_stats.get(key, 0) + value
        d, a, v = window["drafted"], window["accepted"], window["verified"]
        self._infer.monitor.event(
            "speculative",
            rounds=int(window["rounds"]),
            drafted_tokens=d,
            accepted_tokens=a,
            acceptance_rate=round(a / d, 4) if d > 0 else None,
            # emitted tokens per flagship verify launch (each verified
            # slot-round commits its accepted drafts + one flagship
            # token); vanilla decode is identically 1.0
            tokens_per_verify=round((a + v) / v, 3) if v > 0 else None,
            rollback_events=window["rollbacks"],
            rollback_pages=int(rollback_pages),
            mean_k=round(float(np.mean(
                sp["k_slot"][snap["active"]])), 3)
            if snap["active"].any() else None,
            draft_dispatch_ms=round(window["draft_dispatch_s"] * 1e3, 3),
            verify_dispatch_ms=round(window["verify_dispatch_s"] * 1e3, 3))

    def _finish(self, slot, req, snap, now):
        gen = int(snap["n_gen"][slot])
        req.out_tokens = np.asarray(
            snap["out_tokens"][slot][:gen], np.int32)
        req.finish_reason = "eos" if snap["finished_eos"][slot] \
            else "max_tokens"
        req.finished_at = now
        del self.live[slot]
        self._last_n_gen[slot] = 0
        self._last_pos[slot] = 0
        trk = self._infer.tracker
        if trk is not None:
            # before cache.free: the tracker's final row keeps the pages
            # the request held when it finished
            trk.on_finished(slot, req.finish_reason)
        self._infer.cache.free(slot)
        self.results.append(req)
        wall_s = max(now - req.admitted_at, 1e-9)
        live_at = req.live_at if req.live_at is not None \
            else req.admitted_at
        decode_s = max(now - live_at, 1e-9)
        self._infer.monitor.event(
            "request_finished",
            request_id=str(req.rid), slot=int(slot),
            reason=req.finish_reason,
            prompt_tokens=int(len(req.tokens)),
            new_tokens=gen,
            queued_ms=round(
                (req.admitted_at - req.arrival_time) * 1e3, 3),
            ttft_ms=None if req.first_token_at is None else round(
                (req.first_token_at - req.admitted_at) * 1e3, 3),
            prefill_ms=round(max(live_at - req.admitted_at, 0.0) * 1e3,
                             3),
            decode_ms=round(decode_s * 1e3, 3),
            token_ms=round(decode_s * 1e3 / max(gen, 1), 3),
            wall_ms=round(wall_s * 1e3, 3),
            tokens_per_sec=round(gen / wall_s, 3))


def serve_sequential(engine, requests, clock_zero=None):
    """Request-at-a-time baseline: each request is served alone
    (admitted no earlier than its arrival time, run to completion
    before the next is looked at) on the SAME engine and cache. This
    is what continuous batching replaces."""
    loop = ServingLoop(engine)
    loop._t0 = clock_zero if clock_zero is not None \
        else time.monotonic()
    loop._last_fence_t = loop._now()
    for req in sorted(requests, key=lambda r: r.arrival_time):
        while loop._now() < req.arrival_time:
            time.sleep(0.0005)
        loop.submit(req)
        while loop.queue or loop.live or loop.prefilling:
            loop.step()
    return loop
