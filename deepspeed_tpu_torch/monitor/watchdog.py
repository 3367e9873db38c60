"""Stall watchdog: a background thread that fires when training stops
making progress (port of deepspeed_tpu/monitor/watchdog.py).

Progress is defined as the engine's sync fence advancing — the one
point where host and device provably rendezvous (per-step host activity
is NOT progress: under async dispatch the host happily queues steps
against a wedged device until buffer donation blocks it). Subsystems
that can wedge a run (prefetch worker, checkpoint writer, offload step,
pipeline compile) report `heartbeat`s; they don't reset the stall clock
but their ages are included in the diagnostic when the watchdog fires,
pointing at WHICH part of the pipeline went quiet first.

On fire: one warning log with the per-source age table, an optional
`on_stall(diag)` callback, an event into the monitor sinks, and —
with `probe=True` — a device probe: a CUDA event recorded on the
training stream (`probe_stream`) and waited on by a separate daemon
thread (if the wait returns quickly the device queue is drained and
the stall is host-side; if it never returns the device itself is
wedged; the probe thread is sacrificial so a hung wait can't wedge the
watchdog too, and the training thread never waits on it). The watchdog re-arms after each fire, so a run that
stalls, recovers, and stalls again reports both episodes.

Escalation (`escalate_after=N`): a stall that persists keeps firing —
one `on_stall` per further `timeout_sec` of silence — with a
consecutive-fire counter; at the Nth consecutive fire a terminal
`stall_escalated` event is emitted EXACTLY ONCE per episode (sink
event + `on_escalate(diag)` callback; the monitor also dumps the
flight recorder on it), after which the episode goes quiet until a
fence re-arms it. A supervisor uses the
escalated verdict to give up waiting and execute recovery instead.
With escalate_after=0 (the default) behavior is unchanged: one fire
per episode, no terminal event.
"""

import threading
import time

from deepspeed_tpu_torch.utils.logging import logger


class StallWatchdog:
    def __init__(self, timeout_sec, on_stall=None, probe=False,
                 emit=None, poll_interval=None, escalate_after=0,
                 on_escalate=None, probe_stream=None):
        if not timeout_sec > 0:
            raise ValueError(f"timeout_sec must be > 0, got {timeout_sec}")
        self.timeout_sec = float(timeout_sec)
        self.on_stall = on_stall
        self.probe = probe
        # the CUDA stream the probe's event is recorded on (None: no
        # card, the probe reports that the host holds the run)
        self.probe_stream = probe_stream
        self.escalate_after = int(escalate_after or 0)
        self.on_escalate = on_escalate
        self._emit = emit            # monitor event hook (thread-safe)
        self._poll = poll_interval or min(self.timeout_sec / 4.0, 5.0)
        self._lock = threading.Lock()
        self._last_fence = None      # None = not armed yet
        self._heartbeats = {}
        self._terminal = set()       # finished subsystems (not stalled)
        self._fired_for = None       # fence timestamp already reported
        self._last_fire_t = None     # wall time of the episode's last fire
        self._consecutive = 0        # fires since the last fence
        self._escalated = False      # terminal event sent for this episode
        self.stall_count = 0
        self.escalation_count = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="ds-tpu-watchdog", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # progress signals
    # ------------------------------------------------------------------
    def notify_fence(self):
        """A sync fence advanced — THE progress signal. Also arms the
        watchdog on first call (an idle engine that never trained must
        not fire)."""
        with self._lock:
            self._last_fence = time.monotonic()
            self._fired_for = None
            self._last_fire_t = None
            self._consecutive = 0
            self._escalated = False

    def arm(self):
        """Start the stall clock without counting progress (called at
        the first train step, so a first fence that never arrives is
        itself detected)."""
        with self._lock:
            if self._last_fence is None:
                self._last_fence = time.monotonic()

    def heartbeat(self, source):
        with self._lock:
            self._heartbeats[source] = time.monotonic()
            # a fresh beat revives a previously-finished subsystem
            # (e.g. a new prefetch loader reusing the name)
            self._terminal.discard(source)

    def mark_terminal(self, source):
        """A subsystem finished CLEANLY (e.g. the prefetch worker after
        its loader exhausted). Its heartbeat age stops counting toward
        a stall verdict — a done worker going quiet is not a wedge —
        but it stays listed as terminal in the diagnostic."""
        with self._lock:
            self._terminal.add(source)

    # ------------------------------------------------------------------
    # the watchdog loop
    # ------------------------------------------------------------------
    def _diagnose(self, now, age):
        with self._lock:
            beats = dict(self._heartbeats)
            terminal = set(self._terminal)
        return {
            "fence_age_sec": round(age, 3),
            "timeout_sec": self.timeout_sec,
            "heartbeat_age_sec": {
                src: round(now - t, 3) for src, t in beats.items()
                if src not in terminal},
            "terminal_subsystems": sorted(terminal),
        }

    def _probe_device(self):
        """Record a CUDA event on the training stream and time its
        completion on a sacrificial daemon thread."""
        stream = self.probe_stream
        event = None
        if stream is not None:
            import torch
            event = torch.cuda.Event()
            event.record(stream)

        def probe():
            try:
                t0 = time.monotonic()
                if event is not None:
                    event.synchronize()
                logger.warning(
                    "stall probe: the device queue drained in "
                    f"{time.monotonic() - t0:.3f}s — the stall is "
                    "host-side (input pipeline, checkpoint barrier, or "
                    "the loop itself)")
            except Exception:
                logger.warning("stall probe failed", exc_info=True)

        threading.Thread(target=probe, name="ds-tpu-stall-probe",
                         daemon=True).start()

    def _run(self):
        while not self._stop.wait(self._poll):
            with self._lock:
                last = self._last_fence
                fired = self._fired_for
                last_fire = self._last_fire_t
                escalated = self._escalated
            if last is None:
                continue
            if fired == last:
                # already reported this episode: with escalation on,
                # keep re-firing every further timeout_sec of silence
                # (counting consecutive fires) until the terminal
                # verdict; the default keeps one fire per episode
                if self.escalate_after <= 0 or escalated or \
                        last_fire is None or \
                        time.monotonic() - last_fire < self.timeout_sec:
                    continue
            now = time.monotonic()
            age = now - last
            if age < self.timeout_sec:
                continue
            with self._lock:
                self._fired_for = last
                self._last_fire_t = now
                self.stall_count += 1
                self._consecutive += 1
                consecutive = self._consecutive
                escalate = (self.escalate_after > 0 and
                            consecutive >= self.escalate_after and
                            not self._escalated)
                if escalate:
                    self._escalated = True
                    self.escalation_count += 1
            diag = self._diagnose(now, age)
            diag["consecutive_fires"] = consecutive
            term = diag.get("terminal_subsystems") or []
            logger.warning(
                f"STALL: no sync fence for {age:.1f}s "
                f"(stall_timeout_sec={self.timeout_sec}); last subsystem "
                f"heartbeats (sec ago): {diag['heartbeat_age_sec']}"
                + (f"; finished: {term}" if term else ""))
            if self._emit is not None:
                try:
                    self._emit("stall", diag)
                except Exception:
                    # a broken sink must not kill the watchdog thread,
                    # but the evidence of WHY it broke must survive
                    logger.warning("stall event emit failed",
                                   exc_info=True)
            if self.probe:
                self._probe_device()
            if self.on_stall is not None:
                try:
                    self.on_stall(diag)
                except Exception:
                    logger.warning("stall callback raised",
                                   exc_info=True)
            if escalate:
                ediag = dict(diag, escalate_after=self.escalate_after)
                logger.error(
                    f"STALL ESCALATED: {consecutive} consecutive "
                    f"watchdog fires with no progress (escalate_after="
                    f"{self.escalate_after}); this episode is terminal "
                    "— a supervisor should recover, not keep waiting")
                if self._emit is not None:
                    try:
                        self._emit("stall_escalated", ediag)
                    except Exception:
                        logger.warning(
                            "stall_escalated event emit failed",
                            exc_info=True)
                if self.on_escalate is not None:
                    try:
                        self.on_escalate(ediag)
                    except Exception:
                        logger.warning("escalation callback raised",
                                       exc_info=True)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
