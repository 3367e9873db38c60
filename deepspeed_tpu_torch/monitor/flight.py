"""Crash/stall flight recorder.

When a run dies — SIGKILL'd by the scheduler, wedged until the
watchdog fires, or killed by an exception out of the step loop — the
monitor's evidence normally evaporates with the process. The flight
recorder is the bounded black box: a ring buffer retaining the last
`capacity` monitor events (metrics fences, ckpt commits, stalls,
numerics windows, crash records) plus the current per-subsystem
heartbeat ages, dumped ATOMICALLY (tmp + fsync + rename — the checkpoint
writer discipline) to `flight_<ts>.json` so the run's final seconds
survive it.

Dump triggers (monitor/__init__.py wires them):
  * watchdog fire — the stall diagnostic rides along as `extra`;
  * uncaught exception out of `train_batch` — the exception repr +
    traceback tail ride along;
  * SIGTERM — a module-level handler (installed once, chaining any
    existing handler) dumps every live recorder, then re-raises the
    default action so exit codes stay honest;
  * abnormal interpreter exit — an atexit hook dumps recorders whose
    engine stepped but never reached `monitor.close()` (a clean close
    disarms it; an idle engine that never trained stays silent).

Everything here is host-side and thread-safe: `record` is a deque
append under a lock (the watchdog and checkpoint writer call it from
their threads), and `dump` never touches the device — a wedged chip
cannot wedge the dump that is supposed to explain it.
"""

import collections
import json
import os
import signal
import threading
import time
import traceback
import weakref

from deepspeed_tpu_torch.utils.logging import logger

FLIGHT_SCHEMA_VERSION = 1
FLIGHT_PREFIX = "flight_"

# live recorders for the process-level SIGTERM/atexit hooks
_LIVE = weakref.WeakSet()
_HOOKS_INSTALLED = False
_PREV_SIGTERM = None
_hooks_lock = threading.Lock()


def _dump_all(reason):
    for rec in list(_LIVE):
        try:
            rec.dump(reason)
        except Exception:  # ds-lint: allow[BROADEXC] a post-mortem dump must never raise out of a signal handler
            pass


def _on_sigterm(signum, frame):
    _dump_all("sigterm")
    # restore + re-raise so the process still dies with the SIGTERM
    # disposition the sender expects (chained handlers run first)
    prev = _PREV_SIGTERM
    if callable(prev):
        prev(signum, frame)
    else:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _on_atexit():
    # only recorders still armed (engine stepped, monitor.close()
    # never ran) dump here — a clean shutdown leaves no crumbs; an
    # output dir already deleted (ephemeral run dirs) is not recreated
    for rec in list(_LIVE):
        try:
            if rec.armed and os.path.isdir(rec.out_dir):
                rec.dump("atexit")
        except Exception:  # ds-lint: allow[BROADEXC] atexit hooks must not raise during interpreter teardown
            pass


def _install_hooks():
    global _HOOKS_INSTALLED, _PREV_SIGTERM
    with _hooks_lock:
        if _HOOKS_INSTALLED:
            return
        import atexit
        atexit.register(_on_atexit)
        try:
            if threading.current_thread() is threading.main_thread():
                prev = signal.getsignal(signal.SIGTERM)
                # leave a non-default handler alone — the application
                # owns SIGTERM then; it can call dump() itself
                if prev in (signal.SIG_DFL, None):
                    _PREV_SIGTERM = prev
                    signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            pass          # non-main thread / restricted environment
        _HOOKS_INSTALLED = True


class FlightRecorder:
    """Bounded event ring + atomic post-mortem dumps."""

    def __init__(self, out_dir, capacity=256, rank=0, step_fn=None,
                 heartbeats_fn=None, context_fn=None):
        self.out_dir = out_dir
        self.capacity = int(capacity)
        self.rank = int(rank)
        self._step_fn = step_fn              # () -> current step
        self._heartbeats_fn = heartbeats_fn  # () -> (ages, terminal)
        self._context_fn = context_fn        # () -> extra context dict
        try:
            # eager: the atexit hook only dumps into a STILL-existing
            # dir (ephemeral run dirs deleted before exit are left
            # alone), so the dir must exist from the start
            os.makedirs(out_dir, exist_ok=True)
        except OSError:
            # unwritable dir: dump() retries and logs at dump time
            pass
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._context = {}
        self._dumps = []          # paths written this life
        self.armed = False        # True once the engine stepped
        _LIVE.add(self)
        _install_hooks()

    # ------------------------------------------------------------------
    def record(self, event):
        """Retain one (already JSON-able) monitor event."""
        with self._lock:
            self._ring.append(event)

    def set_context(self, **kv):
        """Sticky forensic context (e.g. the last numerics window and
        its first-NaN attribution) included in every dump."""
        with self._lock:
            self._context.update(kv)

    def record_exception(self, exc):
        tb = traceback.format_exc(limit=20)
        self.record({
            "kind": "crash", "ts": round(time.time(), 6),
            "error": repr(exc), "traceback_tail": tb[-4000:]})

    def arm(self):
        self.armed = True

    def disarm(self):
        """A clean close: no atexit dump for this recorder."""
        self.armed = False
        _LIVE.discard(self)

    # ------------------------------------------------------------------
    def snapshot(self, reason, extra=None):
        with self._lock:
            events = list(self._ring)
            context = dict(self._context)
        heartbeats, terminal = {}, []
        if self._heartbeats_fn is not None:
            try:
                heartbeats, terminal = self._heartbeats_fn()
            except Exception:  # ds-lint: allow[BROADEXC] a broken context callback must not kill the dump that documents the crash
                pass
        if self._context_fn is not None:
            try:
                context.update(self._context_fn() or {})
            except Exception:  # ds-lint: allow[BROADEXC] a broken context callback must not kill the dump that documents the crash
                pass
        step = None
        if self._step_fn is not None:
            try:
                step = self._step_fn()
            except Exception:  # ds-lint: allow[BROADEXC] a broken context callback must not kill the dump that documents the crash
                pass
        doc = {
            "v": FLIGHT_SCHEMA_VERSION,
            "kind": "flight",
            "reason": reason,
            "ts": round(time.time(), 6),
            "rank": self.rank,
            "step": step,
            "heartbeat_age_sec": heartbeats,
            "terminal_subsystems": sorted(terminal),
            "context": context,
            "events": events,
        }
        if extra:
            doc["extra"] = extra
        return doc

    def dump(self, reason, extra=None):
        """Atomic dump: `flight_<ts>.json.tmp` -> fsync -> rename.
        Returns the path, or None when the directory is unwritable (a
        post-mortem must never raise out of a signal handler)."""
        doc = self.snapshot(reason, extra=extra)
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            ts = time.strftime("%Y%m%d_%H%M%S")
            ms = int((time.time() % 1) * 1000)
            path = os.path.join(
                self.out_dir,
                f"{FLIGHT_PREFIX}{ts}_{ms:03d}_r{self.rank}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, separators=(",", ":"),
                          default=_json_default)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except Exception:
            try:
                logger.warning("flight recorder dump failed",
                               exc_info=True)
            except Exception:  # ds-lint: allow[BROADEXC] logging during interpreter teardown may itself fail; the dump path must not raise
                pass
            return None
        self._dumps.append(path)
        try:
            logger.warning(
                f"flight recorder: dumped last {len(doc['events'])} "
                f"events to {path} (reason: {reason})")
        except Exception:  # ds-lint: allow[BROADEXC] logging during interpreter teardown may itself fail; the dump path must not raise
            pass
        return path


def _json_default(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def list_flight_dumps(out_dir):
    """flight_*.json files in a monitor output dir, oldest first."""
    if not os.path.isdir(out_dir):
        return []
    names = sorted(n for n in os.listdir(out_dir)
                   if n.startswith(FLIGHT_PREFIX) and
                   n.endswith(".json"))
    return [os.path.join(out_dir, n) for n in names]
