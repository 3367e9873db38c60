"""Step tracing: named spans without per-step device fences (port of
deepspeed_tpu/monitor/trace.py).

The legacy `wall_clock_breakdown` timers synchronize the device on
every start/stop — per MICRO-step — which serializes exactly the
async-dispatch pipeline the engine is built around. Spans here do two
things instead:

  * while a torch profiler is recording, each span wraps its region in
    `torch.profiler.record_function("ds_tpu/<name>")`, so forward/
    backward/step/ckpt/prefetch show up as named ranges in the trace;
    without one a span costs two `perf_counter` calls and no
    record_function;
  * host wall time per span is accumulated WITHOUT any device fence
    and reported fence-aligned at the engine's sync fences. Under
    async dispatch a span therefore measures host-side DISPATCH time
    (what the hot loop actually pays), not device execution — device
    time belongs to the profiler. This is the documented
    `wall_clock_breakdown` behavior change.
"""

import threading
import time

import torch

SPAN_FORWARD = "forward"
SPAN_BACKWARD = "backward"
SPAN_STEP = "step"
SPAN_CKPT = "ckpt"
SPAN_PREFETCH = "prefetch"


def _profiler_active():
    """True while a torch profiler (torch.profiler.profile) records."""
    try:
        return torch.autograd.profiler._is_profiler_enabled
    except AttributeError:
        return False


def _annotation(name):
    if not _profiler_active():
        return None
    try:
        ann = torch.profiler.record_function(f"ds_tpu/{name}")
        ann.__enter__()
        return ann
    except Exception:  # ds-lint: allow[BROADEXC] profiler annotation is decorative; the hot path must not fail on it
        return None


class _Span:
    __slots__ = ("t0", "annotation")

    def __init__(self, name):
        self.t0 = time.perf_counter()
        self.annotation = _annotation(name)


class StepTrace:
    """start/stop named spans (timer-style, so the engine's split
    forward()/backward()/step() call sites can use it) plus a `span`
    context manager; totals drain at fences."""

    def __init__(self):
        self._open = {}
        self._lock = threading.Lock()
        self._totals = {}
        self._counts = {}
        self._export = None      # (name, t0, dur) hook -> TraceExporter

    def set_export_sink(self, fn):
        """Route every closed span to the Perfetto exporter as well
        (monitor/trace_export.py) — spans are timed once, rendered in
        both the fence metrics and the trace file."""
        self._export = fn

    def start(self, name):
        self._open[name] = _Span(name)

    def stop(self, name):
        sp = self._open.pop(name, None)
        if sp is None:
            return
        if sp.annotation is not None:
            try:
                sp.annotation.__exit__(None, None, None)
            except Exception:  # ds-lint: allow[BROADEXC] profiler annotation is decorative; the hot path must not fail on it
                pass
        dt = time.perf_counter() - sp.t0
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1
        if self._export is not None:
            try:
                self._export(name, sp.t0, dt)
            except Exception:  # ds-lint: allow[BROADEXC] trace-export hook on the hot path; a broken exporter must not stall the step loop
                pass

    def span(self, name):
        return _SpanCtx(self, name)

    def drain(self):
        """{name: {"ms": total, "count": n, "ms_per": mean}} since the
        last drain; resets the window."""
        with self._lock:
            totals, self._totals = self._totals, {}
            counts, self._counts = self._counts, {}
        return {
            name: {"ms": round(totals[name] * 1e3, 3),
                   "count": counts.get(name, 0),
                   "ms_per": round(
                       totals[name] * 1e3 / max(counts.get(name, 1), 1),
                       3)}
            for name in totals
        }


class _SpanCtx:
    def __init__(self, trace, name):
        self._trace = trace
        self._name = name

    def __enter__(self):
        self._trace.start(self._name)
        return self

    def __exit__(self, *exc):
        self._trace.stop(self._name)
        return False
