"""deepspeed_tpu_torch.monitor — unified async-safe telemetry (port of
deepspeed_tpu/monitor/, whose file names and public names it keeps).

  * MetricsRegistry (registry.py): hot-path metrics stay as the step's
    own device tensors, retained per step and drained with exactly one
    device-to-host copy at the engine's `steps_per_sync` fences — zero
    new per-step host syncs; host gauges (checkpoint queue depth /
    commit latency, prefetch occupancy, device memory) sample at the
    same fences.
  * Pluggable sinks (sinks.py): schema-versioned JSONL event log and a
    dependency-free native tfevents writer (tfevents.py) — plus the
    in-process `engine.monitor.snapshot()` API, with the JAX package's
    schema.
  * Step tracing + stall watchdog (trace.py / watchdog.py): named
    spans (`torch.profiler.record_function` while a profiler records)
    timed without a device fence and reported at fences
    (`wall_clock_breakdown=true` rides this path), and a background
    thread that fires when no fence advances within
    `stall_timeout_sec`.
  * Perfetto trace export (trace_export.py, `monitor.trace`) and
    `ds_trace merge|summary` (trace_cli.py).
  * Flight recorder (flight.py, `monitor.flight`, default on): a
    bounded ring of the last events + heartbeat ages, dumped
    atomically on watchdog fire / uncaught train_batch exception /
    SIGTERM / abnormal exit.
  * Numerics health (numerics.py, `monitor.numerics`): per-group grad
    stats computed on the device in the step, drained in the same
    one-copy-per-fence path, with sticky first-NaN attribution.
  * Memory ledger (memory.py, `monitor.memory`, default on): every
    long-lived allocation site registers its logical buffers by
    category; fences reconcile ledger vs `device_memory_stats`
    (torch's allocated bytes) + host RSS into a `memory` event with
    per-category attribution, a peak watermark (attribution AT peak),
    Perfetto counter tracks, and OOM-classified flight dumps.
  * The serving tracker (serving.py): request lifecycles, SLO
    histograms and the serving timeline of an InferenceEngine.

The Monitor object orchestrates these against one engine; every hook
is a no-op behind a single attribute check when `monitor.enabled` is
false (the default).
"""

import os
import time
import weakref

import torch

from deepspeed_tpu_torch.monitor import memory as memory_mod
from deepspeed_tpu_torch.monitor.config import (DeepSpeedMonitorConfig,
                                          MonitorConfigError)
from deepspeed_tpu_torch.monitor.flight import FlightRecorder
from deepspeed_tpu_torch.monitor.memory import MemoryLedger
from deepspeed_tpu_torch.monitor.registry import MetricsRegistry
from deepspeed_tpu_torch.monitor.sinks import (SCHEMA_VERSION, base_event,
                                         build_sinks)
from deepspeed_tpu_torch.monitor.trace import (SPAN_BACKWARD, SPAN_CKPT,
                                         SPAN_FORWARD, SPAN_PREFETCH,
                                         SPAN_STEP, StepTrace)
from deepspeed_tpu_torch.monitor.trace_export import (CAT_SUBSYSTEM,
                                                TraceExporter)
from deepspeed_tpu_torch.monitor.watchdog import StallWatchdog
from deepspeed_tpu_torch.runtime.utils import device_memory_stats
from deepspeed_tpu_torch.utils.distributed import get_rank, get_world_size
from deepspeed_tpu_torch.utils.logging import logger

__all__ = [
    "Monitor", "MetricsRegistry", "StepTrace", "StallWatchdog",
    "FlightRecorder", "TraceExporter", "MemoryLedger",
    "DeepSpeedMonitorConfig", "MonitorConfigError", "SCHEMA_VERSION",
    "SPAN_FORWARD", "SPAN_BACKWARD", "SPAN_STEP", "SPAN_CKPT",
    "SPAN_PREFETCH",
]

_MONITOR_OUTPUT_DEFAULT = "ds_monitor"

# nominal dense bf16 peak FLOP/s by CUDA card name (NVIDIA's data
# sheets, without sparsity): the MFU denominator when no
# `peak_flops_override` is set
_CARD_PEAK_BF16 = (("H100", 989e12), ("H200", 989e12), ("A100", 312e12))

# the keys of the JAX package's `device_memory_stats`, which the
# `memory` gauge (and so the metrics event) carries
_MEMORY_GAUGE_KEYS = ("in_use_bytes", "peak_bytes", "device_count",
                      "host_rss_bytes")


def card_peak_flops(name):
    """The nominal dense bf16 peak of a CUDA card named `name`
    (`torch.cuda.get_device_name()`), or None for an unknown card."""
    for key, peak in _CARD_PEAK_BF16:
        if key in name:
            return peak
    return None


def memory_gauge():
    """`device_memory_stats` in the JAX package's keys, with the host
    RSS beside them (the reserved pool stays in device_memory_stats)."""
    stats = device_memory_stats()
    rss = memory_mod.host_rss_bytes()
    if rss is not None:
        stats["host_rss_bytes"] = rss
    return {k: stats[k] for k in _MEMORY_GAUGE_KEYS if k in stats}


class Monitor:
    """Per-engine telemetry orchestrator.

    Lifecycle: the engine constructs one Monitor in __init__ and calls
    `on_step` after each fused step (device-side fold, no sync) and
    `on_fence` inside `_sync_fence` (the one drain + sink emit point).
    Subsystems running off the main thread (checkpoint writer, stall
    watchdog, prefetch worker) use `event`/`heartbeat`, which are
    thread-safe.
    """

    def __init__(self, engine, config: DeepSpeedMonitorConfig):
        self.config = config
        self.enabled = bool(config.enabled)
        # weakref: the watchdog thread must not pin dead engines (and
        # their device state) alive through the monitor
        self._engine_ref = weakref.ref(engine)
        self.registry = MetricsRegistry()
        self.trace = StepTrace()
        self.sinks = []
        self._sink_emit_warned = set()
        self.watchdog = None
        self.trace_export = None
        self.flight = None
        self._armed = False
        self._last_fence_t = None
        self._last_flush_t = 0.0
        self._prefetch_ref = None
        self._cum = {"steps": 0, "overflow_count": 0, "tokens": 0}
        self._last = {}          # most recent drained window metrics
        self._last_numerics = None
        self._last_router = None   # last fence's router-event fields
        self._serving_ref = None     # live ServingTracker (serving)
        self._first_nonfinite = None   # sticky first-NaN attribution
        # host-side heartbeat mirror (ages for the flight recorder even
        # when no watchdog is configured)
        self._hb = {}
        self._hb_terminal = set()
        self._numerics_names = {"grad": None, "act": None}
        # the memory ledger exists even when the monitor is disabled:
        # allocation sites register unconditionally (init-time shape
        # math, no per-step cost) so enabling the monitor later — or a
        # user-initiated snapshot — still has full attribution
        self.ledger = MemoryLedger()
        self._last_memory = None
        # categories last emitted nonzero per counter series: a
        # released buffer must emit one explicit 0 — Chrome counter
        # semantics keep the last seen value per key, so omitting it
        # would freeze the stacked area at its old height forever
        self._mem_counter_keys = {"hbm": set(), "host": set()}
        # gauges register even when disabled so snapshot() keeps its
        # stable key set on a monitor-off engine
        self._register_default_gauges()
        if not self.enabled:
            return

        rank = get_rank()
        rank0 = rank == 0
        out_dir = config.output_path or _MONITOR_OUTPUT_DEFAULT
        if config.job_name:
            out_dir = os.path.join(out_dir, config.job_name)
        self._out_dir = out_dir
        if rank0 or config.all_ranks:
            job = config.job_name
            if config.all_ranks and not rank0:
                job = os.path.join(job or "", f"rank{rank}")
            self.sinks = build_sinks(
                config.sinks, config.output_path or
                _MONITOR_OUTPUT_DEFAULT, job)
        if config.trace_enabled and (rank0 or config.all_ranks):
            self.trace_export = TraceExporter(
                rank=rank, max_events=config.trace_max_events,
                meta={"job_name": config.job_name})
            self.trace.set_export_sink(
                lambda name, t0, dur: self.trace_export.complete(
                    f"host/{name}", name, t0, dur))
        if config.flight_enabled:
            self.flight = FlightRecorder(
                out_dir=config.flight_path or out_dir,
                capacity=config.flight_capacity,
                rank=rank,
                step_fn=self._flight_step,
                heartbeats_fn=self._heartbeat_state)
        if config.stall_timeout_sec > 0:
            device = getattr(engine, "device", None)
            self.watchdog = StallWatchdog(
                config.stall_timeout_sec,
                probe=config.stall_probe,
                escalate_after=config.stall_escalate_after,
                emit=self._emit_kind,
                probe_stream=torch.cuda.current_stream(device)
                if device is not None and device.type == "cuda" else None)

    def _flight_step(self):
        e = self._engine_ref()
        return e._host_steps if e is not None else None

    def _heartbeat_state(self):
        """(age per ACTIVE subsystem, terminal list) from the monitor's
        own heartbeat mirror — available to the flight recorder with or
        without a watchdog."""
        now = time.monotonic()
        return ({src: round(now - t, 3) for src, t in self._hb.items()
                 if src not in self._hb_terminal},
                sorted(self._hb_terminal))

    # ------------------------------------------------------------------
    # gauges
    # ------------------------------------------------------------------
    def _register_default_gauges(self):
        ref = self._engine_ref

        def ckpt_queue_depth():
            e = ref()
            w = getattr(e, "_ckpt_writer", None) if e else None
            return 0.0 if w is None else float(w.queue_depth())

        def prefetch_occupancy():
            loader = self._prefetch_ref() if self._prefetch_ref else None
            if loader is None:
                return None
            return {"occupancy": loader.occupancy(),
                    "depth": loader.depth}

        self.registry.add_gauge("checkpoint/queue_depth",
                                ckpt_queue_depth)
        self.registry.add_gauge("prefetch", prefetch_occupancy)
        self.registry.add_gauge("memory", memory_gauge)

    def attach_prefetch(self, loader):
        """Remember the live PrefetchLoader for the occupancy gauge and
        the memory ledger's dynamic prefetch-staging entry (occupancy x
        staged-batch bytes, sampled at reconcile time; a fresh loader
        supersedes the previous entry)."""
        self._prefetch_ref = weakref.ref(loader)
        ref = self._prefetch_ref
        self.ledger.register_dynamic(
            memory_mod.CAT_PREFETCH, "prefetch.staged",
            lambda: (lambda l: l.buffer_bytes() if l else 0)(ref()))

    def attach_serving(self, tracker):
        """Remember the live ServingTracker (monitor/serving.py) so
        crash forensics can attach the in-flight request table and the
        serving-aware OOM hint ranking. The tracker updates the flight
        context itself at every phase change."""
        self._serving_ref = weakref.ref(tracker)

    def heartbeat(self, source):
        self._hb[source] = time.monotonic()
        self._hb_terminal.discard(source)
        if self.watchdog is not None:
            self.watchdog.heartbeat(source)

    def heartbeat_done(self, source):
        """A subsystem finished cleanly (e.g. the prefetch worker after
        its source exhausted): its heartbeat goes terminal — excluded
        from stall verdicts, listed as finished in diagnostics."""
        self._hb_terminal.add(source)
        if self.watchdog is not None:
            self.watchdog.mark_terminal(source)

    def subsystem_span(self, track, name, t_start, dur, args=None):
        """Stamp one host-subsystem slice (prefetch staging, ckpt
        commit, offload host step) onto the Perfetto timeline.
        Thread-safe, no-op without trace export."""
        if self.trace_export is not None:
            self.trace_export.complete(track, name, t_start, dur,
                                       cat=CAT_SUBSYSTEM, args=args)

    def set_numerics_labels(self, grad=None, act=None):
        """Host-side names for the numerics stat rows: `grad` labels
        the [G,3] gradient-group rows, `act` the [L,3] activation
        boundary rows (the engine knows both at build time)."""
        if grad is not None:
            self._numerics_names["grad"] = list(grad)
        if act is not None:
            self._numerics_names["act"] = list(act)

    @property
    def numerics_enabled(self):
        return self.enabled and self.config.numerics_enabled

    @property
    def memory_enabled(self):
        return self.enabled and self.config.memory_enabled

    def set_memory_plan(self, plan):
        """Attach a per-component ZeRO memory plan ({component: bytes
        per device}; `ZeroShardingPolicy.memory_plan`): every later
        `memory` event and trace export carries plan-vs-measured
        deltas (`bin/ds_trace summary` prints them)."""
        self.ledger.set_plan(plan)
        if self.trace_export is not None:
            self.trace_export.set_meta(
                memory_plan={k: int(v) for k, v in (plan or {}).items()})

    def _reconcile_memory(self, step):
        """Fence-aligned ledger reconciliation: pure host arithmetic
        over shape metadata + one allocator-stats read
        (`torch.cuda.memory_stats`, a host call) — zero host<->device
        syncs (guard-tested). Updates the flight recorder's sticky peak
        context so an OOM dump names what was alive at the watermark
        even after the ring rolled."""
        # the gauge embeds host_rss_bytes; reconcile falls back to it —
        # one /proc read per fence, not two
        payload = self.ledger.reconcile(
            memory_gauge(),
            step=step, top_n=self.config.memory_top_buffers)
        self._last_memory = payload
        if self.flight is not None and payload.get("peak"):
            self.flight.set_context(memory_peak=payload["peak"])
        return payload

    def _emit_memory_event(self, step):
        payload = self._reconcile_memory(step)
        event = base_event("memory", step)
        event.update(payload)
        self._emit(event)
        if self.trace_export is not None:
            # per-category counter tracks: Perfetto stacks the args of
            # one counter series, so the HBM timeline reads as a
            # stacked-by-category area with the residual on top
            for space in ("hbm", "host"):
                cats = payload[space]["categories"]
                live = {c: cats[c] for c in memory_mod.CATEGORIES
                        if cats.get(c)}
                # one explicit 0 for categories that just vanished
                # (e.g. a released ckpt snapshot), then they drop out
                vals = dict(live)
                for gone in self._mem_counter_keys[space] - set(live):
                    vals[gone] = 0
                self._mem_counter_keys[space] = set(live)
                res = payload[space]["residual_bytes"]
                if res is not None:
                    vals["residual"] = max(res, 0)
                if vals:
                    self.trace_export.counter(
                        "memory", f"{space}_bytes", vals)
        return event

    # ------------------------------------------------------------------
    # hot path
    # ------------------------------------------------------------------
    def on_step(self, loss=None, grad_norm=None, loss_scale=None,
                overflow=None, tokens=0, wire_stats=None, health=None,
                router=None):
        """Fold one step's metrics. Device scalars stay on the device
        (a list append); host numbers go to counters; `health`
        (numerics stat tensors, monitor/numerics.py) and `router` (the
        MoE [E+2] router stats vector, moe/router.py) are retained the
        same way. NO host<->device sync on this
        path — the fence-alignment guard test pins it."""
        if not self.enabled:
            return
        self.registry.fold_step(loss, grad_norm, loss_scale, overflow,
                                tokens, health=health, router=router)
        if wire_stats:
            self.registry.inc("wire/d2h_bytes",
                              wire_stats.get("d2h_bytes", 0))
            self.registry.inc("wire/h2d_bytes",
                              wire_stats.get("h2d_bytes", 0))
        if not self._armed:
            self._armed = True
            if self.watchdog is not None:
                self.watchdog.arm()
            if self.flight is not None:
                # armed = the engine actually trained; an abnormal exit
                # from here on leaves a flight dump
                self.flight.arm()

    # ------------------------------------------------------------------
    # fence drain
    # ------------------------------------------------------------------
    def _wire_dict(self, counters):
        e = self._engine_ref()
        stats = getattr(e, "wire_stats", None) if e else None
        stats = stats or {}
        return {
            "d2h_bytes": int(counters.get("wire/d2h_bytes", 0)),
            "h2d_bytes": int(counters.get("wire/h2d_bytes", 0)),
            "grad_bits": stats.get("grad_bits"),
            "param_bits": stats.get("param_bits"),
        }

    def _checkpoint_dict(self, counters, gauges):
        return {
            "queue_depth": int(gauges.get("checkpoint/queue_depth", 0)),
            "commits": int(counters.get("ckpt/commits", 0)),
            "last_commit_ms": counters.get("ckpt/last_commit_ms"),
        }

    def _throughput_derived(self):
        """tokens/s/chip + MFU once the throughput timer has a measured
        window (None before that, and MFU None on the CPU where no
        nominal peak applies). Same convention as bench.py's headline:
        conservative 6·N·tokens/s against the card's nominal dense bf16
        peak. The timer is read without waiting for the device
        (`block=False`): the fence stays one rendezvous."""
        e = self._engine_ref()
        if e is None:
            return {"tokens_per_sec_per_chip": None, "mfu": None}
        sps = e.tput_timer.avg_samples_per_sec(block=False)
        t_per_sample = getattr(e, "_tokens_per_sample", None)
        if not sps or not t_per_sample:
            return {"tokens_per_sec_per_chip": None, "mfu": None}
        tps_chip = sps * t_per_sample / max(get_world_size(), 1)
        mfu = None
        n = getattr(e, "_n_model_params", 0)
        override = self.config.peak_flops_override
        device = getattr(e, "device", None)
        if n and override:
            # monitor.peak_flops_override: report MFU against the
            # caller's denominator on ANY device — CPU rehearsal runs
            # get a real number instead of None
            mfu = round(6.0 * n * tps_chip / override, 4)
        elif n and device is not None and device.type == "cuda":
            peak = card_peak_flops(torch.cuda.get_device_name(device))
            if peak:
                mfu = round(6.0 * n * tps_chip / peak, 4)
        return {"tokens_per_sec_per_chip": round(tps_chip, 1),
                "mfu": mfu}

    def on_fence(self):
        """The ONE telemetry rendezvous: drain the device accumulator
        (a single device-to-host copy), sample host gauges, emit a metrics
        event, and tell the watchdog the run is alive. Returns the
        event (or None) so the engine can reuse it for breakdown
        logging."""
        if not self.enabled:
            return None
        if self.watchdog is not None:
            self.watchdog.notify_fence()
        e = self._engine_ref()
        if e is None:
            return None
        # the throughput window ends before the drain, whose copy then
        # completes it: the fence stays one rendezvous
        timer = getattr(e, "tput_timer", None)
        if timer is not None:
            timer.close_window()
        window = self.registry.drain_device()
        if timer is not None:
            timer.collect()
        now = time.perf_counter()
        if window is None:
            self._maybe_flush()
            return None
        numerics = self._summarize_numerics(window)
        self._last = window
        self._cum["steps"] += window["steps"]
        self._cum["overflow_count"] += window["overflow_count"]
        self._cum["tokens"] += window["tokens"]

        counters = self.registry.counters()
        gauges = self.registry.sample_gauges()
        event = base_event("metrics", e._host_steps)
        event.update(
            micro_steps=e.micro_steps,
            # None when no step in the window reported one (e.g.
            # release_loss=True loops) — never a fabricated 0.0
            loss=None if window["loss"] is None
            else round(window["loss"], 6),
            grad_norm=None if window["grad_norm"] is None
            else round(window["grad_norm"], 6),
            loss_scale=window["loss_scale"],
            lr=e._current_lr(),
            window_steps=window["steps"],
            overflow_count=self._cum["overflow_count"],
            tokens=self._cum["tokens"],
            samples_per_sec=round(
                e.tput_timer.avg_samples_per_sec(block=False), 3),
        )
        event.update(self._throughput_derived())
        if self._last_fence_t is not None and now > self._last_fence_t:
            event["tokens_per_sec"] = round(
                window["tokens"] / (now - self._last_fence_t), 1)
        self._last_fence_t = now
        event["memory"] = {
            k.split("/", 1)[1]: v for k, v in gauges.items()
            if k.startswith("memory/")}
        event["wire"] = self._wire_dict(counters)
        event["checkpoint"] = self._checkpoint_dict(counters, gauges)
        event["prefetch"] = {
            "occupancy": gauges.get("prefetch/occupancy"),
            "depth": gauges.get("prefetch/depth"),
        }
        spans = self.trace.drain()
        if spans:
            event["spans"] = spans
        if self.trace_export is not None:
            # fence marks + counter tracks: loss/throughput ride the
            # Perfetto timeline next to the span and pipeline slices
            vals = {k: event[k] for k in
                    ("loss", "grad_norm", "tokens_per_sec",
                     "samples_per_sec")
                    if isinstance(event.get(k), (int, float))}
            if vals:
                self.trace_export.counter("fences", "metrics", vals)
            self.trace_export.instant(
                "fences", f"fence step {event['step']}",
                args={"window_steps": event.get("window_steps")})
        self._emit(event)
        if numerics is not None:
            num_event = base_event("numerics", e._host_steps)
            num_event.update(numerics)
            self._emit(num_event)
        router = self._summarize_router(window)
        if router is not None:
            r_event = base_event("router", e._host_steps)
            r_event.update(router)
            self._emit(r_event)
        if self.memory_enabled:
            self._emit_memory_event(e._host_steps)
        self._maybe_flush()
        return event

    def _summarize_numerics(self, window):
        """Summarize (and strip) a drained window's raw health data —
        fetched numpy from the fence's single copy — into the
        `numerics` event fields; updates the flight recorder's sticky
        first-NaN context."""
        health = window.pop("health", None)
        if health is None:
            return None
        from deepspeed_tpu_torch.monitor import numerics as num_mod
        entries, acc = health
        summary = num_mod.summarize_window(
            entries, acc,
            grad_names=self._numerics_names["grad"],
            act_names=self._numerics_names["act"])
        if summary is None:
            return None
        self._last_numerics = summary
        if summary.get("first_nonfinite") and \
                self._first_nonfinite is None:
            # sticky FIRST occurrence: once a NaN poisons the params,
            # every later window blames layer 0 — the forensic answer
            # is the window where it first appeared
            e = self._engine_ref()
            self._first_nonfinite = dict(
                summary["first_nonfinite"],
                step=e._host_steps if e else None)
        if self.flight is not None:
            ctx = {"numerics": summary}
            if self._first_nonfinite is not None:
                ctx["first_nonfinite"] = self._first_nonfinite
            self.flight.set_context(**ctx)
        return summary

    def _summarize_router(self, window):
        """The fence's `router` event fields from the drained window's
        MEAN MoE router-stats vector ([E+2] layout — per-expert load
        fractions, drop fraction, aux loss; moe/router.py).
        Returns None (and emits nothing) when the window carried no
        router stats — dense engines never see this event."""
        router = window.pop("router", None)
        if router is None:
            return None
        vec, steps = router
        loads = [round(float(v), 6) for v in vec[:-2]]
        summary = {
            "num_experts": len(loads),
            "expert_load": loads,
            "load_max": round(max(loads), 6) if loads else None,
            "drop_fraction": round(float(vec[-2]), 6),
            "aux_loss": round(float(vec[-1]), 6),
            "window_steps": int(steps),
        }
        self._last_router = summary
        return summary

    # ------------------------------------------------------------------
    # events / sinks
    # ------------------------------------------------------------------
    def _emit(self, event):
        if self.flight is not None:
            # the ring retains what the sinks saw — the dump IS the
            # tail of the event stream
            self.flight.record(event)
        for sink in self.sinks:
            try:
                sink.emit(event)
            except Exception:
                # telemetry must never kill training, but a sink that
                # silently drops every event blinds the run — warn
                # once per sink, with the traceback (duck-typed user
                # sinks may lack .name)
                name = getattr(sink, "name", type(sink).__name__)
                if name not in self._sink_emit_warned:
                    self._sink_emit_warned.add(name)
                    logger.warning(
                        f"monitor sink {name!r} emit failed "
                        "(suppressing further warnings for this sink)",
                        exc_info=True)

    def _emit_kind(self, kind, fields):
        """Thread-safe host-event hook (checkpoint writer, watchdog)."""
        if not self.enabled:
            return
        e = self._engine_ref()
        event = base_event(kind, e._host_steps if e else 0)
        event.update(fields)
        self._emit(event)
        if kind == "ckpt_commit" and self.trace_export is not None:
            # the commit just finished ON the writer thread: a slice of
            # wall_ms ending now on the ckpt-writer track
            wall = float(fields.get("wall_ms") or 0.0) / 1e3
            self.trace_export.complete(
                "ckpt_writer", f"commit {fields.get('tag', '')}",
                time.perf_counter() - wall, wall, cat=CAT_SUBSYSTEM,
                args={"tag": fields.get("tag")})
        if kind in ("stall", "stall_escalated"):
            # the forensic moment: freeze the evidence while the run is
            # still (maybe) wedged — flight dump + trace export. An
            # escalation is terminal for the episode: its dump carries
            # the consecutive-fire diagnostic a recovery post-mortem
            # starts from.
            if self.flight is not None:
                try:
                    self.flight.dump(kind, extra=fields)
                except Exception:
                    logger.warning(f"flight dump on {kind!r} failed",
                                   exc_info=True)
            self._export_trace_safe()

    def event(self, kind, **fields):
        self._emit_kind(kind, fields)

    def on_crash(self, exc):
        """Uncaught exception out of the step loop: record it and dump
        the flight ring + trace before the exception propagates. A
        RESOURCE_EXHAUSTED / out-of-memory failure is classified and
        dumped as reason "oom" with the memory ledger, the top
        buffers, and actionable hints attached — the attribution dies
        with the process otherwise."""
        if not self.enabled:
            return
        extra = {"error": repr(exc)}
        reason = "exception"
        serving = self._serving_ref() if self._serving_ref else None
        if serving is not None:
            try:
                # the in-flight request table: an OOM/crash dump names
                # exactly which requests were being served
                extra["serving"] = serving.snapshot()
            except Exception:  # ds-lint: allow[BROADEXC] crash forensics must not mask the original exception mid-propagation
                serving = None
        if self.memory_enabled and memory_mod.classify_oom(exc):
            reason = "oom"
            try:
                # allocator stats are a host-side read — the failed
                # allocation left the device responsive; still guarded
                # because a post-mortem must never raise
                payload = self._reconcile_memory(
                    self._flight_step() or 0)
            except Exception:  # ds-lint: allow[BROADEXC] an OOM post-mortem must never raise while handling the original failure
                payload = self._last_memory or \
                    self.ledger.reconcile(None, None)
            hints = memory_mod.oom_hints(payload)
            if serving is not None:
                try:
                    from deepspeed_tpu_torch.monitor.serving import \
                        serving_oom_hints
                    # serving-aware ranking FIRST: on a serving engine
                    # the kv_cache / max_slots / prefill_chunk knobs
                    # are the ones the operator can actually turn
                    hints = serving_oom_hints(
                        payload, extra.get("serving")) + hints
                except Exception:  # ds-lint: allow[BROADEXC] an OOM post-mortem must never raise while handling the original failure
                    pass
            extra["oom"] = {
                "hbm": payload.get("hbm"),
                "host": payload.get("host"),
                "peak": payload.get("peak"),
                "top_buffers": payload.get("top_buffers"),
                "hints": hints,
            }
        if self.flight is not None:
            try:
                self.flight.record_exception(exc)
                self.flight.dump(reason, extra=extra)
            except Exception:  # ds-lint: allow[BROADEXC] crash forensics must not mask the original exception mid-propagation
                pass
        self._export_trace_safe()

    # ------------------------------------------------------------------
    # trace export
    # ------------------------------------------------------------------
    def trace_path(self):
        rank = get_rank()
        if self.config.trace_path:
            # explicit path: rank 0 gets it verbatim; other ranks get a
            # rank-suffixed sibling — every rank writing the SAME file
            # would clobber the shards ds_trace merge needs
            if rank == 0:
                return self.config.trace_path
            stem, ext = os.path.splitext(self.config.trace_path)
            return f"{stem}_rank{rank}{ext or '.json'}"
        return os.path.join(
            getattr(self, "_out_dir", _MONITOR_OUTPUT_DEFAULT),
            f"trace_rank{rank}.json")

    def export_trace(self, path=None):
        """Write the Perfetto trace file (atomic) and return its path;
        None when trace export is off."""
        if self.trace_export is None:
            return None
        return self.trace_export.write(path or self.trace_path())

    def _export_trace_safe(self):
        try:
            self.export_trace()
        except Exception:
            # trace export rides failure paths (stall, crash, close);
            # it must not raise there — but leave the evidence
            logger.warning("trace export failed", exc_info=True)

    def _maybe_flush(self):
        now = time.monotonic()
        if now - self._last_flush_t >= self.config.flush_interval:
            self._last_flush_t = now
            for sink in self.sinks:
                try:
                    sink.flush()
                except Exception:  # ds-lint: allow[BROADEXC] flush is advisory visibility; real sink failures surface at emit (warn-once)
                    pass

    # ------------------------------------------------------------------
    # snapshot API (the JAX package's bench.py shares this schema)
    # ------------------------------------------------------------------
    SNAPSHOT_KEYS = (
        "schema", "enabled", "step", "micro_steps", "loss", "grad_norm",
        "loss_scale", "lr", "overflow_count", "tokens",
        "samples_per_sec", "tokens_per_sec_per_chip", "mfu",
        "memory", "wire", "checkpoint", "prefetch", "numerics",
        "router", "memory_ledger",
    )

    def snapshot(self):
        """In-process telemetry snapshot with a STABLE key set across
        engine modes (bf16 / fp16 / ZeRO-2 / offload) — unknown values
        are None, never missing keys. This is a user-initiated sync
        point (it drains the device accumulator)."""
        e = self._engine_ref()
        window = self.registry.drain_device()
        if window is not None:
            self._summarize_numerics(window)
            self._summarize_router(window)
            self._last = window
            self._cum["steps"] += window["steps"]
            self._cum["overflow_count"] += window["overflow_count"]
            self._cum["tokens"] += window["tokens"]
            # snapshot consumed the token window: the next fence's
            # tokens_per_sec must measure from here, not from the
            # pre-snapshot fence
            self._last_fence_t = time.perf_counter()
        last = self._last
        counters = self.registry.counters()
        gauges = self.registry.sample_gauges()
        snap = {
            "schema": SCHEMA_VERSION,
            "enabled": self.enabled,
            "step": e._host_steps if e else None,
            "micro_steps": e.micro_steps if e else None,
            "loss": last.get("loss"),
            "grad_norm": last.get("grad_norm"),
            "loss_scale": last.get("loss_scale"),
            "lr": e._current_lr() if e else None,
            "overflow_count": self._cum["overflow_count"],
            "tokens": self._cum["tokens"],
            "samples_per_sec":
                round(e.tput_timer.avg_samples_per_sec(block=False), 3)
                if e else None,
            **self._throughput_derived(),
            "memory": {
                k.split("/", 1)[1]: v for k, v in gauges.items()
                if k.startswith("memory/")},
            "wire": self._wire_dict(counters),
            "checkpoint": self._checkpoint_dict(counters, gauges),
            "prefetch": {
                "occupancy": gauges.get("prefetch/occupancy"),
                "depth": gauges.get("prefetch/depth"),
            },
            "numerics": self._last_numerics,
            "router": self._last_router,
            "memory_ledger": self._reconcile_memory(
                e._host_steps if e else 0)
            if self.memory_enabled else None,
        }
        return snap

    # ------------------------------------------------------------------
    def close(self):
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        if self.flight is not None:
            # clean shutdown: no atexit dump for this engine
            self.flight.disarm()
        self._export_trace_safe()
        for sink in self.sinks:
            try:
                sink.flush()
                sink.close()
            except Exception:
                logger.warning(
                    f"monitor sink "
                    f"{getattr(sink, 'name', type(sink).__name__)!r} "
                    "close failed", exc_info=True)
        self.sinks = []
