"""`monitor` config block parsing.

    {"monitor": {"enabled": true,
                 "sinks": ["jsonl", {"type": "tensorboard"}],
                 "output_path": "runs/exp1/monitor",
                 "job_name": "",
                 "flush_interval": 0,
                 "stall_timeout_sec": 0,
                 "stall_probe": false,
                 "all_ranks": false}}

enabled: master switch; off (the default) makes every monitor hook a
  single attribute check.
sinks: list of sink names or {"type": name, ...opts} dicts
  (monitor/sinks.py). Default ["jsonl"].
output_path: directory sinks write under (default "./ds_monitor").
flush_interval: seconds between sink flushes (0 = flush every fence).
  A flush makes buffered records VISIBLE to readers; it never fsyncs —
  crash durability is paid once, at close() (a per-fence fsync costs
  more than the fenced training window on some filesystems).
stall_timeout_sec: fire the stall watchdog when no sync fence advances
  for this long (0 = watchdog off).
stall_probe: on a stall, also time a CUDA event recorded on the
  training stream, waited on by a sacrificial thread, to tell a wedged
  device from a stalled host.
stall_escalate_after: consecutive watchdog fires (one per further
  stall_timeout_sec of silence) before ONE terminal `stall_escalated`
  event is emitted — flight dump + sink event — and the episode goes
  quiet (0 = off; the elastic supervisor consumes the verdict).
all_ranks: emit events from every process (default: rank 0 only, with
  a per-rank filename suffix when enabled).
peak_flops_override: MFU denominator in FLOP/s per card (0 = auto:
  the nominal dense bf16 peak of a known CUDA card, None on the CPU).
  Makes MFU and tokens_per_sec_per_chip meaningful on CPU runs.
trace: {"enabled", "path", "max_events"} — Perfetto/Chrome
  trace-event export (monitor/trace_export.py): fence-aligned spans +
  the per-microbatch pipeline timeline, written at close()/watchdog
  fire/export_trace(), merged across ranks by `ds_trace merge`.
flight: {"enabled" (default true), "capacity", "path"} — crash/stall
  flight recorder (monitor/flight.py): the last N events + heartbeat
  ages, dumped atomically on watchdog fire / uncaught train_batch
  exception / SIGTERM / abnormal exit.
numerics: {"enabled"} — device-side per-layer numerics health
  (monitor/numerics.py): per-group grad stats (+ per-layer activation
  stats for layer-exposing models) computed inside the step on the
  device, drained at the same fences.
memory: {"enabled" (default true), "top_buffers"} — live HBM/host
  byte ledger (monitor/memory.py): per-subsystem allocation
  attribution reconciled against the allocator at every fence, peak
  watermark with at-peak attribution, Perfetto per-category counter
  tracks, and OOM forensics on out-of-memory crashes.
"""

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param


class MonitorConfigError(Exception):
    pass


class DeepSpeedMonitorConfig:
    def __init__(self, param_dict):
        block = param_dict.get(C.MONITOR, {})
        if not isinstance(block, dict):
            raise MonitorConfigError(
                f'"monitor" must be a dict, got {block!r}')
        self.enabled = bool(get_scalar_param(
            block, C.MONITOR_ENABLED, C.MONITOR_ENABLED_DEFAULT))
        self.sinks = block.get(C.MONITOR_SINKS,
                               list(C.MONITOR_SINKS_DEFAULT))
        if not isinstance(self.sinks, (list, tuple)):
            raise MonitorConfigError(
                f"monitor.sinks must be a list, got {self.sinks!r}")
        from deepspeed_tpu_torch.monitor.sinks import VALID_SINKS
        for spec in self.sinks:
            name = spec if isinstance(spec, str) else \
                (spec or {}).get("type")
            if name not in VALID_SINKS:
                raise MonitorConfigError(
                    f"unknown monitor sink {name!r}; valid: "
                    f"{list(VALID_SINKS)}")
        self.output_path = get_scalar_param(
            block, C.MONITOR_OUTPUT_PATH, C.MONITOR_OUTPUT_PATH_DEFAULT)
        self.job_name = get_scalar_param(
            block, C.MONITOR_JOB_NAME, C.MONITOR_JOB_NAME_DEFAULT)
        self.flush_interval = float(get_scalar_param(
            block, C.MONITOR_FLUSH_INTERVAL,
            C.MONITOR_FLUSH_INTERVAL_DEFAULT))
        if self.flush_interval < 0:
            raise MonitorConfigError(
                "monitor.flush_interval must be >= 0 "
                f"(0 = flush every fence), got {self.flush_interval}")
        self.stall_timeout_sec = float(get_scalar_param(
            block, C.MONITOR_STALL_TIMEOUT_SEC,
            C.MONITOR_STALL_TIMEOUT_SEC_DEFAULT))
        if self.stall_timeout_sec < 0:
            raise MonitorConfigError(
                "monitor.stall_timeout_sec must be >= 0 (0 = off), "
                f"got {self.stall_timeout_sec}")
        self.stall_probe = bool(get_scalar_param(
            block, C.MONITOR_STALL_PROBE, C.MONITOR_STALL_PROBE_DEFAULT))
        self.stall_escalate_after = int(get_scalar_param(
            block, C.MONITOR_STALL_ESCALATE_AFTER,
            C.MONITOR_STALL_ESCALATE_AFTER_DEFAULT))
        if self.stall_escalate_after < 0:
            raise MonitorConfigError(
                "monitor.stall_escalate_after must be >= 0 (0 = off), "
                f"got {self.stall_escalate_after}")
        self.all_ranks = bool(get_scalar_param(
            block, C.MONITOR_ALL_RANKS, C.MONITOR_ALL_RANKS_DEFAULT))
        self.peak_flops_override = float(get_scalar_param(
            block, C.MONITOR_PEAK_FLOPS_OVERRIDE,
            C.MONITOR_PEAK_FLOPS_OVERRIDE_DEFAULT))
        if self.peak_flops_override < 0:
            raise MonitorConfigError(
                "monitor.peak_flops_override must be >= 0 (0 = auto), "
                f"got {self.peak_flops_override}")

        trace = block.get(C.MONITOR_TRACE, {})
        if not isinstance(trace, dict):
            raise MonitorConfigError(
                f'"monitor.trace" must be a dict, got {trace!r}')
        self.trace_enabled = bool(get_scalar_param(
            trace, C.MONITOR_TRACE_ENABLED,
            C.MONITOR_TRACE_ENABLED_DEFAULT))
        self.trace_path = get_scalar_param(
            trace, C.MONITOR_TRACE_PATH, C.MONITOR_TRACE_PATH_DEFAULT)
        self.trace_max_events = int(get_scalar_param(
            trace, C.MONITOR_TRACE_MAX_EVENTS,
            C.MONITOR_TRACE_MAX_EVENTS_DEFAULT))
        if self.trace_max_events <= 0:
            raise MonitorConfigError(
                "monitor.trace.max_events must be > 0, got "
                f"{self.trace_max_events}")

        flight = block.get(C.MONITOR_FLIGHT, {})
        if not isinstance(flight, dict):
            raise MonitorConfigError(
                f'"monitor.flight" must be a dict, got {flight!r}')
        self.flight_enabled = bool(get_scalar_param(
            flight, C.MONITOR_FLIGHT_ENABLED,
            C.MONITOR_FLIGHT_ENABLED_DEFAULT))
        self.flight_capacity = int(get_scalar_param(
            flight, C.MONITOR_FLIGHT_CAPACITY,
            C.MONITOR_FLIGHT_CAPACITY_DEFAULT))
        if self.flight_capacity <= 0:
            raise MonitorConfigError(
                "monitor.flight.capacity must be > 0, got "
                f"{self.flight_capacity}")
        self.flight_path = get_scalar_param(
            flight, C.MONITOR_FLIGHT_PATH, C.MONITOR_FLIGHT_PATH_DEFAULT)

        numerics = block.get(C.MONITOR_NUMERICS, {})
        if not isinstance(numerics, dict):
            raise MonitorConfigError(
                f'"monitor.numerics" must be a dict, got {numerics!r}')
        self.numerics_enabled = bool(get_scalar_param(
            numerics, C.MONITOR_NUMERICS_ENABLED,
            C.MONITOR_NUMERICS_ENABLED_DEFAULT))

        memory = block.get(C.MONITOR_MEMORY, {})
        if not isinstance(memory, dict):
            raise MonitorConfigError(
                f'"monitor.memory" must be a dict, got {memory!r}')
        self.memory_enabled = bool(get_scalar_param(
            memory, C.MONITOR_MEMORY_ENABLED,
            C.MONITOR_MEMORY_ENABLED_DEFAULT))
        self.memory_top_buffers = int(get_scalar_param(
            memory, C.MONITOR_MEMORY_TOP_BUFFERS,
            C.MONITOR_MEMORY_TOP_BUFFERS_DEFAULT))
        if self.memory_top_buffers < 0:
            raise MonitorConfigError(
                "monitor.memory.top_buffers must be >= 0, got "
                f"{self.memory_top_buffers}")
