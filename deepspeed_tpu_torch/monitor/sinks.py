"""Pluggable telemetry sinks.

Every sink consumes flat JSON-able event dicts produced by the Monitor
at sync fences (kind="metrics") and from host-side subsystems
(kind="ckpt_commit" / "stall" / ...). Sinks must be thread-safe: the
checkpoint writer thread and the stall watchdog emit from off the main
thread.

  * JsonlSink — schema-versioned newline-delimited JSON, one os.write
    per event on an O_APPEND fd (atomic append: concurrent writers
    interleave whole lines, never bytes).
  * TensorBoardSink — the native tfevents writer (monitor/tfevents.py);
    numeric fields of metric events become scalars under `monitor/...`.

Events carry `"v": SCHEMA_VERSION` so log consumers can gate parsing;
bump the version when a field changes meaning (adding fields is not a
version bump).
"""

import json
import os
import threading
import time

from deepspeed_tpu_torch.utils.logging import logger

SCHEMA_VERSION = 1

JSONL_SINK = "jsonl"
TENSORBOARD_SINK = "tensorboard"
VALID_SINKS = (JSONL_SINK, TENSORBOARD_SINK)


class Sink:
    name = "base"

    def emit(self, event):
        raise NotImplementedError

    def flush(self):
        pass

    def close(self):
        pass


class JsonlSink(Sink):
    """Newline-delimited JSON event log with atomic appends."""

    name = JSONL_SINK

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        self._lock = threading.Lock()

    def emit(self, event):
        line = json.dumps(event, separators=(",", ":"),
                          default=_json_default) + "\n"
        with self._lock:
            os.write(self._fd, line.encode("utf-8"))

    def flush(self):
        # os.write on the O_APPEND fd is already visible to readers;
        # fsync (crash durability) is deliberately reserved for sync()
        # and close() — an fsync per fence costs more than the fenced
        # training window on some filesystems
        pass

    def sync(self):
        with self._lock:
            try:
                # ds-lint: allow[LOCKBLOCK] durability point (close/escalation only, never per-fence); the lock orders it against concurrent emit writers
                os.fsync(self._fd)
            except OSError:
                pass

    def close(self):
        self.sync()
        with self._lock:
            if self._fd >= 0:
                try:
                    os.close(self._fd)
                finally:
                    self._fd = -1


def _json_default(x):
    # numpy / torch scalars that slip into an event
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def _flatten_numeric(event, prefix="", out=None):
    out = {} if out is None else out
    for k, v in event.items():
        # event metadata, not scalars — but only at the TOP level: a
        # nested field may legitimately be named "step" (the span) etc.
        if not prefix and k in ("v", "ts", "step", "kind"):
            continue
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten_numeric(v, prefix=f"{key}/", out=out)
        elif isinstance(v, bool):
            out[key] = float(v)
        elif isinstance(v, (int, float)):
            out[key] = float(v)
    return out


class TensorBoardSink(Sink):
    """Scalars for the TensorBoard dashboard via the native tfevents
    writer (monitor/tfevents.py) — no tensorboard package needed."""

    name = TENSORBOARD_SINK

    def __init__(self, log_dir):
        from deepspeed_tpu_torch.monitor.tfevents import TFEventsWriter
        self.log_dir = log_dir
        self._writer = TFEventsWriter(log_dir)

    def emit(self, event):
        kind = event.get("kind", "event")
        scalars = {f"monitor/{kind}/{k}": v
                   for k, v in _flatten_numeric(event).items()}
        if scalars:
            self._writer.add_scalars(scalars, event.get("step", 0),
                                     wall_time=event.get("ts"))

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


def build_sinks(sink_specs, output_dir, job_name=""):
    """Instantiate sinks from the config's `monitor.sinks` list. Each
    spec is a name ("jsonl" / "tensorboard") or a dict
    {"type": name, ...opts}. A sink that fails to construct is skipped
    with a warning — telemetry must never kill training."""
    sinks = []
    base = os.path.join(output_dir, job_name) if job_name else output_dir
    for spec in sink_specs:
        if isinstance(spec, str):
            name, opts = spec, {}
        else:
            spec = dict(spec)
            name, opts = spec.pop("type"), spec
        try:
            if name == JSONL_SINK:
                path = opts.get("path") or os.path.join(base,
                                                        "events.jsonl")
                sinks.append(JsonlSink(path))
            elif name == TENSORBOARD_SINK:
                sinks.append(TensorBoardSink(
                    opts.get("log_dir") or os.path.join(base, "tb")))
            else:
                raise ValueError(
                    f"unknown monitor sink {name!r}; valid: "
                    f"{list(VALID_SINKS)}")
        except ValueError:
            raise
        except Exception:
            logger.warning(f"monitor sink {name!r} unavailable",
                           exc_info=True)
    return sinks


def base_event(kind, step):
    return {"v": SCHEMA_VERSION, "ts": round(time.time(), 6),
            "kind": kind, "step": int(step)}
