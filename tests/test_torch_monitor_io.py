"""PyTorch port: the monitor's host-side pieces against the JAX package's.

The monitor's config block, its sinks (JSONL lines, tfevents bytes and
their CRC32C), the Perfetto trace export and `ds_trace merge|summary`,
the flight recorder's ring and atomic dump, the stall watchdog, and the
OOM classification and hints: the same inputs through
`deepspeed_tpu.monitor` and `deepspeed_tpu_torch.monitor` give the same
values, messages, bytes and files. These are pure host code in both
packages: every comparison is exact.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's monitor imports it lazily)

from deepspeed_tpu.monitor import config as jcfg
from deepspeed_tpu.monitor import flight as jflight
from deepspeed_tpu.monitor import memory as jmem
from deepspeed_tpu.monitor import sinks as jsinks
from deepspeed_tpu.monitor import tfevents as jtfe
from deepspeed_tpu.monitor import trace_cli as jcli
from deepspeed_tpu.monitor import trace_export as jte
from deepspeed_tpu.monitor import watchdog as jwd
from deepspeed_tpu_torch.monitor import config as tcfg
from deepspeed_tpu_torch.monitor import flight as tflight
from deepspeed_tpu_torch.monitor import memory as tmem
from deepspeed_tpu_torch.monitor import sinks as tsinks
from deepspeed_tpu_torch.monitor import tfevents as ttfe
from deepspeed_tpu_torch.monitor import trace_cli as tcli
from deepspeed_tpu_torch.monitor import trace_export as tte
from deepspeed_tpu_torch.monitor import watchdog as twd


# ----------------------------------------------------------------------
# the config block
# ----------------------------------------------------------------------
MONITOR_BLOCKS = [
    {},
    {"monitor": {"enabled": True}},
    {"monitor": {"enabled": True, "sinks": ["jsonl", {"type": "tensorboard"}],
                 "output_path": "runs/x", "job_name": "j",
                 "flush_interval": 2.5, "stall_timeout_sec": 60,
                 "stall_probe": True, "stall_escalate_after": 3,
                 "all_ranks": True, "peak_flops_override": 1e12,
                 "trace": {"enabled": True, "path": "t.json",
                           "max_events": 10},
                 "flight": {"enabled": False, "capacity": 4, "path": "f"},
                 "numerics": {"enabled": True},
                 "memory": {"enabled": False, "top_buffers": 2}}},
    # invalid: each raises MonitorConfigError with the same message
    {"monitor": []},
    {"monitor": {"sinks": "jsonl"}},
    {"monitor": {"sinks": ["csv"]}},
    {"monitor": {"flush_interval": -1}},
    {"monitor": {"stall_timeout_sec": -2}},
    {"monitor": {"stall_escalate_after": -1}},
    {"monitor": {"peak_flops_override": -1.0}},
    {"monitor": {"trace": 1}},
    {"monitor": {"trace": {"max_events": 0}}},
    {"monitor": {"flight": []}},
    {"monitor": {"flight": {"capacity": 0}}},
    {"monitor": {"numerics": "on"}},
    {"monitor": {"memory": 1}},
    {"monitor": {"memory": {"top_buffers": -1}}},
]


@pytest.mark.parametrize("block", MONITOR_BLOCKS,
                         ids=[str(i) for i in range(len(MONITOR_BLOCKS))])
def test_config_block_resolves_like_jax(block):
    """Valid blocks resolve to the same attribute values; invalid ones
    raise MonitorConfigError with the same message."""
    try:
        ref = jcfg.DeepSpeedMonitorConfig(block)
    except jcfg.MonitorConfigError as e:
        with pytest.raises(tcfg.MonitorConfigError) as got:
            tcfg.DeepSpeedMonitorConfig(block)
        assert str(got.value) == str(e)
        return
    got = tcfg.DeepSpeedMonitorConfig(block)
    assert vars(got) == vars(ref)


# ----------------------------------------------------------------------
# sinks and tfevents
# ----------------------------------------------------------------------
EVENTS = [
    {"v": 1, "ts": 1700000000.25, "kind": "metrics", "step": 4,
     "loss": 2.5, "grad_norm": None, "loss_scale": 65536.0,
     "memory": {"in_use_bytes": 123, "device_count": 1},
     "spans": {"step": {"ms": 1.5, "count": 2, "ms_per": 0.75}},
     "value": np.float32(0.5), "flag": True},
    {"v": 1, "ts": 1700000001.0, "kind": "ckpt_commit", "step": 4,
     "tag": "t", "wall_ms": 12.25},
]


def test_jsonl_lines_equal_jax(tmp_path):
    paths = []
    for mod, name in ((jsinks, "jax"), (tsinks, "torch")):
        path = tmp_path / f"{name}.jsonl"
        sink = mod.JsonlSink(str(path))
        for e in EVENTS:
            sink.emit(e)
        sink.close()
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert tsinks.SCHEMA_VERSION == jsinks.SCHEMA_VERSION


@pytest.mark.parametrize("wall_time,step,scalars", [
    (1700000000.5, 0, {"loss": 2.5}),
    (1700000123.0, 17, {"a/b": -1.0, "lr": 3e-4, "big": 1e30}),
    (1.0, 2 ** 40, {}),
])
def test_tfevents_bytes_equal_jax(wall_time, step, scalars):
    assert ttfe.encode_scalar_event(wall_time, step, scalars) == \
        jtfe.encode_scalar_event(wall_time, step, scalars)
    assert ttfe.encode_file_version_event(wall_time) == \
        jtfe.encode_file_version_event(wall_time)
    data = ttfe.encode_scalar_event(wall_time, step, scalars)
    assert ttfe._record(data) == jtfe._record(data)


def _after_first_record(raw):
    """The bytes after a tfevents file's first record (the version
    record the writer stamps with its own clock at open)."""
    n = int.from_bytes(raw[:8], "little")
    return raw[8 + 4 + n + 4:]


def test_tfevents_files_equal_jax_and_read_back(tmp_path):
    """After the writer's own opening record, a file of the same
    records (a version record and scalar events) is the JAX writer's
    byte for byte; the reader checks every CRC."""
    files = []
    for mod, name in ((jtfe, "jax"), (ttfe, "torch")):
        w = mod.TFEventsWriter(str(tmp_path / name))
        w._write(mod._record(mod.encode_file_version_event(1.5)))
        for i in range(3):
            w.add_scalars({"loss": 1.0 / (i + 1), "step_ms": 10.0 * i},
                          step=i, wall_time=2.0 + i)
        w.close()
        (f,) = os.listdir(tmp_path / name)
        files.append(tmp_path / name / f)
    rest = [_after_first_record(f.read_bytes()) for f in files]
    assert rest[0] == rest[1] and len(rest[1]) > 0
    got = ttfe.read_tfevents(str(files[1]))
    want = jtfe.read_tfevents(str(files[0]))
    strip = [{k: v for k, v in r.items() if k != "wall_time"} for r in got]
    assert strip == [{k: v for k, v in r.items() if k != "wall_time"}
                     for r in want]
    raw = bytearray(files[1].read_bytes())
    raw[-1] ^= 0xFF
    files[1].write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        ttfe.read_tfevents(str(files[1]))


@pytest.mark.parametrize("data,crc", [
    (b"", 0x00000000),
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),
    (bytes([0xFF] * 32), 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
])
def test_crc32c_vectors(data, crc):
    """RFC 3720's CRC32C check values, in both packages."""
    assert ttfe.crc32c(data) == crc == jtfe.crc32c(data)
    assert ttfe.masked_crc32c(data) == jtfe.masked_crc32c(data)


def test_tensorboard_sink_scalars_equal_jax(tmp_path):
    """The tensorboard sink flattens an event to the same tags."""
    got = tsinks._flatten_numeric(EVENTS[0])
    assert got == jsinks._flatten_numeric(EVENTS[0])
    assert "spans/step/ms" in got and "grad_norm" not in got


# ----------------------------------------------------------------------
# trace export and ds_trace
# ----------------------------------------------------------------------
def _exporter(mod, rank):
    ex = mod.TraceExporter(rank=rank, meta={"job_name": "j"})
    ex._epoch = 1.7e9          # one clock anchor for both packages
    for i in range(4):
        ex.complete("host/forward", "forward", 10.0 + i, 0.25)
        ex.complete("host/step", "step", 10.25 + i, 0.5)
        ex.counter("fences", "metrics", {"loss": 3.0 - i / 4},
                   t_at=10.75 + i)
        ex.instant("fences", f"fence step {i}", t_at=10.75 + i,
                   args={"window_steps": 1})
    ex.complete("ckpt_writer", "commit t", 12.0, 1.0,
                cat=mod.CAT_SUBSYSTEM, args={"tag": "t"})
    ex.counter("memory", "hbm_bytes", {"params": 1024, "residual": 64},
               t_at=11.0)
    ex.instant("serve/slot0", "finished r0", t_at=13.0,
               cat=mod.CAT_SERVE_REQUEST,
               args={"request_id": "r0", "reason": "max_tokens",
                     "prompt_tokens": 8, "new_tokens": 4,
                     "queued_ms": 1.0, "ttft_ms": 5.0, "token_ms": 2.0,
                     "prefill_ms": 3.0, "decode_ms": 8.0, "wall_ms": 11.0,
                     "slo_ok": True})
    ex.set_meta(memory_plan={"params": 1000})
    return ex


def test_trace_export_and_ds_trace_equal_jax(tmp_path, capsys):
    docs = {}
    for mod, name in ((jte, "jax"), (tte, "torch")):
        for rank in (0, 1):
            path = tmp_path / f"{name}_rank{rank}.json"
            _exporter(mod, rank).write(str(path))
            docs[name, rank] = json.loads(path.read_text())
    for rank in (0, 1):
        assert docs["torch", rank] == docs["jax", rank]
    merged = tte.merge_traces([docs["torch", 0], docs["torch", 1]])
    assert merged == jte.merge_traces([docs["jax", 0], docs["jax", 1]])
    assert tte.summarize_trace(merged) == jte.summarize_trace(merged)
    outs = []
    for cli, name in ((jcli, "jax"), (tcli, "torch")):
        out = tmp_path / f"{name}_merged.json"
        assert cli.main(["merge", str(tmp_path / f"{name}_rank0.json"),
                         str(tmp_path / f"{name}_rank1.json"),
                         "-o", str(out)]) in (0, None)
        capsys.readouterr()
        assert cli.main(["summary", str(out)]) in (0, None)
        summary = capsys.readouterr().out
        assert cli.main(["summary", "--serving", str(out)]) in (0, None)
        outs.append((out.read_bytes(), summary,
                     capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert "host/forward" in outs[1][1]


# ----------------------------------------------------------------------
# the flight recorder
# ----------------------------------------------------------------------
def test_flight_ring_and_atomic_dump_equal_jax(tmp_path):
    """A capacity-4 ring keeps the last 4 events; the dump is one JSON
    file (no temporary left behind) whose keys and ring equal the JAX
    recorder's for the same events and context."""
    dumps = []
    for mod, name in ((jflight, "jax"), (tflight, "torch")):
        rec = mod.FlightRecorder(
            out_dir=str(tmp_path / name), capacity=4, rank=0,
            step_fn=lambda: 7,
            heartbeats_fn=lambda: ({"prefetch": 0.5}, ["checkpoint"]))
        for i in range(6):
            rec.record({"kind": "metrics", "step": i})
        rec.set_context(numerics={"window_steps": 2})
        try:
            raise ValueError("boom")
        except ValueError as e:
            rec.record_exception(e)
        path = rec.dump("exception", extra={"error": "ValueError('boom')"})
        assert os.listdir(tmp_path / name) == [os.path.basename(path)]
        assert mod.list_flight_dumps(str(tmp_path / name)) == [path]
        rec.disarm()
        dumps.append(json.loads(open(path).read()))
    ref, got = dumps
    assert sorted(got) == sorted(ref)
    assert [e.get("step") for e in got["events"]] == \
        [e.get("step") for e in ref["events"]]
    assert [{k: v for k, v in e.items() if k != "ts"}
            for e in got["events"]] == \
        [{k: v for k, v in e.items() if k != "ts"} for e in ref["events"]]
    assert got["reason"] == "exception" and got["step"] == 7
    assert got["heartbeat_age_sec"] == ref["heartbeat_age_sec"]


# ----------------------------------------------------------------------
# the stall watchdog
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stall", [True, False], ids=["stall", "healthy"])
def test_watchdog_fires_only_on_a_stall(stall):
    """Armed with a 0.5 s timeout: a run that keeps fencing never fires;
    one that stops fencing fires once for the episode, in both
    packages, with the same diagnostic keys."""
    fired = {}
    dogs = {}
    for mod, name in ((jwd, "jax"), (twd, "torch")):
        fired[name] = []
        dogs[name] = mod.StallWatchdog(
            0.5, poll_interval=0.02,
            emit=lambda kind, d, _n=name: fired[_n].append((kind, d)))
        dogs[name].arm()
        dogs[name].heartbeat("prefetch")
    deadline = time.monotonic() + (4.0 if stall else 1.5)
    while time.monotonic() < deadline:
        if stall:
            if all(fired.values()):
                time.sleep(0.3)       # the episode fires once only
                break
        else:
            for d in dogs.values():
                d.notify_fence()
        time.sleep(0.05)
    for d in dogs.values():
        d.stop()
    for name in ("jax", "torch"):
        if stall:
            assert [k for k, _ in fired[name]] == ["stall"], name
        else:
            assert fired[name] == [], name
    if stall:
        assert sorted(fired["torch"][0][1]) == sorted(fired["jax"][0][1])
        assert dogs["torch"].stall_count == 1


def test_watchdog_escalates_once_and_probes_without_a_card():
    """escalate_after=2: two consecutive fires, then one terminal
    `stall_escalated`; the probe without a card stream returns."""
    kinds = []
    dog = twd.StallWatchdog(0.2, poll_interval=0.02, probe=True,
                            escalate_after=2,
                            emit=lambda kind, d: kinds.append(kind))
    dog.arm()
    deadline = time.monotonic() + 5.0
    while "stall_escalated" not in kinds and time.monotonic() < deadline:
        time.sleep(0.05)
    time.sleep(0.3)
    dog.stop()
    assert kinds[:3] == ["stall", "stall", "stall_escalated"]
    assert kinds.count("stall_escalated") == 1
    assert dog.escalation_count == 1


# ----------------------------------------------------------------------
# OOM classification and hints
# ----------------------------------------------------------------------
OOM_ERRORS = [
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                 "allocate 1.2GiB"),
    RuntimeError("XlaRuntimeError: RESOURCE EXHAUSTED"),
    MemoryError(),
    RuntimeError("Failed to allocate request for 4.0GiB"),
    RuntimeError("allocation failure in the pool"),
    RuntimeError("the run hit an OOM"),
    RuntimeError("zoom and bloom in the room"),
    ValueError("shape mismatch"),
]


@pytest.mark.parametrize("exc", OOM_ERRORS,
                         ids=[str(i) for i in range(len(OOM_ERRORS))])
def test_classify_oom_on_jax_strings(exc):
    assert tmem.classify_oom(exc) == jmem.classify_oom(exc)


def test_classify_oom_knows_torch_out_of_memory():
    """torch.OutOfMemoryError is an OOM by type, whatever its message."""
    assert tmem.classify_oom(torch.OutOfMemoryError("CUDA out of memory."))
    assert tmem.classify_oom(torch.OutOfMemoryError("no message marker"))


GIB = 2 ** 30
PAYLOADS = [
    {"hbm": {"categories": {"params": 1 * GIB}, "ledger_bytes": 1 * GIB,
             "measured_in_use_per_device": 10 * GIB,
             "residual_bytes": 9 * GIB}},
    {"hbm": {"categories": {"params": 1 * GIB, "master": 4 * GIB,
                            "opt_state": 8 * GIB, "ckpt_snapshot": GIB,
                            "prefetch": 2 * GIB},
             "ledger_bytes": 16 * GIB,
             "measured_in_use_per_device": 17 * GIB,
             "residual_bytes": GIB}},
    {"hbm": {"categories": {"kv_cache": 6 * GIB, "params": 3 * GIB,
                            "moe_dispatch": 2 * GIB,
                            "overlap_inflight": 2 * GIB},
             "ledger_bytes": 13 * GIB,
             "measured_in_use_per_device": 14 * GIB,
             "residual_bytes": GIB}},
    {"hbm": {"categories": {"params": GIB}, "ledger_bytes": GIB,
             "measured_in_use_per_device": None, "residual_bytes": None}},
]


@pytest.mark.parametrize("payload", PAYLOADS,
                         ids=[str(i) for i in range(len(PAYLOADS))])
def test_oom_hints_equal_jax(payload):
    """The same hints in the same order; the port says "temporaries"
    where the JAX package says "XLA temporaries"."""
    want = [h.replace("activations/XLA temporaries",
                      "activations/temporaries")
            for h in jmem.oom_hints(payload)]
    assert tmem.oom_hints(payload) == want


def test_ledger_reconcile_and_plan_equal_jax():
    """The same registrations reconcile to the same payload (tensors on
    the port's side, numpy arrays on the JAX side)."""
    stats = {"in_use_bytes": 10000, "peak_bytes": 12000, "device_count": 1,
             "host_rss_bytes": 5 * GIB}
    payloads = []
    for mod, arr in ((jmem, lambda s, d: np.zeros(s, d)),
                     (tmem, lambda s, d: torch.zeros(s, dtype=getattr(
                         torch, d)))):
        led = mod.MemoryLedger()
        led.register_tree(mod.CAT_PARAMS, "p", {"a": arr((4, 8), "float32"),
                                                 "b": arr((16,), "float16")})
        led.register(mod.CAT_HOST_MASTER, "h", 4096, space=mod.SPACE_HOST)
        led.register_dynamic(mod.CAT_PREFETCH, "pf", lambda: 256)
        tok = led.register(mod.CAT_CKPT, "snap", 1000)
        led.set_plan({"params": 100, "opt_state": 50})
        first = led.reconcile(stats, step=1)
        led.release(tok)
        payloads.append((first, led.reconcile(dict(stats, peak_bytes=9),
                                              step=2)))
    assert payloads[1] == payloads[0]
    assert payloads[1][1]["hbm"]["categories"] == {"params": 160,
                                                   "prefetch": 256}
    assert payloads[1][1]["peak"]["step"] == 1
