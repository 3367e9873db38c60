"""`ds_trace` — merge and summarize Perfetto trace shards.

    ds_trace merge runA/trace_rank*.json -o merged.json
    ds_trace summary runA/trace_rank0.json [more.json ...]

(`python -m deepspeed_tpu_torch.monitor.trace_cli ...` until the port
ships its `bin/ds_trace` launcher.)

`merge` concatenates per-rank shards (events are rank-tagged by `pid`
and anchored on the unix clock, so concatenation + sort IS the merge)
into one file Perfetto opens as a multi-rank timeline. `summary`
prints per-track busy/occupancy and — when pipeline events are present
— the measured bubble fraction next to the schedule's analytic
(p-1)/(v·m+p-1), the number the interleaved-1F1B work exists to move.
When the trace carries the memory ledger's counter tracks it also
prints per-category last/peak bytes and — when a memory plan rode in
the trace metadata — the per-component plan-vs-measured deltas.

`summary --serving` restricts the output to the serving view: the
per-request p50/p99 queue-wait / TTFT / per-token decode latency and
goodput-vs-throughput, recomputed from the `serving_request` finish
instants the ServingTracker stamps (monitor/serving.py).
"""

import argparse
import json
import sys

from deepspeed_tpu_torch.monitor.trace_export import (load_trace,
                                                merge_traces,
                                                summarize_trace)


def _cmd_merge(args):
    docs = [load_trace(p) for p in args.paths]
    merged = merge_traces(docs)
    out = args.output or "trace_merged.json"
    with open(out, "w") as f:
        json.dump(merged, f, separators=(",", ":"))
    print(f"merged {len(docs)} shard(s), "
          f"{len(merged['traceEvents'])} events -> {out}")
    _print_summary(merged)
    return 0


def _cmd_summary(args):
    docs = [load_trace(p) for p in args.paths]
    doc = docs[0] if len(docs) == 1 else merge_traces(docs)
    if getattr(args, "serving", False):
        s = summarize_trace(doc)
        serving = s.get("serving")
        if not serving:
            print("no serving events in trace (run with a monitor "
                  "block + inference.observability enabled)")
            return 1
        _print_serving(serving)
        return 0
    _print_summary(doc)
    return 0


def _print_summary(doc):
    s = summarize_trace(doc)
    tracks = s.get("tracks", {})
    if tracks:
        width = max(len(n) for n in tracks)
        print(f"{'track'.ljust(width)}  events     busy_ms  occupancy")
        for name, tr in tracks.items():
            print(f"{name.ljust(width)}  {tr['events']:6d}  "
                  f"{tr['busy_ms']:10.3f}  {tr['occupancy']:9.4f}")
    pipe = s.get("pipeline")
    if pipe:
        print("pipeline:")
        print(f"  stages={pipe['stages']} "
              f"dispatch_windows={pipe['dispatch_windows']} "
              f"occupancy={pipe['occupancy']}")
        line = f"  bubble_fraction={pipe['bubble_fraction']}"
        if pipe.get("analytic_bubble_fraction") is not None:
            line += (" (schedule analytic "
                     f"{pipe['analytic_bubble_fraction']})")
        print(line)
        sched = pipe.get("schedule")
        if sched:
            print(f"  schedule: p={sched.get('stages')} "
                  f"m={sched.get('micro_batches')} "
                  f"v={sched.get('num_virtual_stages')} "
                  f"ticks={sched.get('ticks')}")
    mem = s.get("memory")
    if mem:
        _print_memory(mem)
    serving = s.get("serving")
    if serving:
        _print_serving(serving)
    if not tracks and not pipe and not mem and not serving:
        print("no complete events in trace")


def _fmt_gib(b):
    return f"{b / 2**30:.3f}"


def _print_memory(mem):
    """The memory ledger's counter tracks: final composition + peak
    per category, and plan-vs-measured deltas when a memory plan rode
    in the trace metadata."""
    for series in ("hbm_bytes", "host_bytes"):
        rows = mem.get(series)
        if not rows:
            continue
        print(f"memory ({series.split('_')[0]}):")
        width = max(len(k) for k in rows)
        print(f"  {'category'.ljust(width)}   last_gib   peak_gib")
        for name, r in rows.items():
            print(f"  {name.ljust(width)}  {_fmt_gib(r['last_bytes']):>9}"
                  f"  {_fmt_gib(r['peak_bytes']):>9}")
    pvm = mem.get("plan_vs_measured")
    if pvm:
        print("memory plan vs measured (per-device, peak):")
        width = max(len(k) for k in pvm)
        print(f"  {'component'.ljust(width)}  planned_gib  "
              "measured_gib  delta_pct")
        for comp, r in pvm.items():
            planned = "-" if r["planned_bytes"] is None else \
                _fmt_gib(r["planned_bytes"])
            got = "-" if r["measured_bytes"] is None else \
                _fmt_gib(r["measured_bytes"])
            delta = "-" if r["delta_pct"] is None else \
                f"{r['delta_pct']:+.2f}"
            print(f"  {comp.ljust(width)}  {planned:>11}  {got:>12}  "
                  f"{delta:>9}")


def _print_serving(s):
    """Per-request serving stats recomputed from the `serving_request`
    finish instants (fence-granularity host stamps — see
    monitor/serving.py)."""
    print("serving (per-request, fence granularity):")
    good = s.get("goodput_fraction")
    share = s.get("queue_wait_share")
    print(f"  requests={s['requests']} new_tokens={s['new_tokens']} "
          f"goodput_tokens={s['goodput_tokens']}"
          + ("" if good is None else f" goodput_fraction={good}")
          + ("" if share is None else f" queue_wait_share={share}"))
    print(f"  {'metric'.ljust(12)}  {'p50_ms':>9}  {'p99_ms':>9}")
    for label, key in (("queue_wait", "queued_ms"),
                       ("ttft", "ttft_ms"),
                       ("token", "token_ms")):
        row = s.get(key) or {}

        def fmt(v):
            return "-" if v is None else f"{v:.3f}"

        print(f"  {label.ljust(12)}  {fmt(row.get('p50')):>9}  "
              f"{fmt(row.get('p99')):>9}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ds_trace",
        description="merge / summarize deepspeed-tpu Perfetto traces")
    sub = parser.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge", help="merge per-rank trace shards")
    m.add_argument("paths", nargs="+")
    m.add_argument("-o", "--output", default=None)
    m.set_defaults(fn=_cmd_merge)
    s = sub.add_parser("summary",
                       help="per-track occupancy + pipeline bubble")
    s.add_argument("paths", nargs="+")
    s.add_argument("--serving", action="store_true",
                   help="per-request serving view: p50/p99 queue-wait/"
                        "TTFT/per-token latency + goodput vs "
                        "throughput")
    s.set_defaults(fn=_cmd_summary)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # `ds_trace summary | head` closing stdout is not an error
        try:
            sys.stdout.close()
        except Exception:  # ds-lint: allow[BROADEXC] closing an already-broken pipe; any error here is noise on exit
            pass
        return 0


cli_main = main

if __name__ == "__main__":
    sys.exit(main())
