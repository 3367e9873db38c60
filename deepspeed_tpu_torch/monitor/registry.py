"""Async-safe metrics core (port of deepspeed_tpu/monitor/registry.py).

Hot-path metrics (loss, grad-norm, loss-scale, overflow, tokens) stay
DEVICE-SIDE between fences: the step already computes each of them as a
device tensor, and the registry simply RETAINS those tensors (a Python
list append — no launch, no host<->device sync) until the engine's
`steps_per_sync` fence, where everything drains in exactly ONE
device-to-host copy of one stacked tensor (`fetch_tree`;
tests/test_torch_monitor_engine.py pins both properties). Values that
are host numbers already (an offload step's loss scale, a host overflow
flag) are kept as they are and never copied.

Long fence windows stay bounded: every `_COMPACT_AT` retained steps the
pending tensors are reduced on the device (`torch.stack(...).sum`, a
handful of launches, still no host sync), so a steps_per_sync of 100k
holds at most _COMPACT_AT+3 scalar tensors.

Host-side state splits into:
  * counters — monotonically increasing floats bumped by host events
    (checkpoint commits, wire bytes, stall fires); thread-safe, since
    the checkpoint writer and watchdog threads increment them.
  * gauges — callables sampled at drain time (checkpoint queue depth,
    prefetch occupancy, device memory); a gauge may return a float or
    a flat dict of floats. Gauge failures are swallowed: telemetry
    must never kill training.
"""

import threading

import numpy as np
import torch


def fetch_tree(tree):
    """`tree` (dicts, lists, tuples of tensors and host values) with
    every tensor replaced by a numpy array of its values, read from the
    device in ONE copy: the tensors are flattened into one float64
    tensor on their device (exact for the float32, int32 and bool
    values the monitor retains) and that tensor is copied to the host
    once. Host values pass through. No copy when the tree holds no
    tensor."""
    leaves = []

    def collect(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)

    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in leaves]).cpu().numpy()
    at = 0
    parts = []
    for t in leaves:
        n = t.numel()
        parts.append(flat[at:at + n].reshape(tuple(t.shape)))
        at += n
    arrays = iter(parts)

    def rebuild(node):
        if isinstance(node, torch.Tensor):
            return next(arrays)
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rebuild(v) for v in node]
        if isinstance(node, tuple):
            return tuple(rebuild(v) for v in node)
        return node

    return rebuild(tree)


def _column_sum(values, dtype):
    """(device partial sum or None, host partial sum) of a list mixing
    device tensors and host numbers."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    host = float(sum(float(v) for v in values
                     if not isinstance(v, torch.Tensor)))
    dev = torch.sum(torch.stack([t.to(dtype) for t in tensors])) \
        if tensors else None
    return dev, host


class MetricsRegistry:
    _COMPACT_AT = 256

    def __init__(self):
        self._pending = []        # [(loss, grad_norm, overflow), ...]
        # [(device sum or None, host sum)] per column, over compacted steps
        self._acc = None
        self._scale_last = 0.0    # device scalar or host float
        self._steps = 0
        self._loss_steps = 0      # steps that actually reported a loss
        self._gnorm_steps = 0     # ... and a grad norm
        self._tokens = 0.0        # host sum (token counts are host ints)
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        # numerics health (monitor/numerics.py): per-step [L,3]/[G,3]
        # device stat tensors retained exactly like the scalars — a list
        # append per step, compacted on the device, fetched in the SAME
        # per-fence copy
        self._pending_health = []   # [(window_step, {"act","grad"})]
        self._health_acc = None
        # MoE router stats (moe/router.py): per-step [E+2] device
        # vectors (per-expert load, drop frac, aux loss) retained the
        # same way — list append, summed on the device at compaction,
        # drained in the same per-fence copy; the fence reports the
        # window MEAN
        self._pending_router = []
        self._router_acc = None     # device [E+2] sum over compacted
        self._router_steps = 0

    # ------------------------------------------------------------------
    # device-side accumulator
    # ------------------------------------------------------------------
    def fold_step(self, loss, grad_norm, loss_scale, overflow, tokens,
                  health=None, router=None):
        """Retain one step's device scalars. NO device work, NO sync —
        a list append; the tensors were produced by the step anyway.
        (Never `bool()`/`float()` a device value here: that would be a
        hidden per-step sync.)

        A None loss/grad_norm (backward(release_loss=True) loops, paths
        that skip the norm) folds as 0 but is EXCLUDED from the window
        mean — reporting a bogus 0.0 loss would read as sudden
        convergence on a dashboard.

        `health` ({"act": [L,3], "grad": [G,3]} device tensors, either
        key possibly None) retains numerics-health stats the same way."""
        self._pending.append((0.0 if loss is None else loss,
                              0.0 if grad_norm is None else grad_norm,
                              False if overflow is None else overflow))
        if health is not None and (health.get("act") is not None or
                                   health.get("grad") is not None):
            self._pending_health.append((self._steps, health))
        if router is not None:
            self._pending_router.append(router)
            self._router_steps += 1
        if loss is not None:
            self._loss_steps += 1
        if grad_norm is not None:
            self._gnorm_steps += 1
        if loss_scale is not None:
            self._scale_last = loss_scale
        self._tokens += float(tokens)
        self._steps += 1
        if len(self._pending) >= self._COMPACT_AT:
            self._compact()

    def _compact(self):
        """Reduce the pending scalars into the device partial
        accumulator — a few launches (async like the step), amortized
        over _COMPACT_AT steps. Bounds retained tensors for arbitrarily
        long fence windows."""
        pend, self._pending = self._pending, []
        losses, gnorms, ovfs = zip(*pend)
        part = [_column_sum(losses, torch.float32),
                _column_sum(gnorms, torch.float32),
                _column_sum(ovfs, torch.int32)]
        if self._acc is not None:
            part = [(p[0] if a[0] is None else
                     a[0] if p[0] is None else a[0] + p[0], a[1] + p[1])
                    for a, p in zip(self._acc, part)]
        self._acc = part
        if self._pending_health:
            from deepspeed_tpu_torch.monitor import numerics
            ph, self._pending_health = self._pending_health, []
            self._health_acc = numerics.fold_entries(
                [s for s, _ in ph], [h for _, h in ph],
                self._health_acc)
        if self._pending_router:
            pr, self._pending_router = self._pending_router, []
            part = torch.sum(torch.stack(
                [r.to(torch.float32) for r in pr]), dim=0)
            self._router_acc = part if self._router_acc is None \
                else self._router_acc + part

    # ------------------------------------------------------------------
    # host-side counters + gauges
    # ------------------------------------------------------------------
    def inc(self, name, value=1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + \
                float(value)

    def set_counter(self, name, value):
        with self._lock:
            self._counters[name] = float(value)

    def counters(self):
        with self._lock:
            return dict(self._counters)

    def add_gauge(self, name, fn):
        self._gauges[name] = fn

    def sample_gauges(self):
        out = {}
        for name, fn in self._gauges.items():
            try:
                val = fn()
            except Exception:  # ds-lint: allow[BROADEXC] host gauges are best-effort callables sampled at the fence; one bad gauge must not kill the drain
                continue
            if isinstance(val, dict):
                for k, v in val.items():
                    out[f"{name}/{k}"] = float(v)
            elif val is not None:
                out[name] = float(val)
        return out

    # ------------------------------------------------------------------
    # fence drain
    # ------------------------------------------------------------------
    def drain_device(self):
        """ONE device-to-host copy of everything retained (partial
        accumulator + pending scalars + last loss scale + numerics and
        router tensors, `fetch_tree`); resets the window. Returns None
        when nothing was folded since the last drain."""
        if self._steps == 0:
            return None
        (acc, pend, scale, health_acc, pend_health, router_acc,
         pend_router) = fetch_tree(
            (self._acc, self._pending, self._scale_last,
             self._health_acc, self._pending_health,
             self._router_acc, self._pending_router))
        steps, self._steps = self._steps, 0
        loss_steps, self._loss_steps = self._loss_steps, 0
        gnorm_steps, self._gnorm_steps = self._gnorm_steps, 0
        router_steps, self._router_steps = self._router_steps, 0
        tokens, self._tokens = self._tokens, 0.0
        self._pending, self._acc = [], None
        self._pending_health, self._health_acc = [], None
        self._pending_router, self._router_acc = [], None

        loss_sum = gnorm_sum = ovf_sum = 0.0
        if acc is not None:
            loss_sum, gnorm_sum, ovf_sum = (
                (0.0 if dev is None else float(dev)) + host
                for dev, host in acc)
        for loss, gnorm, ovf in pend:
            loss_sum += float(loss)
            gnorm_sum += float(gnorm)
            ovf_sum += float(ovf)
        scale = float(np.asarray(scale))
        # loss_scale persists across windows (the next window may hold
        # only overflow-skipped steps that never touch the scale)
        self._scale_last = scale
        out = {
            "steps": int(steps),
            "loss": loss_sum / loss_steps if loss_steps else None,
            "grad_norm": gnorm_sum / gnorm_steps if gnorm_steps
            else None,
            "loss_scale": scale,
            "overflow_count": int(ovf_sum),
            "tokens": int(tokens),
        }
        if pend_health or health_acc is not None:
            # fetched numpy already (it rode the one copy above); the
            # Monitor summarizes with its host-side labels
            out["health"] = (pend_health, health_acc)
        if router_steps:
            # window MEAN of the [E+2] router stats vector (per-expert
            # load fractions, drop fraction, aux loss) — fetched numpy
            # via the same copy
            total = np.zeros_like(np.asarray(
                pend_router[0] if pend_router else router_acc,
                np.float64))
            if router_acc is not None:
                total = total + np.asarray(router_acc, np.float64)
            for r in pend_router:
                total = total + np.asarray(r, np.float64)
            out["router"] = (total / router_steps, int(router_steps))
        return out
