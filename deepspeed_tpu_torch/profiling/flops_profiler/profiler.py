"""FLOPS profiler: counts a run's operations instead of reading a
compiler's cost analysis (port of
deepspeed_tpu/profiling/flops_profiler/profiler.py).

The JAX module reads XLA's cost analysis of a compiled program, which it
never runs. PyTorch runs eagerly, so the port counts the run itself:

  * every aten operation under a dispatch mode of the port's own
    (`_AtenCounter`): flops from `torch.utils.flop_counter`'s formulas
    (the matrix products: mm, addmm, bmm, baddbmm and the rest of
    torch's registry), bytes as each tensor argument read once and each
    output written once, transcendentals as the output elements of the
    transcendental ops (exp, log, tanh, erf, rsqrt, ...). View and
    metadata operations move no bytes and make no row;
  * every hand-written kernel by itself: the ctypes launches are
    invisible to any dispatch mode, so each wrapper runs through
    `kernel_call`, which records the kernel's flops, bytes and
    transcendentals from its shapes (the counts `chip_smoke.py`'s
    bounds use) and suspends the aten count for the wrapper's body. A
    wrapper records the same row on either route, the kernel on the
    card or its plain twin on the CPU, so the twin's arithmetic never
    enters a profile.

`per_fusion_costs` gives one row per kernel or aten op with the JAX
package's keys (`name`, `op`, `kind`, `kernel`, `flops`, `bytes`,
`transcendentals`, `calls`, `est_us`, `time_pct`); `est_us` is the same
roofline estimate, max(flops / peak, bytes / bandwidth, transcendentals
/ (peak / 16)) per call. There is no HLO text to parse: the seam the
JAX package's text parser was, `per_fusion_costs_from_ops`, builds the
rows from a recorded op list.

Recording is process-wide while a profile is open (the backward of CUDA
tensors runs on autograd's device threads); nothing is recorded and the
wrappers pay one list check when none is.
"""

import threading
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import logger


def _number_to_string(num, units=None, precision=2):
    if units is None:
        if num >= 1e12:
            return f"{num / 1e12:.{precision}f} T"
        if num >= 1e9:
            return f"{num / 1e9:.{precision}f} G"
        if num >= 1e6:
            return f"{num / 1e6:.{precision}f} M"
        if num >= 1e3:
            return f"{num / 1e3:.{precision}f} K"
        return f"{num:.{precision}f} "
    return f"{num:.{precision}f} {units}"


def flops_to_string(flops, units=None, precision=2):
    return _number_to_string(flops, units, precision) + "FLOPS"


def params_to_string(params_num, units=None, precision=2):
    return _number_to_string(params_num, units, precision).rstrip() or "0"


def duration_to_string(duration, units=None, precision=2):
    if duration >= 1:
        return f"{duration:.{precision}f} s"
    if duration >= 1e-3:
        return f"{duration * 1e3:.{precision}f} ms"
    return f"{duration * 1e6:.{precision}f} us"


def _leaves(params):
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return [x for v in params.values() for x in _leaves(v)]
    if isinstance(params, (list, tuple)):
        return [x for v in params for x in _leaves(v)]
    return [params]


def num_params(params) -> int:
    """Elements of every leaf of a parameter dict (nested dicts, lists),
    an nn.Module's parameters, or one array."""
    return int(sum(int(np.prod(np.shape(p))) for p in _leaves(params)))


# ----------------------------------------------------------------------
# recording
# ----------------------------------------------------------------------
_recorders = []            # open OpRecorders, process-wide
_recorders_lock = threading.Lock()
_tls = threading.local()   # .suspended: depth of kernel wrappers entered

KIND_KERNEL = "kernel"
KIND_ATEN = "aten"


class OpRecorder:
    """The op list of one profiled run: one tuple per call,
    (kind, name, op, kernel, flops, bytes, transcendentals)."""

    def __init__(self):
        self.ops = []
        self._lock = threading.Lock()

    def add(self, kind, name, op, kernel, flops, nbytes, trans):
        with self._lock:
            self.ops.append((kind, name, op, kernel, float(flops),
                             float(nbytes), float(trans)))


def kernel_call(name, kernel, op, cost, fn):
    """Run `fn()`, a kernel wrapper's launch (or its twin). While a
    profile records, add the row of kernel `name` (`kernel`: its CUDA
    source; `op`: the wrapper) with `cost()` -> (flops, bytes,
    transcendentals), and suspend the aten count inside `fn`: the
    twin's step-by-step arithmetic and the wrapper's allocations are
    the kernel's, not rows of their own."""
    if not _recorders:
        return fn()
    depth = getattr(_tls, "suspended", 0)
    _tls.suspended = depth + 1
    try:
        flops, nbytes, trans = cost()
        with _recorders_lock:
            recs = list(_recorders)
        for r in recs:
            r.add(KIND_KERNEL, name, op, kernel, flops, nbytes, trans)
        return fn()
    finally:
        _tls.suspended = depth


# the aten ops whose every output element costs one transcendental
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "tanh_backward", "erf", "erfc", "erfinv", "rsqrt", "sqrt", "pow",
    "sin", "cos", "tan", "atan2", "sigmoid", "sigmoid_backward",
    "logit", "softplus", "gelu", "gelu_backward", "silu",
    "_softmax", "_log_softmax", "logsumexp"))


def _tensor_bytes(tree):
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _numel(tree):
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() for t in leaves if isinstance(t, torch.Tensor))


def aten_cost(func, args, kwargs, out):
    """(flops, bytes, transcendentals) of one aten call: torch's flop
    formula where it has one (the matrix products), its tensor
    arguments read once and its outputs written once, one
    transcendental per output element of a transcendental op."""
    from torch.utils.flop_counter import flop_registry
    packet = func.overloadpacket
    formula = flop_registry.get(packet)
    flops = formula(*args, **kwargs, out_val=out) if formula else 0
    nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
    base = packet.__name__.rstrip("_")
    trans = _numel(out) if base in _TRANSCENDENTAL else 0
    return flops, nbytes, trans


def _is_view(func):
    """Whether an aten overload moves no bytes: it returns a view of an
    input (an output aliased to an input and not written), or is one of
    the ops that share an input's storage without saying so in their
    schema (`_unsafe_view`, ...)."""
    view = _views.get(func)
    if view is None:
        view = _views[func] = \
            func.overloadpacket.__name__ in _STORAGE_SHARING or any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns)
    return view


_views = {}
_STORAGE_SHARING = frozenset(("_unsafe_view", "_reshape_alias",
                              "lift_fresh"))


class _AtenCounter(TorchDispatchMode):
    """Adds each aten call outside a kernel wrapper to `recorder`."""

    def __init__(self, recorder):
        super().__init__()
        self.recorder = recorder

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not getattr(_tls, "suspended", 0) and not _is_view(func):
            flops, nbytes, trans = aten_cost(func, args, kwargs, out)
            name = str(func.overloadpacket)
            self.recorder.add(KIND_ATEN, name, name, None, flops, nbytes,
                              trans)
        return out


class _Recording:
    """Open: a recorder registered for the kernel wrappers and the aten
    counter entered on this thread; close() undoes both."""

    def __init__(self):
        self.recorder = OpRecorder()
        self._mode = _AtenCounter(self.recorder)
        with _recorders_lock:
            _recorders.append(self.recorder)
        self._mode.__enter__()

    def close(self):
        self._mode.__exit__(None, None, None)
        with _recorders_lock:
            if self.recorder in _recorders:
                _recorders.remove(self.recorder)
        return self.recorder.ops


def record_ops(fn, *args, **kwargs):
    """(fn's result, its op list): `fn(*args, **kwargs)` run once under
    the counting."""
    rec = _Recording()
    try:
        out = fn(*args, **kwargs)
    finally:
        ops = rec.close()
    return out, ops


def cost_analysis_of(fn, *args, **kwargs):
    """Totals of one run of `fn(*args)`: {'flops', 'bytes accessed',
    'transcendentals'} (the keys of XLA's cost analysis). The port runs
    `fn` to count it."""
    _, ops = record_ops(fn, *args, **kwargs)
    return totals_of(ops)


def totals_of(ops):
    return {"flops": float(sum(o[4] for o in ops)),
            "bytes accessed": float(sum(o[5] for o in ops)),
            "transcendentals": float(sum(o[6] for o in ops))}


# ----------------------------------------------------------------------
# per-op breakdown
# ----------------------------------------------------------------------
def device_peak_specs(device=None):
    """(peak_bf16_flops, hbm_GBps) of a device from its name: the H100's
    published dense bf16 rate and memory rate (989 TFLOP/s, 3,350 GB/s);
    a generic 100 TF / 800 GB/s for anything else, the CPU included
    (rankings and time_pct are scale-free either way). `device`: a
    torch.device, a device name, or None for the current CUDA device
    (the CPU when there is no card)."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() \
            else torch.device("cpu")
    if isinstance(device, torch.device):
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
    else:
        name = str(device)
    table = {"h100": (989e12, 3350.0)}
    for key, spec in table.items():
        if key in name.lower():
            return spec
    return 100e12, 800.0


def per_fusion_costs_from_ops(ops, peak_flops=None, hbm_gbps=None):
    """Rows of a recorded op list (`record_ops`), one per kernel or aten
    op, sorted by estimated time: {name, op, kind, kernel, flops, bytes,
    transcendentals, calls, est_us, time_pct}. est_us sums, over the
    calls, max(flops / peak, bytes / bandwidth, transcendentals / (peak
    / 16)): an ESTIMATE for ranking, not a measurement."""
    if peak_flops is None or hbm_gbps is None:
        pf, bw = device_peak_specs()
        peak_flops = peak_flops or pf
        hbm_gbps = hbm_gbps or bw
    rows = {}
    for kind, name, op, kernel, flops, nbytes, trans in ops:
        row = rows.get((kind, name))
        if row is None:
            row = rows[(kind, name)] = {
                "name": name, "op": op, "kind": kind, "kernel": kernel,
                "flops": 0.0, "bytes": 0.0, "transcendentals": 0.0,
                "calls": 0, "est_us": 0.0}
        row["flops"] += flops
        row["bytes"] += nbytes
        row["transcendentals"] += trans
        row["calls"] += 1
        row["est_us"] += max(flops / peak_flops,
                             nbytes / (hbm_gbps * 1e9),
                             trans / (peak_flops / 16.0)) * 1e6
    out = list(rows.values())
    total = sum(r["est_us"] for r in out) or 1.0
    for r in out:
        r["time_pct"] = round(100.0 * r["est_us"] / total, 2)
        r["est_us"] = round(r["est_us"], 2)
        for k in ("flops", "bytes", "transcendentals"):
            r[k] = int(r[k])
    out.sort(key=lambda r: -r["est_us"])
    return out


def per_fusion_costs(fn, *args, peak_flops=None, hbm_gbps=None, **kwargs):
    """Roofline breakdown of one run of `fn(*args)`: the rows of
    `per_fusion_costs_from_ops` over its recorded ops."""
    _, ops = record_ops(fn, *args, **kwargs)
    return per_fusion_costs_from_ops(ops, peak_flops=peak_flops,
                                     hbm_gbps=hbm_gbps)


def _compact(rows, top):
    out = []
    for r in rows[:top]:
        row = {"op": (r["op"] or r.get("kernel") or r["name"])[-120:],
               "kind": r["kind"], "est_us": r["est_us"],
               "time_pct": r["time_pct"], "flops": r["flops"],
               "bytes": r["bytes"], "calls": r["calls"]}
        if r.get("kernel"):
            row["kernel"] = r["kernel"]
        out.append(row)
    return out


def top_fusion_sinks(fn, *args, top=3, **kwargs):
    """The top-`top` rows of `per_fusion_costs` in compact form: {op,
    kind, est_us, time_pct, flops, bytes, calls} (+ `kernel` for a
    kernel row)."""
    return _compact(per_fusion_costs(fn, *args, **kwargs), top)


class FlopsProfiler:
    """Profiles one run of a callable, or whatever runs between
    `start_profile` and `stop_profile` (the engine's profile step).

        prof = FlopsProfiler(model)
        prof.start_profile()
        ...                      # or prof.profile_jitted(fn, *args)
        prof.stop_profile()
        prof.print_model_profile()
    """

    def __init__(self, model=None, config=None):
        self.model = model
        self.config = config
        self.started = False
        self.total_flops = 0.0
        self.total_bytes = 0.0
        self.total_transcendentals = 0.0
        self.total_params = 0
        self.total_duration = 0.0
        self.rows = []
        self._recording = None

    def start_profile(self, ignore_list=None):
        """Reset the totals and start counting on this thread (and the
        kernel wrappers' rows on every thread)."""
        self.total_flops = self.total_bytes = 0.0
        self.total_transcendentals = self.total_duration = 0.0
        self.rows = []
        if self._recording is None:
            self._recording = _Recording()
        self.started = True

    def stop_profile(self):
        """Stop counting; the totals and `rows` are those of the ops
        recorded since `start_profile`."""
        if self._recording is not None:
            ops = self._recording.close()
            self._recording = None
            tot = totals_of(ops)
            self.total_flops = tot["flops"]
            self.total_bytes = tot["bytes accessed"]
            self.total_transcendentals = tot["transcendentals"]
            self.rows = per_fusion_costs_from_ops(ops)
        self.started = False

    def end_profile(self):
        self.stop_profile()

    def profile_jitted(self, fn, *args, measure_time=True, **kwargs):
        """Count one run of `fn(*args)`; with `measure_time`, time a
        second, uncounted run (synchronised on a card). Returns the
        totals, as `cost_analysis_of`."""
        self.start_profile()
        try:
            fn(*args, **kwargs)
        finally:
            self.stop_profile()
        if measure_time:
            _sync()
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            _sync()
            self.total_duration = time.perf_counter() - t0
        return {"flops": self.total_flops,
                "bytes accessed": self.total_bytes,
                "transcendentals": self.total_transcendentals}

    # -- accessors (ref profiler.py naming) -----------------------------
    def get_total_flops(self, as_string=False):
        return flops_to_string(self.total_flops) if as_string \
            else self.total_flops

    def get_total_params(self, as_string=False):
        return params_to_string(self.total_params) if as_string \
            else self.total_params

    def get_total_duration(self, as_string=False):
        return duration_to_string(self.total_duration) if as_string \
            else self.total_duration

    def print_model_profile(self, profile_step=1, module_depth=-1,
                            top_modules=3, detailed=True):
        tflops = self.total_flops / self.total_duration / 1e12 \
            if self.total_duration else 0.0
        text = (
            f"\n-------------------------- DeepSpeed Flops Profiler "
            f"--------------------------\n"
            f"Profile at step {profile_step}:\n"
            f"  params:            {params_to_string(self.total_params)}\n"
            f"  fwd+bwd+step flops:{flops_to_string(self.total_flops)}\n"
            f"  HBM bytes:         {_number_to_string(self.total_bytes)}B\n"
            f"  step latency:      "
            f"{duration_to_string(self.total_duration)}\n"
            f"  achieved:          {tflops:.2f} TFLOPS")
        if detailed and self.rows:
            text += "\n  top ops by estimated time:"
            for r in self.rows[:max(int(top_modules), 0)]:
                text += (f"\n    {r['name']:<28} {r['kind']:<6} calls "
                         f"{r['calls']:>5}  {flops_to_string(r['flops'])}"
                         f"  {_number_to_string(r['bytes'])}B  est "
                         f"{r['est_us']:.2f} us ({r['time_pct']}%)")
        logger.info(text)

    def print_model_aggregated_profile(self, module_depth=-1,
                                       top_modules=3):
        self.print_model_profile(module_depth=module_depth,
                                 top_modules=top_modules)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def get_model_profile(model=None,
                      input_shape=None,
                      args=None,
                      kwargs=None,
                      print_profile=True,
                      detailed=True,
                      module_depth=-1,
                      top_modules=3,
                      warm_up=1,
                      as_string=True,
                      ignore_modules=None,
                      fn=None,
                      params=None,
                      device=None):
    """Standalone profile: returns (flops, macs, params). Takes a
    callable `fn(*args)`, or an `nn.Module` `model` called on `args` (or
    on a zero tensor of `input_shape`). Inputs of `input_shape` are made
    on `device`, by default the model's parameters' device, else the
    card. `warm_up` uncounted calls run first, so a first call's
    kernel builds are not what is timed."""
    kwargs = kwargs or {}
    if fn is None:
        if model is None or (args is None and input_shape is None):
            raise ValueError("get_model_profile needs fn, or a model and "
                             "args or input_shape")
        if args is None:
            if device is None:
                first = next(iter(model.parameters()), None)
                device = first.device if first is not None else "cuda"
            args = (torch.zeros(input_shape, device=resolve_device(device)),)
        params = model if params is None else params

        def fn(*a):
            return model(*a, **kwargs)
    if args is None:
        raise ValueError("get_model_profile needs args")

    with torch.no_grad():
        for _ in range(warm_up):
            fn(*args)
        prof = FlopsProfiler(model)
        prof.total_params = num_params(params) if params is not None else 0
        prof.profile_jitted(fn, *args)

    if print_profile:
        prof.print_model_profile(module_depth=module_depth,
                                 top_modules=top_modules,
                                 detailed=detailed)

    flops = prof.get_total_flops(as_string)
    macs = prof.total_flops / 2
    if as_string:
        macs = _number_to_string(macs) + "MACs"
    n = prof.get_total_params(as_string)
    return flops, macs, n
