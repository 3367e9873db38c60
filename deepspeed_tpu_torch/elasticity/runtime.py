"""Elastic preemption-safe training runtime (port of
deepspeed_tpu/elasticity/runtime.py: the same names, taxonomy, config
block, recovery steps and event keys).

  * `FaultInjector` — the chaos harness: a sentinel subprocess per
    "host" (its liveness IS the host's), SIGKILLs, direct lost / slow /
    stall / capacity events; `poll()` turns dead sentinels into
    `host_lost` events.
  * `classify_failure` — the failure taxonomy: lost host > slow host >
    escalated stall > transient stall, escalating after N consecutive
    stall fires (the watchdog's own `escalate_after`).
  * `ElasticSupervisor` — owns a train loop end to end over the port's
    engine. Healthy path: deterministic batches from `batch_fn(step,
    spec)`, periodic (async) checkpoints. On a terminal failure:

      1. drain — or, past `drain_timeout_sec`, abandon — the in-flight
         checkpoint writers (`engine.shutdown`);
      2. pick the newest committed tag (`read_latest_tag`, bounded
         retries);
      3. re-form on the surviving devices at the largest device count
         `compute_elastic_config` declares valid, the micro batch
         re-derived for it (the total batch size is invariant);
      4. re-plan ZeRO for that world size (`engine.zero_policy.
         memory_plan`; the per-category bytes ride the event);
      5. rebuild the engine and load the checkpoint;
      6. resume, asserting loss continuity: every replayed step's loss
         must match the pre-failure history within
         `loss_continuity_atol` (bit-identical at an unchanged world
         size).

    (The JAX supervisor grows back onto returned hosts at the next
    checkpoint boundary: a world above one device, item 6 below.)

The port trains at world size 1 (one card): the `elasticity.runtime`
block takes `hosts: 1`, and a re-form onto another device count is data
parallelism, ROADMAP Queue 1 item 6 (`hosts` above 1 or more than one
device raises NotImplementedError naming it). Everything that exists at
one device behaves as the JAX supervisor on one device: an escalated
stall (or an engine / batch_fn error) recovers in place from the last
committed tag; a lost (or slow) host leaves no survivor and raises
`ElasticityIncompatibleWorldSize` — no device count is valid at 0
survivors (the JAX supervisor's message, "every host is lost"; its
class there is the base `ElasticityError`).

Config block (inside "elasticity"), as in the JAX package:

    "elasticity": {
      "enabled": true,
      "max_train_batch_size": 48,
      "micro_batch_sizes": [2],
      "runtime": {
        "enabled": true,
        "hosts": 1,
        "checkpoint_dir": "ckpts",
        "checkpoint_interval": 10,     // optimizer steps between saves
        "drain_timeout_sec": 5.0,      // writer drain before abandon
        "load_retries": 3,
        "escalate_after": 3,           // consecutive stalls -> terminal
        "grow_at_checkpoint_boundary": true,
        "loss_continuity_atol": 1e-3,
        "max_recoveries": 16
      }
    }

The supervisor reads the loss on the host every step (a resilience
harness, not the sync-free hot loop). Fault events are consumed between
steps, so the escalated-stall path recovers host-side stalls (a wedged
input pipeline, a hung batch_fn, a stuck checkpoint barrier).
"""

import copy
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from typing import NamedTuple

import numpy as np

from deepspeed_tpu_torch.elasticity import (ElasticityConfigError,
                                            ElasticityError,
                                            ElasticityIncompatibleWorldSize,
                                            compute_elastic_config)
from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.version import __version__

__all__ = [
    "FaultEvent", "FaultInjector", "BatchSpec", "ElasticRuntimeConfig",
    "ElasticSupervisor", "LossContinuityError", "classify_failure",
    "HOST_LOST", "HOST_SLOW", "STALL", "STALL_ESCALATED",
    "CAPACITY_RETURNED",
]

# failure/event taxonomy
HOST_LOST = "host_lost"
HOST_SLOW = "host_slow"
STALL = "stall"
STALL_ESCALATED = "stall_escalated"
CAPACITY_RETURNED = "capacity_returned"
ENGINE_ERROR = "engine_error"


def _later(what):
    return NotImplementedError(
        f"{what} is not in the port yet: ROADMAP Queue 1 item 6")


class LossContinuityError(ElasticityError):
    """A replayed post-resume step's loss diverged from the recorded
    pre-failure trajectory beyond loss_continuity_atol — the restore
    did not reproduce the checkpointed state."""


class FaultEvent:
    """One injected or detected fault."""

    __slots__ = ("kind", "host", "info", "ts")

    def __init__(self, kind, host=None, info=None):
        self.kind = kind
        self.host = host
        self.info = dict(info or {})
        self.ts = time.monotonic()

    def __repr__(self):
        return (f"FaultEvent({self.kind!r}, host={self.host!r}"
                + (f", info={self.info}" if self.info else "") + ")")


class FaultInjector:
    """Chaos harness for the supervisor.

    Each "host" may be backed by a sentinel subprocess (`spawn_host`)
    whose liveness stands in for the host's: SIGKILLing it
    (`sigkill_host`) is the injected host crash, and `poll()` reports
    the death as one `host_lost` event. Faults can also be injected
    directly (`mark_host_lost` / `mark_host_slow` / `inject_stall` /
    `return_capacity`). Thread-safe: the watchdog thread and the
    supervisor loop may both touch the queue."""

    _SENTINEL = "import time\nwhile True:\n    time.sleep(3600)\n"

    def __init__(self):
        self._lock = threading.Lock()
        self._queue = deque()
        self._procs = {}        # host_id -> Popen
        self._reported = set()  # host_ids whose death was emitted

    # -- sentinel "host" subprocesses ---------------------------------
    def spawn_host(self, host_id):
        """Start a sentinel subprocess standing in for `host_id`. A dead
        predecessor is evicted so the host can be re-backed; respawning
        over a live sentinel raises. Returns the new pid."""
        with self._lock:
            old = self._procs.get(host_id)
            if old is not None:
                if old.poll() is None:
                    raise ValueError(
                        f"host {host_id} already has a live sentinel "
                        f"(pid {old.pid})")
                old.wait()
                del self._procs[host_id]
            proc = subprocess.Popen(
                [sys.executable, "-c", self._SENTINEL],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            self._procs[host_id] = proc
            self._reported.discard(host_id)
            return proc.pid

    def sigkill_host(self, host_id):
        """SIGKILL the host's sentinel; detected at the next poll."""
        with self._lock:
            proc = self._procs[host_id]
        os.kill(proc.pid, signal.SIGKILL)

    def host_dead(self, host_id):
        """True once `host_id`'s sentinel has exited; False for hosts
        with no sentinel."""
        with self._lock:
            proc = self._procs.get(host_id)
        return proc is not None and proc.poll() is not None

    def wait_host_dead(self, host_id, timeout=10.0):
        """Wait up to `timeout` seconds for the sentinel's death to be
        observable. Returns True when dead, False on timeout."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            if self.host_dead(host_id):
                return True
            time.sleep(0.01)
        return False

    # -- direct fault injection ---------------------------------------
    def _push(self, event):
        with self._lock:
            self._queue.append(event)

    def mark_host_lost(self, host_id, **info):
        self._push(FaultEvent(HOST_LOST, host=host_id, info=info))

    def mark_host_slow(self, host_id, **info):
        self._push(FaultEvent(HOST_SLOW, host=host_id, info=info))

    def inject_stall(self, **info):
        """Simulate one watchdog stall fire."""
        self._push(FaultEvent(STALL, info=info))

    def return_capacity(self, host_id, **info):
        self._push(FaultEvent(CAPACITY_RETURNED, host=host_id,
                              info=info))

    # -- detection ----------------------------------------------------
    def poll(self):
        """Drain pending events; dead sentinels become `host_lost`
        events (reported once per death)."""
        events = []
        with self._lock:
            for host_id, proc in self._procs.items():
                if host_id in self._reported:
                    continue
                rc = proc.poll()
                if rc is not None:
                    self._reported.add(host_id)
                    events.append(FaultEvent(
                        HOST_LOST, host=host_id,
                        info={"returncode": rc, "pid": proc.pid}))
            while self._queue:
                events.append(self._queue.popleft())
        return events

    def close(self):
        """Kill and reap every sentinel still alive."""
        with self._lock:
            procs, self._procs = dict(self._procs), {}
            self._reported.clear()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def classify_failure(events, consecutive_stalls=0, escalate_after=3):
    """Map a batch of fault events (+ the running consecutive-stall
    count) to one verdict: (kind | None, lost_hosts, returned_hosts,
    new_consecutive_stalls). Severity: lost host > slow host (treated
    as lost) > escalated stall > transient stall; transient stalls
    become a verdict after `escalate_after` consecutive fires or an
    explicit `stall_escalated` event."""
    lost = {e.host for e in events if e.kind == HOST_LOST}
    slow = {e.host for e in events if e.kind == HOST_SLOW}
    returned = sorted({e.host for e in events
                       if e.kind == CAPACITY_RETURNED})
    stalls = sum(1 for e in events if e.kind == STALL)
    escalated = any(e.kind == STALL_ESCALATED for e in events)
    if lost or slow:
        return (HOST_LOST if lost else HOST_SLOW), \
            sorted(lost | slow), returned, 0
    if escalated:
        return STALL_ESCALATED, [], returned, 0
    if stalls:
        consecutive_stalls += stalls
        if escalate_after and consecutive_stalls >= escalate_after:
            return STALL_ESCALATED, [], returned, 0
        return STALL, [], returned, consecutive_stalls
    return None, [], returned, consecutive_stalls


class BatchSpec(NamedTuple):
    """Batch geometry at one world size: `total` (the elastic batch
    size) is invariant across re-forms; rows = micro * world rows a
    microbatch."""
    world: int
    micro: int
    gas: int
    total: int

    @property
    def rows(self):
        return self.micro * self.world


class ElasticRuntimeConfig:
    """Validated view of the "elasticity.runtime" block (the JAX
    package's checks and messages)."""

    def __init__(self, block):
        block = dict(block or {})
        self.enabled = bool(block.get("enabled", False))
        self.hosts = int(block.get("hosts", 1))
        self.checkpoint_dir = block.get("checkpoint_dir",
                                        "elastic_ckpts")
        self.checkpoint_interval = int(block.get("checkpoint_interval",
                                                 10))
        self.drain_timeout_sec = float(block.get("drain_timeout_sec",
                                                 5.0))
        self.load_retries = int(block.get("load_retries", 3))
        self.escalate_after = int(block.get("escalate_after", 3))
        self.grow_at_checkpoint_boundary = bool(
            block.get("grow_at_checkpoint_boundary", True))
        self.loss_continuity_atol = float(
            block.get("loss_continuity_atol", 1e-3))
        self.max_recoveries = int(block.get("max_recoveries", 16))
        if self.hosts < 1:
            raise ElasticityConfigError(
                f"elasticity.runtime.hosts must be >= 1, "
                f"got {self.hosts}")
        if self.checkpoint_interval < 1:
            raise ElasticityConfigError(
                "elasticity.runtime.checkpoint_interval must be >= 1, "
                f"got {self.checkpoint_interval}")
        if self.drain_timeout_sec <= 0:
            raise ElasticityConfigError(
                "elasticity.runtime.drain_timeout_sec must be > 0, "
                f"got {self.drain_timeout_sec}")
        if self.load_retries < 0 or self.escalate_after < 0 or \
                self.max_recoveries < 1:
            raise ElasticityConfigError(
                "bad elasticity.runtime bounds: "
                f"load_retries={self.load_retries}, "
                f"escalate_after={self.escalate_after}, "
                f"max_recoveries={self.max_recoveries}")


class ElasticSupervisor:
    """Owns a train loop end to end and survives faults.

    Args:
      ds_config: full config dict with an enabled "elasticity" block
        and an enabled "runtime" sub-block. The engine's config is
        derived from it (batch triple from the elastic math; the
        "elasticity" block stripped — the supervisor IS the runtime).
      model_factory: () -> (model, params), the model on `device`.
        Called once per engine build.
      batch_fn: (global_step, BatchSpec) -> stacked [gas, rows, ...]
        batch dict. Must be a pure function of its arguments: replay
        determinism depends on it.
      save_dir: checkpoint directory (default: the block's
        checkpoint_dir).
      devices: the devices to supervise (default: [device]); one.
      injector: a FaultInjector (a fresh one if omitted).
      device: the engine's device, "cuda" unless the caller asks for
        the CPU.
    """

    def __init__(self, ds_config, model_factory, batch_fn,
                 save_dir=None, devices=None, injector=None,
                 device=None):
        self.ds_config = copy.deepcopy(ds_config)
        el = self.ds_config.get("elasticity") or {}
        if not el.get("enabled", False):
            raise ElasticityConfigError(
                "ElasticSupervisor requires an enabled 'elasticity' "
                "config block")
        self.rt = ElasticRuntimeConfig(el.get("runtime"))
        if not self.rt.enabled:
            raise ElasticityConfigError(
                "ElasticSupervisor requires elasticity.runtime.enabled")
        mesh_block = dict(self.ds_config.get("mesh") or {})
        for axis in ("pipe", "model"):
            if int(mesh_block.get(axis, 1)) != 1:
                raise ElasticityConfigError(
                    "ElasticSupervisor re-forms pure data-parallel "
                    f"meshes; mesh.{axis}={mesh_block[axis]} is not "
                    "supported — run model/pipe-parallel jobs under "
                    "plain deepspeed_tpu_torch.initialize()")
        if int(mesh_block.get("expert", 1)) != 1:
            raise _later("an elastic expert axis")
        self.device = resolve_device(device if device is not None
                                     else "cuda")
        all_devices = list(devices) if devices is not None \
            else [self.device]
        if len(all_devices) != 1 or self.rt.hosts != 1:
            raise _later(
                f"elastic training over {len(all_devices)} device(s) in "
                f"{self.rt.hosts} host group(s) (the port supervises "
                "one device, hosts: 1)")
        self.model_factory = model_factory
        self.batch_fn = batch_fn
        self.injector = injector if injector is not None \
            else FaultInjector()
        self.save_dir = save_dir or self.rt.checkpoint_dir
        self._groups = [all_devices]
        self._alive = {0}
        self._stall_queue = deque()   # fed by watchdog threads
        self._consecutive_stalls = 0
        self._returned_pending = set()
        self._carried_abandoned = []  # writers surviving a rebuild
        self.engine = None
        self.devices = []
        self.batch_spec = None
        self.zero_plan = None
        self.events = []              # recovery / scale_up records
        self.loss_history = {}        # step -> loss
        # step -> (pre-failure loss, replayed loss): the continuity
        # check's pairs
        self.replayed_losses = {}
        self._replay_until = 0        # steps < this are replays
        self.recoveries = 0
        self._step = 0

    # ------------------------------------------------------------------
    # elastic config math
    # ------------------------------------------------------------------
    def _valid_worlds(self):
        _, valid = compute_elastic_config(self.ds_config, __version__)
        return valid

    def _select_world(self, n_devices):
        """Largest compatible device count <= the survivor count."""
        valid = [g for g in self._valid_worlds() if g <= n_devices]
        if not valid:
            raise ElasticityIncompatibleWorldSize(
                f"no compatible device count <= {n_devices} survivors "
                f"(valid: {self._valid_worlds()}); cannot re-form")
        return max(valid)

    def _plan(self, world):
        total, _, micro = compute_elastic_config(
            self.ds_config, __version__, world_size=world)
        gas = total // (micro * world)
        return BatchSpec(world=world, micro=micro, gas=gas, total=total)

    def _surviving_devices(self):
        return [d for h in sorted(self._alive) for d in self._groups[h]]

    # ------------------------------------------------------------------
    # engine lifecycle
    # ------------------------------------------------------------------
    def _engine_config(self, spec):
        cfg = copy.deepcopy(self.ds_config)
        cfg.pop("elasticity", None)   # the supervisor IS the runtime
        cfg.pop("mesh", None)
        cfg["train_batch_size"] = spec.total
        cfg["train_micro_batch_size_per_gpu"] = spec.micro
        cfg["gradient_accumulation_steps"] = spec.gas
        return cfg

    def _build_engine(self, devices):
        import deepspeed_tpu_torch
        world = self._select_world(len(devices))
        devices = list(devices)[:world]
        spec = self._plan(world)
        model, params = self.model_factory()
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=params,
            config=self._engine_config(spec), device=devices[0])
        wd = engine.monitor.watchdog
        if wd is not None:
            # each watchdog fire is a transient-stall vote, the
            # escalation a terminal verdict
            wd.on_stall = self._on_stall
            wd.on_escalate = self._on_escalate
            if self.rt.escalate_after and not wd.escalate_after:
                wd.escalate_after = self.rt.escalate_after
        # abandoned writers of the torn-down predecessor may still own
        # `<tag>.tmp` staging dirs: the successor keeps refusing those
        # tags
        if self._carried_abandoned:
            engine._abandoned_ckpt_writers = [
                w for w in self._carried_abandoned if w.pending()]
            self._carried_abandoned = []
        self.engine = engine
        self.devices = devices
        self.batch_spec = spec
        # the ZeRO plan for this world size with the engine's own byte
        # settings; it rides the recovery event. The port keeps an fp32
        # store beside the parameters only under mixed precision (an
        # fp32 engine's parameters are the store, as bf16's master-less
        # mode's are): the plan's `sr_mode` form
        try:
            params = engine.state.params
            self.zero_plan = engine.zero_policy.memory_plan(
                {n: tuple(p.shape) for n, p in params.items()},
                compute_bytes=next(iter(params.values())).element_size(),
                sr_mode=not engine.mixed_precision,
                gas=engine.gradient_accumulation_steps())
        except Exception:  # forensic garnish, not the recovery itself
            logger.warning("ZeRO memory-plan computation failed",
                           exc_info=True)
            self.zero_plan = None
        return engine

    def _teardown_engine(self, drain=True):
        """Drop the current engine: drain (or, past the timeout,
        abandon) its checkpoint writers and stop its monitor threads.
        Abandoned writers still alive are carried to the successor."""
        engine, self.engine = self.engine, None
        if engine is None:
            return
        try:
            engine.shutdown(
                wait_for_checkpoint=drain,
                checkpoint_timeout=self.rt.drain_timeout_sec)
        except Exception:
            logger.warning("engine teardown raised", exc_info=True)
        finally:
            self._carried_abandoned = [
                w for w in getattr(engine, "_abandoned_ckpt_writers", [])
                if w.pending()]

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def _checkpoint(self):
        tag = f"global_step{self._step}"
        try:
            self.engine.save_checkpoint(self.save_dir, tag=tag)
        except Exception:
            # the next boundary retries with a fresh tag; recovery uses
            # the last committed one either way
            logger.warning(f"checkpoint save '{tag}' failed",
                           exc_info=True)

    def _load_latest(self):
        """Newest committed tag -> engine. Returns (tag, restored global
        step), or (None, None) when nothing is committed."""
        tag = ckpt_io.read_latest_tag(self.save_dir,
                                      retries=self.rt.load_retries)
        if tag is None:
            return None, None
        self.engine.load_checkpoint(self.save_dir, tag=tag,
                                    retries=self.rt.load_retries)
        return tag, int(self.engine.global_steps)

    # ------------------------------------------------------------------
    # recovery + scale-up
    # ------------------------------------------------------------------
    def _emit_event(self, event):
        self.events.append(event)
        eng = self.engine
        if eng is not None and eng.monitor.enabled:
            try:
                eng.monitor.event(event["kind"],
                                  **{k: v for k, v in event.items()
                                     if k != "kind"})
                if eng.monitor.flight is not None and \
                        event["kind"] == "recovery":
                    eng.monitor.flight.set_context(
                        last_recovery=dict(event))
            except Exception:
                logger.warning("recovery event emission failed",
                               exc_info=True)

    def _recover(self, cause, lost_hosts=(), error=None):
        detect_t = time.monotonic()
        self.recoveries += 1
        if self.recoveries > self.rt.max_recoveries:
            raise ElasticityError(
                f"giving up after {self.recoveries - 1} recoveries "
                f"(elasticity.runtime.max_recoveries="
                f"{self.rt.max_recoveries}); last cause: {cause}")
        for h in lost_hosts:
            self._alive.discard(h)
        if not self._alive:
            raise ElasticityIncompatibleWorldSize(
                f"every host is lost (cause: {cause}); nothing to "
                f"re-form onto (no compatible device count <= 0 "
                f"survivors; valid: {self._valid_worlds()})")
        old_world = self.batch_spec.world if self.batch_spec else None
        old_step = self._step
        logger.warning(
            f"RECOVERY ({cause}): lost hosts {sorted(lost_hosts)}; "
            f"re-forming on hosts {sorted(self._alive)}"
            + (f"; error: {error!r}" if error is not None else ""))
        self._teardown_engine(drain=True)
        self._build_engine(self._surviving_devices())
        tag, restored = self._load_latest()
        if tag is None:
            logger.warning(
                "recovery found no committed checkpoint; restarting "
                "from scratch (step 0)")
            self._step = 0
        else:
            self._step = restored
        self._replay_until = max(self._replay_until, old_step)
        self._consecutive_stalls = 0
        event = {
            "kind": "recovery",
            "cause": cause,
            "lost_hosts": sorted(lost_hosts),
            "world_before": old_world,
            "world_after": self.batch_spec.world,
            "micro_batch": self.batch_spec.micro,
            "gradient_accumulation_steps": self.batch_spec.gas,
            "resumed_from_tag": tag,
            "resumed_step": self._step,
            "replayed_steps": max(0, old_step - self._step),
            "detect_to_resume_sec": round(
                time.monotonic() - detect_t, 3),
            "zero_plan_bytes": {k: int(v) for k, v in
                                (self.zero_plan or {}).items()},
        }
        if error is not None:
            event["error"] = repr(error)
        self._emit_event(event)
        return event

    # ------------------------------------------------------------------
    # loss continuity
    # ------------------------------------------------------------------
    def _note_loss(self, step, loss):
        if not np.isfinite(loss):
            raise LossContinuityError(
                f"non-finite loss {loss} at step {step}")
        prev = self.loss_history.get(step)
        if prev is not None and step < self._replay_until:
            if abs(prev - loss) > self.rt.loss_continuity_atol:
                raise LossContinuityError(
                    f"replayed step {step} loss {loss!r} diverged from "
                    f"the pre-failure trajectory {prev!r} by "
                    f"{abs(prev - loss):.3e} > loss_continuity_atol="
                    f"{self.rt.loss_continuity_atol} — the restore did "
                    "not reproduce the checkpointed state")
            self.replayed_losses[step] = (prev, loss)
        self.loss_history[step] = loss

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def run(self, num_steps):
        """Train to `num_steps` optimizer steps, surviving faults.
        Returns the run report (`report()`)."""
        if self.engine is None:
            self._build_engine(self._surviving_devices())
            # a supervisor restart adopts committed progress
            tag, restored = self._load_latest()
            if tag is not None:
                self._step = restored
        while self._step < num_steps:
            verdict, hosts = self._poll_faults()
            if verdict in (HOST_LOST, HOST_SLOW, STALL_ESCALATED):
                self._recover(cause=verdict, lost_hosts=hosts)
                self._apply_returns()
                continue
            self._apply_returns()
            try:
                batch = self.batch_fn(self._step, self.batch_spec)
                loss = float(self.engine.train_batch(batch=batch))
            except LossContinuityError:
                raise
            except Exception as e:
                # batch_fn is part of the supervised loop: its failures
                # recover like the engine's
                self._recover(cause=ENGINE_ERROR, error=e)
                self._apply_returns()
                continue
            self._note_loss(self._step, loss)
            self._step += 1
            if verdict is None:
                self._consecutive_stalls = 0
            if self._step % self.rt.checkpoint_interval == 0:
                self._checkpoint()
        try:
            self.engine.wait_for_checkpoint(
                timeout=self.rt.drain_timeout_sec)
        except ckpt_io.CheckpointWaitTimeout as e:
            logger.warning(f"final checkpoint drain timed out: {e}")
        except RuntimeError as e:
            logger.warning(
                f"final checkpoint drain: background save failed: {e}")
        return self.report()

    # ------------------------------------------------------------------
    def report(self):
        return {
            "steps": self._step,
            "world_size": self.batch_spec.world
            if self.batch_spec else None,
            "micro_batch": self.batch_spec.micro
            if self.batch_spec else None,
            "gradient_accumulation_steps": self.batch_spec.gas
            if self.batch_spec else None,
            "device_ids": [d.index if d.index is not None else 0
                           for d in self.devices],
            "alive_hosts": sorted(self._alive),
            "recoveries": [dict(e) for e in self.events
                           if e["kind"] == "recovery"],
            "scale_ups": [dict(e) for e in self.events
                          if e["kind"] == "scale_up"],
            "losses": dict(self.loss_history),
        }

    def close(self):
        self._teardown_engine(drain=True)
        self.injector.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # fault intake
    # ------------------------------------------------------------------
    def _on_stall(self, diag):
        self._stall_queue.append(FaultEvent(STALL, info=diag))

    def _on_escalate(self, diag):
        self._stall_queue.append(FaultEvent(STALL_ESCALATED, info=diag))

    def _poll_faults(self):
        events = list(self.injector.poll())
        while self._stall_queue:
            events.append(self._stall_queue.popleft())
        verdict, hosts, returned, self._consecutive_stalls = \
            classify_failure(events, self._consecutive_stalls,
                             self.rt.escalate_after)
        # capacity returns apply after any recovery in the same batch
        self._returned_pending.update(returned)
        return verdict, hosts

    def _apply_returns(self):
        """A returned host that is not alive would grow the world: at
        one host that cannot happen (losing it raises), so any such
        return is another host's, which needs data parallelism."""
        returned = sorted(h for h in self._returned_pending
                          if h not in self._alive)
        self._returned_pending.clear()
        if returned:
            raise _later(f"growing onto returned host(s) {returned}")
