"""Wall-clock and throughput timers on CUDA events (port of
deepspeed_tpu/utils/timer.py).

The JAX package fenced the device (`jax.effects_barrier`) at each timer
start/stop and at each throughput window's edges. Here a timer records a
CUDA event on the current stream instead: recording is asynchronous, so
starting and stopping never wait for the device, and the elapsed time is
read from the event pair only when a caller asks for it (`elapsed`,
`avg_samples_per_sec`), which then waits for the stop event. The
throughput timer reports a window when its end event has completed, by
a non-blocking query, so a training loop that calls it every step never
waits on the device. On the CPU the host clock stands in (CPU work is
synchronous).
"""

import time

import torch

from deepspeed_tpu_torch.utils.logging import logger


class _Mark:
    """A point in the device's stream (CUDA event) or, on the CPU, the
    host clock."""

    def __init__(self, device):
        self.event = None
        self.host = None
        if torch.device(device).type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.host = time.perf_counter()

    def done(self):
        return self.event is None or self.event.query()

    def seconds_since(self, start):
        """Seconds from `start` to this mark; waits for this mark's event."""
        if self.event is None:
            return self.host - start.host
        self.event.synchronize()
        return start.event.elapsed_time(self.event) / 1e3


class SynchronizedWallClockTimer:
    """Named timers whose start/stop mark the device stream."""

    class Timer:
        def __init__(self, name, device):
            self.name_ = name
            self.device = device
            self.elapsed_ = 0.0
            self.started_ = False
            self._start = None
            self._spans = []

        def start(self):
            if self.started_:
                raise RuntimeError(f"timer {self.name_} has already been "
                                   "started")
            self._start = _Mark(self.device)
            self.started_ = True

        def stop(self, reset=False):
            if not self.started_:
                raise RuntimeError(f"timer {self.name_} is not started")
            if reset:
                self._spans, self.elapsed_ = [], 0.0
            self._spans.append((self._start, _Mark(self.device)))
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self._spans = []
            self.started_ = False

        def elapsed(self, reset=True):
            """Seconds over the stopped spans (waits for the last stop
            event)."""
            started = self.started_
            if started:
                self.stop()
            total = self.elapsed_ + sum(end.seconds_since(start)
                                        for start, end in self._spans)
            self.elapsed_, self._spans = total, []
            if reset:
                self.reset()
            if started:
                self.start()
            return total

        def mean(self, reset=True):
            return self.elapsed(reset=reset)

    def __init__(self, device="cuda"):
        self.device = device
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    def has_timer(self, name):
        return name in self.timers

    def log(self, names, normalizer=1.0, reset=True):
        if normalizer <= 0.0:
            raise ValueError("normalizer must be positive")
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / \
                    normalizer
                string += " | {}: {:.2f}".format(name, ms)
        logger.info(string)


class ThroughputTimer:
    """Samples per second over the steps after `start_step` warm-up
    steps. `stop(count)` is called once per step with the microbatches
    it consumed; every `steps_per_output` microbatches a window closes
    at a marked point of the device stream, and the window is counted
    (and logged) once that point has passed."""

    def __init__(self, batch_size, num_workers=1, start_step=2,
                 steps_per_output=50, device="cuda", logging_fn=None):
        self.batch_size = batch_size or 1
        self.num_workers = num_workers
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.device = device
        self.logging = logging_fn or logger.info
        self.started = False
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self._measured_steps = 0
        self._window_start = None       # (mark, global step count)
        self._pending = []              # closed windows: (start, end, steps)

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        self.started = True

    def stop(self, report_speed=True, count=1):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += count
        self.global_step_count += count
        if self._window_start is None:
            if self.global_step_count >= self.start_step:
                self._window_start = (_Mark(self.device),
                                      self.global_step_count)
            return
        if report_speed and \
                self.global_step_count % self.steps_per_output < count:
            self._close_window()
        self._drain(block=False, log=report_speed)

    def close_window(self):
        """End the open window at this point of the device stream without
        waiting for it (a later host read of the stream completes it:
        the monitor closes the window before its fence's one copy)."""
        if self._window_start is not None and \
                self.global_step_count > self._window_start[1]:
            self._close_window()

    def collect(self):
        """Count the closed windows whose end the device has passed,
        without waiting for the others."""
        self._drain(block=False, log=False)

    def _close_window(self):
        start, steps0 = self._window_start
        end = _Mark(self.device)
        self._pending.append((start, end, self.global_step_count - steps0))
        self._window_start = (end, self.global_step_count)

    def _drain(self, block, log):
        while self._pending and (block or self._pending[0][1].done()):
            start, end, steps = self._pending.pop(0)
            self.total_elapsed_time += end.seconds_since(start)
            self._measured_steps += steps
            if log:
                self.logging("{}/{}, SamplesPerSec={}".format(
                    self.epoch_count, self.micro_step_count,
                    self.avg_samples_per_sec(block=False)))

    def avg_samples_per_sec(self, block=True):
        """Samples per second over the counted windows; with `block`
        (the default) it first closes the open window and waits for the
        device to reach its end. 0.0 before any window."""
        if block:
            if self._window_start is not None and \
                    self.global_step_count > self._window_start[1]:
                self._close_window()
            self._drain(block=True, log=False)
        if self._measured_steps > 0 and self.total_elapsed_time > 0:
            samples_per_step = self.batch_size * self.num_workers
            return samples_per_step * self._measured_steps / \
                self.total_elapsed_time
        return 0.0
