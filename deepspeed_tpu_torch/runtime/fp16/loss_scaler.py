"""Static and dynamic loss scaling (port of
deepspeed_tpu/runtime/fp16/loss_scaler.py).

The automaton is a function of device tensors, so the fp16 step decides
its scale with no host read:

  * scale x2 after `scale_window` consecutive overflow-free steps (a
    full clean window also restores the hysteresis);
  * on overflow: decrement the hysteresis; once it is exhausted, scale =
    max(scale / 2, min_scale) and the hysteresis resets;
  * overflow = a non-finite global gradient norm (the engine's).

`LossScaleState` is the JAX package's NamedTuple of 0-dim tensors
(fp32 scale, int32 good_steps and hysteresis), in the same order, so a
checkpoint's `aux/scale` entry maps onto it. The host classes
`LossScaler`, `DynamicLossScaler` and `CreateLossScaler` are kept for
API parity.
"""

from typing import Any, NamedTuple

import torch

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"


class LossScaleState(NamedTuple):
    """Device-resident loss-scale state (all 0-dim tensors)."""
    loss_scale: Any      # fp32
    good_steps: Any      # int32: consecutive overflow-free steps
    hysteresis: Any      # int32: overflows left before the scale drops


def make_loss_scale_state(init_scale=2.0**32, delayed_shift=2,
                          device=None):
    return LossScaleState(
        loss_scale=torch.tensor(float(init_scale), dtype=torch.float32,
                                device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(int(delayed_shift), dtype=torch.int32,
                                device=device))


def make_static_loss_scale_state(scale, device=None):
    return LossScaleState(
        loss_scale=torch.tensor(float(scale), dtype=torch.float32,
                                device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(1, dtype=torch.int32, device=device))


def update_loss_scale(state, overflow, scale_window=1000, min_scale=1.0,
                      delayed_shift=2, scale_factor=2.0, dynamic=True):
    """One transition of the automaton: a new LossScaleState from
    `state` and the device bool `overflow`, with no host read. The
    static form (`dynamic=False`) returns `state`."""
    if not dynamic:
        return state
    overflow = torch.as_tensor(overflow, device=state.loss_scale.device)
    overflow = overflow.to(torch.bool)
    shift = torch.full_like(state.hysteresis, int(delayed_shift))
    drop = overflow & (state.hysteresis <= 1)
    scale_on_overflow = torch.where(
        drop, torch.clamp(state.loss_scale / scale_factor,
                          min=float(min_scale)), state.loss_scale)
    hyst_on_overflow = torch.where(drop, shift, state.hysteresis - 1)
    good = state.good_steps + 1
    grow = ~overflow & (torch.remainder(good, int(scale_window)) == 0)
    scale_on_clean = torch.where(grow, state.loss_scale * scale_factor,
                                 state.loss_scale)
    hyst_on_clean = torch.where(grow, shift, state.hysteresis)
    return LossScaleState(
        loss_scale=torch.where(overflow, scale_on_overflow, scale_on_clean),
        good_steps=torch.where(overflow, torch.zeros_like(good), good),
        hysteresis=torch.where(overflow, hyst_on_overflow, hyst_on_clean))


class LossScalerBase:
    """Host-side wrapper (API parity with the reference)."""

    def __init__(self, cur_scale):
        self.cur_scale = cur_scale
        self.dynamic = False

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, module, grad_in, grad_out):
        return tuple(None if g is None else g * self.loss_scale
                     for g in grad_in)

    def update_scale(self, overflow):
        pass

    def backward(self, loss, retain_graph=False):
        scaled = loss * self.loss_scale
        scaled.backward(retain_graph=retain_graph)
        return scaled

    def state(self, device=None):
        return make_static_loss_scale_state(self.cur_scale, device)


class LossScaler(LossScalerBase):
    """Static loss scale."""

    def __init__(self, scale=1):
        super().__init__(scale)

    def has_overflow(self, params):
        return False


class DynamicLossScaler(LossScalerBase):
    """Dynamic loss scale; mirrors the reference's knobs."""

    def __init__(self, init_scale=2**32, scale_factor=2., scale_window=1000,
                 min_scale=1, delayed_shift=1, consecutive_hysteresis=False):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis
        self.dynamic = True

    def has_overflow(self, params):
        """Whether any gradient of `params` (tensors with `.grad`) is
        non-finite (a host read)."""
        for p in params:
            g = getattr(p, "grad", None)
            if g is not None and not bool(torch.isfinite(g).all()):
                return True
        return False

    def update_scale(self, overflow):
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                self.cur_scale = max(self.cur_scale / self.scale_factor,
                                     self.min_scale)
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) % \
                    self.scale_window == 0:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor
        self.cur_iter += 1

    def state(self, device=None):
        return LossScaleState(
            loss_scale=torch.tensor(float(self.cur_scale),
                                    dtype=torch.float32, device=device),
            good_steps=torch.tensor(0, dtype=torch.int32, device=device),
            hysteresis=torch.tensor(int(self.cur_hysteresis),
                                    dtype=torch.int32, device=device))


def CreateLossScaler(dtype_fp16, static_loss_scale, dynamic_scaling,
                     dynamic_loss_args):
    """The engine's scaler selection (ref `fused_optimizer.py:74-98`)."""
    if not dtype_fp16:
        return LossScaler(scale=1)
    if dynamic_scaling:
        if dynamic_loss_args is None:
            return DynamicLossScaler()
        return DynamicLossScaler(
            init_scale=dynamic_loss_args.get(INITIAL_LOSS_SCALE, 2**32),
            scale_window=dynamic_loss_args.get(SCALE_WINDOW, 1000),
            min_scale=dynamic_loss_args.get(MIN_LOSS_SCALE, 1),
            delayed_shift=dynamic_loss_args.get(DELAYED_SHIFT, 1))
    return LossScaler(scale=static_loss_scale)
