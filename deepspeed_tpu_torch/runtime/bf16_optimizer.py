"""Adam with 16-bit moments and stochastic rounding, and the fp32-master
Adam/AdamW of the same math (port of
deepspeed_tpu/runtime/bf16_optimizer.py).

bf16 {"master_weights": false} keeps everything in bf16 (params, mu, nu:
6 bytes per parameter instead of mixed precision's 16) and recovers fp32
master-quality updates two ways: all update math runs in fp32 (the
moments are widened, updated and rounded back), and the parameter
write-back uses stochastic rounding, so E[round(x)] = x and updates far
below one bf16 ulp of the parameter accumulate in expectation instead
of being swallowed.

The same `scale_by_adam_bf16` with `state_dtype=torch.float32` is
exactly optax's `scale_by_adam` ((mu / (1 - b1^t)) / (sqrt(nu /
(1 - b2^t)) + eps)), so the engine's fp32-master Adam and AdamW (the
JAX engine's `optax.adam` / `optax.adamw`) are `adam` / `adamw_bf16`
with fp32 moments.

The port updates in place and one leaf at a time: `update` returns the
updates as an iterator, and taking each update writes that leaf's new
moments into the state's tensors; the caller applies it before taking
the next. So no second copy of the optimizer state, of the parameters
or of the updates exists at the step's peak (at 1.5B parameters a
whole fp32 update tree would be 6 GB). The learning rate may be a
Python float or a 0-dim device tensor (the engine passes a device
scalar, so no step needs a host sync).
"""

from typing import Any, Callable, NamedTuple

import torch


class ScaleByAdamBF16State(NamedTuple):
    count: torch.Tensor   # int32 device scalar: steps taken
    mu: Any               # [tensor] in state_dtype, one per parameter
    nu: Any


class GradientTransformation(NamedTuple):
    """optax's (init, update) pair: `init(params) -> state`;
    `update(grads, state, params, lr) -> (updates, state)`, the updates
    an iterator of fp32 tensors, one per leaf, whose every step also
    updates that leaf's state in place."""
    init: Callable
    update: Callable


def scale_by_adam_bf16(b1=0.9, b2=0.999, eps=1e-8,
                       state_dtype=torch.bfloat16):
    """Adam's preconditioner with persistent moments in `state_dtype`;
    the moment recursion and the preconditioned update are fp32 every
    step (widen, update, round back into the state)."""

    def init_fn(params):
        params = list(params)
        dev = params[0].device if params else None
        return ScaleByAdamBF16State(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=[torch.zeros(p.shape, dtype=state_dtype, device=p.device)
                for p in params],
            nu=[torch.zeros(p.shape, dtype=state_dtype, device=p.device)
                for p in params])

    def update_fn(grads, state, params=None, lr=None):
        del params, lr
        state.count.add_(1)
        c = state.count.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)

        def leaves():
            for g, m, v in zip(grads, state.mu, state.nu):
                g32 = g.to(torch.float32)
                mu32 = b1 * m.to(torch.float32) + (1.0 - b1) * g32
                nu32 = b2 * v.to(torch.float32) + (1.0 - b2) * (g32 * g32)
                m.copy_(mu32)
                v.copy_(nu32)
                yield (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)

        return leaves(), state

    return GradientTransformation(init_fn, update_fn)


def adamw_bf16(learning_rate=None, b1=0.9, b2=0.999, eps=1e-8,
               weight_decay=0.0, state_dtype=torch.bfloat16):
    """AdamW: -lr * (adam_precond + weight_decay * p), fp32 updates.
    `learning_rate` is the default when `update` gets no `lr`. Pair the
    bf16 form with `stochastic_round_apply`, not a plain bf16 add (a
    deterministic bf16 add would swallow small updates)."""
    inner = scale_by_adam_bf16(b1=b1, b2=b2, eps=eps,
                               state_dtype=state_dtype)

    def update_fn(grads, state, params, lr=None):
        lr = learning_rate if lr is None else lr
        precond, state = inner.update(grads, state)
        updates = (-lr * (u + weight_decay * p.to(torch.float32))
                   for u, p in zip(precond, params))
        return updates, state

    return GradientTransformation(inner.init, update_fn)


def adam(learning_rate=None, b1=0.9, b2=0.999, eps=1e-8,
         state_dtype=torch.float32):
    """Adam without weight decay (optax.adam): -lr * adam_precond."""
    inner = scale_by_adam_bf16(b1=b1, b2=b2, eps=eps,
                               state_dtype=state_dtype)

    def update_fn(grads, state, params=None, lr=None):
        lr = learning_rate if lr is None else lr
        precond, state = inner.update(grads, state)
        return (-lr * u for u in precond), state

    return GradientTransformation(inner.init, update_fn)


def stochastic_round_bf16(x32, generator):
    """fp32 -> bf16 with unbiased stochastic rounding: add 16 uniform
    random bits below the bf16 truncation point, then truncate. The sum
    is int32 arithmetic modulo 2^32, bit for bit the JAX package's
    uint32 sum, so ties and carries into the kept mantissa are exact and
    NaN/inf pass through (their exponent field saturates). The random
    bits come from `generator` (a torch.Generator on x32's device): the
    port's stream, not JAX's rbg stream, so the two packages round
    alike only in distribution."""
    bits = x32.to(torch.float32).contiguous().view(torch.int32)
    noise = torch.randint(0, 1 << 16, x32.shape, dtype=torch.int32,
                          device=x32.device, generator=generator)
    rounded = (bits + noise) & -65536           # & 0xFFFF0000
    return rounded.view(torch.float32).to(torch.bfloat16)


def stochastic_round_apply(params, updates, generator):
    """Write round(p + u) into each bf16 parameter tensor of `params`
    (in place), from fp32 updates `updates`, by stochastic rounding."""
    for p, u in zip(params, updates):
        p.copy_(stochastic_round_bf16(p.to(torch.float32) +
                                      u.to(torch.float32), generator))
