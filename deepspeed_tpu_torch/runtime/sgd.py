"""SGD with optional momentum: optax's `sgd` as the JAX engine wires it
for `"type": "SGD"` (`inject_hyperparams(optax.sgd)(learning_rate,
momentum or None)`), in the port's transform contract
(`runtime/bf16_optimizer.py`: updates one leaf at a time, the state
written in place, a device bool `keep` masking every write).

optax's momentum is a trace: t <- g + momentum * t, update = -lr * t
(no dampening, no Nesterov). The state `SGDState(count, trace)` holds
the inject wrapper's step count and the fp32 traces (None without
momentum); checkpoints write it in optax's layout
(`InjectStatefulHyperparamsState` over `(TraceState, EmptyState)`).
"""

from typing import Any, NamedTuple

import torch

from deepspeed_tpu_torch.runtime.bf16_optimizer import (
    GradientTransformation, masked_copy_, step_increment)


class SGDState(NamedTuple):
    count: Any   # int32 device scalar
    trace: Any   # [fp32 tensor] per parameter, or None without momentum


def sgd(learning_rate=None, momentum=None):
    def init_fn(params):
        params = list(params)
        dev = params[0].device if params else None
        trace = None if momentum is None else [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]
        return SGDState(torch.zeros((), dtype=torch.int32, device=dev),
                        trace)

    def update_fn(grads, state, params=None, lr=None, keep=None):
        lr = learning_rate if lr is None else lr
        state.count.add_(step_increment(keep))

        def leaves():
            if state.trace is None:
                for g in grads:
                    yield -lr * g.to(torch.float32)
                return
            for g, t in zip(grads, state.trace):
                new = g.to(torch.float32) + momentum * t
                masked_copy_(t, new, keep)
                yield -lr * new

        return leaves(), state

    return GradientTransformation(init_fn, update_fn)
