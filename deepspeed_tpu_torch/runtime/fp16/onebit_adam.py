"""1-bit Adam, the single-worker form (port of
deepspeed_tpu/runtime/fp16/onebit_adam.py with `static_phase=None`).

The algorithm (Tang et al.): plain Adam for `freeze_step` warm-up
steps, then the variance is frozen and the momentum is sign-compressed
with error feedback (`compress`: one scale, the mean |x|, and a bit of
sign per element, packed 8 to a byte by `pack_signs`). The phase is
selected on the device from the step count (`torch.where` between the
warm and the compressed moments), as the JAX package's dynamic form
does, so the step reads nothing on the host at the switch. At world
size 1 the server-side error stays as it was. The compressed collective
across workers waits for data-parallel training (ROADMAP Queue 1
item 6).

The state is the JAX package's `OnebitAdamState` (count, exp_avg,
exp_avg_sq, worker_error, server_error, hyperparams), the learning rate
kept under hyperparams["learning_rate"] for checkpoints. The update
follows the port's transform contract (`runtime/bf16_optimizer.py`).
"""

from typing import Any, NamedTuple

import torch

from deepspeed_tpu_torch.runtime.bf16_optimizer import (
    GradientTransformation, masked_copy_, step_increment)
from deepspeed_tpu_torch.utils.logging import logger

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)
_bit_weights_cache = {}


def _bit_weights(device):
    """The 8 bit weights as a uint8 tensor on `device`, made once per
    device (a copy from the host on every step would wait for it)."""
    w = _bit_weights_cache.get(device)
    if w is None:
        w = _bit_weights_cache[device] = torch.tensor(
            _BIT_WEIGHTS, dtype=torch.uint8).to(device)
    return w


def pack_signs(x):
    """[N] float -> ceil(N/8) uint8 of sign bits (1 = non-negative)."""
    n = x.shape[0]
    bits = (x >= 0).to(torch.uint8)
    pad = (-n) % 8
    if pad:
        bits = torch.cat([bits, torch.zeros((pad,), dtype=torch.uint8,
                                            device=x.device)])
    return torch.sum(bits.view(-1, 8) * _bit_weights(x.device),
                     dim=1).to(torch.uint8)


def unpack_signs(packed, n):
    """ceil(N/8) uint8 -> [N] float32 of +-1."""
    bits = (packed[:, None] & _bit_weights(packed.device)[None, :]) > 0
    return torch.where(bits.reshape(-1)[:n], 1.0, -1.0).to(torch.float32)


def compress(x, error):
    """Error-feedback sign compression of flat `x`: (scale,
    packed_signs, new_error); scale * sign reconstructs what is sent."""
    corrected = x + error
    scale = torch.mean(torch.abs(corrected))
    signs = torch.where(corrected >= 0, 1.0, -1.0)
    new_error = corrected - scale * signs
    return scale, pack_signs(corrected), new_error


class OnebitAdamState(NamedTuple):
    count: Any
    exp_avg: Any        # momentum
    exp_avg_sq: Any     # variance, frozen after freeze_step
    worker_error: Any
    server_error: Any
    hyperparams: Any    # {"learning_rate": fp32 device scalar}


def onebit_adam(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, freeze_step=100):
    def init_fn(params):
        params = list(params)
        dev = params[0].device if params else None
        zeros = lambda: [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in params]
        return OnebitAdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg=zeros(), exp_avg_sq=zeros(), worker_error=zeros(),
            server_error=zeros(),
            hyperparams={"learning_rate": torch.tensor(
                float(learning_rate), dtype=torch.float32, device=dev)})

    def update_fn(grads, state, params=None, lr=None, keep=None):
        lr_t = state.hyperparams["learning_rate"]
        if lr is not None:
            masked_copy_(lr_t, torch.as_tensor(lr, dtype=torch.float32,
                                               device=lr_t.device), keep)
        lr = lr_t
        state.count.add_(step_increment(keep))
        count = state.count
        in_warmup = count <= freeze_step
        bias1 = 1 - torch.pow(b1, count.to(torch.float32))
        bias2 = 1 - torch.pow(b2, torch.clamp(count, max=freeze_step)
                              .to(torch.float32))
        params = params if params is not None else state.exp_avg

        def leaves():
            for g, m, v, werr, p in zip(grads, state.exp_avg,
                                        state.exp_avg_sq,
                                        state.worker_error, params):
                g32 = g.to(torch.float32)
                m_warm = b1 * m + (1 - b1) * g32
                v_warm = b2 * v + (1 - b2) * g32 * g32
                flat = m_warm.reshape(-1)   # the compressed phase's m too
                scale, packed, werr_new = compress(flat, werr.reshape(-1))
                m_comp = (unpack_signs(packed, flat.shape[0]) * scale) \
                    .reshape(m.shape)
                m_new = torch.where(in_warmup, m_warm, m_comp)
                v_new = torch.where(in_warmup, v_warm, v)
                werr_new = torch.where(in_warmup, werr,
                                       werr_new.reshape(werr.shape))
                masked_copy_(m, m_new, keep)
                masked_copy_(v, v_new, keep)
                masked_copy_(werr, werr_new, keep)
                denom = torch.sqrt(v_new / bias2) + eps
                upd = -(lr / bias1) * (m_new / denom)
                if weight_decay:
                    upd = upd - lr * weight_decay * p.to(torch.float32)
                yield upd

        return leaves(), state

    return GradientTransformation(init_fn, update_fn)


class OnebitAdam:
    """Class-style facade (ref `OnebitAdam`): a client optimizer object
    for `initialize(optimizer=...)`, the single-worker form."""

    def __init__(self, params=None, lr=1e-3, freeze_step=100,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 cuda_aware=False):
        if cuda_aware:
            logger.warning("cuda_aware has no effect in the single-worker "
                           "form; ignored")
        self.lr = lr
        self.freeze_step = freeze_step
        self.transformation = onebit_adam(
            learning_rate=lr, b1=betas[0], b2=betas[1], eps=eps,
            weight_decay=weight_decay, freeze_step=freeze_step)

    def init(self, params):
        return self.transformation.init(params)

    def update(self, grads, state, params=None, lr=None, keep=None):
        return self.transformation.update(grads, state, params, lr=lr,
                                          keep=keep)
