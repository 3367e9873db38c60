"""Reference-parity LAMB (port of deepspeed_tpu/ops/lamb/fused_lamb.py).

The update rule of the reference's CUDA kernel
(`csrc/lamb/fused_lamb_cuda_kernel.cu:279-306`):

    m = b1*m + (1-b1)*g ;  v = b2*v + (1-b2)*g*g
    u = m_hat / (sqrt(v_hat) + eps) + weight_decay * w      (eps mode 1)
    coeff = ||w|| / ||u||   clipped to [min_coeff, max_coeff],
            1.0 when either norm is zero
    w <- w - lr * coeff * u

with the JAX package's association, fp32 moments, and the port's
transform contract (`runtime/bf16_optimizer.py`): `update` yields one
leaf's update at a time and writes that leaf's moments in place, the
learning rate may be a device scalar, and a device bool `keep` masks
every state write (an fp16 step skipped on overflow). The state is the
JAX package's `LambState` (count, mu, nu), which its engine checkpoints
under optax's `inject_hyperparams` wrapper.
"""

from typing import Any, NamedTuple

import torch

from deepspeed_tpu_torch.runtime.bf16_optimizer import (
    GradientTransformation, masked_copy_, step_increment)


class LambState(NamedTuple):
    count: Any   # int32 device scalar
    mu: Any      # [fp32 tensor] per parameter
    nu: Any


def lamb(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
         max_coeff=10.0, min_coeff=0.01, bias_correction=True):
    """LAMB with the clipped trust ratio; `learning_rate` is the default
    when `update` gets no `lr`."""

    def init_fn(params):
        params = list(params)
        dev = params[0].device if params else None
        zeros = lambda: [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in params]
        return LambState(torch.zeros((), dtype=torch.int32, device=dev),
                         zeros(), zeros())

    def update_fn(grads, state, params, lr=None, keep=None):
        if params is None:
            raise ValueError("lamb requires params for the trust ratio")
        lr = learning_rate if lr is None else lr
        state.count.add_(step_increment(keep))
        if bias_correction:
            c = state.count.to(torch.float32)
            c1 = 1.0 - torch.pow(b1, c)
            c2 = 1.0 - torch.pow(b2, c)
        else:
            c1 = c2 = 1.0

        def leaves():
            for g, m, v, p in zip(grads, state.mu, state.nu, params):
                g32 = g.to(torch.float32)
                mu = b1 * m + (1 - b1) * g32
                nu = b2 * v + (1 - b2) * g32 * g32
                masked_copy_(m, mu, keep)
                masked_copy_(v, nu, keep)
                u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
                p32 = p.to(torch.float32)
                if weight_decay:
                    u = u + weight_decay * p32
                w_norm = torch.sqrt(torch.sum(p32 ** 2))
                u_norm = torch.sqrt(torch.sum(u ** 2))
                coeff = torch.clamp(
                    w_norm / torch.where(u_norm == 0, 1.0, u_norm),
                    min_coeff, max_coeff)
                coeff = torch.where((w_norm == 0) | (u_norm == 0), 1.0,
                                    coeff)
                yield -lr * coeff * u

        return leaves(), state

    return GradientTransformation(init_fn, update_fn)


class FusedLamb:
    """Class-style facade mirroring ref `ops/lamb/fused_lamb.py:38`: a
    client optimizer object for `initialize(optimizer=...)`."""

    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0.0, max_grad_norm=0.0, max_coeff=10.0,
                 min_coeff=0.01, amsgrad=False):
        if amsgrad:
            raise RuntimeError("FusedLamb does not support the AMSGrad "
                               "variant.")
        if eps_inside_sqrt:
            raise NotImplementedError(
                "eps_inside_sqrt (adam mode 0) is not implemented; the "
                "reference default (mode 1) is used")
        self.lr = lr
        self.transformation = lamb(
            learning_rate=lr, b1=betas[0], b2=betas[1], eps=eps,
            weight_decay=weight_decay, max_coeff=max_coeff,
            min_coeff=min_coeff, bias_correction=bias_correction)

    def init(self, params):
        return self.transformation.init(params)

    def update(self, grads, state, params=None, lr=None, keep=None):
        return self.transformation.update(grads, state, params, lr=lr,
                                          keep=keep)
