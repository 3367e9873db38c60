"""In-situ A/B correctness harness (port of
deepspeed_tpu/runtime/correctness.py), the runtime counterpart of the
reference's `pg_correctness_test` toggle (`stage2.py:25,1060`).

A shadow engine runs the same model and batches under the plainest
configuration (ZeRO-0, fp32, no loss scaling) beside the primary, and
the harness compares their loss trajectories (and optionally parameter
norms) every `interval` steps, logging or raising on divergence.
Agreement certifies the primary's runtime path end to end: mixed
precision, masters, loss scaling, accumulation and the update.

Usage:

    checker = ABCorrectnessChecker(
        model, params,
        primary_config={..., "zero_optimization": {"stage": 2},
                        "bf16": {"enabled": True}},
        interval=10, loss_atol=0.05)
    for batch in data:
        loss = checker.train_batch(batch=batch)   # steps BOTH engines
    checker.report()
"""

import copy

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.prefetch import stack_microbatches
from deepspeed_tpu_torch.utils.logging import logger


class DivergenceError(AssertionError):
    pass


class ABCorrectnessChecker:
    """Steps a primary (mixed-precision) engine and a plain fp32 ZeRO-0
    shadow engine on identical batches and compares.

    interval: compare every N steps (the comparison reads both losses
    on the host; the steps between do not). loss_atol: absolute loss
    tolerance (bf16 primaries drift by rounding; fp32 primaries agree to
    ~1e-5). param_rtol: when set, also compares global parameter norms
    at each check. raise_on_divergence: raise DivergenceError instead of
    logging a warning.

    Scope note: the shadow strips the ENGINE's mixed-precision and ZeRO
    config, but a model whose own config fixes a low-precision compute
    dtype (e.g. GPT2Config(dtype=torch.bfloat16)) computes in that dtype
    on BOTH sides: the A/B then certifies the runtime path (masters,
    scaling, update), not the model's compute precision. Build the model
    in fp32 to A/B precision as well."""

    def __init__(self, model, params, primary_config, device=None,
                 interval=10, loss_atol=0.05, param_rtol=None,
                 raise_on_divergence=True):
        from deepspeed_tpu_torch import initialize

        ref_config = copy.deepcopy(primary_config)
        ref_config["zero_optimization"] = {"stage": 0}
        for key in ("fp16", "bf16", "bfloat16", "amp"):
            ref_config.pop(key, None)
        self.primary, _, _, _ = initialize(
            model=model, model_parameters=params,
            config=primary_config, device=device)
        self.reference, _, _, _ = initialize(
            model=model, model_parameters=params,
            config=ref_config, device=device)
        self.interval = max(1, int(interval))
        self.loss_atol = loss_atol
        self.param_rtol = param_rtol
        self.raise_on_divergence = raise_on_divergence
        self.steps = 0
        self.checks = 0
        self.max_loss_gap = 0.0
        self.max_param_gap = 0.0

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _param_norm(engine):
        total = 0.0
        for leaf in engine.state.params.values():
            x = leaf.detach().to("cpu", torch.float64)
            total += float((x ** 2).sum())
        return float(np.sqrt(total))

    def _diverged(self, msg):
        if self.raise_on_divergence:
            raise DivergenceError(msg)
        logger.warning(msg)

    # -- API -------------------------------------------------------------
    def train_batch(self, data_iter=None, batch=None):
        """Step both engines; compare at the configured interval;
        returns the PRIMARY engine's loss."""
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs data_iter or batch")
            gas = self.primary.gradient_accumulation_steps()
            batch = stack_microbatches([next(data_iter)
                                        for _ in range(gas)])
        loss_p = self.primary.train_batch(batch=batch)
        loss_r = self.reference.train_batch(batch=batch)
        self.steps += 1
        if self.steps % self.interval == 0:
            lp = float(loss_p)
            lr = float(loss_r)
            gap = abs(lp - lr)
            self.checks += 1
            if np.isfinite(gap):
                self.max_loss_gap = max(self.max_loss_gap, gap)
            # NaN compares False against everything: a NaN on EITHER
            # side must trip the checker
            if not np.isfinite(lp) or not np.isfinite(lr) or \
                    gap > self.loss_atol:
                self._diverged(
                    f"A/B divergence at step {self.steps}: primary loss "
                    f"{lp:.6f} vs fp32 reference {lr:.6f} "
                    f"(|gap| {gap:.6f} > atol {self.loss_atol})")
            if self.param_rtol is not None:
                np_, nr = (self._param_norm(self.primary),
                           self._param_norm(self.reference))
                rgap = abs(np_ - nr) / max(abs(nr), 1e-12)
                self.max_param_gap = max(self.max_param_gap, rgap)
                if rgap > self.param_rtol:
                    self._diverged(
                        f"A/B param-norm divergence at step "
                        f"{self.steps}: {np_:.6f} vs {nr:.6f} "
                        f"(rel {rgap:.2e} > rtol {self.param_rtol})")
        return loss_p

    def report(self):
        summary = {"steps": self.steps, "checks": self.checks,
                   "max_loss_gap": round(self.max_loss_gap, 6),
                   "max_param_rel_gap": round(self.max_param_gap, 8)}
        logger.info(f"A/B correctness: {summary}")
        return summary
