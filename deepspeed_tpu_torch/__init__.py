"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The port lives beside the JAX package and never imports it (nor jax):
modules that it needs from there are kept as trimmed copies. Module
names and layout follow the JAX package so each counterpart is easy to
find. Every Pallas kernel on a ported path has a hand-written CUDA
kernel for Hopper (sm_90a) under `ops/csrc/`, built at first use by
`ops/_build.py`, and a plain PyTorch twin beside its wrapper. A wrapper
takes the twin only for tensors on the CPU; a CUDA tensor launches the
kernel or raises.

Slice 1: GPT-2 inference — the model forward (`models/gpt2.py`) and the
paged-KV serving engine (`inference/`). Slice 2: GPT-2 training —
`initialize()` -> `DeepSpeedEngine` (`runtime/`) with the model's
`loss_fn`, the backward kernels and remat.
"""

from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import logger

__version__ = "0.1.0"

__all__ = ["initialize", "DeepSpeedEngine", "DeepSpeedConfig",
           "resolve_device", "logger", "__version__"]


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, device=None):
    """Build the training engine (deepspeed_tpu.initialize's signature,
    with `device` in place of the mesh). Returns the same 4-tuple:
    (engine, optimizer, training_dataloader, lr_scheduler)."""
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu,
                             dist_init_required=dist_init_required,
                             collate_fn=collate_fn, config=config,
                             config_params=config_params, device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
