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
`loss_fn`, the backward kernels and remat. Later slices: MoE,
quantized compute, block-sparse attention, and sequence parallelism
(`ops/sequence/`, over the process groups `init_distributed` sets up),
checkpoints in the JAX package's on-disk layout
(`runtime/checkpoint.py`, the engine's `save_checkpoint` and
`load_checkpoint`), BERT pretraining on the fused transformer layer
(`DeepSpeedTransformerLayer` / `DeepSpeedTransformerConfig`, re-exported
here as in the JAX package; `models/bert.py`; `module_inject/`), and fp16
training with dynamic loss scaling (`runtime/fp16/`), LAMB
(`ops/lamb/`), SGD, 1-bit Adam, client optimizer and scheduler objects
and progressive layer drop; the named remat policies and the
user-facing activation checkpointing (`checkpointing`, the module
alias of `runtime/activation_checkpointing/checkpointing.py`, as in the
JAX package), the `async_dispatch` block with `runtime/prefetch.py`,
`runtime/utils.py`, the A/B checker (`runtime/correctness.py`) and
`add_config_arguments`.
"""

import argparse

from deepspeed_tpu_torch.ops.transformer import (
    DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.distributed import init_distributed
from deepspeed_tpu_torch.utils.logging import logger
# `deepspeed.checkpointing` module alias (the activation-checkpointing
# module at package level, as in the JAX package)
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing  # noqa: F401

__version__ = "0.1.0"

__all__ = ["initialize", "DeepSpeedEngine", "DeepSpeedConfig",
           "DeepSpeedTransformerLayer", "DeepSpeedTransformerConfig",
           "init_distributed", "resolve_device", "logger", "checkpointing",
           "add_config_arguments", "__version__"]


def _add_core_arguments(parser):
    """--deepspeed family of args (ref `__init__.py:142-175`)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag to user code)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file.")
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Discover launch info from MPI environment")
    return parser


def add_config_arguments(parser: argparse.ArgumentParser):
    """Update an argument parser with DeepSpeed's args (ref
    `__init__.py:193`)."""
    return _add_core_arguments(parser)


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
