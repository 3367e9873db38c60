"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The port lives beside the JAX package and never imports it (nor jax):
modules that it needs from there are kept as trimmed copies. Module
names and layout follow the JAX package so each counterpart is easy to
find. Every Pallas kernel on a ported path has a hand-written CUDA
kernel for Hopper (sm_90a) under `ops/csrc/`, built at first use by
`ops/_build.py`, and a plain PyTorch twin beside its wrapper. A wrapper
takes the twin only for tensors on the CPU; a CUDA tensor launches the
kernel or raises.

Slice 1 (this package so far): GPT-2 inference — the model forward
(`models/gpt2.py`) and the paged-KV serving engine (`inference/`).
"""

from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import logger

__version__ = "0.1.0"

__all__ = ["resolve_device", "logger", "__version__"]
