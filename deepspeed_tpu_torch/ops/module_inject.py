"""The module-injection API under `ops`, as the reference ships it twice
(`deepspeed/ops/module_inject.py` beside `deepspeed/module_inject/`):
a re-export of the one implementation."""

from deepspeed_tpu_torch.module_inject.replace_module import (  # noqa: F401
    replace_transformer_layer, revert_transformer_layer, replace_module)
