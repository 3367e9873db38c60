"""The transformer ops (port of deepspeed_tpu/ops/transformer): the fused
layer and the kernel entry points it runs on.

The JAX package's `__init__` also exports the functions `flash_attention`
and `quantized_matmul`, whose names shadow their modules there. Here the
modules keep those names (`ops.transformer.flash_attention.flash_attention`
is the function), so `from deepspeed_tpu_torch.ops.transformer import
flash_attention` gives the module, as the port's callers expect.
"""

from deepspeed_tpu_torch.ops.transformer.transformer import (
    DeepSpeedTransformerLayer, DeepSpeedTransformerConfig)
from deepspeed_tpu_torch.ops.transformer.flash_attention import \
    flash_attention_usable
from deepspeed_tpu_torch.ops.transformer.fused_ops import (
    fused_bias_gelu, fused_bias_residual_layernorm, resolve_fused_ops)
from deepspeed_tpu_torch.ops.transformer.quantized_matmul import (
    quantized_dense, resolve_quantized_compute)

__all__ = ["DeepSpeedTransformerLayer", "DeepSpeedTransformerConfig",
           "flash_attention_usable", "fused_bias_gelu",
           "fused_bias_residual_layernorm", "resolve_fused_ops",
           "quantized_dense", "resolve_quantized_compute"]
