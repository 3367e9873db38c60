"""int8 weight-only quantization for serving (port of
deepspeed_tpu/inference/quant.py), over the shared quantized-matmul
primitive (`ops/transformer/quantized_matmul.py`): one scale layout and
one epilogue for serving and the training family.

Each projection kernel [K, N] of the port's flat parameter dict
(`h.{i}.c_attn.kernel`, ... : the JAX tree's stacked [L, K, N] kernels
one layer at a time) is quantized once, at engine load, to symmetric
int8 values with one fp32 scale per (block of K, output column): scale
= max-abs / 127 over the block. The engine's projections then run the
epilogue

    y[.., n] = sum_b ( x[.., b*blk:(b+1)*blk] @ q[b] ) * scale[b, n]

(`int8_matmul`). wte, wpe and the LayerNorms stay in full precision:
they are gathers and vector ops, and the tied wte is also the head,
where quantization error would land directly on the logits.

The quantizer runs on the tensors' device (the card at load), and its
values and scales equal the JAX package's numpy quantizer bit for bit
(tests/test_torch_inference_int8.py).
"""

import torch

# int8_matmul: the epilogue, re-exported under the JAX module's names
from deepspeed_tpu_torch.ops.transformer.quantized_matmul import (  # noqa
    int8_matmul, quantize_kernel_int8)

# the parameter-name suffix marking a quantized kernel's scales; its
# presence switches the engine's projection onto the epilogue
KERNEL_SCALE = "kernel_scale"

# the projection submodules whose kernels quantize (GPT-2 block naming;
# wte/wpe/ln_* stay full precision)
QUANT_KERNEL_MODULES = ("c_attn", "c_proj", "c_fc", "mlp_c_proj")


def is_quant_kernel(name):
    """True for a flat name `h.{i}.<module>.kernel` of a projection that
    quantizes."""
    parts = name.split(".")
    return len(parts) == 4 and parts[0] == "h" and parts[3] == "kernel" \
        and parts[2] in QUANT_KERNEL_MODULES


def quantize_param_tree(params, block):
    """Copy of a flat GPT-2 parameter dict with every projection kernel
    under QUANT_KERNEL_MODULES replaced by its int8 values [K, N] and a
    `<module>.kernel_scale` entry [nb, N] beside it (the JAX package's
    layout: values cut to K rows, raw scales). Everything else is the
    same object."""
    out = {}
    for name, value in params.items():
        if is_quant_kernel(name):
            w = torch.as_tensor(value)
            q, s = quantize_kernel_int8(w, block)
            # the JAX layout keeps an all-zero block's scale at 0 (the
            # product clamps it to 1 itself); a block's values are all 0
            # exactly when the block is
            zero = q.reshape(s.shape[:-1] + (block, s.shape[-1])).eq(
                0).all(dim=-2)
            out[name] = q[..., :w.shape[-2], :]
            out[name[:-len("kernel")] + KERNEL_SCALE] = torch.where(
                zero, 0.0, s)
        else:
            out[name] = value
    return out
