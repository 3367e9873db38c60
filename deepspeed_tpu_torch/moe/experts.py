"""Expert FFNs as grouped GEMMs (port of deepspeed_tpu/moe/experts.py).

`grouped_gemm(x [G, M, K], w [G, K, N])` is one batched product
(`torch.bmm`, cuBLAS) with `pack=False`. `pack=True` keeps the JAX
package's block-diagonal pairing of experts (2g, 2g+1) into one product
of twice the contraction, exact to additions of zeros; it exists to fill
the TPU matrix unit's 128-wide lanes and has no purpose on the card, so
`resolve_pack_experts("auto")` is False there. It stays for parity.

`ExpertFFN` runs the bias + tanh-GeLU epilogue of all E experts as ONE
launch of kernel K4 with a grouped bias [E, F] (`fused_bias_gelu`), where
the JAX package vmaps the fused kernel over the expert dimension; its
backward is one K4-bwd launch with dbias [E, F].

Quantized experts (`quantized="on"`, or "auto" on CUDA): each of the two
projections is one grouped `quantized_dense` (kernel K6 with the expert
as the group, its straight-through backward), where the JAX package
vmaps `quantized_dense` over the experts; weights cast to the compute
dtype first and rounded to nearest, as there.
"""

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.ops.transformer.fused_ops import fused_bias_gelu
from deepspeed_tpu_torch.ops.transformer.quantized_matmul import (
    DEFAULT_QUANT_BLOCK, quantized_dense, resolve_quantized_compute)


def grouped_gemm(x, w, *, pack=True):
    """Batched per-group GEMM: x [G, M, K] @ w [G, K, N] -> [G, M, N].
    pack=True pairs groups block-diagonally (see module docstring);
    pack=False is the plain batched product."""
    g, m, k = x.shape
    gw, kw, n = w.shape
    if gw != g or kw != k:
        raise ValueError(f"grouped_gemm shape mismatch: x {tuple(x.shape)} "
                         f"vs w {tuple(w.shape)}")
    if not pack or g < 2:
        return torch.bmm(x, w)
    gp = g + (g % 2)
    if gp != g:
        x = torch.cat([x, x.new_zeros((1, m, k))])
        w = torch.cat([w, w.new_zeros((1, k, n))])
    xp = torch.cat([x[0::2], x[1::2]], dim=-1)            # [G/2, M, 2K]
    wp = w.new_zeros((gp // 2, 2 * k, 2 * n))
    wp[:, :k, :n] = w[0::2]
    wp[:, k:, n:] = w[1::2]
    yp = torch.bmm(xp, wp)                                 # [G/2, M, 2N]
    y = torch.stack([yp[..., :n], yp[..., n:]], dim=1).reshape(gp, m, n)
    return y[:g]


class ExpertFFN(nn.Module):
    """E parallel FFN experts over dispatched [E, C, H] buffers.
    Parameters (expert dim leading, the JAX package's tree):
    wi [E, H, F], bi [E, F], wo [E, F, H], bo [E, H]."""

    def __init__(self, num_experts, d_model, d_ff, dtype, param_dtype,
                 pack=False, quantized="off", quant_block=DEFAULT_QUANT_BLOCK):
        super().__init__()
        resolve_quantized_compute(quantized)   # ValueError on a bad mode
        self.num_experts, self.d_model, self.d_ff = num_experts, d_model, d_ff
        self.dtype, self.pack = dtype, pack
        self.quantized, self.quant_block = quantized, int(quant_block)
        e = num_experts
        self.wi = nn.Parameter(torch.empty((e, d_model, d_ff),
                                           dtype=param_dtype))
        self.bi = nn.Parameter(torch.empty((e, d_ff), dtype=param_dtype))
        self.wo = nn.Parameter(torch.empty((e, d_ff, d_model),
                                           dtype=param_dtype))
        self.bo = nn.Parameter(torch.empty((e, d_model), dtype=param_dtype))

    def forward(self, xe):
        e, c, h = xe.shape
        if e != self.num_experts or h != self.d_model:
            raise ValueError(f"ExpertFFN expects [E={self.num_experts}, C, "
                             f"H={self.d_model}], got {tuple(xe.shape)}")
        dt = self.dtype
        if resolve_quantized_compute(self.quantized, xe.device):
            def gemm(x, w):
                return quantized_dense(x, w.to(dt), block=self.quant_block,
                                       out_dtype=dt)
        else:
            def gemm(x, w):
                return grouped_gemm(x, w.to(dt), pack=self.pack)
        yi = gemm(xe.to(dt), self.wi)
        # one grouped launch: expert g's rows add bias row g
        act = fused_bias_gelu(yi, self.bi.to(dt), approximate=True,
                              out_dtype=dt)
        yo = gemm(act, self.wo)
        return yo + self.bo.to(dt)[:, None, :]


def expert_ffn_reference(params, xe, dtype=torch.float32):
    """Per-expert loop of single GEMMs with plain bias + tanh-GeLU: the
    parity oracle of grouped_gemm/ExpertFFN. `params` holds wi/bi/wo/bo."""
    outs = []
    for g in range(np.shape(params["wi"])[0]):
        y = xe[g].to(dtype) @ params["wi"][g].to(dtype)
        y = nn.functional.gelu(y + params["bi"][g].to(dtype),
                               approximate="tanh")
        outs.append(y @ params["wo"][g].to(dtype) +
                    params["bo"][g].to(dtype))
    return torch.stack(outs)
