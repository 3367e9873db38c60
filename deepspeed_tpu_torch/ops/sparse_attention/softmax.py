"""Standalone block-sparse Softmax over the compact block format (port
of deepspeed_tpu/ops/sparse_attention/softmax.py).

Counterpart of the reference's Triton sparse softmax
(`deepspeed/ops/sparse_attention/softmax.py:17-304`): normalizes each
QUERY ROW across every visible key block of that row in a
[batch, nnz, block, block] tensor, with the same optional masks —
relative position embedding, key padding mask [B, seq], attention mask
[seq, seq], each in 'add' or 'mul' mode.

Plain torch, as the JAX package leaves it to XLA: a row's blocks are
scattered along the nnz axis, so the row-wise max and sum reduce over
segments keyed by (head, block_row) (`scatter_reduce`/`index_add`, JAX's
`segment_max`/`segment_sum`). Autograd supplies the backward.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.ops.sparse_attention.matmul import _layout_indices

_NEG = -1e30


class Softmax:
    """Block-sparse softmax over a fixed layout (ref `softmax.py:219`)."""

    def __init__(self, layout, block):
        self.layout = np.asarray(layout)
        self.block = int(block)
        self.spdims = self.layout.shape
        self._h, self._r, self._c = _layout_indices(self.layout)

    def __call__(self, x, scale=1.0, rpe=None, key_padding_mask=None,
                 attn_mask=None, key_padding_mask_mode="add",
                 attn_mask_mode="add"):
        """x: [B, nnz, block, block] scores in compact block format.

        scale multiplies x first; rpe (broadcastable to x, compact
        format) adds; key_padding_mask [B, seq_k] and attn_mask
        [seq_q, seq_k] apply per their mode ('add' before softmax, or
        'mul' zeroing: 0-entries become -inf). Rows with no surviving
        entries return 0 probabilities (not NaN)."""
        bs = self.block
        H, R, C = self.spdims
        dev = x.device
        h, r, c = (i.to(dev) for i in (self._h, self._r, self._c))
        neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
        xs = x.to(torch.float32) * scale
        if rpe is not None:
            xs = xs + rpe.to(torch.float32)

        if key_padding_mask is not None:
            # gather each block's key columns: [B, nnz, bs]
            kpm = key_padding_mask.to(torch.float32)
            kcols = kpm.reshape(kpm.shape[0], C, bs)[:, c]
            if key_padding_mask_mode == "add":
                xs = xs + kcols[:, :, None, :]
            else:
                xs = torch.where(kcols[:, :, None, :] == 0, neg, xs)
        if attn_mask is not None:
            am = attn_mask.to(torch.float32)
            blocks = am.reshape(R, bs, C, bs).permute(0, 2, 1, 3)[r, c]
            if attn_mask_mode == "add":
                xs = xs + blocks[None]
            else:
                xs = torch.where(blocks[None] == 0, neg, xs)

        # row-wise softmax across this row's blocks (segments over nnz);
        # an empty or all-masked row's max saturates at _NEG
        seg = h * R + r
        b = xs.shape[0]
        rowmax = xs.amax(dim=-1)                            # [B, z, bs]
        gmax = torch.full((b, H * R, bs), _NEG, dtype=torch.float32,
                          device=dev)
        gmax = gmax.scatter_reduce(
            1, seg[None, :, None].expand(b, -1, bs), rowmax, "amax")
        p = torch.exp(xs - gmax[:, seg][..., None])
        # entries pushed to -inf by a mask contribute 0 probability even
        # when the whole row is masked (gmax saturates at _NEG there and
        # exp(0) would otherwise resurrect them)
        p = torch.where(xs > _NEG / 2, p, torch.zeros((), device=dev))
        rowsum = p.sum(dim=-1)                              # [B, z, bs]
        gsum = torch.zeros((b, H * R, bs), dtype=torch.float32,
                           device=dev).index_add_(1, seg, rowsum)
        denom = gsum[:, seg][..., None]
        p = torch.where(denom > 0, p / denom.clamp(min=1e-30),
                        torch.zeros((), device=dev))
        return p.to(x.dtype)
