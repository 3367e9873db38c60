"""Standalone block-sparse MatMul (port of
deepspeed_tpu/ops/sparse_attention/matmul.py).

Counterpart of the reference's Triton block-sparse matmul
(`deepspeed/ops/sparse_attention/matmul.py:16-750`): the same three
modes over the same data format —

    sdd   sparse = dense  x dense
    dsd   dense  = sparse x dense
    dds   dense  = dense  x sparse

with dense tensors shaped [batch, heads, M, N] and sparse tensors in
the compact block format [batch, nnz, block, block], where nnz
enumerates `layout.nonzero()` in (head, block_row, block_col)
lexicographic order (the reference's LUT order).

Plain torch, as the JAX package leaves it to XLA (no Pallas kernel): the
nonzero blocks become one batched matmul over a gathered [batch, nnz,
...] operand, and dense outputs sum over the nnz axis with `index_add`
(JAX's `segment_sum`). Autograd supplies the backward.
"""

import numpy as np
import torch


def _layout_indices(layout):
    """layout [H, R, C] -> (h_idx, r_idx, c_idx) in the reference's
    lexicographic nonzero order."""
    lay = np.asarray(layout)
    if lay.ndim != 3:
        raise ValueError(f"layout must be [heads, rows, cols] 3-D, got "
                         f"shape {lay.shape}")
    h, r, c = np.nonzero(lay)
    return (torch.as_tensor(h, dtype=torch.long),
            torch.as_tensor(r, dtype=torch.long),
            torch.as_tensor(c, dtype=torch.long))


def _seg_sum(data, seg_ids, num_segments):
    """Sum of [B, nnz, ...] over the nnz axis into `num_segments`
    segments: [B, num_segments, ...]."""
    out = data.new_zeros((data.shape[0], num_segments) + data.shape[2:])
    return out.index_add_(1, seg_ids.to(data.device), data)


def to_sparse(dense, layout, block):
    """[B, H, R*block, C*block] dense -> [B, nnz, block, block] compact
    (the inverse of `to_dense`; test/interop helper)."""
    h, r, c = _layout_indices(layout)
    b = dense.shape[0]
    H, R, C = np.asarray(layout).shape
    x = dense.reshape(b, H, R, block, C, block).permute(0, 1, 2, 4, 3, 5)
    return x[:, h, r, c]


def to_dense(sparse, layout, block, fill=0.0):
    """[B, nnz, block, block] compact -> [B, H, R*block, C*block]."""
    h, r, c = _layout_indices(layout)
    H, R, C = np.asarray(layout).shape
    b = sparse.shape[0]
    out = torch.full((b, H * R * C, block, block), fill, dtype=sparse.dtype,
                     device=sparse.device)
    out[:, (h * R * C + r * C + c).to(sparse.device)] = sparse
    out = out.reshape(b, H, R, C, block, block)
    return out.permute(0, 1, 2, 4, 3, 5).reshape(b, H, R * block, C * block)


class MatMul:
    """Block-sparse matmul over a fixed layout (ref `matmul.py:616`).

    Arguments match the reference: layout [heads, blocks, blocks] 0/1;
    block size; mode in {'sdd','dsd','dds'}; trans_a/trans_b transpose
    the corresponding operand (for the sparse operand this transposes
    each block AND swaps its row/column placement — the layout the
    caller passes is always the layout of the UNtransposed operand)."""

    def __init__(self, layout, block, mode, trans_a=False, trans_b=False):
        if mode not in ("sdd", "dsd", "dds"):
            raise NotImplementedError("Supported modes are: sdd, dsd, dds")
        self.layout = np.asarray(layout)
        self.block = int(block)
        self.mode = mode
        self.trans_a = trans_a
        self.trans_b = trans_b
        self.spdims = self.layout.shape
        self._h, self._r, self._c = _layout_indices(self.layout)

    # -- gathers ---------------------------------------------------------
    def _dense_rows(self, x, h, r):
        """x [B, H, M, K] -> [B, nnz, block, K] (block-rows r of head h)."""
        b, H, m, k = x.shape
        xr = x.reshape(b, H, m // self.block, self.block, k)
        return xr[:, h.to(x.device), r.to(x.device)]

    def _dense_cols(self, x, h, c):
        """x [B, H, K, N] -> [B, nnz, K, block] (block-cols c of head h)."""
        b, H, k, n = x.shape
        xc = x.reshape(b, H, k, n // self.block, self.block)
        return xc.movedim(3, 2)[:, h.to(x.device), c.to(x.device)]

    def __call__(self, a, b):
        bs = self.block
        H, R, C = self.spdims
        h, r, c = self._h, self._r, self._c

        if self.mode == "sdd":
            ad = a.transpose(-1, -2) if self.trans_a else a
            bd = b.transpose(-1, -2) if self.trans_b else b
            a_r = self._dense_rows(ad, h, r)           # [B, z, bs, K]
            b_c = self._dense_cols(bd, h, c)           # [B, z, K, bs]
            return torch.matmul(a_r, b_c)

        if self.mode == "dsd":
            # a sparse [B, nnz, bs, bs]; out rows follow a's layout rows
            # (or cols when trans_a)
            blk = a.transpose(-1, -2) if self.trans_a else a
            row, col = (c, r) if self.trans_a else (r, c)
            nrows = C if self.trans_a else R
            bd = b.transpose(-1, -2) if self.trans_b else b
            b_r = self._dense_rows(bd, h, col)         # [B, z, bs, N]
            prod = torch.matmul(blk, b_r)
            out = _seg_sum(prod, h * nrows + row, H * nrows)
            bsz, _, _, n = prod.shape
            return out.reshape(bsz, H, nrows * bs, n)

        # dds: b sparse; out cols follow b's layout cols (or rows when
        # trans_b)
        blk = b.transpose(-1, -2) if self.trans_b else b
        row, col = (c, r) if self.trans_b else (r, c)
        ncols = R if self.trans_b else C
        ad = a.transpose(-1, -2) if self.trans_a else a
        a_c = self._dense_cols(ad, h, row)             # [B, z, M, bs]
        prod = torch.matmul(a_c, blk)
        out = _seg_sum(prod, h * ncols + col, H * ncols)  # [B, H*nc, M, bs]
        bsz, _, m, _ = prod.shape
        out = out.reshape(bsz, H, ncols, m, bs)
        return out.movedim(2, 3).reshape(bsz, H, m, ncols * bs)
