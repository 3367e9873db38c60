"""SparseSelfAttention + BertSparseSelfAttention modules (port of
deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py).

Parity with `deepspeed/ops/sparse_attention/sparse_self_attention.py:14-164`
and `bert_sparse_self_attention.py:9`. Without masks the whole chain is
one block-sparse flash call (`block_sparse_attention`: kernels K7 on the
card, their twins on the CPU), with the JAX package's layout cache keyed
on sequence length. With masks (rpe, key padding, attention mask) it is
the JAX package's masked path, which that package leaves to XLA: the
layout, the causal triangle and the masks folded into one additive mask
for `dense_attention` (plain torch, fp32 scores).
"""

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
    NEG_INF, block_sparse_attention, layout_to_dense_mask)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig)
from deepspeed_tpu_torch.ops.transformer.flash_attention import \
    dense_attention
from deepspeed_tpu_torch.utils.device import resolve_device


class SparseSelfAttention:
    """Applies block-sparse scaled-dot-product attention
    (ref `sparse_self_attention.py:14`).

    Call with q, k, v of shape [B, T, H, D] (the reference uses
    [B, H, T, D]; BTHD is the JAX package's layout, kept here). The
    tensors' device decides the route: CUDA tensors launch the kernels.
    """

    # layout cache shared across instances (ref `master_layout` caching)
    _layout_cache = {}

    def __init__(self, sparsity_config=None, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length=2048,
                 head_packing="auto"):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=4)
        if key_padding_mask_mode not in ("add", "mul") or \
                attn_mask_mode not in ("add", "mul"):
            raise ValueError("mask modes must be 'add' or 'mul'")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        # forwarded to block_sparse_attention, which validates it; the
        # sparse kernels run unpacked regardless
        self.head_packing = head_packing

    def get_layout(self, seq_len):
        key = (id(type(self.sparsity_config)),
               self.sparsity_config.num_heads, self.sparsity_config.block,
               seq_len, repr(sorted(self.sparsity_config.__dict__.items(),
                                    key=lambda kv: kv[0])))
        if key not in self._layout_cache:
            self._layout_cache[key] = \
                self.sparsity_config.make_layout(seq_len)
        return self._layout_cache[key]

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None, causal=False):
        if query.dtype not in (torch.float32, torch.bfloat16,
                               torch.float16):
            raise TypeError(f"query dtype {query.dtype} not supported")
        b, t, h, d = query.shape
        layout = self.get_layout(t)
        block = self.sparsity_config.block

        if rpe is None and key_padding_mask is None and attn_mask is None:
            return block_sparse_attention(
                query, key, value, layout, block, causal=causal,
                head_packing=self.head_packing)

        # masked path: fold the layout, the causal triangle and the masks
        # into one additive fp32 mask (NEG_INF where any hides a score)
        # and run the dense math (exact, but O(T^2) memory — the
        # reference's mask support has the same cost in its sparse
        # softmax, `softmax.py:17-304`)
        dev = query.device
        visible = torch.as_tensor(layout_to_dense_mask(layout, t, block),
                                  device=dev)[None]
        if causal:
            visible = visible & torch.ones((t, t), dtype=torch.bool,
                                           device=dev).tril()
        bias = torch.zeros((), dtype=torch.float32, device=dev)
        if rpe is not None:
            bias = bias + rpe.to(torch.float32)
        masks = []
        if key_padding_mask is not None:
            masks.append((key_padding_mask[:, None, None, :],
                          self.key_padding_mask_mode))
        if attn_mask is not None:
            masks.append((attn_mask.reshape((1,) * (4 - attn_mask.ndim) +
                                            tuple(attn_mask.shape)),
                          self.attn_mask_mode))
        for m, mode in masks:
            m = m.to(torch.float32)
            if mode == "add":
                bias = bias + m
            else:
                visible = visible & (m != 0)
        mask = torch.where(visible, bias,
                           torch.full((), NEG_INF, device=dev))
        return dense_attention(query, key, value, mask=mask)


class BertSparseSelfAttention(nn.Module):
    """BERT-style self-attention block with block-sparse scores
    (ref `bert_sparse_self_attention.py:9`): `query`/`key`/`value`
    projections (nn.Linear, fp32 parameters on `device`, computed in
    `dtype` as flax's nn.Dense(dtype=...) does), then SparseSelfAttention
    with the attention mask in "mul" mode. The projections start as
    flax's nn.Dense does: lecun-normal weights (a normal truncated at two
    standard deviations, variance 1 / fan_in) and zero biases, drawn from
    a torch generator seeded with `seed` (torch's draws, not JAX's)."""

    def __init__(self, hidden_size, num_attention_heads,
                 sparsity_config=None, dtype=torch.float32, device="cuda",
                 seed=0):
        super().__init__()
        if hidden_size % num_attention_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_attention_heads {num_attention_heads}")
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.dtype = dtype
        dev = resolve_device(device)
        self.query, self.key, self.value = (
            nn.Linear(hidden_size, hidden_size, device=dev)
            for _ in range(3))
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        # flax's truncated_normal(-2, 2) scaled so the variance is
        # 1 / fan_in: its std divided by the truncated unit normal's std
        std = (1.0 / hidden_size) ** 0.5 / 0.87962566103423978
        with torch.no_grad():
            for lin in (self.query, self.key, self.value):
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=gen)
                lin.bias.zero_()
        self.sparse_attn = SparseSelfAttention(
            sparsity_config=sparsity_config or
            FixedSparsityConfig(num_heads=num_attention_heads),
            key_padding_mask_mode="add", attn_mask_mode="mul")

    def forward(self, hidden_states, attention_mask=None):
        b, t, _ = hidden_states.shape
        nh = self.num_attention_heads
        x = hidden_states.to(self.dtype)

        def project(lin):
            y = F.linear(x, lin.weight.to(self.dtype),
                         lin.bias.to(self.dtype))
            return y.reshape(b, t, nh, self.hidden_size // nh)

        ctx = self.sparse_attn(project(self.query), project(self.key),
                               project(self.value), attn_mask=attention_mask)
        return ctx.reshape(b, t, self.hidden_size)
