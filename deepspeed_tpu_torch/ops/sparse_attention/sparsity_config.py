"""Block-sparsity layout configs: Dense, Fixed, Variable, BigBird,
BSLongformer (the port's own copy of
deepspeed_tpu/ops/sparse_attention/sparsity_config.py, numpy and
`random` only; every config gives the JAX package's layout element for
element).

Parity with `deepspeed/ops/sparse_attention/sparsity_config.py:9,63,94,
243,421,544`: each config builds a boolean layout matrix
[num_heads, T/block, T/block] marking which key blocks each query block
attends to. The patterns are re-derived from their papers (Sparse
Transformers fixed pattern, BigBird random+window+global, Longformer
sliding+dilated+global) rather than ported line-by-line.

The default block is 128, as in the JAX package. The CUDA kernels
(`block_sparse_attention.py`) walk 64-row tiles and take blocks of 16,
32, 64, 128 and 256: a smaller block becomes a bit mask of visible
sub-blocks inside each tile.
"""

import random

import numpy as np


class SparsityConfig:
    """Base class (ref `sparsity_config.py:9`).

    Args:
        num_heads: attention heads (layouts may differ per head).
        block: sparsity block size — layout entries gate block x block
            score tiles (the reference's default is 16).
        different_layout_per_head: give each head its own pattern where
            the pattern has per-head structure.
    """

    def __init__(self, num_heads, block=128, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block "
                f"size {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks),
                        dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks visible (ref `sparsity_config.py:63`) — for testing."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers 'fixed' pattern (ref `sparsity_config.py:94`):
    each block attends to its local window of `num_local_blocks` and to
    'summary' block columns — the last `num_global_blocks` block(s) of
    each preceding local window."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only unidirectional or bidirectional attention is "
                "supported")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional "
                "attention")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and \
                not different_layout_per_head:
            raise ValueError(
                "different global patterns require "
                "different_layout_per_head")
        if num_different_global_patterns > \
                num_local_blocks // num_global_blocks:
            raise ValueError(
                f"only {num_local_blocks // num_global_blocks} different "
                "global patterns are possible")
        self.num_different_global_patterns = num_different_global_patterns

    def _global_block_indices(self, head, window_start):
        """Summary (global) block columns inside one local window."""
        # head h uses the h-th pattern: the global blocks slide within
        # the window across heads (ref fixed pattern's per-head offsets)
        pattern = head % self.num_different_global_patterns
        first = window_start + self.num_local_blocks - \
            (pattern + 1) * self.num_global_blocks
        return range(first, first + self.num_global_blocks)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        for h in range(self.num_layout_heads):
            # local windows
            for start in range(0, num_blocks, self.num_local_blocks):
                end = min(start + self.num_local_blocks, num_blocks)
                for q in range(start, end):
                    if self.attention == "unidirectional":
                        layout[h, q, start:q + 1] = 1
                    else:
                        layout[h, q, start:end] = 1
            # global/summary columns
            for start in range(0, num_blocks, self.num_local_blocks):
                for g in self._global_block_indices(h, start):
                    if not 0 <= g < num_blocks:
                        continue
                    if self.horizontal_global_attention:
                        layout[h, g, :] = 1
                    if self.attention == "unidirectional":
                        # queries after this window see the summary block
                        layout[h, g + 1:, g] = 1
                    else:
                        layout[h, :, g] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Custom local windows + explicit global blocks
    (ref `sparsity_config.py:243`): local window sizes may vary
    (`num_local_blocks` is a list), and `global_block_indices` /
    `global_block_end_indices` pick arbitrary global columns."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional",
                 horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices \
            if global_block_indices is not None else [0]
        if global_block_end_indices is not None:
            if len(global_block_end_indices) != \
                    len(self.global_block_indices):
                raise ValueError(
                    "global_block_end_indices must pair with "
                    "global_block_indices")
            for start, end in zip(self.global_block_indices,
                                  global_block_end_indices):
                if start >= end:
                    raise ValueError(
                        "global block end must exceed its start")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only unidirectional or bidirectional attention is "
                "supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional "
                "attention (full global rows attend to future blocks)")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def _set_local(self, layout, h, num_blocks):
        start = 0
        window_idx = 0
        while start < num_blocks:
            size = self.local_window_blocks[
                min(window_idx, len(self.local_window_blocks) - 1)]
            end = min(start + size, num_blocks)
            for q in range(start, end):
                if self.attention == "unidirectional":
                    layout[h, q, start:q + 1] = 1
                else:
                    layout[h, q, start:end] = 1
            start = end
            window_idx += 1

    def _set_global(self, layout, h, num_blocks):
        cols = []
        if self.global_block_end_indices is None:
            cols = [i for i in self.global_block_indices if i < num_blocks]
        else:
            for start, end in zip(self.global_block_indices,
                                  self.global_block_end_indices):
                cols.extend(range(start, min(end, num_blocks)))
        for g in cols:
            if self.horizontal_global_attention:
                layout[h, g, :] = 1
            if self.attention == "unidirectional":
                layout[h, g:, g] = 1
            else:
                layout[h, :, g] = 1

    def _set_random(self, layout, h, num_blocks, rng):
        for q in range(num_blocks):
            hi = q + 1 if self.attention == "unidirectional" else num_blocks
            if hi <= 0:
                continue
            for _ in range(self.num_random_blocks):
                layout[h, q, rng.randrange(hi)] = 1

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        rng = random.Random(0)  # deterministic layouts across processes
        for h in range(self.num_layout_heads):
            self._set_local(layout, h, num_blocks)
            self._set_global(layout, h, num_blocks)
            if self.num_random_blocks:
                self._set_random(layout, h, num_blocks, rng)
        layout = self.check_and_propagate_first_head_layout(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding-window + global blocks
    (ref `sparsity_config.py:421`)."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only unidirectional or bidirectional attention is "
                "supported")
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        rng = random.Random(0)
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for q in range(num_blocks):
                # sliding window
                lo = max(0, q - w)
                hi = min(num_blocks, q + w + 1)
                if self.attention == "unidirectional":
                    hi = min(hi, q + 1)
                layout[h, q, lo:hi] = 1
                # random blocks
                rand_hi = q + 1 if self.attention == "unidirectional" \
                    else num_blocks
                for _ in range(self.num_random_blocks):
                    layout[h, q, rng.randrange(max(rand_hi, 1))] = 1
            # global: first num_global_blocks rows+cols
            g = min(self.num_global_blocks, num_blocks)
            if self.attention == "unidirectional":
                layout[h, :, :g] = 1
                layout[h, :g, :] = np.tril(
                    np.ones((g, num_blocks), dtype=np.int64))
            else:
                layout[h, :, :g] = 1
                layout[h, :g, :] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding (+dilated) window + global
    (ref `sparsity_config.py:544`)."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices \
            if global_block_indices is not None else [0]
        if global_block_end_indices is not None:
            if len(global_block_end_indices) != \
                    len(self.global_block_indices):
                raise ValueError(
                    "global_block_end_indices must pair with "
                    "global_block_indices")
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for q in range(num_blocks):
                lo = max(0, q - w)
                hi = min(num_blocks, q + w + 1)
                if self.attention == "unidirectional":
                    hi = min(hi, q + 1)
                layout[h, q, lo:hi] = 1
            cols = []
            if self.global_block_end_indices is None:
                cols = [i for i in self.global_block_indices
                        if i < num_blocks]
            else:
                for start, end in zip(self.global_block_indices,
                                      self.global_block_end_indices):
                    cols.extend(range(start, min(end, num_blocks)))
            for g in cols:
                if self.attention == "unidirectional":
                    layout[h, g:, g] = 1        # vertical, causal half
                    layout[h, g, :g + 1] = 1    # horizontal, causal half
                else:
                    layout[h, :, g] = 1
                    layout[h, g, :] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        return layout
