"""Seed streams: one step's host-side seed split into independent
streams (dropout: stream 0 the embedding, i + 1 block i; a block's
stochastic-rounding seed: stream j its projection j, and within a
projection stream 0 the weights, stream 1 the activations).

A stream's generator is built afresh from its seed wherever it is
needed, so a remat recompute and a straight-through backward draw the
forward's numbers again without saving them.
"""

import torch


def stream_seed(seed, index):
    """The seed of stream `index` of `seed` (None without a seed)."""
    if seed is None:
        return None
    return (int(seed) * 1000003 + index) % (1 << 63)


def stream_generator(seed, index, device):
    """A fresh torch.Generator on `device` for stream `index` of `seed`
    (None without a seed)."""
    if seed is None:
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, index))
    return gen
