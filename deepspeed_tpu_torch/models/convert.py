"""JAX GPT-2 parameter tree -> the port's flat parameter dict.

The JAX model (deepspeed_tpu/models/gpt2.py) keeps wte/wpe, ln_f and a
single scanned child under "h" whose leaves carry a leading [n_layer]
axis. That child is named "GPT2Block_0" without remat and
"CheckpointGPT2Block_0" with it (same leaves either way). Dense
kernels are [in, out] in both packages, so conversion is an unstack:
no transpose. The tree comes in as nested dicts of numpy arrays (e.g.
`jax.tree_util.tree_map(np.asarray, params)`); this module imports no
JAX.
"""

import numpy as np
import torch

_BLOCK_CHILDREN = ("GPT2Block_0", "CheckpointGPT2Block_0")


def _stacked_child(h):
    if len(h) != 1:
        raise ValueError(f'expected one scanned child under "h", got '
                         f"{sorted(h)}")
    (name, stacked), = h.items()
    if name not in _BLOCK_CHILDREN:
        raise ValueError(f'unexpected child {name!r} under "h" (expected '
                         f"one of {_BLOCK_CHILDREN}; MoE trees are a "
                         "later slice)")
    return stacked


def params_from_jax(tree, dtype=None):
    """{"wte", "wpe", "h.{i}.<module>.<leaf>", "ln_f.scale",
    "ln_f.bias"} -> CPU torch tensors (dtype: keep the tree's, or cast
    to the given torch dtype)."""
    def tensor(x):
        t = torch.from_numpy(np.array(x))
        return t.to(dtype) if dtype is not None else t

    out = {"wte": tensor(tree["wte"]), "wpe": tensor(tree["wpe"])}
    stacked = _stacked_child(tree["h"])
    n_layer = None
    for module, leaves in stacked.items():
        for leaf, value in leaves.items():
            arr = np.asarray(value)
            if n_layer is None:
                n_layer = arr.shape[0]
            elif arr.shape[0] != n_layer:
                raise ValueError(f"{module}.{leaf}: layer axis "
                                 f"{arr.shape[0]} != {n_layer}")
            for i in range(n_layer):
                out[f"h.{i}.{module}.{leaf}"] = tensor(arr[i])
    out["ln_f.scale"] = tensor(tree["ln_f"]["scale"])
    out["ln_f.bias"] = tensor(tree["ln_f"]["bias"])
    return out
