"""JAX GPT-2 parameter tree <-> the port's flat parameter dict.

The JAX model (deepspeed_tpu/models/gpt2.py) keeps wte/wpe, ln_f and a
single scanned child under "h" whose leaves carry a leading [n_layer]
axis. That child is named "GPT2Block_0" without remat and
"CheckpointGPT2Block_0" with it (same leaves either way; the training
trees of the flagship are remat trees). An MoE tree scans super-cells
instead: dense children "GPT2Block_{j}" (j < every_n_layers - 1) and one
"MoEGPT2Block_0", each with a leading [cells] axis, and "Checkpoint"
before each name under remat. Dense kernels are [in, out] in
both packages, so conversion is an unstack: no transpose. The tree
comes in as nested dicts of numpy arrays (e.g.
`jax.tree_util.tree_map(np.asarray, params)`); a bf16 training tree's
leaves are numpy's `bfloat16` extension dtype, which torch cannot wrap,
so they go through fp32 (exact) to torch.bfloat16. This module imports
no JAX.

`bert_sparse_params_from_jax` carries a `BertSparseSelfAttention` tree
(query/key/value nn.Dense: kernel [in, out], bias) into the port
module's state dict (nn.Linear: weight [out, in], bias).

`params_to_jax` is `params_from_jax`'s inverse: it stacks the port's
per-layer tensors into the scanned children (named for the remat
setting, and cut into MoE cells from the parameter names), as a
checkpoint in the JAX package's layout holds them.

`config_from_jax` carries a JAX `GPT2Config` into the port's.

BERT (`models/bert.py`): the JAX encoder scans one child under
"bert.encoder.layer" ("DeepSpeedTransformerLayer_0", with `core`
beneath it; the memory flags rename nothing), whose leaves carry a
leading [num_hidden_layers] axis. `bert_params_from_jax` unstacks it
into "bert.encoder.layer.{i}.core.<leaf>" and flattens every other
leaf by its path; `bert_params_to_jax` stacks it back; a bf16 tree goes
through fp32, as GPT-2's does. `bert_config_from_jax` carries a JAX
`BertConfig` across.
"""

import dataclasses

import numpy as np
import torch

_BLOCK_CHILDREN = ("GPT2Block_0", "CheckpointGPT2Block_0")
_MOE_CHILDREN = ("MoEGPT2Block_0", "CheckpointMoEGPT2Block_0")


def _dense_index(name):
    """j of a dense child "GPT2Block_{j}" / "CheckpointGPT2Block_{j}",
    else None."""
    for prefix in ("GPT2Block_", "CheckpointGPT2Block_"):
        rest = name[len(prefix):]
        if name.startswith(prefix) and rest.isdigit():
            return int(rest)
    return None


def _layer_children(h):
    """[(first layer, layer stride, stacked subtree)] of the scanned
    children under "h": the dense model's one block child, or an MoE
    tree's cell of (every_n_layers - 1) dense children and one MoE
    child, whose cell c holds layers c * every .. c * every + every - 1
    (the MoE block last)."""
    names = sorted(h)
    moe = [n for n in names if n in _MOE_CHILDREN]
    dense = {n: _dense_index(n) for n in names if n not in _MOE_CHILDREN}
    bad = [n for n, j in dense.items() if j is None]
    if bad or len(moe) > 1 or (not moe and len(names) != 1) or \
            (not moe and names[0] not in _BLOCK_CHILDREN):
        raise ValueError(f'unexpected children {names} under "h" '
                         f"(expected one of {_BLOCK_CHILDREN}, or dense "
                         f"block children and one of {_MOE_CHILDREN})")
    if not moe:
        return [(0, 1, h[names[0]])]
    every = len(dense) + 1
    if sorted(dense.values()) != list(range(every - 1)):
        raise ValueError(f'dense children under "h" are not numbered '
                         f"0..{every - 2}: {sorted(dense)}")
    out = [(j, every, h[n]) for n, j in dense.items()]
    return out + [(every - 1, every, h[moe[0]])]


def _leaves(tree, prefix=""):
    """(dotted path, array) of every leaf of a nested dict."""
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _leaves(value, path + ".")
        else:
            yield path, value


def _tensor(x, dtype=None):
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(dtype) if dtype is not None else t


def params_from_jax(tree, dtype=None):
    """{"wte", "wpe", "h.{i}.<module>.<leaf>", "ln_f.scale",
    "ln_f.bias"} -> CPU torch tensors (dtype: keep the tree's, or cast
    to the given torch dtype). MoE trees give "h.{i}.moe_mlp.wg" and
    "h.{i}.moe_mlp.experts.{wi,bi,wo,bo}" for their MoE layers."""
    def tensor(x):
        return _tensor(x, dtype)

    out = {"wte": tensor(tree["wte"]), "wpe": tensor(tree["wpe"])}
    cells = None
    for first, stride, stacked in _layer_children(tree["h"]):
        for path, value in _leaves(stacked):
            arr = np.array(value)
            if cells is None:
                cells = arr.shape[0]
            elif arr.shape[0] != cells:
                raise ValueError(f"{path}: layer axis {arr.shape[0]} != "
                                 f"{cells}")
            for c in range(cells):
                out[f"h.{first + c * stride}.{path}"] = tensor(arr[c])
    out["ln_f.scale"] = tensor(tree["ln_f"]["scale"])
    out["ln_f.bias"] = tensor(tree["ln_f"]["bias"])
    return out


def _nest(tree, path, value):
    *parents, leaf = path.split(".")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def params_to_jax(params, remat=False, stack=torch.stack):
    """The JAX tree of a flat parameter dict: "h.{i}.<path>" stacked
    over the layers of each scanned child under "h" (`stack` of the
    per-layer values; "Checkpoint" before each child name under
    `remat`), every other dotted name nested as it reads. The layers
    holding "moe_mlp" entries are the MoE blocks: the last of each cell
    of every_n_layers, as `_layer_children` reads them."""
    layers = {}
    tree = {}
    for name, value in params.items():
        head, _, rest = name.partition(".")
        index, _, path = rest.partition(".")
        if head == "h" and index.isdigit() and path:
            layers.setdefault(int(index), {})[path] = value
        else:
            _nest(tree, name, value)
    if not layers:
        return tree
    n = len(layers)
    if sorted(layers) != list(range(n)):
        raise ValueError(f"layers {sorted(layers)} are not 0..{n - 1}")
    moe = [i for i in range(n)
           if any(p.startswith("moe_mlp.") for p in layers[i])]
    prefix = "Checkpoint" if remat else ""
    if not moe:
        children = [(f"{prefix}GPT2Block_0", 0, 1)]
    else:
        every = moe[0] + 1
        if moe != list(range(every - 1, n, every)) or n % every:
            raise ValueError(f"MoE layers {moe} do not close cells of "
                             f"{every} layers over {n}")
        children = [(f"{prefix}GPT2Block_{j}", j, every)
                    for j in range(every - 1)]
        children.append((f"{prefix}MoEGPT2Block_0", every - 1, every))
    tree["h"] = {}
    for child, first, stride in children:
        stacked = {}
        for path in layers[first]:
            _nest(stacked, path, stack([layers[i][path] for i in
                                        range(first, n, stride)]))
        tree["h"][child] = stacked
    return tree


def bert_sparse_params_from_jax(tree, dtype=None):
    """A flax `BertSparseSelfAttention` tree ({"query", "key", "value"},
    each {"kernel" [in, out], "bias"}, optionally under "params") ->
    the port module's state dict {"query.weight" [out, in],
    "query.bias", ...} as CPU tensors (for `load_state_dict`)."""
    tree = tree.get("params", tree)
    out = {}
    for name in ("query", "key", "value"):
        out[f"{name}.weight"] = _tensor(tree[name]["kernel"], dtype).t() \
            .contiguous()
        out[f"{name}.bias"] = _tensor(tree[name]["bias"], dtype)
    return out


def _torch_dtype(dtype):
    """A jnp/numpy dtype (or dtype class) -> the torch dtype of its
    name."""
    return getattr(torch, np.dtype(dtype).name)


def config_from_jax(jcfg, sp_group=None, **overrides):
    """The port's `GPT2Config` for a JAX `GPT2Config`: every field carried
    across by name, jnp dtypes as torch's, the `MoEConfig` rebuilt in the
    port without its mesh, and `sequence_parallel` kept with `sp_group` (a
    torch.distributed process group, None for WORLD) in place of the
    JAX `sp_mesh` and `sp_axis`. `overrides` replace fields after that."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.moe.layer import MoEConfig
    fields = {}
    for f in dataclasses.fields(GPT2Config):
        if f.name == "sp_group" or not hasattr(jcfg, f.name):
            continue
        value = getattr(jcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            value = _torch_dtype(value)
        elif f.name == "moe" and value is not None:
            value = MoEConfig(**{g.name: getattr(value, g.name)
                                 for g in dataclasses.fields(MoEConfig)
                                 if g.name != "mesh"})
        fields[f.name] = value
    fields["sp_group"] = sp_group
    fields.update(overrides)
    return GPT2Config(**fields)


_BERT_LAYER_CHILD = "DeepSpeedTransformerLayer_0"
_BERT_LAYERS = "bert.encoder.layer."


def bert_params_from_jax(tree, dtype=None):
    """A JAX `BertForPreTrainingLM` tree (nested dicts of numpy arrays)
    -> the port's flat parameter dict of CPU tensors (dtype: keep the
    tree's, or cast to the given torch dtype)."""
    layer = tree["bert"]["encoder"]["layer"]
    if sorted(layer) != [_BERT_LAYER_CHILD]:
        raise ValueError(f'unexpected children {sorted(layer)} under '
                         f'"bert.encoder.layer" (expected '
                         f'["{_BERT_LAYER_CHILD}"])')
    out = {}
    for path, value in _leaves(tree):
        if path.startswith(_BERT_LAYERS):
            continue
        out[path] = _tensor(value, dtype)
    stacked = list(_leaves(layer[_BERT_LAYER_CHILD]))
    n = {np.shape(v)[0] for _, v in stacked}
    if len(n) != 1:
        raise ValueError(f"encoder leaves disagree on the layer axis: {n}")
    for path, value in stacked:
        arr = np.array(value)
        for i in range(arr.shape[0]):
            out[f"{_BERT_LAYERS}{i}.{path}"] = _tensor(arr[i], dtype)
    return out


def bert_params_to_jax(params, stack=torch.stack):
    """`bert_params_from_jax`'s inverse: "bert.encoder.layer.{i}.<path>"
    stacked over the layers (`stack` of the per-layer values) under the
    scanned child, every other dotted name nested as it reads."""
    layers = {}
    tree = {}
    for name, value in params.items():
        if name.startswith(_BERT_LAYERS):
            index, _, path = name[len(_BERT_LAYERS):].partition(".")
            layers.setdefault(int(index), {})[path] = value
        else:
            _nest(tree, name, value)
    n = len(layers)
    if sorted(layers) != list(range(n)):
        raise ValueError(f"layers {sorted(layers)} are not 0..{n - 1}")
    stacked = {}
    for path in layers[0] if n else ():
        _nest(stacked, path, stack([layers[i][path] for i in range(n)]))
    tree.setdefault("bert", {}).setdefault("encoder", {})["layer"] = {
        _BERT_LAYER_CHILD: stacked}
    return tree


def bert_config_from_jax(jcfg, **overrides):
    """The port's `BertConfig` for a JAX `BertConfig`: every field carried
    across by name; `overrides` replace fields after that."""
    from deepspeed_tpu_torch.models.bert import BertConfig
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(BertConfig)
              if hasattr(jcfg, f.name)}
    fields.update(overrides)
    return BertConfig(**fields)


def optimizer_state_to_jax(engine):
    """{keystr: numpy array} of a training engine's optimizer state in
    the JAX engine's layout, the tree its checkpoints write (optax's
    `InjectStatefulHyperparamsState` over Adam's, LAMB's or SGD's state,
    or `OnebitAdamState`; the scanned layers stacked), for a leaf by leaf
    comparison with a JAX engine's `opt_state`."""
    from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io
    state = engine.state
    leaves = state.master if engine.mixed_precision else \
        list(state.params.values())
    _, tree = engine._ckpt_trees(leaves, state.opt_state,
                                 engine._injected_lr(), engine._remat())
    out = {}
    for key, value in ckpt_io.tree_to_entries(tree, ""):
        if isinstance(value, ckpt_io.Stacked):
            value = torch.stack(list(value))
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().float().numpy()
        out[key] = np.asarray(value)
    return out
