"""Checkpoint file I/O (port of deepspeed_tpu/runtime/checkpoint.py).

The on-disk layout is the JAX package's, byte for byte in its
conventions, so a checkpoint written by either package loads in the
other:

    <save_dir>/<tag>/mp_rank_00_model_states.npz (+ .json manifest)
    <save_dir>/<tag>/zero_pp_rank_{k}_mp_rank_00optim_states.npz (+ .json)
    <save_dir>/<tag>/zero_pp_rank_{k}_mp_rank_00model_states.npz (+ .json)
    <save_dir>/latest                      (pointer file)

Entries are named by the JAX package's tree paths (`jax.tree_util.keystr`:
`['key']` for a dict entry, `[i]` for a tuple item, `.name` for a
NamedTuple field), which `tree_to_entries` reproduces over nested dicts,
tuples and NamedTuples without JAX. A leaf may be a torch tensor, a
numpy array, or a `Stacked` list of equal-shape parts written as one
array with a new leading axis (the JAX package's scanned layers).

The port runs at data-parallel world size 1, so it writes no
`zero_pp_rank_*` shard buckets: every leaf goes to the model-states file,
where the JAX package puts its fully replicated leaves. The loader still
reassembles the bucket files a sharded JAX save writes (`_assemble`).

The npz is np.savez's format, written and read one buffer per member
(`_savez`, `_load_npz`), so a writer thread beside the training loop
holds the GIL only briefly.

bf16 leaves are written as their uint16 bit pattern with "bfloat16" in
the manifest's `npz_dtypes`, as the JAX package writes them; the port
converts through torch alone (`view(torch.int16)`), and
decodes every leaf to a CPU torch tensor.

Legacy (round-1) pickle checkpoints load when they hold only numpy
arrays and Python objects; any other class raises, naming the format.
"""

import contextlib
import hashlib
import json
import os
import pickle
import re
import shutil
import threading
import time
import traceback
import zipfile

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

FORMAT_VERSION = 2

MODEL_STATES_FMT = "mp_rank_{:02d}_model_states"
OPTIM_SHARD_FMT = "zero_pp_rank_{}_mp_rank_{:02d}optim_states"
MODEL_SHARD_FMT = "zero_pp_rank_{}_mp_rank_{:02d}model_states"
LATEST_FILE = "latest"

# Suffix of the in-progress staging directory an async (or crashed)
# save writes into before the atomic rename to `<tag>`. Readers must
# never treat one as a checkpoint.
STAGING_SUFFIX = ".tmp"

_SHARD_RE = re.compile(
    r"zero_pp_rank_(\d+)_mp_rank_(\d+)(optim|model)_states\.npz$")



# ----------------------------------------------------------------------
# error taxonomy
# ----------------------------------------------------------------------
class CheckpointNotFoundError(FileNotFoundError):
    """No checkpoint exists under the requested tag at all — nothing
    was ever saved (or rotation removed it). Recovery action: start
    fresh, or pick a different tag."""


class CheckpointStagingOnlyError(FileNotFoundError):
    """The tag exists ONLY as a `<tag>.tmp` staging dir: a save was
    killed before its atomic commit. The staging dir must never be
    loaded. Recovery action: load an earlier committed tag (the
    `latest` pointer only ever names committed saves)."""


class CheckpointWaitTimeout(TimeoutError):
    """wait_for_checkpoint(timeout=...) expired with a writer still in
    flight. `heartbeat_age_sec` is the writer's last heartbeat age as
    the engine's monitor recorded it (None when it saw none), so a caller
    can tell a slow-but-alive writer from a wedged one. Abandonment unblocks
    in-process teardown/rebuild; writer threads stay non-daemon by
    design (the interpreter will not EXIT mid-write)."""

    def __init__(self, msg, pending=0, heartbeat_age_sec=None):
        super().__init__(msg)
        self.pending = pending
        self.heartbeat_age_sec = heartbeat_age_sec


# Transient read failures worth retrying: a checkpoint dir mid-commit
# (two-rename window of commit_staging_dir), NFS attribute-cache
# flutter, or a reader racing rotation. Structural corruption
# (coverage mismatch, future format) is NOT retried.
_TRANSIENT_READ_ERRORS = (OSError, zipfile.BadZipFile)


def _retry_read(fn, retries, backoff_sec, describe):
    """Run fn() with bounded retries on transient read errors.
    CheckpointNotFoundError passes straight through; the staging-only
    verdict IS retried (a reader racing a same-tag resave's two-rename
    commit window sees it for a few milliseconds)."""
    attempt = 0
    while True:
        try:
            return fn()
        except CheckpointNotFoundError:
            raise
        except _TRANSIENT_READ_ERRORS as e:
            attempt += 1
            if attempt > retries:
                raise
            logger.warning(
                f"transient checkpoint read error ({describe}, attempt "
                f"{attempt}/{retries}): {e}; retrying in "
                f"{backoff_sec * attempt:.2f}s")
            time.sleep(backoff_sec * attempt)


# ----------------------------------------------------------------------
# npz-safe dtype encoding
# ----------------------------------------------------------------------
def _npz_encode(arr):
    """array or tensor -> (npz-native numpy array, logical dtype string
    or None). A bf16 tensor becomes its bit pattern as uint16."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                np.uint16), "bfloat16"
        return t.numpy(), None
    return np.asarray(arr), None


def _npz_decode(arr, dtype_name):
    """npz array -> CPU torch tensor of the logical dtype."""
    t = torch.from_numpy(np.require(arr, requirements="CW"))
    if dtype_name is None:
        return t
    if dtype_name != "bfloat16":
        raise ValueError(f"checkpoint leaf of logical dtype {dtype_name!r}: "
                         "the port reads the bfloat16 encoding only")
    return t.view(torch.int16).view(torch.bfloat16)


def _torch_dtype(name):
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


# ----------------------------------------------------------------------
# tree <-> flat path/leaf maps (jax.tree_util.keystr paths)
# ----------------------------------------------------------------------
class Stacked(tuple):
    """A leaf: equal-shape parts written as one array stacked along a
    new leading axis."""


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """[(key string, child)] of a container node, in JAX's order (dict
    keys sorted), or None for a leaf. None is an empty node."""
    if node is None:
        return []
    if isinstance(node, Stacked):
        return None
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def tree_to_entries(tree, prefix=""):
    """[(path_string, leaf)] with the JAX package's tree paths."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += tree_to_entries(child, prefix + key)
    return out


def tree_map(fn, tree):
    """`tree` with every leaf replaced by fn(leaf)."""
    if tree is None:
        return None
    if _children(tree) is None:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    return type(tree)(tree_map(fn, v) for v in tree)


def _is_array(x):
    return isinstance(x, (torch.Tensor, np.ndarray, Stacked))


def _host(leaf):
    """A leaf on the host: a Stacked leaf as one stacked tensor."""
    if isinstance(leaf, Stacked):
        return torch.stack([torch.as_tensor(p).cpu() for p in leaf])
    return leaf


# ----------------------------------------------------------------------
# save
# ----------------------------------------------------------------------
def _ckpt_dir(save_dir, tag):
    return os.path.join(save_dir, str(tag))


def model_states_path(save_dir, tag, mp_rank=0):
    return os.path.join(_ckpt_dir(save_dir, tag),
                        MODEL_STATES_FMT.format(mp_rank) + ".npz")


def _json_safe(obj):
    """Recursively convert checkpoint metadata to JSON-able values;
    numpy scalars/arrays and tensors become lists (small metadata
    only)."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist(), "dtype": str(obj.dtype)}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    logger.warning(
        f"checkpoint metadata value of type {type(obj).__name__} is not "
        "JSON-serializable; storing its repr (round-trip lossy)")
    return {"__unserializable__": repr(obj)}


def _json_restore(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.asarray(obj["__ndarray__"],
                              dtype=np.dtype(obj["dtype"]))
        return {k: _json_restore(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_restore(v) for v in obj]
    return obj


def _savez(path, arrays):
    """`np.savez(path, **arrays)`'s file (a stored zip64 of .npy
    members) with each member's data written as one buffer. np.savez
    copies every array through 16 MiB chunks while it holds the GIL,
    which stalls a training loop in another thread for seconds; zlib's
    CRC and the file write release it."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            arr = np.require(arr, requirements="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(memoryview(arr.reshape(-1)).cast("B"))


def _load_npz(path):
    """{name: array} of an npz of .npy members (what np.savez writes),
    each member read into its array in one call: np.load copies through
    256 KiB chunks, ~35k Python iterations for a 1.5B-parameter save."""
    headers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    out = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            if not info.filename.endswith(".npy"):
                continue
            with zf.open(info) as f:
                version = np.lib.format.read_magic(f)
                if version not in headers:
                    raise ValueError(f"{path}: {info.filename} is .npy "
                                     f"format {version}")
                shape, fortran, dtype = headers[version](f)
                if dtype.hasobject:
                    raise ValueError(f"{path}: {info.filename} holds "
                                     "Python objects")
                arr = np.empty(shape, dtype, order="F" if fortran else "C")
                buf = memoryview(arr.reshape(-1, order="A")).cast("B")
                if f.readinto(buf) != arr.nbytes:
                    raise zipfile.BadZipFile(f"{path}: {info.filename} "
                                             "is truncated")
            out[info.filename[:-len(".npy")]] = arr
    return out


def save_checkpoint_files(save_dir, tag, model_sd, optim_sd, mp_rank=0,
                          ckpt_dir=None):
    """Write a checkpoint.

    `model_sd` — dict with a "module" tree of host leaves plus JSON-able
    metadata entries. `optim_sd` — dict with an "opt_state" tree plus
    metadata; array-valued entries other than "opt_state" (and trees of
    arrays: the offload engine's host_adam and offload_wire dicts, which
    the JAX writer puts in the JSON metadata as lists) are written under
    "aux/<name>"; may be None. `ckpt_dir` overrides the
    destination directory (the writer points it at the `<tag>.tmp`
    staging dir and renames on commit)."""
    if ckpt_dir is None:
        ckpt_dir = _ckpt_dir(save_dir, tag)
    os.makedirs(ckpt_dir, exist_ok=True)

    entries = tree_to_entries(model_sd.get("module", {}), "module")
    opt_meta = {}
    if optim_sd is not None:
        for k, v in optim_sd.items():
            if k == "opt_state":
                entries += tree_to_entries(v, "optim")
            elif _is_array(v) or (isinstance(v, (tuple, list, dict)) and any(
                    _is_array(x) for _, x in tree_to_entries(v))):
                entries += tree_to_entries(v, f"aux/{k}")
            else:
                opt_meta[k] = v

    meta = {k: v for k, v in model_sd.items() if k != "module"}
    main = {}
    npz_dtypes = {}
    for key, leaf in entries:
        arr, enc = _npz_encode(_host(leaf))
        main[key] = arr
        if enc is not None:
            npz_dtypes[key] = enc
    base = os.path.join(ckpt_dir, MODEL_STATES_FMT.format(mp_rank))
    _savez(base + ".npz", main)
    with open(base + ".json", "w") as f:
        json.dump({
            "format_version": FORMAT_VERSION,
            "meta": _json_safe(meta),
            "optim_meta": _json_safe(opt_meta),
            "npz_dtypes": npz_dtypes,
            "has_optim": optim_sd is not None,
        }, f)


# ----------------------------------------------------------------------
# load
# ----------------------------------------------------------------------
def _assemble(flat, shard_entries):
    """Reassemble the sharded leaves of a JAX save's bucket files, one
    leaf at a time. Coverage is verified: the primary shards of a leaf
    tile it exactly, so a missing or unreadable bucket file raises
    instead of silently zero-filling the hole."""
    by_key = {}
    for npz, entry in shard_entries:
        by_key.setdefault(entry["key"], []).append((npz, entry))
    for key, pieces in by_key.items():
        _, first = pieces[0]
        out = torch.zeros(first["global_shape"],
                          dtype=_torch_dtype(first["dtype"]))
        covered = 0
        for npz, entry in pieces:
            piece = _npz_decode(npz[entry["name"]], entry.get("npz_dtype"))
            idx = tuple(slice(s, s + d) for s, d in
                        zip(entry["start"], piece.shape))
            out[idx] = piece
            covered += piece.numel()
        total = int(np.prod(first["global_shape"]))
        if covered != total:
            raise ValueError(
                f"checkpoint shard coverage mismatch for {key!r}: "
                f"{covered} of {total} elements present — a "
                "zero_pp_rank shard file is missing or truncated")
        flat[key] = out
    return flat


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and plain Python objects only."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" or (
                module in ("builtins", "collections", "copyreg") and
                name in ("dict", "list", "tuple", "set", "frozenset",
                         "int", "float", "complex", "bool", "str",
                         "bytes", "bytearray", "slice", "range",
                         "OrderedDict", "_reconstructor", "object")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name}")


def _load_pickle(path):
    with open(path, "rb") as f:
        try:
            return _NumpyOnlyUnpickler(f).load()
        except pickle.UnpicklingError as e:
            raise ValueError(
                f"{path} is a legacy (round-1) pickle checkpoint holding "
                f"{e}: the port reads legacy pickles of numpy arrays and "
                "Python objects only; load it with deepspeed_tpu and "
                "resave to the npz format") from None


def _load_legacy_pickle(load_dir, tag, mp_rank, dp_rank):
    logger.warning(
        "loading legacy (round-1) pickle checkpoint; resave to upgrade "
        "to the sharded npz format")
    model_sd = _load_pickle(os.path.join(
        _ckpt_dir(load_dir, tag), f"mp_rank_{mp_rank:02d}_model_states.pt"))
    optim_sd = None
    legacy_opt = os.path.join(
        _ckpt_dir(load_dir, tag),
        f"zero_pp_rank_{dp_rank}_mp_rank_{mp_rank:02d}optim_states.pt")
    if os.path.exists(legacy_opt):
        optim_sd = _load_pickle(legacy_opt)
    return model_sd, optim_sd, True


def load_checkpoint_flat(load_dir, tag, mp_rank=0, retries=0,
                         backoff_sec=0.05):
    """Read a checkpoint into ({path: CPU tensor}, meta, optim_meta,
    has_optim). Paths are prefixed "module"/"optim"/"aux".

    `retries` bounds retry-with-backoff on TRANSIENT read errors.
    Missing checkpoints fail immediately: `CheckpointStagingOnlyError`
    when only the `<tag>.tmp` staging dir of an interrupted save exists,
    `CheckpointNotFoundError` when there is nothing at all."""
    return _retry_read(
        lambda: _load_checkpoint_flat_once(load_dir, tag, mp_rank),
        retries, backoff_sec, f"tag '{tag}' in {load_dir}")


def _load_checkpoint_flat_once(load_dir, tag, mp_rank=0):
    ckpt_dir = _ckpt_dir(load_dir, tag)
    base = os.path.join(ckpt_dir, MODEL_STATES_FMT.format(mp_rank))
    if not os.path.exists(base + ".json"):
        legacy = os.path.join(ckpt_dir,
                              f"mp_rank_{mp_rank:02d}_model_states.pt")
        if os.path.isdir(staging_dir(load_dir, tag)):
            raise CheckpointStagingOnlyError(
                f"checkpoint tag '{tag}' in {load_dir} only exists as "
                f"an incomplete staging dir ('{tag}{STAGING_SUFFIX}') "
                "left by an interrupted save; load an earlier tag (see "
                "the 'latest' pointer)")
        if not os.path.isdir(ckpt_dir):
            raise CheckpointNotFoundError(
                f"no checkpoint tag '{tag}' under {load_dir}: the tag "
                "directory does not exist (never saved, or removed by "
                "keep_last rotation)")
        if os.path.exists(legacy):
            raise CheckpointNotFoundError(
                f"checkpoint dir {ckpt_dir} holds a legacy pickle "
                "checkpoint (mp_rank_*.pt) with no npz manifest; load "
                "it through load_checkpoint_files / "
                "engine.load_checkpoint")
        raise CheckpointNotFoundError(
            f"checkpoint dir {ckpt_dir} exists but has no manifest "
            f"{os.path.basename(base)}.json (mp_rank mismatch, or a "
            "corrupted/partially deleted checkpoint)")
    with open(base + ".json") as f:
        manifest = json.load(f)
    version = manifest.get("format_version", 1)
    if version > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {ckpt_dir} has format_version {version}, but "
            f"this build reads up to {FORMAT_VERSION}")
    npz_dtypes = manifest.get("npz_dtypes", {})
    flat = {key: _npz_decode(arr, npz_dtypes.get(key))
            for key, arr in _load_npz(base + ".npz").items()}

    shard_entries = []
    for fname in sorted(os.listdir(ckpt_dir)):
        m = _SHARD_RE.match(fname)
        if not m or int(m.group(2)) != mp_rank:
            continue
        npz = _load_npz(os.path.join(ckpt_dir, fname))
        with open(os.path.join(
                ckpt_dir, fname[:-len(".npz")] + ".json")) as f:
            bucket = json.load(f)
        for entry in bucket["entries"]:
            shard_entries.append((npz, entry))
    _assemble(flat, shard_entries)
    return (flat, _json_restore(manifest.get("meta", {})),
            _json_restore(manifest.get("optim_meta", {})),
            manifest.get("has_optim", False))


def _flat(tree, prefix):
    """{path: CPU tensor} of a pickled tree."""
    return {k: torch.as_tensor(v) for k, v in tree_to_entries(tree, prefix)}


def load_checkpoint_files(load_dir, tag, zero_enabled=True, mp_rank=0,
                          dp_rank=0, retries=0):
    """Engine-facing loader. Returns (model_sd, optim_sd): the metadata
    with the module's {path: tensor} map under model_sd["module_flat"],
    and the optimizer metadata with its map under
    optim_sd["opt_state_flat"] and the aux trees' (the loss scale) under
    optim_sd["aux_flat"] (None without optimizer state, or when
    `zero_enabled` is False). A legacy pickle checkpoint's trees come
    back as the same maps."""
    legacy_marker = os.path.join(
        _ckpt_dir(load_dir, tag), f"mp_rank_{mp_rank:02d}_model_states.pt")
    npz_marker = model_states_path(load_dir, tag, mp_rank)
    if not os.path.exists(npz_marker) and os.path.exists(legacy_marker):
        model_sd, optim_sd, _ = _load_legacy_pickle(load_dir, tag, mp_rank,
                                                    dp_rank)
        model_sd["module_flat"] = _flat(model_sd.pop("module", {}),
                                        "module")
        if optim_sd is not None:
            optim_sd["opt_state_flat"] = _flat(
                optim_sd.pop("opt_state", {}), "optim")
        return model_sd, optim_sd

    flat, meta, opt_meta, has_optim = load_checkpoint_flat(
        load_dir, tag, mp_rank, retries=retries)
    model_sd = dict(meta)
    model_sd["module_flat"] = {
        k: v for k, v in flat.items() if k.startswith("module")}
    optim_sd = None
    if has_optim and zero_enabled:
        optim_sd = dict(opt_meta)
        optim_sd["opt_state_flat"] = {
            k: v for k, v in flat.items() if k.startswith("optim")}
        # the aux trees (the loss scale): {"aux/scale.loss_scale": ...}
        optim_sd["aux_flat"] = {
            k: v for k, v in flat.items() if k.startswith("aux/")}
    return model_sd, optim_sd


# ----------------------------------------------------------------------
# durability: fsync helpers, staging-dir commit, latest tag, rotation
# ----------------------------------------------------------------------
def _fsync_path(path):
    """fsync a file (or directory) by descriptor; directory fsync is
    best-effort — not all filesystems support it."""
    flags = os.O_RDONLY
    if os.path.isdir(path) and hasattr(os, "O_DIRECTORY"):
        flags |= os.O_DIRECTORY
    try:
        fd = os.open(path, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def staging_dir(save_dir, tag):
    """The `<tag>.tmp` directory an in-progress save writes into."""
    return _ckpt_dir(save_dir, tag) + STAGING_SUFFIX


def is_staging_name(name):
    return str(name).endswith(STAGING_SUFFIX)


def commit_staging_dir(save_dir, tag):
    """Durably publish `<tag>.tmp` as `<tag>`: fsync every file in the
    staging dir, atomically rename it over the final name, fsync the
    parent. A crash at any point leaves either the old `<tag>` (or
    nothing) or the new one — never a half-written visible checkpoint."""
    src = staging_dir(save_dir, tag)
    dst = _ckpt_dir(save_dir, tag)
    for root, _, files in os.walk(src):
        for fname in files:
            _fsync_path(os.path.join(root, fname))
    _fsync_path(src)
    trash = None
    if os.path.exists(dst):
        # resave of an existing tag: move the old dir aside by rename,
        # so the window with no `<tag>` visible is two renames wide; the
        # trash name carries the staging suffix so readers skip it
        trash = dst + ".old" + STAGING_SUFFIX
        if os.path.exists(trash):
            shutil.rmtree(trash)
        os.replace(dst, trash)
    os.replace(src, dst)
    # stamp COMMIT time on the dir: rotation ranks by mtime
    os.utime(dst, None)
    _fsync_path(save_dir)
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)


def checkpoint_dirs_bit_identical(d1, d2):
    """True when two checkpoint dirs are byte-identical: same file
    names, every npz entry equal in dtype and raw bytes, every json
    manifest equal."""
    f1, f2 = sorted(os.listdir(d1)), sorted(os.listdir(d2))
    if f1 != f2:
        return False
    for name in f1:
        p1, p2 = os.path.join(d1, name), os.path.join(d2, name)
        if name.endswith(".npz"):
            a, b = _load_npz(p1), _load_npz(p2)
            if sorted(a) != sorted(b):
                return False
            for k in a:
                if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape \
                        or a[k].tobytes() != b[k].tobytes():
                    return False
            del a, b
        elif name.endswith(".json"):
            with open(p1) as fa, open(p2) as fb:
                if json.load(fa) != json.load(fb):
                    return False
    return True


def is_checkpoint_dir(path):
    """True when `path` looks like a completed checkpoint directory;
    staging dirs and unrelated directories are excluded."""
    if not os.path.isdir(path) or is_staging_name(path):
        return False
    try:
        names = os.listdir(path)
    except OSError:
        return False
    return any("model_states" in n or n.startswith("layer_")
               for n in names)


def rotate_checkpoints(save_dir, keep_last, protect=()):
    """Delete all but the newest `keep_last` checkpoint dirs under
    `save_dir` (by mtime). `latest`'s target and `protect` tags are
    never deleted; `.tmp` staging dirs are never counted or touched.
    Returns the list of deleted tags."""
    if not keep_last or keep_last <= 0:
        return []
    keep = {str(t) for t in protect}
    latest = read_latest_tag(save_dir)
    if latest is not None:
        keep.add(latest)
    entries = []
    for name in os.listdir(save_dir):
        full = os.path.join(save_dir, name)
        if is_checkpoint_dir(full):
            try:
                entries.append((os.path.getmtime(full), name))
            except OSError:
                continue   # vanished concurrently (shared save_dir)
    entries.sort(reverse=True)
    deleted = []
    for _, name in entries[keep_last:]:
        if name in keep:
            continue
        shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)
        deleted.append(name)
    return deleted


class AsyncCheckpointWriter:
    """Background checkpoint writer: one non-daemon thread per save job
    (the interpreter cannot exit with a write half-done), a bounded
    in-flight window for backpressure, and error propagation into the
    training loop at the next submit/wait.

    queue_depth: saves allowed in flight before backpressure engages.
    queue_policy: "block" — a submit over the depth waits for the
    oldest job; "drop" — the new save is discarded with a warning.

    Jobs may SERIALIZE concurrently (queue_depth >= 2) but COMMIT in
    submission order via the gate submit() hands to each job — so
    `latest` and keep_last rotation can never regress to an older save
    whose writer happened to finish last.
    """

    def __init__(self, queue_depth=1, queue_policy="block"):
        if queue_depth < 1 or queue_policy not in ("block", "drop"):
            raise ValueError(f"queue_depth {queue_depth} (>= 1), "
                             f"queue_policy {queue_policy!r} (block, drop)")
        self._depth = queue_depth
        self._policy = queue_policy
        # set when the engine detaches this writer: jobs still commit
        # their tag dirs atomically, but no longer move `latest` or
        # rotate (a successor engine may own them)
        self.abandoned = threading.Event()
        self._jobs = []          # [(thread, tag)]
        self._lock = threading.Lock()
        self._error = None
        self._seq_next = 0       # submission-order ticket
        self._commit_turn = 0    # ticket currently allowed to commit
        self._done_seqs = set()  # finished out of order, turn not theirs
        self._commit_cv = threading.Condition()

    def _reap(self):
        with self._lock:
            self._jobs = [(t, tag) for t, tag in self._jobs
                          if t.is_alive()]
            return list(self._jobs)

    def queue_depth(self):
        """Saves currently in flight."""
        return len(self._reap())

    def tag_in_flight(self, tag):
        """True while a live job of THIS writer holds `tag` (and so
        owns its `<tag>.tmp` staging dir)."""
        tag = str(tag)
        return any(jt == tag for _, jt in self._reap())

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "background checkpoint write failed") from err

    def _warn_drop(self, tag):
        logger.warning(
            f"async checkpoint '{tag}' dropped: "
            f"{self._depth} save(s) already in flight "
            "(checkpoint.queue_policy=drop)")

    def admit(self, tag):
        """Cheap pre-snapshot check: False when queue_policy="drop"
        would discard a submit right now, so the caller skips building
        the snapshot. Under "block" always True."""
        if self._policy != "drop":
            return True
        jobs = self._reap()
        tag = str(tag)
        if len(jobs) < self._depth and \
                not any(jt == tag for _, jt in jobs):
            return True
        self._warn_drop(tag)
        return False

    def _mark_done(self, seq):
        """Job `seq` no longer needs its commit turn. Advance the turn
        across contiguously finished seqs ONLY — jumping past a still
        running earlier job would strand its writer at the gate."""
        with self._commit_cv:
            if seq < self._commit_turn:
                return           # turn already consumed (gate path ran)
            self._done_seqs.add(seq)
            while self._commit_turn in self._done_seqs:
                self._done_seqs.discard(self._commit_turn)
                self._commit_turn += 1
            self._commit_cv.notify_all()

    def submit(self, fn, tag, on_done=None):
        """Run fn(commit_gate) on a writer thread; `commit_gate` is a
        context manager the job holds around its commit section (rename
        + `latest` + rotation) — gates open in submission order.
        Returns True when the job was accepted, False when
        queue_policy="drop" rejected it. `on_done` runs on the writer
        thread after the job finishes, success or failure."""
        self._raise_pending()
        tag = str(tag)
        # two writers on one tag would share a `<tag>.tmp` staging dir:
        # serialize same-tag jobs regardless of queue depth
        while True:
            same = [t for t, jt in self._reap() if jt == tag]
            if not same:
                break
            if self._policy == "drop":
                self._warn_drop(tag)
                return False
            same[0].join()
        while True:
            jobs = self._reap()
            if len(jobs) < self._depth:
                break
            if self._policy == "drop":
                self._warn_drop(tag)
                return False
            jobs[0][0].join()
        seq = self._seq_next
        self._seq_next += 1

        @contextlib.contextmanager
        def commit_gate():
            with self._commit_cv:
                while self._commit_turn != seq:
                    self._commit_cv.wait()
            try:
                yield
            finally:
                self._mark_done(seq)

        def run():
            try:
                fn(commit_gate)
            except BaseException as e:  # noqa: BLE001 — must not die silent
                logger.error("async checkpoint write failed:\n"
                             + traceback.format_exc())
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                # a job that died before taking its gate must still
                # release its turn or later jobs deadlock
                self._mark_done(seq)
                if on_done is not None:
                    try:
                        on_done()
                    except Exception:
                        logger.warning("checkpoint on_done hook failed:\n"
                                       + traceback.format_exc())

        t = threading.Thread(target=run, daemon=False,
                             name=f"ckpt-writer-{tag}")
        with self._lock:
            self._jobs.append((t, tag))
        t.start()
        return True

    def wait(self, timeout=None):
        """Barrier: block until every in-flight save has committed;
        re-raise the first writer error, if any. With a `timeout`
        (seconds, across ALL in-flight jobs) returns True when drained
        and False when the deadline expired with a writer still alive."""
        deadline = None if timeout is None else \
            time.monotonic() + float(timeout)
        while True:
            with self._lock:
                jobs = list(self._jobs)
            if not jobs:
                break
            for t, _ in jobs:
                if deadline is None:
                    t.join()
                else:
                    t.join(max(0.0, deadline - time.monotonic()))
                    if t.is_alive():
                        self._raise_pending()
                        return False
            self._reap()
        self._raise_pending()
        return True

    def pending(self):
        return len(self._reap())


# ----------------------------------------------------------------------
# latest tag + tag validation
# ----------------------------------------------------------------------
def write_latest_tag(save_dir, tag):
    """Crash-atomic `latest` pointer: write a tmp file, fsync, then
    os.replace — a reader sees either the previous tag or the new one."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, LATEST_FILE)
    # unique tmp name: concurrent writer threads must not truncate each
    # other's tmp file between write and rename
    tmp = (f"{path}.{os.getpid()}.{threading.get_ident()}"
           f"{STAGING_SUFFIX}")
    with open(tmp, "w") as f:
        f.write(str(tag))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(save_dir)


def read_latest_tag(load_dir, retries=0, backoff_sec=0.05):
    """Read the `latest` pointer (None when absent, or when it names a
    staging entry)."""
    def once():
        path = os.path.join(load_dir, LATEST_FILE)
        if not os.path.exists(path):
            return None
        with open(path, "r") as f:
            return f.read().strip()

    tag = _retry_read(once, retries, backoff_sec,
                      f"latest pointer in {load_dir}")
    if tag is None:
        return None
    if not tag or is_staging_name(tag):
        logger.warning(
            f"{os.path.join(load_dir, LATEST_FILE)} points at staging "
            f"entry {tag!r}; ignoring it")
        return None
    return tag


def validate_checkpoint_tag(tag, fail_on_mismatch=False):
    """Cross-process tag consistency vote: every rank's sha1 of the tag,
    all-gathered over the initialised torch.distributed group (a no-op
    at world size 1). Returns True when all processes agree."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return True
    digest = hashlib.sha1(str(tag).encode()).hexdigest()
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, digest)
    valid = all(d == gathered[0] for d in gathered)
    msg = (f"checkpoint tag '{tag}' is not consistent across all "
           "processes; rank-unique tags break restores at different "
           "world sizes")
    if not valid:
        if fail_on_mismatch:
            raise ValueError(msg)
        logger.warning(msg)
    return valid
