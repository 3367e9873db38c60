"""DeepSpeedConfig: JSON config parsing and batch-triple resolution
(trimmed port of deepspeed_tpu/runtime/config.py).

What the training slices read: the batch triple (train_batch_size =
micro batch x gradient accumulation x data-parallel world size; any two
determine the third), the `bf16` block with `master_weights`, the
`fp16` block and its loss-scale settings (`get_loss_scale`,
`get_initial_dynamic_scale`, `get_dynamic_loss_scale_args`), the
`progressive_layer_drop` block (`get_pld_params`),
`zero_optimization.stage`, the `optimizer` and `scheduler` blocks,
`gradient_clipping`, `steps_per_print`, the `moe` block
(`get_moe_config`), the `quantized_compute` block
(`get_quantized_compute_config`) and the `sparse_attention` block
(`get_sparse_attention`) and the `checkpoint` block
(`get_checkpoint_config`), the `async_dispatch` block
(`get_async_dispatch_config`), the `activation_checkpointing` block
(`activation_checkpointing_config`), `dump_state`, the `monitor` block
(`monitor_config`, a `monitor.config.DeepSpeedMonitorConfig`), the
legacy `tensorboard` block (`tensorboard_enabled`, `_output_path`,
`_job_name`) and `wall_clock_breakdown`, each validated as the JAX
package validates it. `zero_config` holds the
`zero_optimization` block with its `offload_wire` (runtime/zero/
config.py); the `overlap` block configures ops/overlap.py through the
engine, the `autotune` block configures ops/autotune.py through the
engine, the `flops_profiler` block (`flops_profiler_config`, a
`profiling.config.DeepSpeedFlopsProfilerConfig`) drives the engine's
profile step, and an enabled `elasticity` block resolves the batch
triple as the JAX package's `_apply_elasticity` does.

A block that the JAX engine acts on and the port does not yet raises
NotImplementedError naming the ROADMAP Queue 1 item that ports it
(`_check_later_slices`): pipeline, sparse gradients and a `mesh` axis
above 1 (6). The `mesh` block is
resolved for the port's world size as the JAX package's `build_mesh`
resolves it for its devices (`resolve_mesh`, `mesh_shape`).
"""

import math
import os

from deepspeed_tpu_torch.profiling.config import \
    DeepSpeedFlopsProfilerConfig
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.activation_checkpointing.config import \
    DeepSpeedActivationCheckpointingConfig
from deepspeed_tpu_torch.runtime.config_utils import (get_scalar_param,
                                                      load_config_dict)
from deepspeed_tpu_torch.runtime.zero import config as Z
from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedConfigError(Exception):
    pass


def _later(what, item):
    return NotImplementedError(
        f"{what} is not in the port yet: ROADMAP Queue 1 item {item}")


# the mesh's axis orders, the JAX package's runtime/mesh.py AXIS_ORDER and
# AXIS_ORDER_EXPERT
MESH_AXES = (C.MESH_PIPE_AXIS, C.MESH_DATA_AXIS, C.MESH_MODEL_AXIS)
MESH_AXES_EXPERT = (C.MESH_PIPE_AXIS, C.MESH_DATA_AXIS, C.MESH_EXPERT_AXIS,
                    C.MESH_MODEL_AXIS)


def _mesh_sizes(mesh_config):
    """The `mesh` block's axes and sizes, -1 for an inferred axis (the
    JAX `build_mesh`'s defaults: data -1, pipe and model 1)."""
    cfg = dict(mesh_config or {})
    axes = MESH_AXES_EXPERT if C.MESH_EXPERT_AXIS in cfg else MESH_AXES
    sizes = {C.MESH_PIPE_AXIS: int(cfg.get(C.MESH_PIPE_AXIS, 1)),
             C.MESH_DATA_AXIS: int(cfg.get(C.MESH_DATA_AXIS, -1)),
             C.MESH_MODEL_AXIS: int(cfg.get(C.MESH_MODEL_AXIS, 1))}
    if C.MESH_EXPERT_AXIS in cfg:
        sizes[C.MESH_EXPERT_AXIS] = int(cfg[C.MESH_EXPERT_AXIS])
    return axes, sizes


def resolve_mesh(mesh_config, n):
    """The `mesh` block resolved for n devices as the JAX package's
    `build_mesh` resolves it (`deepspeed_tpu/runtime/mesh.py:51-81`, its
    assertions word for word): at most one axis -1, inferred from n; the
    axes' product must be n; an `expert` axis switches to the 4-axis
    order. Raises AssertionError (not `assert`, so that `-O` keeps the
check) with the JAX package's messages. Returns {axis: size} in the
mesh's axis order."""
    axes, sizes = _mesh_sizes(mesh_config)
    known = [sizes[a] for a in axes if sizes[a] != -1]
    n_known = math.prod(known) if known else 1
    unknown = [a for a in axes if sizes[a] == -1]
    if len(unknown) > 1:
        raise AssertionError("at most one mesh axis may be -1 (inferred)")
    if unknown:
        if n % n_known != 0:
            raise AssertionError(f"device count {n} not divisible by fixed "
                                 f"axis product {n_known}")
        sizes[unknown[0]] = n // n_known
    dims = tuple(sizes[a] for a in axes)
    if math.prod(dims) != n:
        raise AssertionError(
            f"mesh {'x'.join(map(str, dims))} != device count {n}")
    return {a: sizes[a] for a in axes}


def _block_enabled(param_dict, key, enabled_key="enabled"):
    block = param_dict.get(key)
    if isinstance(block, dict):
        return bool(block.get(enabled_key, False))
    return bool(block)


def get_bfloat16_enabled(param_dict):
    for key in (C.BFLOAT16, C.BFLOAT16_ALIAS):
        if key in param_dict:
            return get_scalar_param(param_dict[key], C.BFLOAT16_ENABLED,
                                    C.BFLOAT16_ENABLED_DEFAULT)
    return False


def get_fp16_enabled(param_dict):
    if C.FP16 in param_dict:
        return get_scalar_param(param_dict[C.FP16], C.FP16_ENABLED,
                                C.FP16_ENABLED_DEFAULT)
    return False


def get_loss_scale(param_dict):
    if get_fp16_enabled(param_dict):
        return get_scalar_param(param_dict[C.FP16], C.FP16_LOSS_SCALE,
                                C.FP16_LOSS_SCALE_DEFAULT)
    return C.FP16_LOSS_SCALE_DEFAULT


def get_initial_dynamic_scale(param_dict):
    if get_fp16_enabled(param_dict):
        power = get_scalar_param(param_dict[C.FP16],
                                 C.FP16_INITIAL_SCALE_POWER,
                                 C.FP16_INITIAL_SCALE_POWER_DEFAULT)
    else:
        power = C.FP16_INITIAL_SCALE_POWER_DEFAULT
    return 2**power


def get_dynamic_loss_scale_args(param_dict):
    """The automaton's settings when the fp16 block names any of them
    (the JAX package's dict: init_scale, scale_window, delayed_shift,
    min_scale), else None."""
    if not get_fp16_enabled(param_dict):
        return None
    fp16 = param_dict[C.FP16]
    props = (C.FP16_INITIAL_SCALE_POWER, C.FP16_LOSS_SCALE_WINDOW,
             C.FP16_MIN_LOSS_SCALE, C.FP16_HYSTERESIS)
    if not any(p in fp16 for p in props):
        return None
    return {
        "init_scale": 2**get_scalar_param(
            fp16, C.FP16_INITIAL_SCALE_POWER,
            C.FP16_INITIAL_SCALE_POWER_DEFAULT),
        "scale_window": get_scalar_param(
            fp16, C.FP16_LOSS_SCALE_WINDOW, C.FP16_LOSS_SCALE_WINDOW_DEFAULT),
        "delayed_shift": get_scalar_param(
            fp16, C.FP16_HYSTERESIS, C.FP16_HYSTERESIS_DEFAULT),
        "min_scale": get_scalar_param(
            fp16, C.FP16_MIN_LOSS_SCALE, C.FP16_MIN_LOSS_SCALE_DEFAULT),
    }


def get_pld_enabled(param_dict):
    if C.PROGRESSIVE_LAYER_DROP in param_dict:
        return get_scalar_param(param_dict[C.PROGRESSIVE_LAYER_DROP],
                                C.PLD_ENABLED, C.PLD_ENABLED_DEFAULT)
    return False


def get_pld_params(param_dict):
    """The block's theta and gamma, only where given (absent keys take
    ProgressiveLayerDrop's own defaults, theta 0.5: the constants'
    theta 1.0 would make PLD a no-op), or False without the block."""
    if C.PROGRESSIVE_LAYER_DROP not in param_dict:
        return False
    block = param_dict[C.PROGRESSIVE_LAYER_DROP]
    unknown = set(block) - {C.PLD_ENABLED, C.PLD_THETA, C.PLD_GAMMA}
    if unknown:
        logger.warning(f"progressive_layer_drop: ignoring unknown key(s) "
                       f"{sorted(unknown)}")
    return {k: block[k] for k in (C.PLD_THETA, C.PLD_GAMMA) if k in block}


def get_bfloat16_master_weights(param_dict):
    for key in (C.BFLOAT16, C.BFLOAT16_ALIAS):
        if key in param_dict:
            return get_scalar_param(param_dict[key],
                                    C.BFLOAT16_MASTER_WEIGHTS,
                                    C.BFLOAT16_MASTER_WEIGHTS_DEFAULT)
    return C.BFLOAT16_MASTER_WEIGHTS_DEFAULT


def get_zero_config(param_dict):
    """The zero_optimization block (a bool block means stage 1 or 0, as
    in the JAX package) as a DeepSpeedZeroConfig, its stage checked."""
    zc = Z.DeepSpeedZeroConfig(param_dict)
    if not 0 <= zc.stage <= Z.MAX_STAGE_ZERO_OPTIMIZATION:
        raise DeepSpeedConfigError(
            f"zero_optimization.stage must be in "
            f"[0,{Z.MAX_STAGE_ZERO_OPTIMIZATION}], got {zc.stage}")
    return zc


def _is_int(v):
    return isinstance(v, int) and not isinstance(v, bool)


def _is_number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def get_moe_config(param_dict):
    """Validated `moe` block -> dict(enabled, num_experts, top_k,
    capacity_factor, aux_loss_weight, every_n_layers, jitter_eps,
    fused_dispatch). The engine verifies the structural keys
    (num_experts, every_n_layers) against the built model through its
    configure_moe hook and applies the router knobs."""
    block = param_dict.get(C.MOE, {})
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(f'"moe" must be a dict, got {block!r}')
    enabled = bool(get_scalar_param(block, C.MOE_ENABLED,
                                    C.MOE_ENABLED_DEFAULT))
    num_experts = get_scalar_param(block, C.MOE_NUM_EXPERTS,
                                   C.MOE_NUM_EXPERTS_DEFAULT)
    if not _is_int(num_experts) or num_experts < 2:
        raise DeepSpeedConfigError(
            f"moe.num_experts must be an int >= 2, got {num_experts!r}")
    top_k = get_scalar_param(block, C.MOE_TOP_K, C.MOE_TOP_K_DEFAULT)
    if not _is_int(top_k) or not 1 <= top_k <= num_experts:
        raise DeepSpeedConfigError(
            f"moe.top_k must be an int in [1, num_experts="
            f"{num_experts}], got {top_k!r}")
    cf = get_scalar_param(block, C.MOE_CAPACITY_FACTOR,
                          C.MOE_CAPACITY_FACTOR_DEFAULT)
    if not _is_number(cf) or cf <= 0:
        raise DeepSpeedConfigError(
            f"moe.capacity_factor must be > 0, got {cf!r}")
    aux = get_scalar_param(block, C.MOE_AUX_LOSS_WEIGHT,
                           C.MOE_AUX_LOSS_WEIGHT_DEFAULT)
    if not _is_number(aux) or aux < 0:
        raise DeepSpeedConfigError(
            f"moe.aux_loss_weight must be >= 0, got {aux!r}")
    every = get_scalar_param(block, C.MOE_EVERY_N_LAYERS,
                             C.MOE_EVERY_N_LAYERS_DEFAULT)
    if not _is_int(every) or every < 1:
        raise DeepSpeedConfigError(
            f"moe.every_n_layers must be an int >= 1, got {every!r}")
    jitter = get_scalar_param(block, C.MOE_JITTER_EPS,
                              C.MOE_JITTER_EPS_DEFAULT)
    if not _is_number(jitter) or jitter < 0:
        raise DeepSpeedConfigError(
            f"moe.jitter_eps must be >= 0, got {jitter!r}")
    fused = get_scalar_param(block, C.MOE_FUSED_DISPATCH,
                             C.MOE_FUSED_DISPATCH_DEFAULT)
    if fused is True:
        fused = "on"
    elif fused is False:
        fused = "off"
    if fused not in C.MOE_FUSED_DISPATCH_VALID:
        raise DeepSpeedConfigError(
            "moe.fused_dispatch must be one of "
            f"{list(C.MOE_FUSED_DISPATCH_VALID)}, got {fused!r}")
    known = {C.MOE_ENABLED, C.MOE_NUM_EXPERTS, C.MOE_TOP_K,
             C.MOE_CAPACITY_FACTOR, C.MOE_AUX_LOSS_WEIGHT,
             C.MOE_EVERY_N_LAYERS, C.MOE_JITTER_EPS, C.MOE_FUSED_DISPATCH}
    unknown = set(block) - known
    if unknown:
        logger.warning(f"moe: ignoring unknown key(s) {sorted(unknown)}; "
                       f"known keys: {sorted(known)}")
    return {"enabled": enabled, "num_experts": num_experts,
            "top_k": top_k, "capacity_factor": float(cf),
            "aux_loss_weight": float(aux), "every_n_layers": every,
            "jitter_eps": float(jitter), "fused_dispatch": fused}


def get_quantized_compute_config(param_dict):
    """Validated `quantized_compute` block -> dict(enabled, mode,
    block, stochastic_rounding)."""
    block = param_dict.get(C.QUANTIZED_COMPUTE, {})
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f'"quantized_compute" must be a dict, got {block!r}')
    enabled = bool(get_scalar_param(
        block, C.QUANTIZED_COMPUTE_ENABLED,
        C.QUANTIZED_COMPUTE_ENABLED_DEFAULT))
    mode = get_scalar_param(block, C.QUANTIZED_COMPUTE_MODE,
                            C.QUANTIZED_COMPUTE_MODE_DEFAULT)
    if mode not in C.QUANTIZED_COMPUTE_MODE_VALID:
        raise DeepSpeedConfigError(
            f"quantized_compute.mode must be one of "
            f"{list(C.QUANTIZED_COMPUTE_MODE_VALID)}, got {mode!r}")
    qblock = get_scalar_param(block, C.QUANTIZED_COMPUTE_BLOCK,
                              C.QUANTIZED_COMPUTE_BLOCK_DEFAULT)
    if not _is_int(qblock) or qblock < 1:
        raise DeepSpeedConfigError(
            f"quantized_compute.block must be an int >= 1, got "
            f"{qblock!r}")
    sr = bool(get_scalar_param(
        block, C.QUANTIZED_COMPUTE_STOCHASTIC_ROUNDING,
        C.QUANTIZED_COMPUTE_STOCHASTIC_ROUNDING_DEFAULT))
    return {"enabled": enabled, "mode": mode, "block": qblock,
            "stochastic_rounding": sr}


def get_sparse_attention(param_dict):
    """The `sparse_attention` block with `mode` validated and resolved
    and unknown keys dropped with a warning (the block passes through
    wholesale to the SparsityConfig constructors), or None without one."""
    if C.SPARSE_ATTENTION in param_dict:
        sparsity = param_dict[C.SPARSE_ATTENTION]
        mode = get_scalar_param(sparsity, C.SPARSE_MODE, C.SPARSE_MODE_DEFAULT)
        if mode not in C.SPARSE_MODE_VALID:
            raise DeepSpeedConfigError(
                f"sparse_attention.mode must be one of "
                f"{list(C.SPARSE_MODE_VALID)}, got {mode!r}")
        # an unknown key would otherwise surface as a TypeError deep
        # inside ops/sparse_attention
        unknown = set(sparsity) - set(C.SPARSE_ATTENTION_KEYS)
        if unknown:
            logger.warning(
                f"sparse_attention: ignoring unknown key(s) "
                f"{sorted(unknown)}; known keys: "
                f"{list(C.SPARSE_ATTENTION_KEYS)}")
        sparsity = {k: v for k, v in sparsity.items()
                    if k in C.SPARSE_ATTENTION_KEYS}
        sparsity[C.SPARSE_MODE] = mode
        return sparsity
    return None


def get_checkpoint_config(param_dict):
    """Validated `checkpoint` block -> dict(tag_validation, async_save,
    keep_last, writer_queue_depth, queue_policy), with the JAX package's
    errors (deepspeed_tpu/runtime/config.py get_checkpoint_*)."""
    block = param_dict.get(C.CHECKPOINT, {})
    mode = get_scalar_param(block, C.CHECKPOINT_TAG_VALIDATION,
                            C.CHECKPOINT_TAG_VALIDATION_DEFAULT)
    mode = mode.capitalize()
    if mode not in C.CHECKPOINT_TAG_VALIDATION_MODES:
        raise DeepSpeedConfigError(
            f"checkpoint.tag_validation mode {mode} not one of "
            f"{C.CHECKPOINT_TAG_VALIDATION_MODES}")
    keep = get_scalar_param(block, C.CHECKPOINT_KEEP_LAST,
                            C.CHECKPOINT_KEEP_LAST_DEFAULT)
    if keep < 0:
        raise DeepSpeedConfigError(
            f"checkpoint.keep_last must be >= 0 (0 = keep all), got {keep}")
    depth = get_scalar_param(block, C.CHECKPOINT_WRITER_QUEUE_DEPTH,
                             C.CHECKPOINT_WRITER_QUEUE_DEPTH_DEFAULT)
    if depth < 1:
        raise DeepSpeedConfigError(
            f"checkpoint.writer_queue_depth must be >= 1, got {depth}")
    policy = get_scalar_param(block, C.CHECKPOINT_QUEUE_POLICY,
                              C.CHECKPOINT_QUEUE_POLICY_DEFAULT)
    if policy not in C.CHECKPOINT_QUEUE_POLICIES:
        raise DeepSpeedConfigError(
            f"checkpoint.queue_policy {policy!r} not one of "
            f"{C.CHECKPOINT_QUEUE_POLICIES}")
    return {"tag_validation": mode,
            "async_save": bool(get_scalar_param(
                block, C.CHECKPOINT_ASYNC_SAVE,
                C.CHECKPOINT_ASYNC_SAVE_DEFAULT)),
            "keep_last": int(keep), "writer_queue_depth": int(depth),
            "queue_policy": policy}


def get_async_dispatch_config(param_dict):
    """Validated `async_dispatch` block -> dict(enabled, steps_per_sync,
    prefetch_depth), with the JAX package's errors."""
    block = param_dict.get(C.ASYNC_DISPATCH, {})
    steps = get_scalar_param(block, C.ASYNC_DISPATCH_STEPS_PER_SYNC,
                             C.ASYNC_DISPATCH_STEPS_PER_SYNC_DEFAULT)
    if steps < 0:
        raise DeepSpeedConfigError(
            f"async_dispatch.steps_per_sync must be >= 0 (0 = follow "
            f"steps_per_print), got {steps}")
    depth = get_scalar_param(block, C.ASYNC_DISPATCH_PREFETCH_DEPTH,
                             C.ASYNC_DISPATCH_PREFETCH_DEPTH_DEFAULT)
    if depth < 1:
        raise DeepSpeedConfigError(
            f"async_dispatch.prefetch_depth must be >= 1, got {depth}")
    return {"enabled": get_scalar_param(block, C.ASYNC_DISPATCH_ENABLED,
                                        C.ASYNC_DISPATCH_ENABLED_DEFAULT),
            "steps_per_sync": int(steps), "prefetch_depth": int(depth)}


# the overlap sites of the JAX package's ops/overlap.py (SITES)
_OVERLAP_SITES = ("moe_dispatch", "ring", "zero3_leaf")


def get_overlap_config(param_dict):
    """Validated `overlap` block -> dict(enabled, sites, issue_distance),
    with the JAX package's errors; site names are checked against its
    site registry."""
    block = param_dict.get(C.OVERLAP, {})
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f'"overlap" must be a dict, got {block!r}')
    enabled = bool(get_scalar_param(block, C.OVERLAP_ENABLED,
                                    C.OVERLAP_ENABLED_DEFAULT))
    sites = block.get(C.OVERLAP_SITES, C.OVERLAP_SITES_DEFAULT)
    if not (isinstance(sites, str) or
            (isinstance(sites, (list, tuple)) and
             all(isinstance(s, str) for s in sites))):
        raise DeepSpeedConfigError(
            'overlap.sites must be "auto" or a list of site names, '
            f"got {sites!r}")
    names = sites
    if isinstance(sites, str):
        names = [] if sites == "auto" else \
            [s.strip() for s in sites.split(",") if s.strip()]
    for s in names:
        if s not in _OVERLAP_SITES:
            raise DeepSpeedConfigError(
                f"overlap.sites: unknown site {s!r} "
                f"(valid: {', '.join(_OVERLAP_SITES)}, or 'auto')")
    dist = get_scalar_param(block, C.OVERLAP_ISSUE_DISTANCE,
                            C.OVERLAP_ISSUE_DISTANCE_DEFAULT)
    if not _is_int(dist) or dist < 1:
        raise DeepSpeedConfigError(
            f"overlap.issue_distance must be an int >= 1, got {dist!r}")
    known = {C.OVERLAP_ENABLED, C.OVERLAP_SITES, C.OVERLAP_ISSUE_DISTANCE}
    unknown = set(block) - known
    if unknown:
        logger.warning(f"overlap: ignoring unknown key(s) {sorted(unknown)}; "
                       f"known keys: {sorted(known)}")
    return {"enabled": enabled,
            "sites": sites if isinstance(sites, str) else list(sites),
            "issue_distance": dist}


def get_autotune_config(param_dict):
    """Validated `autotune` block -> dict(enabled, table_path)."""
    block = param_dict.get(C.AUTOTUNE, {})
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f'"autotune" must be a dict, got {block!r}')
    enabled = bool(get_scalar_param(block, C.AUTOTUNE_ENABLED,
                                    C.AUTOTUNE_ENABLED_DEFAULT))
    path = get_scalar_param(block, C.AUTOTUNE_TABLE_PATH,
                            C.AUTOTUNE_TABLE_PATH_DEFAULT)
    if not isinstance(path, str):
        raise DeepSpeedConfigError(
            f"autotune.table_path must be a string, got {path!r}")
    return {"enabled": enabled, "table_path": path}


def get_tensorboard_enabled(param_dict):
    if C.TENSORBOARD in param_dict:
        return get_scalar_param(param_dict[C.TENSORBOARD],
                                C.TENSORBOARD_ENABLED,
                                C.TENSORBOARD_ENABLED_DEFAULT)
    return False


def get_tensorboard_output_path(param_dict):
    if get_tensorboard_enabled(param_dict):
        return get_scalar_param(param_dict[C.TENSORBOARD],
                                C.TENSORBOARD_OUTPUT_PATH,
                                C.TENSORBOARD_OUTPUT_PATH_DEFAULT)
    return C.TENSORBOARD_OUTPUT_PATH_DEFAULT


def get_tensorboard_job_name(param_dict):
    if get_tensorboard_enabled(param_dict):
        return get_scalar_param(param_dict[C.TENSORBOARD],
                                C.TENSORBOARD_JOB_NAME,
                                C.TENSORBOARD_JOB_NAME_DEFAULT)
    return C.TENSORBOARD_JOB_NAME_DEFAULT


def _block_type_and_params(param_dict, key):
    block = param_dict.get(key) or {}
    name = block.get(C.TYPE) if isinstance(block, dict) else None
    params = block.get(C.OPTIMIZER_PARAMS) if name is not None else None
    return name, params


def get_amp_config(param_dict):
    """(enabled, other params) of the "amp" block, as the JAX package
    reads it: a non-dict block raises, and amp together with fp16
    fails."""
    amp = param_dict.get(C.AMP)
    if amp is not None and not isinstance(amp, dict):
        raise DeepSpeedConfigError(
            f'"amp" must be a dict like {{"enabled": true}}, got {amp!r}')
    amp = amp or {}
    enabled = bool(amp.get(C.AMP_ENABLED, C.AMP_ENABLED_DEFAULT))
    if enabled and _block_enabled(param_dict, C.FP16, C.FP16_ENABLED):
        raise DeepSpeedConfigError(
            "amp and fp16 modes cannot be simultaneously enabled")
    return enabled, {k: v for k, v in amp.items() if k != C.AMP_ENABLED}


class DeepSpeedConfig:
    def __init__(self, json_file_or_dict, world_size=1):
        self._param_dict = load_config_dict(json_file_or_dict)
        self.world_size = world_size
        # elasticity: the elastic config overrides the batch triple
        self.elasticity_enabled = False
        ec = self._param_dict.get(C.ELASTICITY, None)
        if ec is not None and ec.get(C.ELASTICITY_ENABLED, False):
            self._apply_elasticity(ec)
        self.amp_enabled, self.amp_params = get_amp_config(self._param_dict)
        self._initialize_params(self._param_dict)
        self._check_later_slices(self._param_dict)
        self.mesh_shape = resolve_mesh(self._param_dict.get(C.MESH),
                                       self.world_size)
        self._configure_train_batch_size()

    def _check_later_slices(self, d):
        """Raise on a block the JAX engine acts on and the port does not
        yet, naming the ROADMAP Queue 1 item that ports it. Runs after
        the blocks are validated, so a bad value fails as it does in the
        JAX package."""
        if d.get(C.PIPELINE):
            raise _later("pipeline parallelism", 6)
        _, mesh = _mesh_sizes(d.get(C.MESH))
        wide = sorted(a for a, size in mesh.items() if size > 1)
        if wide:
            raise _later(f"a mesh with {', '.join(wide)} above 1 "
                         "(runtime/mesh.py)", 6)
        if d.get(C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT):
            raise _later("sparse_gradients (runtime/csr_tensor.py)", 6)

    def _apply_elasticity(self, ec):
        """The JAX config's `_apply_elasticity`: explicit batch keys
        conflict with elasticity unless `ignore_non_elastic_batch_info`;
        the batch triple comes from `compute_elastic_config` at this
        world size (gradient accumulation derived), checked against
        DEEPSPEED_ELASTICITY_CONFIG where the scheduler set it."""
        from deepspeed_tpu_torch import elasticity as el
        from deepspeed_tpu_torch.version import __version__
        self.elasticity_enabled = True
        ignore = ec.get(el.IGNORE_NON_ELASTIC_BATCH_INFO,
                        el.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)
        batch_keys = [C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                      C.GRADIENT_ACCUMULATION_STEPS]
        if not ignore:
            present = [k for k in batch_keys if k in self._param_dict]
            if present:
                raise el.ElasticityConfigError(
                    f"Elasticity is enabled but batch parameters {present} "
                    f"are also set; remove them or set "
                    f"'{el.IGNORE_NON_ELASTIC_BATCH_INFO}': true")
        final_batch_size, _, micro_batch_size = el.compute_elastic_config(
            ds_config=self._param_dict,
            target_deepspeed_version=__version__,
            world_size=self.world_size)
        if os.environ.get(el.DEEPSPEED_ELASTICITY_CONFIG) is not None:
            el.ensure_immutable_elastic_config(runtime_elastic_config_dict=ec)
        self._param_dict[C.TRAIN_BATCH_SIZE] = final_batch_size
        self._param_dict[C.TRAIN_MICRO_BATCH_SIZE_PER_GPU] = micro_batch_size
        self._param_dict.pop(C.GRADIENT_ACCUMULATION_STEPS, None)

    def _initialize_params(self, d):
        self.train_batch_size = get_scalar_param(
            d, C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = get_scalar_param(
            d, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = get_scalar_param(
            d, C.GRADIENT_ACCUMULATION_STEPS,
            C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = get_scalar_param(d, C.STEPS_PER_PRINT,
                                                C.STEPS_PER_PRINT_DEFAULT)

        self.zero_config = get_zero_config(d)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_cpu_offload = bool(self.zero_config.cpu_offload)
        self.zero_enabled = self.zero_optimization_stage > 0
        if self.zero_config.offload_wire_compressed() and \
                not self.zero_cpu_offload:
            logger.warning(
                "DeepSpeedConfig: zero_optimization.offload_wire "
                "compresses the ZeRO-Offload host link and has no effect "
                "without cpu_offload: true")

        self.bfloat16_enabled = get_bfloat16_enabled(d)
        self.bfloat16_master_weights = get_bfloat16_master_weights(d)
        if self.amp_enabled:
            # Apex AMP does not exist here: amp means bf16 mixed
            # precision, as in the JAX package
            logger.warning("amp.enabled maps to bf16 mixed precision; amp "
                           f"params {list(self.amp_params)} are ignored")
            self.bfloat16_enabled = True
        self.fp16_enabled = get_fp16_enabled(d)
        # the JAX package's assertion, word for word
        assert not (self.fp16_enabled and self.bfloat16_enabled), \
            "fp16 and bf16 modes are mutually exclusive"
        self.loss_scale = get_loss_scale(d)
        self.initial_dynamic_scale = get_initial_dynamic_scale(d)
        self.dynamic_loss_scale_args = get_dynamic_loss_scale_args(d)
        self.pld_enabled = get_pld_enabled(d)
        self.pld_params = get_pld_params(d)

        self.gradient_clipping = get_scalar_param(
            d, C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)

        self.optimizer_name, self.optimizer_params = \
            _block_type_and_params(d, C.OPTIMIZER)
        if self.optimizer_name is not None and \
                self.optimizer_name.lower() in C.DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.scheduler_name, self.scheduler_params = \
            _block_type_and_params(d, C.SCHEDULER)
        self.moe = get_moe_config(d)
        self.quantized_compute = get_quantized_compute_config(d)
        self.sparse_attention = get_sparse_attention(d)

        # validated as the JAX package validates them, and kept under its
        # attribute names; `_check_later_slices` refuses what they enable
        ck = get_checkpoint_config(d)
        self.checkpoint_tag_validation_enabled = \
            ck["tag_validation"] != "Ignore"
        self.checkpoint_tag_validation_fail = ck["tag_validation"] == "Fail"
        self.checkpoint_async_save = ck["async_save"]
        self.checkpoint_keep_last = ck["keep_last"]
        self.checkpoint_writer_queue_depth = ck["writer_queue_depth"]
        self.checkpoint_queue_policy = ck["queue_policy"]
        ad = get_async_dispatch_config(d)
        self.async_dispatch_enabled = ad["enabled"]
        self.async_dispatch_steps_per_sync = ad["steps_per_sync"]
        self.async_dispatch_prefetch_depth = ad["prefetch_depth"]
        self.autotune = get_autotune_config(d)
        self.overlap = get_overlap_config(d)
        self.flops_profiler_config = DeepSpeedFlopsProfilerConfig(d)
        self.activation_checkpointing_config = \
            DeepSpeedActivationCheckpointingConfig(d)
        self.wall_clock_breakdown = bool(get_scalar_param(
            d, C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT))
        from deepspeed_tpu_torch.monitor.config import \
            DeepSpeedMonitorConfig
        self.monitor_config = DeepSpeedMonitorConfig(d)
        self.tensorboard_enabled = get_tensorboard_enabled(d)
        self.tensorboard_output_path = get_tensorboard_output_path(d)
        self.tensorboard_job_name = get_tensorboard_job_name(d)
        self.dump_state = bool(get_scalar_param(d, C.DUMP_STATE,
                                                C.DUMP_STATE_DEFAULT))

    def print(self, name):
        """Log every resolved setting (the JAX config's `print`, what the
        engine's dump_state shows at init)."""
        logger.info("{}:".format(name))
        for arg in sorted(vars(self)):
            if arg != "_param_dict":
                dots = "." * (29 - len(arg))
                logger.info("  {} {} {}".format(arg, dots,
                                                 getattr(self, arg)))

    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if train_batch is not None and micro_batch is not None and \
                grad_acc is not None:
            return
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = \
                train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if not (train_batch > 0 and micro_batch > 0 and grad_acc > 0):
            raise DeepSpeedConfigError(
                f"batch sizes must be positive: train_batch_size "
                f"{train_batch}, micro batch {micro_batch}, gradient "
                f"accumulation {grad_acc}")
        if train_batch != micro_batch * grad_acc * self.world_size:
            raise DeepSpeedConfigError(
                "Check batch related parameters. train_batch_size is not "
                "equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size {train_batch} != {micro_batch} * {grad_acc} "
                f"* {self.world_size}")
