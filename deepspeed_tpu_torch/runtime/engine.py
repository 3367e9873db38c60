"""DeepSpeedEngine: the training engine (trimmed port of
deepspeed_tpu/runtime/engine.py).

One step: the loss and its gradients for each microbatch (the model's
`loss_fn` under torch autograd), accumulation in fp32 when
gradient_accumulation_steps > 1, then `_unscale_clip_and_update`:
global-norm clipping (the norm is computed only when clipping consumes
it), the optimizer update and the step counter. `train_batch` runs a
whole step over a stacked [gas, micro_batch, ...] batch;
`forward`/`backward`/`step` run it one microbatch at a time.

Precision, as in the JAX engine:
  * fp32: fp32 parameters and Adam moments;
  * fp16: fp16 compute parameters, an fp32 master copy and fp32
    moments, and loss scaling (`runtime/fp16/loss_scaler.py`): the loss
    is multiplied by scale / gas before differentiation, the fp32
    gradients are divided by the scale, the global norm is always
    computed, and a non-finite norm is an overflow. An overflowed step
    is skipped: the device step counter holds, the skipped counter and
    the scale automaton step. PyTorch has no `lax.cond`, so the skip is
    a mask: every optimizer-state write and the master's update are
    `torch.where(keep, new, old)` with the device bool keep = not
    overflow, so a skipped step leaves every parameter, master, moment
    and counter bit for bit as it was, with no host read;
  * bf16 with master weights: bf16 compute parameters, an fp32 master
    copy and fp32 moments; the update lands on the master and is cast
    back;
  * bf16 {"master_weights": false}: bf16 parameters, bf16 moments
    (`adamw_bf16`), stochastically rounded write-back; at gas = 1 the
    gradients stay bf16 (a whole-tree fp32 cast would be a second
    parameter-sized tree at the step's peak).

No host sync inside `train_batch`: the learning rate is evaluated on
the device from the device step counter (`device_schedule_fn`, which
holds still across skipped fp16 steps), the clip factor stays a device
scalar, and the loss comes back as a device tensor. A host-side mirror
of the step count serves logging; the config scheduler's host object
(what `get_lr()` reads) steps every step and is corrected from the
device counter at print fences and in `get_lr()`, as the JAX engine's
async loop does. The `async_dispatch` block (on unless it says
`"enabled": false`, as in JAX) sets that loop's host fences: every
`steps_per_sync` optimizer steps (0: steps_per_print) the engine
corrects the mirror (fp16 only: one device read) and logs; between
fences nothing reads the device. `engine.prefetch(source)` wraps a
microbatch iterable in a `PrefetchLoader` (runtime/prefetch.py: a worker
thread collates and stages `prefetch_depth` batches ahead on a side CUDA
stream) that `train_batch(data_iter=...)` takes from directly. With
`"enabled": false`, or with a client scheduler object (host code, which
turns async dispatch off with the JAX engine's log line), the loop is
the JAX engine's synced one: the scheduler's host lr rides to the step
as a device scalar through a non-blocking copy, and under fp16 the
engine reads each step's overflow flag to rewind the scheduler — the
one per-step host read, in that mode only.

The `activation_checkpointing` block configures
`deepspeed_tpu_torch.checkpointing` (runtime/activation_checkpointing/)
for the user's `checkpoint()` calls, as the JAX engine does; `dump_state`
logs the resolved config at init.

Optimizers: Adam/AdamW (`bf16_optimizer.py`), LAMB with the clipped
trust ratio (`ops/lamb/fused_lamb.py`), SGD with momentum
(`runtime/sgd.py`) and 1-bit Adam's single-worker form
(`runtime/fp16/onebit_adam.py`), or a client object with
`init(params)` and `update(grads, state, params, lr=None[, keep])`
(e.g. `FusedLamb`, `OnebitAdam`, `adamw_bf16(...)`); a client object
whose update takes no `keep` gets the skip by a copy of its state,
restored where the step overflowed. Progressive layer drop
(`runtime/progressive_layer_drop.py`) hands the model its per-step
theta as a device scalar (`layer_keep_prob`).

An `moe` block is wired into the model through its `configure_moe`
hook before the state is built (`_init_moe`): the structural keys are
verified against the model, the router knobs applied. A
`quantized_compute` block goes through the model's
`configure_quantized_compute` hook the same way
(`_init_quantized_compute`).

Each microbatch draws two host-side seeds, so no step reads the device:
`rngs["dropout"]` from the engine's seed and `rngs["quant"]`, the
stochastic-rounding stream of the quantized projections, from a second
generator keyed by the same seed (the JAX engine's fold_in(rng, 0x51)).

ZeRO stages 0, 1 and 2 at data-parallel world size 1 compute the
unpartitioned update, as the JAX engine does on one chip. World size
> 1 and stage 3 raise NotImplementedError naming ROADMAP Queue 1 item 6.
`zero_optimization.cpu_offload` (with stage > 0) is ZeRO-Offload
(`runtime/zero/offload.py`, the `ZeroOffloadMixin` this class takes):
host fp32 masters and CPU-Adam moments, the device parameters and an
fp32 accumulator on the card, every step's micro batches accumulated
and then `_offload_take_step`; a bf16 `master_weights: false` is
ignored with the JAX engine's warning, and async dispatch is off (the
host step is a sync by nature). The `overlap` block configures
`ops/overlap.py` at init.

Telemetry (`deepspeed_tpu_torch/monitor/`, the `monitor` block): every
engine carries a `Monitor`; with the block enabled, `train_batch` and
the microbatch API hand each step's device scalars (loss, grad norm,
loss scale, overflow, tokens; per-group gradient numerics under
`monitor.numerics`; MoE router stats) to it with no host read, and
`_sync_fence` drains them in one device-to-host copy into the sinks'
`metrics`/`numerics`/`router`/`memory` events. Forward, backward and
step spans are timed without a fence when `wall_clock_breakdown` is
set or a Perfetto trace is exported; the memory ledger holds the
state's bytes by category; an exception out of `train_batch` leaves a
flight dump (classified `oom` for `torch.OutOfMemoryError`). The legacy
`tensorboard` block writes its scalars at print fences through the
native tfevents writer. As in the JAX engine, MoE router stats ride
the step only while the monitor is on, so a monitor-off engine
launches exactly what it launched before.

Checkpoints (`save_checkpoint`, `load_checkpoint`) are the JAX engine's
files (`runtime/checkpoint.py`): the module tree with the scanned
layers stacked (the model's `params_to_jax`: GPT-2's and BERT's
converters in `models/convert.py`), the optimizer state as
optax's trees (`inject_hyperparams(adamw)` over `ScaleByAdamState`, or
`adamw_bf16`'s `ScaleByAdamBF16State` without master weights; LAMB's
`LambState` and SGD's `TraceState` under `inject_hyperparams`;
`OnebitAdamState` bare), the live `LossScaleState` under `aux/scale`
(restored only by an fp16 engine, as in the JAX engine), the skipped
steps and the JAX engine's metadata, so either package loads the
other's. The port's own streams (dropout,
quant, stochastic rounding) ride in one more metadata entry,
`torch_rng`. An async save copies every leaf into fresh device buffers
on the training stream before it returns (the update writes the state
in place); the writer thread copies them into pinned host buffers on a
side CUDA stream that waits for the snapshot's event, so its copies
never queue behind the steps that follow, and frees them once copied.
"""

import contextlib
import copy
import inspect
import os
import shutil
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.monitor import (SPAN_BACKWARD, SPAN_CKPT,
                                         SPAN_FORWARD, SPAN_STEP, Monitor)
from deepspeed_tpu_torch.monitor import memory as _mem
from deepspeed_tpu_torch.monitor import numerics as _num
from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.ops.lamb.fused_lamb import LambState, lamb
from deepspeed_tpu_torch.runtime.bf16_optimizer import (
    ScaleByAdamBF16State, adam, adamw_bf16, apply_updates,
    stochastic_round_apply)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.config_utils import load_config_dict
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    DELAYED_SHIFT, INITIAL_LOSS_SCALE, MIN_LOSS_SCALE, SCALE_WINDOW,
    LossScaleState, make_loss_scale_state,
    make_static_loss_scale_state, update_loss_scale)
from deepspeed_tpu_torch.runtime.fp16.onebit_adam import (OnebitAdamState,
                                                          onebit_adam)
from deepspeed_tpu_torch.runtime.prefetch import (PrefetchLoader,
                                                   stack_microbatches)
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.sgd import SGDState, sgd
from deepspeed_tpu_torch.runtime.zero.offload import ZeroOffloadMixin
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.distributed import get_rank, get_world_size
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)

# the seed of the stochastic-rounding stream (the JAX engine's PRNGKey(17))
SR_SEED = 17
# the key of the per-step quant stream (the JAX engine's fold_in(rng, 0x51))
QUANT_STREAM = 0x51


# the checkpoint's metadata entry of the port's own streams (the JAX
# engine returns it inside its client_state)
TORCH_RNG = "torch_rng"
# metadata entries that are the engine's, not the client's
_CKPT_META = ("module", "module_flat", "global_steps", "skipped_steps",
              "micro_steps", "dp_world_size", "lr_scheduler", "rng",
              TORCH_RNG)


def _later(what, item):
    return NotImplementedError(
        f"{what} is not in the port yet: ROADMAP Queue 1 item {item}")


class EngineState(NamedTuple):
    params: Any        # {name: tensor}: compute-dtype leaves that take grads
    master: Any        # [fp32 tensor] per leaf (mixed precision) or None
    opt_state: Any
    acc_grads: Any     # [fp32 tensor] per leaf at gas > 1, else ()
    global_steps: Any  # int32 device scalar: optimizer steps taken
    scale: Any         # LossScaleState (static 1.0 outside fp16)
    skipped: Any       # int32 device scalar: steps skipped on overflow


# optax's optimizer-state trees, as the JAX engine checkpoints them
class InjectStatefulHyperparamsState(NamedTuple):
    count: Any
    hyperparams: Any
    hyperparams_states: Any
    inner_state: Any


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    pass


class TraceState(NamedTuple):
    trace: Any


def _batch_token_count(batch):
    """Element count of a batch's first leaf (keys sorted, as the JAX
    engine's tree flattening orders them), from its shape alone: the
    token count of a token-id batch."""
    if not batch:
        return 0
    return int(np.prod(np.shape(batch[sorted(batch)[0]])))


def _batch_lead(batch):
    return tuple(np.shape(batch[sorted(batch)[0]])) if batch else ()


class DeepSpeedEngine(ZeroOffloadMixin):
    """Training engine. Args mirror `deepspeed_tpu.initialize`:
      model: an object with `.loss_fn(params, batch, rngs,
        deterministic)` (e.g. `models.gpt2.GPT2ForCausalLM`,
        `models.bert.BertForPreTrainingLM`), and for checkpoints
        `.params_to_jax(params, remat, stack)`;
      model_parameters: the flat parameter dict {name: tensor};
      device: where the state lives (default: the model's `device`,
        else "cuda").
    The optimizer and the LR schedule come from the config, or from
    client objects: `optimizer` with `init(params)` and
    `update(grads, state, params, lr=None[, keep])`, `lr_scheduler`
    with `step()` and `get_last_lr()`.
    """

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config=None, config_params=None,
                 rng_seed=42, device=None):
        config = config if config is not None else config_params
        if config is None and args is not None and \
                getattr(args, "deepspeed_config", None) is not None:
            config = args.deepspeed_config
        if config is None:
            raise ValueError("DeepSpeed requires --deepspeed_config or a "
                             "config dict")
        world = mpu.get_data_parallel_world_size() if mpu is not None \
            else get_world_size()
        if world > 1:
            raise _later(f"data-parallel training (world size {world})", 6)
        if optimizer is not None and not (hasattr(optimizer, "init") and
                                          hasattr(optimizer, "update")):
            raise TypeError(
                f"client optimizer {type(optimizer).__name__} needs "
                "init(params) and update(grads, state, params, lr=None): "
                "a GradientTransformation-like object (e.g. FusedLamb, "
                "OnebitAdam, adamw_bf16(...))")
        self.client_optimizer = optimizer
        self.client_lr_scheduler = lr_scheduler
        self._config = DeepSpeedConfig(load_config_dict(config),
                                       world_size=1)
        if self._config.zero_optimization_stage == 3:
            raise _later("ZeRO stage 3", 6)

        # activation checkpointing (the JAX engine wires the JSON block
        # into the checkpointing module through configure)
        ac = self._config.activation_checkpointing_config
        if any([ac.partition_activations, ac.cpu_checkpointing,
                ac.contiguous_memory_optimization,
                ac.synchronize_checkpoint_boundary, ac.profile]):
            from deepspeed_tpu_torch.runtime.activation_checkpointing \
                import checkpointing as ds_checkpointing
            ds_checkpointing.configure(mpu, deepspeed_config=self._config)
        self._steps_per_sync = \
            self._config.async_dispatch_steps_per_sync or \
            self.steps_per_print()

        self.collate_fn = collate_fn
        self._resolve_model(model, model_parameters)
        self.device = resolve_device(
            device if device is not None else getattr(model, "device",
                                                      "cuda"))
        if self.device.type == "cuda" and self.device.index is None:
            # the index tensors carry, so placed batches compare equal
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.micro_steps = 0
        self._host_steps = 0
        # telemetry (monitor/): device scalars retained per step and
        # drained at the sync fences; every hook is one attribute check
        # when monitor.enabled is false
        self.monitor = Monitor(self, self._config.monitor_config)
        mon_cfg = self._config.monitor_config
        self._numerics_on = bool(mon_cfg.enabled and
                                 mon_cfg.numerics_enabled)
        self._init_moe()
        self._init_quantized_compute()

        self.fp16_mode = bool(self._config.fp16_enabled)
        self.bf16_mode = bool(self._config.bfloat16_enabled)
        self.bf16_sr_mode = self.bf16_mode and \
            not self._config.bfloat16_master_weights and \
            not self._offload_enabled()
        if self.bf16_mode and not self._config.bfloat16_master_weights \
                and not self.bf16_sr_mode:
            logger.warning(
                'bf16 {"master_weights": false} is ignored together '
                "with cpu_offload — the offload path IS the master "
                "store (fp32 masters + moments in host RAM); remove "
                "one of the two settings")
        self.mixed_precision = (self.fp16_mode or self.bf16_mode) and \
            not self.bf16_sr_mode
        self.compute_dtype = torch.float16 if self.fp16_mode else \
            torch.bfloat16 if self.bf16_mode else torch.float32
        self.dynamic_loss_scale_enabled = self.fp16_mode and \
            self._config.loss_scale == 0
        self.progressive_layer_drop = None
        if self._config.pld_enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(
                **(self._config.pld_params or {}))

        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            steps_per_output=self.steps_per_print(), device=self.device)
        self.training_dataloader = self.deepspeed_io(training_data) \
            if training_data is not None else None
        self.summary_writer = None
        if self.tensorboard_enabled() and get_rank() == 0:
            self.summary_writer = self.get_summary_writer()

        # tokens (elements of the first batch leaf) consumed since the
        # last optimizer step — a host int for the monitor, no sync
        self._tokens_pending = 0
        self._pending_router = None   # forward()'s router stats
        self._pending = None       # (loss, grads) of forward()
        self._ready_grads = None   # gas = 1: backward()'s grads for step()
        self.losses = None
        # per-step dropout and quant seeds: host-side, so no step reads
        # the device
        self._rng = np.random.default_rng(rng_seed)
        self._quant_rng = np.random.default_rng([rng_seed, QUANT_STREAM])
        self._sr_gen = None
        if self.bf16_sr_mode:
            self._sr_gen = torch.Generator(device=self.device)
            self._sr_gen.manual_seed(SR_SEED)

        self._configure_optimizer()
        self._configure_lr_scheduler(lr_scheduler)
        self._init_overlap()
        self._init_state()
        self.optimizer = self   # `engine.optimizer` parity
        self._ckpt_writer = None
        self._abandoned_ckpt_writers = []
        if self._config.dump_state:
            self._config.print("DeepSpeedEngine configuration")

    def _init_overlap(self):
        """Wire the `overlap` block into ops/overlap.py (the enabled
        toggle, the pinned or "auto" site set, the issue distance), as
        the JAX engine does, and emit one `overlap` monitor event
        recording the configuration."""
        from deepspeed_tpu_torch.ops import overlap
        ov = self._config.overlap
        overlap.configure(enabled=ov["enabled"], sites=ov["sites"],
                          issue_distance=ov["issue_distance"])
        if self.monitor.enabled:
            self.monitor.event(
                "overlap", enabled=ov["enabled"],
                sites=(ov["sites"] if isinstance(ov["sites"], str)
                       else ",".join(sorted(ov["sites"]))),
                issue_distance=ov["issue_distance"])

    # ------------------------------------------------------------------
    # model resolution
    # ------------------------------------------------------------------
    def _resolve_model(self, model, model_parameters):
        if not hasattr(model, "loss_fn"):
            raise TypeError(f"the model ({type(model).__name__}) needs a "
                            "loss_fn(params, batch, rngs, deterministic)")
        self.module = model
        self._loss_fn = model.loss_fn
        if model_parameters is None and hasattr(model, "params"):
            model_parameters = model.params()
        if model_parameters is None:
            raise ValueError("model_parameters (the parameter dict) is "
                             "required")
        self._initial_params = dict(model_parameters)

    def _init_moe(self):
        """Wire the `moe` config block into the model: call its
        `configure_moe` hook with the router knobs (the structural keys
        are verified against the built parameters there). At world size
        1 there is no expert mesh axis, so every expert count divides
        it. Emits one `moe` monitor event recording the configuration;
        the router stats ride the step to the fences only while the
        monitor is on."""
        mc = self._config.moe
        self._moe_active = False
        self._moe_stats_on = False
        if not mc["enabled"]:
            return
        hook = getattr(self.module, "configure_moe", None)
        if hook is None:
            logger.warning(
                "moe.enabled is set but the model "
                f"({type(self.module).__name__}) exposes no configure_moe "
                "hook; the moe block has no effect on this model")
            return
        expert_axis = 1
        if mc["num_experts"] % expert_axis:
            raise ValueError(
                f"moe.num_experts={mc['num_experts']} must divide by the "
                f"expert axis ({expert_axis})")
        hook(mesh=None, num_experts=mc["num_experts"],
             every_n_layers=mc["every_n_layers"], top_k=mc["top_k"],
             capacity_factor=mc["capacity_factor"],
             aux_loss_weight=mc["aux_loss_weight"],
             jitter_eps=mc["jitter_eps"],
             fused_dispatch=mc["fused_dispatch"])
        self._moe_active = True
        # router stats ride the step only when something drains them
        # (the monitor fence): a monitor-off engine launches what it did
        self._moe_stats_on = self.monitor.enabled
        if self.monitor.enabled:
            self.monitor.event(
                "moe", num_experts=mc["num_experts"],
                top_k=mc["top_k"],
                capacity_factor=mc["capacity_factor"],
                aux_loss_weight=mc["aux_loss_weight"],
                every_n_layers=mc["every_n_layers"],
                jitter_eps=mc["jitter_eps"],
                fused_dispatch=mc["fused_dispatch"],
                expert_axis=expert_axis)
        logger.info(
            f"MoE: {mc['num_experts']} experts (top_k={mc['top_k']}, "
            f"cf={mc['capacity_factor']}, every_n_layers="
            f"{mc['every_n_layers']}) over expert axis {expert_axis}")

    def _init_quantized_compute(self):
        """Wire the `quantized_compute` config block into the model:
        call its `configure_quantized_compute` hook with the configured
        mode, block and stochastic_rounding, or warn when the model has
        no such hook (the block then has no effect), and emit one
        `quantized_matmul` monitor event recording the configuration."""
        qc = self._config.quantized_compute
        if not qc["enabled"]:
            return
        hook = getattr(self.module, "configure_quantized_compute", None)
        if hook is None:
            logger.warning(
                "quantized_compute.enabled is set but the model "
                f"({type(self.module).__name__}) exposes no "
                "configure_quantized_compute hook; forward matmuls stay "
                "unquantized")
            applied = False
        else:
            hook(qc["mode"], block=qc["block"],
                 stochastic_rounding=qc["stochastic_rounding"])
            applied = True
        if self.monitor.enabled:
            from deepspeed_tpu_torch.ops.transformer.quantized_matmul \
                import resolve_quantized_compute
            self.monitor.event(
                "quantized_matmul", applied=applied,
                mode=qc["mode"], block=qc["block"],
                stochastic_rounding=qc["stochastic_rounding"],
                active=bool(applied and resolve_quantized_compute(
                    qc["mode"], self.device)))

    # ------------------------------------------------------------------
    # config accessors
    # ------------------------------------------------------------------
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def steps_per_print(self):
        return self._config.steps_per_print

    def scheduler_name(self):
        return self._config.scheduler_name

    def scheduler_params(self):
        return self._config.scheduler_params

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bfloat16_enabled(self):
        return self._config.bfloat16_enabled

    def loss_scale(self):
        """The current loss scale (a host read)."""
        return float(self.state.scale.loss_scale)

    def dynamic_loss_scale(self):
        return self.dynamic_loss_scale_enabled

    def initial_dynamic_scale(self):
        return self._config.initial_dynamic_scale

    def dynamic_loss_scale_args(self):
        return self._config.dynamic_loss_scale_args

    def pld_enabled(self):
        return self._config.pld_enabled

    def pld_params(self):
        return self._config.pld_params

    def pld_theta(self):
        return self.progressive_layer_drop.get_theta() \
            if self.progressive_layer_drop else 1.0

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def tensorboard_enabled(self):
        return self._config.tensorboard_enabled

    def tensorboard_output_path(self):
        return self._config.tensorboard_output_path

    def tensorboard_job_name(self):
        return self._config.tensorboard_job_name

    _tb_fallback_warned = False

    def get_summary_writer(self, name="DeepSpeedJobName", base=None):
        """TensorBoard writer for the legacy `tensorboard` config block,
        served by the native tfevents writer (monitor/tfevents.py); the
        config keys (enabled/output_path/job_name) keep their reference
        meaning. Returns None (warn-once) only when the log dir is
        unusable."""
        if base is None:
            base = os.path.join(os.path.expanduser("~"), "tensorboard")
        base_dir = self.tensorboard_output_path() or base
        log_dir = os.path.join(base_dir, self.tensorboard_job_name() or name)
        try:
            from deepspeed_tpu_torch.monitor.tfevents import SummaryWriter
            return SummaryWriter(log_dir)
        except OSError:
            if not DeepSpeedEngine._tb_fallback_warned:
                DeepSpeedEngine._tb_fallback_warned = True
                logger.warning(
                    "tensorboard unavailable; scalar summaries are "
                    "disabled for this run", exc_info=True)
            return None

    # ------------------------------------------------------------------
    # optimizer, schedule, state
    # ------------------------------------------------------------------
    def _build_optimizer_transform(self):
        # the checkpoint's optax layout: the injected hyperparameters
        # and, for Adam, the chain around its state (None: adamw_bf16's
        # bare state; else the number of EmptyStates after it)
        self._ckpt_layout({}, None)
        if self.client_optimizer is not None:
            # the client's own lr applies unless a scheduler drives it
            self._base_lr = None
            return self.client_optimizer
        name = (self._config.optimizer_name or C.ADAM_OPTIMIZER).lower()
        params = dict(self._config.optimizer_params or {})
        lr = params.get("lr", 1e-3)
        betas = params.get("betas", (0.9, 0.999))
        eps = params.get("eps", 1e-8)
        weight_decay = params.get("weight_decay", 0.0)
        self._base_lr = lr
        if self.bf16_sr_mode and name not in (C.ADAM_OPTIMIZER,
                                              C.ADAMW_OPTIMIZER):
            raise ValueError(
                f'bf16 {{"master_weights": false}} supports Adam/AdamW '
                f"only (got {name!r}); drop the flag to use the "
                "fp32-master path")
        if name == C.ONEBIT_ADAM_OPTIMIZER:
            return onebit_adam(learning_rate=lr, b1=betas[0], b2=betas[1],
                               eps=eps, weight_decay=weight_decay,
                               freeze_step=params.get("freeze_step", 100))
        if name == C.LAMB_OPTIMIZER:
            return lamb(learning_rate=lr, b1=betas[0], b2=betas[1], eps=eps,
                        weight_decay=weight_decay,
                        max_coeff=params.get("max_coeff", 10.0),
                        min_coeff=params.get("min_coeff", 0.01),
                        bias_correction=params.get("bias_correction", True))
        if name == C.SGD_OPTIMIZER:
            momentum = params.get("momentum", 0.0) or None
            if momentum is not None:
                self._ckpt_layout(dict(momentum=momentum), None)
            return sgd(learning_rate=lr, momentum=momentum)
        if name not in (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER):
            raise ValueError(f"Unknown optimizer {name}")
        hp = dict(b1=betas[0], b2=betas[1], eps=eps)
        if self.bf16_sr_mode:
            # master-less bf16: bf16 moments, fp32 update math,
            # stochastically rounded write-back (decoupled decay)
            self._ckpt_layout(dict(hp, weight_decay=weight_decay), None)
            return adamw_bf16(learning_rate=lr, b1=betas[0], b2=betas[1],
                              eps=eps, weight_decay=weight_decay)
        # fp32 moments: optax.adamw / optax.adam math
        if params.get("adam_w_mode", True) or name == C.ADAMW_OPTIMIZER:
            self._ckpt_layout(dict(hp, eps_root=0.0,
                                   weight_decay=weight_decay), 2)
            return adamw_bf16(learning_rate=lr, b1=betas[0], b2=betas[1],
                              eps=eps, weight_decay=weight_decay,
                              state_dtype=torch.float32)
        self._ckpt_layout(dict(hp, eps_root=0.0), 1)
        return adam(learning_rate=lr, b1=betas[0], b2=betas[1], eps=eps)

    def _ckpt_layout(self, hyperparams, empty_states):
        self._ckpt_hparams = {k: np.asarray(v, np.float32)
                              for k, v in hyperparams.items()}
        self._ckpt_empty_states = empty_states

    def _configure_optimizer(self):
        self.optimizer_transform = self._build_optimizer_transform()
        self._update_takes_keep = "keep" in inspect.signature(
            self.optimizer_transform.update).parameters
        self._optimizer_shim = lr_schedules._OptimizerShim(
            lr=self._base_lr or 0.0)

    def _configure_lr_scheduler(self, client_lr_scheduler=None):
        """The device schedule (lr from the device step counter) of the
        config's scheduler block, or the constant base lr; a client
        scheduler object is stepped on the host instead (`_step_lr`)."""
        self._device_lr_fn = None
        # ZeRO-Offload's host optimizer step is a sync by nature
        self._async_dispatch = self._config.async_dispatch_enabled and \
            client_lr_scheduler is None and not self._offload_enabled()
        if client_lr_scheduler is not None:
            self.lr_scheduler = client_lr_scheduler
            if self._config.async_dispatch_enabled:
                logger.info(
                    "async_dispatch: disabled — a client lr_scheduler "
                    "object is host code the step cannot evaluate on the "
                    "device (use the config scheduler block for the "
                    "sync-free hot path)")
            return
        name = self.scheduler_name()
        if name is None:
            self.lr_scheduler = None
            if self._base_lr is not None:
                self._device_lr_fn = lr_schedules.device_schedule_fn(
                    None, base_lr=self._base_lr)
            return
        sched_cls = {
            lr_schedules.LR_RANGE_TEST: lr_schedules.LRRangeTest,
            lr_schedules.ONE_CYCLE: lr_schedules.OneCycle,
            lr_schedules.WARMUP_LR: lr_schedules.WarmupLR,
            lr_schedules.WARMUP_DECAY_LR: lr_schedules.WarmupDecayLR,
        }.get(name)
        if sched_cls is None:
            raise ValueError(f"Unknown scheduler {name}")
        params = self.scheduler_params() or {}
        # the host object is a mirror for get_lr(); the step uses the
        # device form of the same schedule
        self.lr_scheduler = sched_cls(self._optimizer_shim, **params)
        self._device_lr_fn = lr_schedules.device_schedule_fn(name, params)

    def _init_state(self):
        dev = self.device
        names = list(self._initial_params)
        if self._offload_enabled():
            self._init_offload_state()
            return
        with torch.no_grad():
            if self.mixed_precision:
                master = [torch.as_tensor(self._initial_params[n]).to(
                    dev, torch.float32, copy=True) for n in names]
                leaves = [m.to(self.compute_dtype) for m in master]
            else:
                master = None
                leaves = [torch.as_tensor(self._initial_params[n]).to(
                    dev, self.compute_dtype, copy=True) for n in names]
        params = {n: p.requires_grad_(True) for n, p in zip(names, leaves)}
        target = master if self.mixed_precision else leaves
        opt_state = self.optimizer_transform.init(target)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for p in leaves] \
            if self.gradient_accumulation_steps() > 1 else ()
        if self.dynamic_loss_scale_enabled:
            args = self.dynamic_loss_scale_args() or {}
            scale = make_loss_scale_state(
                init_scale=args.get(INITIAL_LOSS_SCALE,
                                    self.initial_dynamic_scale()),
                delayed_shift=args.get(DELAYED_SHIFT, 2), device=dev)
        else:
            scale = make_static_loss_scale_state(
                self._config.loss_scale if self.fp16_mode else 1.0, dev)
        self.state = EngineState(
            params=params, master=master, opt_state=opt_state,
            acc_grads=acc,
            global_steps=torch.zeros((), dtype=torch.int32, device=dev),
            scale=scale,
            skipped=torch.zeros((), dtype=torch.int32, device=dev))
        self._initial_params = None   # don't pin the caller's copy
        n_params = sum(p.numel() for p in leaves)
        self._init_telemetry_state(n_params)
        logger.info(f"engine initialized: {n_params / 1e6:.1f}M params, "
                    f"zero_stage={self.zero_optimization_stage()}, "
                    f"dtype={self.compute_dtype}, "
                    f"master_weights={self.mixed_precision}, device={dev}")

    def _init_offload_state(self):
        """ZeRO-Offload: no device master or optimizer state; host
        masters and CPU-Adam moments (runtime/zero/offload.py)."""
        dev = self.device
        params, acc = self._init_offload(self._initial_params)
        if self.fp16_mode:
            scale = make_static_loss_scale_state(
                self._host_scaler.cur_scale, dev)
        else:
            scale = make_static_loss_scale_state(1.0, dev)
        self.state = EngineState(
            params=params, master=None, opt_state=(), acc_grads=acc,
            global_steps=torch.zeros((), dtype=torch.int32, device=dev),
            scale=scale,
            skipped=torch.zeros((), dtype=torch.int32, device=dev))
        self._initial_params = None
        self._init_telemetry_state(int(self._host_master.size))
        logger.info(f"engine initialized (offload): "
                    f"{self._host_master.size / 1e6:.1f}M params, "
                    f"zero_stage={self.zero_optimization_stage()}, "
                    f"dtype={self.compute_dtype}, device={dev}")

    def _init_telemetry_state(self, n_params):
        """The parameter count (the monitor's MFU), the numerics group
        labels and the memory ledger's state entries."""
        # 6·N·tokens/s against the card's nominal peak: the bench.py
        # convention
        self._n_model_params = int(n_params)
        if self._numerics_on:
            names, of = self._numerics_group_index()
            self._numerics_mask = _num.group_mask(
                [of[n] for n in self.state.params], len(names), self.device)
            self.monitor.set_numerics_labels(grad=names)
        self._register_memory_ledger()

    def _numerics_group_index(self):
        """(group names, {parameter name: group index}): the JAX
        engine's `group_paths(params, depth=2)` on the model's
        `params_to_jax` tree (its leaves here the parameter names), so
        both packages label the same groups; without a converter, the
        first two components of the dotted names."""
        names = list(self.state.params)
        to_jax = getattr(self.module, "params_to_jax", None)
        if to_jax is not None:
            tree = to_jax(dict(zip(names, names)), remat=self._remat(),
                          stack=ckpt_io.Stacked)
            return _num.group_index(tree)
        groups, of = [], {}
        for n in names:
            g = "/".join(n.split(".")[:2])
            if g not in groups:
                groups.append(g)
            of[n] = groups.index(g)
        return groups, of

    def _register_memory_ledger(self):
        """Register the engine's long-lived device state groups with the
        monitor's memory ledger (monitor/memory.py): init-time shape
        metadata only, no per-step cost. Runs whether or not the monitor
        is on (the ledger is a dict)."""
        led = self.monitor.ledger
        st = self.state
        led.register_tree(_mem.CAT_PARAMS, "engine.params",
                          list(st.params.values()))
        if st.master is not None:
            led.register_tree(_mem.CAT_MASTER, "engine.master_fp32",
                              st.master)
        if st.opt_state:
            led.register_tree(_mem.CAT_OPT, "engine.opt_state",
                              st.opt_state)
        if st.acc_grads:
            led.register_tree(_mem.CAT_GRADS, "engine.acc_grads",
                              st.acc_grads)
        if self._moe_active:
            # the MoE layers' [E, C, H] dispatch pair: per-layer bytes
            # recorded at the first forward (moe/dispatch.py), times
            # the model's MoE layer count; 0 until a step runs
            from deepspeed_tpu_torch.moe.dispatch import \
                dispatch_bytes_per_layer
            info = getattr(self.module, "moe_info", lambda: None)() or {}
            n_moe = int(info.get("moe_layers", 1))
            n_experts, width = info.get("num_experts"), info.get("width")
            led.register_dynamic(
                _mem.CAT_MOE, "moe.dispatch_buffers",
                lambda: dispatch_bytes_per_layer(
                    num_experts=n_experts, width=width) * n_moe)
        from deepspeed_tpu_torch.ops import overlap as _overlap
        led.register_dynamic(_mem.CAT_OVERLAP, "overlap.inflight_window",
                             _overlap.inflight_bytes)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _next_rngs(self):
        """One microbatch's seeds: {"dropout": int, "quant": int}."""
        return {"dropout": int(self._rng.integers(1 << 62)),
                "quant": int(self._quant_rng.integers(1 << 62))}

    def _keep_prob(self):
        """PLD's theta for this step as a device scalar, or None."""
        if self.progressive_layer_drop is None:
            return None
        return self._to_device_scalar(self.progressive_layer_drop
                                      .get_theta())

    def _to_device_scalar(self, value):
        """A host float as an fp32 0-dim tensor on the engine's device,
        by a non-blocking copy from pinned memory (no sync)."""
        t = torch.tensor(float(value), dtype=torch.float32)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _micro_grad(self, batch, rngs, keep_prob=None, spans=False):
        """(raw loss, grads, router stats or None) of one microbatch;
        the loss is divided by gas before differentiation, so
        accumulated grads are the mean, and under fp16 multiplied by the
        loss scale first (the JAX engine's loss * (scale / gas)). The
        [E+2] router stats come back only while the monitor drains them
        (`_moe_stats_on`); the model computes them for its aux loss
        either way. With `spans` (train_batch's, when spans are active)
        the loss and its differentiation are timed as the forward and
        backward spans (host dispatch time, no fence)."""
        params = self.state.params
        gas = self.gradient_accumulation_steps()
        kwargs = {} if keep_prob is None else \
            {"layer_keep_prob": keep_prob}
        rstats = None
        if spans:
            self.monitor.trace.start(SPAN_FORWARD)
        with torch.enable_grad():
            if self._moe_stats_on:
                loss, rstats = self._loss_fn(
                    params, batch, rngs=rngs, deterministic=False,
                    return_router_stats=True, **kwargs)
                rstats = rstats.detach()
            else:
                loss = self._loss_fn(params, batch, rngs=rngs,
                                     deterministic=False, **kwargs)
            if self.fp16_mode:
                scaled = loss * (self.state.scale.loss_scale / gas)
            else:
                scaled = loss * (1.0 / gas) if gas > 1 else loss
            leaves = list(params.values())
            if spans:
                self.monitor.trace.stop(SPAN_FORWARD)
                self.monitor.trace.start(SPAN_BACKWARD)
            grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
            if spans:
                self.monitor.trace.stop(SPAN_BACKWARD)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        if not (self.bf16_sr_mode and gas == 1):
            grads = [g.to(torch.float32) for g in grads]
        return loss.detach(), grads, rstats

    def _step_lr(self):
        """The step's learning rate as a device scalar: under async
        dispatch from the device step counter (the config's schedule), in
        the synced loop the scheduler's host value copied without a sync;
        the constant base lr without a scheduler; None for a client
        optimizer with neither (its own lr applies). Also steps the host
        scheduler, the mirror get_lr() reads. Under ZeRO-Offload: the
        host float CPU-Adam takes (None: the optimizer block's lr)."""
        if self._offload_enabled():
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
                return float(self.lr_scheduler.get_last_lr()[0])
            return self._base_lr
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
            if not self._async_dispatch:
                return self._to_device_scalar(
                    self.lr_scheduler.get_last_lr()[0])
        if self._device_lr_fn is not None:
            return self._device_lr_fn(self.state.global_steps)
        return None

    @staticmethod
    def _state_tensors(tree):
        """Every tensor of an optimizer state (NamedTuples, tuples,
        lists, dicts), in a fixed order."""
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [t for k in sorted(tree)
                    for t in DeepSpeedEngine._state_tensors(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [t for x in tree
                    for t in DeepSpeedEngine._state_tensors(x)]
        return []

    @torch.no_grad()
    def _unscale_clip_and_update(self, grads, lr):
        """Unscale (fp16), the global norm (computed when fp16 or
        clipping consumes it), the overflow flag, clipping, the update
        (masked by keep = not overflow under fp16), the step counters
        and the scale automaton; all on the device. Returns (grad norm
        or None, overflow device bool or None, per-group numerics stats
        [G, 3] or None). With `monitor.numerics` the group stats are
        taken on the unscaled gradients, sharing the per-leaf sums of
        squares with the global norm where one is taken; they read the
        gradients and write nothing the update reads."""
        state = self.state
        grad_norm = None
        overflow = keep = None
        if self.fp16_mode:
            for g in grads:
                g.div_(state.scale.loss_scale)
        clip = self.gradient_clipping()
        sq = health_grad = None
        if self.fp16_mode or (clip and clip > 0):
            sq = _num.leaf_sumsq(grads)
            grad_norm = torch.sqrt(torch.sum(torch.stack(sq)))
        if self._numerics_on:
            health_grad = _num.grad_group_stats(grads, self._numerics_mask,
                                                sq=sq)
        if self.fp16_mode:
            overflow = ~torch.isfinite(grad_norm)
            keep = ~overflow
        if clip and clip > 0:
            factor = torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
            factor = torch.where(torch.isfinite(factor), factor,
                                 torch.ones_like(factor))
            for g in grads:
                g.mul_(factor.to(g.dtype))
        leaves = list(state.params.values())
        target = state.master if self.mixed_precision else leaves
        saved = None
        if keep is not None and not self._update_takes_keep:
            # a client transform without `keep`: its state is restored
            # where the step overflowed
            saved = [t.clone() for t in self._state_tensors(state.opt_state)]
            updates, _ = self.optimizer_transform.update(
                grads, state.opt_state, target, lr)
        elif keep is not None:
            updates, _ = self.optimizer_transform.update(
                grads, state.opt_state, target, lr, keep=keep)
        else:
            updates, _ = self.optimizer_transform.update(
                grads, state.opt_state, target, lr)
        if self.bf16_sr_mode:
            stochastic_round_apply(target, updates, self._sr_gen)
        else:
            apply_updates(target, updates, keep)
        if saved is not None:
            for t, old in zip(self._state_tensors(state.opt_state), saved):
                t.copy_(torch.where(keep, t, old))
        if self.mixed_precision:
            for p, m in zip(leaves, state.master):
                p.copy_(m)
        if keep is None:
            state.global_steps.add_(1)
            return grad_norm, None, health_grad
        state.global_steps.add_(keep.to(torch.int32))
        state.skipped.add_(overflow.to(torch.int32))
        args = self.dynamic_loss_scale_args() or {}
        new_scale = update_loss_scale(
            state.scale, overflow,
            scale_window=args.get(SCALE_WINDOW, 1000),
            min_scale=args.get(MIN_LOSS_SCALE, 1.0),
            delayed_shift=args.get(DELAYED_SHIFT, 2),
            dynamic=self.dynamic_loss_scale_enabled)
        for dest, value in zip(state.scale, new_scale):
            dest.copy_(value)
        return grad_norm, overflow, health_grad

    def _stacked(self, data_iter, batch):
        gas = self.gradient_accumulation_steps()
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs data_iter or batch")
            return stack_microbatches([next(data_iter)
                                       for _ in range(gas)])
        leading = next(iter(batch.values())).shape[0]
        if leading != gas:
            raise ValueError(f"stacked batch leading dim {leading} != "
                             f"gas {gas}")
        return batch

    def stage_batch(self, batch):
        """Place a batch dict on the engine's device. Tensors already
        there pass through; host arrays go through pinned memory with a
        non-blocking copy, so staging ahead of the step loop (as an input
        pipeline prefetches) keeps the loop free of host syncs."""
        def put(x):
            t = x if isinstance(x, torch.Tensor) else \
                torch.as_tensor(np.asarray(x))
            if t.device == self.device:
                return t
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)
        return {k: put(v) for k, v in batch.items()}

    def prefetch(self, data_source, depth=None, stacked=False):
        """Wrap a microbatch iterable in a background PrefetchLoader:
        collation and `stage_batch` placement run on a worker thread (on
        a side CUDA stream of the loader's), `depth` (default
        async_dispatch.prefetch_depth) staged batches ahead of the step
        loop. Feed the result to `train_batch` as `data_iter`. With the
        monitor on, the worker's heartbeats (terminal at exhaustion),
        its staging spans and its queued bytes reach the monitor."""
        mon = self.monitor
        loader = PrefetchLoader(
            data_source, stage_fn=self.stage_batch,
            gas=self.gradient_accumulation_steps(),
            depth=depth if depth is not None else self.prefetch_depth(),
            stacked=stacked, device=self.device,
            heartbeat=(lambda: mon.heartbeat("prefetch"))
            if mon.enabled else None,
            finished=(lambda: mon.heartbeat_done("prefetch"))
            if mon.enabled else None,
            span=(lambda t0, dur: mon.subsystem_span(
                "prefetch", "stage_batch", t0, dur))
            if mon.trace_export is not None else None)
        # the occupancy gauge and the ledger's staged-bytes entry ride
        # the live loader
        mon.attach_prefetch(loader)
        return loader

    def _spans_active(self):
        """Record fwd/bwd/step spans when wall_clock_breakdown is on OR a
        Perfetto trace is being exported (monitor.trace.enabled)."""
        return self.wall_clock_breakdown() or \
            self.monitor.trace_export is not None

    def train_batch(self, data_iter=None, batch=None):
        """One optimizer step over gas microbatches: an iterator yielding
        microbatch dicts, a PrefetchLoader (stacked batches already
        staged: no collation here), or a stacked batch dict with leading
        dim [gas, micro_batch, ...]. Returns the mean loss as a device
        tensor; nothing in the call waits for the device.

        An exception escaping the step (a StopIteration of an exhausted
        iterator aside) is a forensic moment: with the monitor on, the
        flight recorder dumps the last events and heartbeat ages —
        classified `oom` with the memory ledger's hints for
        `torch.OutOfMemoryError` — before it propagates."""
        try:
            return self._train_batch_impl(data_iter=data_iter, batch=batch)
        except StopIteration:
            raise
        except BaseException as e:
            if self.monitor.enabled and \
                    not getattr(e, "_ds_flight_dumped", False):
                try:
                    e._ds_flight_dumped = True
                except AttributeError:
                    pass
                self.monitor.on_crash(e)
            raise

    def _train_batch_impl(self, data_iter=None, batch=None):
        gas = self.gradient_accumulation_steps()
        if batch is None and isinstance(data_iter, PrefetchLoader):
            batch, data_iter = next(data_iter), None
        batch = self.stage_batch(self._stacked(data_iter, batch))
        self.tput_timer.start()
        tokens = _batch_token_count(batch)
        # tokens per sample (shape math): the stacked batch is [gas,
        # rows, ...] and the timer counts rows
        lead = _batch_lead(batch)
        self._tokens_per_sample = int(np.prod(lead[2:])) \
            if len(lead) > 2 else 1
        lr = self._step_lr()
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self._host_steps)
        kp = self._keep_prob()
        offload = self._offload_enabled()
        spans = self._spans_active()
        if spans:
            self.monitor.trace.start(SPAN_STEP)
        if gas == 1 and not offload:
            loss, grads, rstats = self._micro_grad(
                {k: v[0] for k, v in batch.items()}, self._next_rngs(), kp,
                spans)
        else:
            losses, router = [], []
            for i in range(gas):
                loss_i, g, rstats = self._micro_grad(
                    {k: v[i] for k, v in batch.items()}, self._next_rngs(),
                    kp, spans)
                with torch.no_grad():
                    for a, gi in zip(self.state.acc_grads, g):
                        a.add_(gi)
                losses.append(loss_i)
                if rstats is not None:
                    router.append(rstats)
                del g
            grads = self.state.acc_grads
            loss = torch.stack(losses).mean()
            # the router stats are per-step means: average over the
            # accumulation window
            rstats = torch.stack(router).mean(dim=0) if router else None
        grad_norm = hgrad = None
        if offload:
            # the grads-only device half, then the host step (which
            # zeroes the accumulator)
            overflow = self._offload_take_step(lr)
        else:
            grad_norm, overflow, hgrad = self._unscale_clip_and_update(
                grads, lr)
        del grads
        if gas > 1 and not offload:
            for a in self.state.acc_grads:
                a.zero_()
        if spans:
            self.monitor.trace.stop(SPAN_STEP)
        self.micro_steps += gas
        self._host_steps += 1
        self.losses = loss
        self._monitor_step(loss, grad_norm, overflow, tokens, hgrad, rstats)
        self._after_model_step(overflow)
        self.tput_timer.stop(count=gas)
        return loss

    def _monitor_step(self, loss, grad_norm, overflow, tokens, hgrad, rstats):
        """Hand one optimizer step's device scalars to the monitor (no
        host read). As in the JAX engine a step that takes no norm
        reports 0.0 (a host number, no device work). No model here taps
        activation stats (the JAX engine's layer-exposing PipelineModule
        does), so `act` is None."""
        if not self.monitor.enabled:
            return
        health = {"grad": hgrad, "act": None} if self._numerics_on \
            else None
        if self._offload_enabled():
            self.monitor.on_step(
                loss=loss, grad_norm=self._offload_last_norm,
                loss_scale=self._host_scaler.cur_scale,
                overflow=overflow, tokens=tokens,
                wire_stats=self.wire_stats, health=health, router=rstats)
        else:
            self.monitor.on_step(
                loss=loss, grad_norm=0.0 if grad_norm is None else grad_norm,
                loss_scale=self.state.scale.loss_scale, overflow=overflow,
                tokens=tokens, health=health, router=rstats)

    # ------------------------------------------------------------------
    # forward / backward / step, one microbatch at a time
    # ------------------------------------------------------------------
    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % \
            self.gradient_accumulation_steps() == 0

    def forward(self, batch, **kwargs):
        """Loss of one microbatch dict; its gradients are computed here
        too and cached for `backward`."""
        spans = self._spans_active()
        if spans:
            # fence-free span (monitor/trace.py): host dispatch time
            self.monitor.trace.start(SPAN_FORWARD)
        batch = self.stage_batch(batch)
        self._tokens_pending += _batch_token_count(batch)
        # here the batch is ONE microbatch [rows, ...]
        lead = _batch_lead(batch)
        self._tokens_per_sample = int(np.prod(lead[1:])) \
            if len(lead) > 1 else 1
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self._host_steps)
        loss, grads, rstats = self._micro_grad(batch, self._next_rngs(),
                                               self._keep_prob())
        self._pending = (loss, grads)
        # the manual path's router stats: the last microbatch's stand in
        # for the accumulation window, as in the JAX engine
        self._pending_router = rstats
        if spans:
            self.monitor.trace.stop(SPAN_FORWARD)
        return loss

    __call__ = forward

    def backward(self, loss=None, allreduce_gradients=True,
                 release_loss=False):
        """Fold the cached microbatch gradients into the accumulator."""
        if self._pending is None:
            raise RuntimeError("backward() called without a preceding "
                               "forward()")
        spans = self._spans_active()
        if spans:
            self.monitor.trace.start(SPAN_BACKWARD)
        pending_loss, grads = self._pending
        self._pending = None
        if self.state.acc_grads:
            with torch.no_grad():
                for a, g in zip(self.state.acc_grads, grads):
                    a.add_(g)
        else:
            self._ready_grads = grads
        self.losses = None if release_loss else \
            (loss if loss is not None else pending_loss)
        if spans:
            self.monitor.trace.stop(SPAN_BACKWARD)
        return loss

    def step(self, lr_kwargs=None):
        """Advance one micro step; at the accumulation boundary, take
        the optimizer step."""
        spans = self._spans_active()
        if spans:
            self.monitor.trace.start(SPAN_STEP)
        if self.is_gradient_accumulation_boundary():
            grads = self.state.acc_grads or self._ready_grads
            if grads is None:
                raise RuntimeError("step() at an accumulation boundary "
                                   "without backward()")
            tokens, self._tokens_pending = self._tokens_pending, 0
            grad_norm = hgrad = None
            if self._offload_enabled():
                overflow = self._offload_take_step(self._step_lr())
            else:
                grad_norm, overflow, hgrad = self._unscale_clip_and_update(
                    grads, self._step_lr())
            self._ready_grads = None
            for a in self.state.acc_grads:
                a.zero_()
            self._host_steps += 1
            rstats, self._pending_router = self._pending_router, None
            self._monitor_step(self.losses, grad_norm, overflow, tokens,
                               hgrad, rstats)
            self._after_model_step(overflow)
        self.micro_steps += 1
        if spans:
            self.monitor.trace.stop(SPAN_STEP)

    def _after_model_step(self, overflow=None):
        if self._offload_enabled() and not self.fp16_mode:
            overflow = None   # the JAX engine rewinds for fp16 only
        if overflow is not None and not self._async_dispatch and \
                self.lr_scheduler is not None:
            # the JAX engine's synced loop: the scheduler does not
            # advance past an overflowed step (this reads the device)
            if bool(overflow):
                self.lr_scheduler.step(
                    self.lr_scheduler.last_batch_iteration - 1)
        # print fences are fences too: a steps_per_sync that doesn't
        # divide into the print multiples must not suppress the log
        if self._host_steps % self._steps_per_sync == 0 or \
                self._host_steps % self.steps_per_print() == 0:
            self._sync_fence()

    def _sync_fence(self):
        """The hot loop's only host-device rendezvous: correct the
        scheduler mirror, drain the monitor (one device-to-host copy),
        and at print steps log (with the span breakdown under
        wall_clock_breakdown) and write the tensorboard block's scalars.
        Runs every `steps_per_sync` optimizer steps (default:
        steps_per_print)."""
        self._sync_scheduler_mirror()
        at_print = self._host_steps % self.steps_per_print() == 0
        spans = None
        if self.monitor.enabled:
            event = self.monitor.on_fence()
            spans = event.get("spans") if event else None
        elif self.wall_clock_breakdown() and at_print:
            # wall_clock_breakdown without the monitor block: the trace
            # accumulated the span times over the print window
            spans = self.monitor.trace.drain()
        if at_print and spans:
            logger.info(
                "span ms/step (host dispatch, fence-aligned) | " +
                " | ".join(f"{k}: {v['ms_per']:.2f}"
                           for k, v in spans.items()))
        if self.summary_writer is not None and at_print:
            samples = self.global_steps * self.train_batch_size()
            self.summary_writer.add_scalar(
                "Train/Samples/lr", self._current_lr(), samples)
            if self.losses is not None:
                # the tensorboard block's own read, at print fences only
                self.summary_writer.add_scalar(
                    "Train/Samples/train_loss", float(self.losses), samples)
            if self.fp16_mode:
                self.summary_writer.add_scalar(
                    "Train/Samples/loss_scale", self.loss_scale(), samples)
            self.summary_writer.flush()
        if at_print:
            logger.info(f"step={self._host_steps}, "
                        f"lr={[self._current_lr()]}")

    def _sync_scheduler_mirror(self):
        """Correct the config scheduler's host mirror from the device
        step counter (one device read): only fp16 skips make it drift,
        and only under async dispatch (the synced loop rewinds it each
        step)."""
        if self._async_dispatch and self.fp16_mode and \
                self.lr_scheduler is not None:
            gs = int(self.state.global_steps)
            if self.lr_scheduler.last_batch_iteration != gs - 1:
                self.lr_scheduler.step(gs - 1)

    # ------------------------------------------------------------------
    # data, eval, properties
    # ------------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        return DeepSpeedDataLoader(
            dataset=dataset,
            batch_size=batch_size or self.train_micro_batch_size_per_gpu(),
            collate_fn=collate_fn or self.collate_fn)

    def eval_batch(self, batch):
        """Deterministic loss of one microbatch dict, without
        gradients."""
        with torch.no_grad():
            return self._loss_fn(self.state.params, self.stage_batch(batch),
                                 rngs=None, deterministic=True)

    def async_dispatch_enabled(self):
        """Effective async-dispatch mode (the config flag, vetoed when a
        client lr_scheduler object forces the synced loop)."""
        return self._async_dispatch

    def steps_per_sync(self):
        """Host-device fence cadence in optimizer steps
        (async_dispatch.steps_per_sync, or steps_per_print when 0)."""
        return self._steps_per_sync

    def prefetch_depth(self):
        return self._config.async_dispatch_prefetch_depth

    def _current_lr(self):
        """The host mirror's learning rate, without correcting it first
        (no device read: what the fences log after their correction)."""
        if self.lr_scheduler is not None:
            try:
                return float(self.lr_scheduler.get_last_lr()[0])
            except AssertionError:
                return float(self.lr_scheduler.get_lr()[0])
        if self._base_lr is None:
            return float(getattr(self.client_optimizer, "lr", 0.0))
        return float(self._base_lr)

    def get_lr(self):
        self._sync_scheduler_mirror()
        return [self._current_lr()]

    @property
    def global_steps(self):
        """Optimizer steps attempted, skipped ones included (the host
        mirror; the device counter `state.global_steps` counts the steps
        applied)."""
        return self._host_steps

    @property
    def skipped_steps(self):
        """Steps skipped on fp16 overflow (a device read)."""
        return int(self.state.skipped)

    @property
    def params(self):
        return self.state.params

    # ------------------------------------------------------------------
    # checkpointing: the JAX engine's files and semantics
    # ------------------------------------------------------------------
    def checkpoint_tag_validation_enabled(self):
        return self._config.checkpoint_tag_validation_enabled

    def checkpoint_tag_validation_fail(self):
        return self._config.checkpoint_tag_validation_fail

    def checkpoint_async_save(self):
        return self._config.checkpoint_async_save

    def checkpoint_keep_last(self):
        return self._config.checkpoint_keep_last

    def checkpoint_writer_queue_depth(self):
        return self._config.checkpoint_writer_queue_depth

    def checkpoint_queue_policy(self):
        return self._config.checkpoint_queue_policy

    def _ckpt_trees(self, leaves, opt, lr, remat):
        """(module tree, optimizer tree) in the JAX engine's layout of
        per-parameter values `leaves` (in parameter order), the
        optimizer state `opt` (the port's, its per-parameter lists in
        parameter order) and the learning rate. The same trees of the
        live tensors are the load's destinations."""
        names = list(self.state.params)
        to_jax = getattr(self.module, "params_to_jax", None)
        if to_jax is None:
            raise TypeError(
                f"the model ({type(self.module).__name__}) needs a "
                "params_to_jax(params, remat, stack) method for "
                "checkpoints in the JAX package's layout")

        def tree(values):
            return to_jax(dict(zip(names, values)), remat=remat,
                          stack=ckpt_io.Stacked)

        if self._offload_enabled():
            # the JAX offload engine's device optimizer state is ()
            return tree(leaves), ()
        hyperparams = dict(self._ckpt_hparams, learning_rate=lr)
        if isinstance(opt, OnebitAdamState):
            return tree(leaves), OnebitAdamState(
                opt.count, tree(opt.exp_avg), tree(opt.exp_avg_sq),
                tree(opt.worker_error), tree(opt.server_error),
                {"learning_rate": opt.hyperparams["learning_rate"]})
        if isinstance(opt, LambState):
            inner = LambState(opt.count, tree(opt.mu), tree(opt.nu))
        elif isinstance(opt, SGDState):
            inner = (EmptyState() if opt.trace is None else
                     TraceState(tree(opt.trace)), EmptyState())
        elif isinstance(opt, ScaleByAdamBF16State):
            inner = ScaleByAdamState(opt.count, tree(opt.mu), tree(opt.nu))
            if self._ckpt_empty_states is not None:
                inner = (inner,) + (EmptyState(),) * self._ckpt_empty_states
            elif self.client_optimizer is not None:
                return tree(leaves), inner   # adamw_bf16's bare state
        else:
            raise TypeError(
                f"checkpoints of optimizer state {type(opt).__name__} are "
                "not in the JAX package's layout (Adam/AdamW, LAMB, SGD "
                "and 1-bit Adam are)")
        return tree(leaves), InjectStatefulHyperparamsState(
            opt.count, hyperparams, {}, inner)

    def _injected_lr(self):
        """The learning rate of the last step applied, as optax's
        injected hyperparameter holds it in the JAX engine's state."""
        if self._device_lr_fn is None:
            return np.asarray(self.get_lr()[0], np.float32)
        if self._host_steps:
            return self._device_lr_fn(self.state.global_steps - 1)
        return np.asarray(self._base_lr, np.float32)

    def _remat(self):
        return bool(getattr(getattr(self.module, "config", None), "remat",
                            False))

    def _rng_states(self):
        """The port's streams: the dropout and quant generators' states
        and the stochastic-rounding generator's."""
        return {"dropout": self._rng.bit_generator.state,
                "quant": self._quant_rng.bit_generator.state,
                "stochastic_rounding": None if self._sr_gen is None else
                self._sr_gen.get_state().numpy()}

    def _jax_rng_key(self):
        """A uint32[2] PRNG key for the JAX engine's `rng` entry, drawn
        from a copy of the dropout stream (the stream does not move)."""
        gen = np.random.Generator(type(self._rng.bit_generator)())
        gen.bit_generator.state = self._rng.bit_generator.state
        return gen.integers(0, 1 << 32, size=2, dtype=np.uint32)

    def _checkpoint_snapshot(self, client_state, isolate=True):
        """Phase 1 of save_checkpoint, the only part the train loop pays
        for. isolate=True (async): every leaf copied into fresh device
        buffers, queued on the training stream — the update writes
        parameters and moments in place — and an event recorded after
        the copies for the writer's stream to wait on. isolate=False
        (inline writes) serializes straight from live state: nothing
        steps while an inline write runs."""
        state = self.state
        take = (lambda t: t.detach().clone()) if isolate else \
            (lambda t: t.detach())
        offload = None
        if self._offload_enabled():
            # the module tree is views of the host masters' copy
            offload = self._offload_checkpoint_snapshot(isolate)
            views = self._offload_views(offload["host_master"])
            leaves = [views[n] for n in state.params]
        else:
            leaves = [take(t) for t in (
                state.master if self.mixed_precision else
                state.params.values())]
        lr = self._injected_lr()
        opt = ckpt_io.tree_map(
            lambda t: take(t) if isinstance(t, torch.Tensor) else t,
            state.opt_state)
        module, opt_state = self._ckpt_trees(leaves, opt, lr, self._remat())
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return dict(
            module=module, opt_state=opt_state, event=event, offload=offload,
            scale=LossScaleState(*[take(t) for t in state.scale]),
            skipped=take(state.skipped),
            rng=self._jax_rng_key(), torch_rng=self._rng_states(),
            global_steps=self._host_steps, micro_steps=self.micro_steps,
            lr_scheduler=self.lr_scheduler.state_dict()
            if self.lr_scheduler else None,
            # deep copy: the caller may keep mutating nested values
            # while the background writer serializes
            client_state=copy.deepcopy(dict(client_state or {})),
            zero_stage=self.zero_optimization_stage())

    def _fetch(self, trees, event):
        """`trees` with every device leaf copied into pinned host
        memory on a side stream that waits for `event` (a Stacked leaf
        into one buffer, part by part), then synchronized; CPU leaves
        pass through."""
        if event is None:
            return trees
        stream = torch.cuda.Stream(device=self.device)

        def to_host(leaf):
            if isinstance(leaf, ckpt_io.Stacked):
                host = torch.empty((len(leaf),) + tuple(leaf[0].shape),
                                   dtype=leaf[0].dtype, pin_memory=True)
                for i, part in enumerate(leaf):
                    host[i].copy_(part, non_blocking=True)
                return host
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
                return host.copy_(leaf, non_blocking=True)
            return leaf

        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            stream.wait_event(event)
            trees = ckpt_io.tree_map(to_host, trees)
        stream.synchronize()
        return trees

    def _write_checkpoint(self, save_dir, tag, snap, save_latest,
                          commit_gate=None, writer=None):
        """Phase 2 (the writer thread under async_save): fetch the
        snapshot to the host, serialize into a `<tag>.tmp` staging dir,
        fsync, rename to `<tag>`, update `latest` LAST, then rotate per
        checkpoint.keep_last. `commit_gate` orders the commit sections
        of concurrent writers by submission; a job whose `writer` was
        abandoned commits its tag dir but leaves `latest` and rotation
        alone. With the monitor on, the writer beats the `checkpoint`
        heartbeat and emits one `ckpt_commit` event from its thread."""
        write_t0 = time.perf_counter()
        self.monitor.heartbeat("checkpoint")
        staging = ckpt_io.staging_dir(save_dir, tag)
        if os.path.exists(staging):
            shutil.rmtree(staging)   # stale leftover of a killed save
        os.makedirs(staging, exist_ok=True)
        module, opt_state, scale, skipped = self._fetch(
            (snap.pop("module"), snap.pop("opt_state"), snap.pop("scale"),
             snap.pop("skipped")), snap["event"])
        # the device copies are released here, once on the host
        sd = dict(module=module, global_steps=snap["global_steps"],
                  skipped_steps=int(skipped),
                  micro_steps=snap["micro_steps"],
                  dp_world_size=1, lr_scheduler=snap["lr_scheduler"],
                  rng=snap["rng"])
        sd[TORCH_RNG] = snap["torch_rng"]
        sd.update(snap["client_state"])
        optim_sd = dict(opt_state=opt_state, scale=scale,
                        zero_stage=snap["zero_stage"])
        if snap.get("offload"):
            # host_master, host_adam and offload_wire under aux/ (the JAX
            # engine's names, read by either package)
            optim_sd.update(snap["offload"])
        ckpt_io.save_checkpoint_files(save_dir, tag, sd, optim_sd,
                                      ckpt_dir=staging)
        with (commit_gate() if commit_gate is not None
              else contextlib.nullcontext()):
            ckpt_io.commit_staging_dir(save_dir, tag)
            stale = writer is not None and writer.abandoned.is_set()
            if stale:
                logger.warning(
                    f"abandoned checkpoint writer committed tag '{tag}' "
                    "but is leaving `latest` and rotation alone (a "
                    "successor engine may own them now)")
            if save_latest and not stale:
                ckpt_io.write_latest_tag(save_dir, tag)
            keep_last = self.checkpoint_keep_last()
            if keep_last and not stale:
                deleted = ckpt_io.rotate_checkpoints(save_dir, keep_last,
                                                     protect=(tag,))
                if deleted:
                    logger.info(f"checkpoint rotation removed {deleted}")
        if self.monitor.enabled:
            # on the writer thread under async_save: the monitor's event
            # path and counters are thread-safe
            commit_ms = (time.perf_counter() - write_t0) * 1e3
            self.monitor.registry.inc("ckpt/commits")
            self.monitor.registry.set_counter("ckpt/last_commit_ms",
                                              round(commit_ms, 2))
            self.monitor.heartbeat("checkpoint")
            self.monitor.event(
                "ckpt_commit", tag=str(tag), dir=save_dir,
                wall_ms=round(commit_ms, 2),
                global_steps=int(snap["global_steps"]))
        logger.info(f"saved checkpoint {tag} to {save_dir}")

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, async_save=None):
        """Snapshot-then-write checkpoint save. With
        checkpoint.async_save (default true) the call returns after the
        device-side snapshot; a background thread serializes into a
        staging dir and commits atomically (`wait_for_checkpoint` is
        the barrier). `async_save` overrides the config per call.
        Returns False only when checkpoint.queue_policy="drop"
        discarded the save under backpressure."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        # a still-running abandoned writer may own this tag's staging
        # dir; writing into it concurrently would commit a torn mix
        for w in list(self._abandoned_ckpt_writers):
            if not w.pending():
                self._abandoned_ckpt_writers.remove(w)
            elif w.tag_in_flight(tag):
                logger.warning(
                    f"skipping checkpoint save '{tag}': an abandoned "
                    "writer still holds this tag's staging dir")
                return False
        if self.checkpoint_tag_validation_enabled():
            ckpt_io.validate_checkpoint_tag(
                tag, fail_on_mismatch=self.checkpoint_tag_validation_fail())
        if async_save is None:
            async_save = self.checkpoint_async_save()
        if async_save:
            if self._ckpt_writer is None:
                self._ckpt_writer = ckpt_io.AsyncCheckpointWriter(
                    queue_depth=self.checkpoint_writer_queue_depth(),
                    queue_policy=self.checkpoint_queue_policy())
            # queue_policy="drop" decides BEFORE the snapshot: a
            # dropped save must not pay the device copy it drops
            if not self._ckpt_writer.admit(tag):
                return False
        with self.monitor.trace.span(SPAN_CKPT):
            # the only part of an async save the train loop pays for
            snap = self._checkpoint_snapshot(client_state,
                                             isolate=async_save)
        if not async_save:
            # an in-flight async writer may hold this tag's staging dir
            # or commit `latest` after us: drain it first
            self.wait_for_checkpoint()
            self._write_checkpoint(save_dir, str(tag), snap, save_latest)
            return True
        # memory ledger: the snapshot's copies are alive from here until
        # the writer finishes (success or failure)
        tokens = self._register_ckpt_snapshot(str(tag), snap)
        led = self.monitor.ledger
        writer = self._ckpt_writer
        try:
            accepted = writer.submit(
                lambda commit_gate: self._write_checkpoint(
                    save_dir, str(tag), snap, save_latest,
                    commit_gate=commit_gate, writer=writer), tag,
                on_done=lambda: [led.release(t) for t in tokens])
        except BaseException:
            # submit re-raises a pending writer error before accepting
            # the job: a leaked entry would show a phantom snapshot
            for t in tokens:
                led.release(t)
            raise
        if not accepted:
            for t in tokens:
                led.release(t)
        return accepted

    def _register_ckpt_snapshot(self, tag, snap):
        """Register the isolated snapshot's copies with the memory
        ledger: the device clones and the offload host copies. Entry
        names carry a per-engine sequence number, so a re-save of the
        same tag while the first write is in flight does not replace the
        first save's entries. Returns the tokens the writer's on_done
        releases."""
        led = self.monitor.ledger
        self._ckpt_snap_seq = getattr(self, "_ckpt_snap_seq", 0) + 1
        name = f"snapshot:{tag}@{self._ckpt_snap_seq}"
        device = [t for t in _mem._leaves((snap["module"], snap["opt_state"],
                                           snap["scale"], snap["skipped"]))
                  if isinstance(t, torch.Tensor) and t.device == self.device]
        tokens = [led.register_tree(_mem.CAT_CKPT, name, device)]
        host = 0
        for v in _mem._leaves(snap.get("offload")):
            if isinstance(v, np.ndarray):
                host += int(v.nbytes)
        if host:
            tokens.append(led.register(_mem.CAT_CKPT, f"{name}#host", host,
                                       space=_mem.SPACE_HOST))
        return tokens

    def wait_for_checkpoint(self, timeout=None):
        """Barrier for in-flight async saves: returns once every
        submitted checkpoint is durably committed and re-raises the
        first background write error. `timeout` (seconds) bounds the
        wait: on expiry a `CheckpointWaitTimeout` is raised, so a
        supervisor can abandon a hung writer
        (`abandon_checkpoint_writers`); it carries the writer's last
        heartbeat age (`heartbeat_age_sec`, None when the monitor saw
        none)."""
        if self._ckpt_writer is None:
            return
        if self._ckpt_writer.wait(timeout):
            return
        hb, _ = self.monitor._heartbeat_state()
        age = hb.get("checkpoint")
        pending = self._ckpt_writer.pending()
        raise ckpt_io.CheckpointWaitTimeout(
            f"{pending} async checkpoint save(s) still in flight after "
            f"{timeout}s; writer heartbeat "
            + (f"{age}s ago" if age is not None else "never seen")
            + " — abandon_checkpoint_writers() detaches them (the "
            "committed `latest` tag is unaffected)",
            pending=pending, heartbeat_age_sec=age)

    def abandon_checkpoint_writers(self):
        """Detach in-flight async save jobs: the engine stops tracking
        (and waiting on) them. Running writer threads finish or fail on
        their own — their tag dirs still commit atomically — but no
        longer move `latest` or rotate, and their errors no longer
        reach the train loop. Returns the number of jobs abandoned. The
        next save_checkpoint builds a fresh writer."""
        writer, self._ckpt_writer = self._ckpt_writer, None
        if writer is None:
            return 0
        writer.abandoned.set()
        # remembered so later saves refuse a tag whose staging dir a
        # still-running abandoned job may own
        self._abandoned_ckpt_writers = [
            w for w in self._abandoned_ckpt_writers if w.pending()] + \
            [writer]
        abandoned = writer.pending()
        if abandoned:
            logger.warning(
                f"abandoning {abandoned} in-flight async checkpoint "
                "save(s); their tag dirs (if completed) remain atomic "
                "but they will not move `latest`, and their errors "
                "will no longer propagate")
        return abandoned

    def shutdown(self, wait_for_checkpoint=True, checkpoint_timeout=None):
        """Tear down the engine's host-side services so it can be
        dropped and rebuilt: drain — or, on timeout, abandon — in-flight
        checkpoint writers, then close the monitor (watchdog thread,
        flight recorder disarm, trace export, sink flush). Device state
        is freed once the last reference to the engine goes."""
        if wait_for_checkpoint:
            try:
                self.wait_for_checkpoint(timeout=checkpoint_timeout)
            except ckpt_io.CheckpointWaitTimeout as e:
                logger.warning(f"shutdown: {e}")
                self.abandon_checkpoint_writers()
            except RuntimeError as e:
                # a failed background write must not block teardown
                logger.warning(f"shutdown: pending writer error: {e}")
        self.monitor.close()

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True, retries=0):
        """Load `tag` (default: the `latest` pointer) written by either
        package into the live state, in place. Returns (path,
        client_state), or (None, {}) when there is no `latest`. The
        scanned children are read under the names of the run that
        wrote them (remat or not); an optimizer state that does not
        match this engine's optimizer leaves the moments as they are,
        with a warning, as the JAX engine does."""
        # a save of the checkpoint being loaded may still be in flight
        self.wait_for_checkpoint()
        if tag is None:
            tag = ckpt_io.read_latest_tag(load_dir, retries=retries)
            if tag is None:
                logger.warning(
                    f"Unable to find latest file at {load_dir}/latest")
                return None, {}
        sd, optim_sd = ckpt_io.load_checkpoint_files(
            load_dir, tag, zero_enabled=load_optimizer_states,
            retries=retries)
        module_flat = sd["module_flat"]
        remat = any(k.startswith("module['h']['Checkpoint")
                    for k in module_flat)
        state = self.state
        offload = self._offload_enabled()
        if offload:
            # the module lands in the host masters, then on the device
            views = self._offload_views()
            leaves = [views[n] for n in state.params]
        else:
            leaves = state.master if self.mixed_precision else \
                list(state.params.values())
        module, opt_state = self._ckpt_trees(leaves, state.opt_state, None,
                                             remat)

        def pairs(tree, flat, prefix):
            """[(destination, saved)] of every tensor leaf of `tree`,
            KeyError for a missing entry, ValueError for a shape."""
            out = []
            for key, dest in ckpt_io.tree_to_entries(tree, prefix):
                if not isinstance(dest, (torch.Tensor, ckpt_io.Stacked)):
                    continue   # hyperparameters: the config's hold
                if key not in flat:
                    raise KeyError(f"checkpoint is missing entry {key!r}")
                saved = flat[key]
                parts = [(dest, saved)]
                if isinstance(dest, ckpt_io.Stacked):
                    if saved.dim() == 0 or saved.shape[0] != len(dest):
                        raise ValueError(f"{key}: {tuple(saved.shape)} in "
                                         f"the checkpoint, {len(dest)} "
                                         "layers here")
                    parts = list(zip(dest, saved))
                for d, s in parts:
                    if tuple(d.shape) != tuple(s.shape):
                        raise ValueError(f"{key}: shape {tuple(s.shape)} "
                                         f"!= {tuple(d.shape)}")
                out += parts
            return out

        for dest, saved in pairs(module, module_flat, "module"):
            dest.copy_(saved)
        if offload:
            # the masters resync from the module even without optimizer
            # states; the wire state restarts unless the states restore it
            if self._config.zero_config.offload_wire_compressed():
                self._offload_wire_load_state_dict(None)
            if load_optimizer_states and optim_sd is not None:
                self._offload_load_state(optim_sd)
            self._offload_push_masters()
        elif self.mixed_precision:
            for p, m in zip(state.params.values(), state.master):
                p.copy_(m)
        if load_optimizer_states and optim_sd is not None and not offload:
            try:
                moments = pairs(opt_state, optim_sd["opt_state_flat"],
                                "optim")
            except (KeyError, ValueError) as e:
                # checkpoint saved with a different optimizer or layout:
                # keep the moments, as the JAX engine does
                logger.warning(
                    "checkpoint optimizer state does not match the "
                    f"current optimizer ({e}); optimizer moments not "
                    "loaded (kept as they are)")
            else:
                for dest, saved in moments:
                    dest.copy_(saved)
            saved_scale = optim_sd.get("scale")   # a legacy pickle's
            aux = optim_sd.get("aux_flat") or {}
            if saved_scale is None and "aux/scale.loss_scale" in aux:
                saved_scale = [aux[f"aux/scale.{f}"]
                               for f in LossScaleState._fields]
            if saved_scale is not None and self.fp16_mode:
                # only fp16 unscales: a saved scale != 1 restored into a
                # bf16/fp32 engine would scale every gradient forever
                for dest, saved in zip(state.scale, saved_scale):
                    dest.copy_(torch.as_tensor(np.asarray(saved)))
        for a in state.acc_grads:
            a.zero_()
        self._pending = self._ready_grads = None
        state.skipped.fill_(int(sd.get("skipped_steps", 0)))
        state.global_steps.fill_(int(sd.get("global_steps", 0)) -
                                 int(sd.get("skipped_steps", 0)))
        self.micro_steps = int(sd.get("micro_steps", 0))
        # the checkpoint's global_steps counts every optimizer step
        # (micro_steps // gas would drift across a gas change)
        self._host_steps = int(sd.get("global_steps", 0))
        streams = sd.get(TORCH_RNG)
        if streams is None:
            logger.info(
                f"checkpoint {tag} carries no {TORCH_RNG} entry (written "
                "by the JAX package): the dropout, quant and "
                "stochastic-rounding streams keep their seeded state")
        else:
            self._rng.bit_generator.state = streams["dropout"]
            self._quant_rng.bit_generator.state = streams["quant"]
            sr = streams["stochastic_rounding"]
            if self._sr_gen is not None and sr is not None:
                self._sr_gen.set_state(torch.as_tensor(sr,
                                                       dtype=torch.uint8))
        if load_lr_scheduler_states and self.lr_scheduler is not None and \
                sd.get("lr_scheduler") is not None:
            self.lr_scheduler.load_state_dict(sd["lr_scheduler"])
        client_state = {k: v for k, v in sd.items() if k not in _CKPT_META}
        logger.info(f"loaded checkpoint {tag} from {load_dir}")
        return f"{load_dir}/{tag}", client_state
