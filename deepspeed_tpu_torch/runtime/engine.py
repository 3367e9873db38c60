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
  * bf16 with master weights: bf16 compute parameters, an fp32 master
    copy and fp32 moments; the update lands on the master and is cast
    back;
  * bf16 {"master_weights": false}: bf16 parameters, bf16 moments
    (`adamw_bf16`), stochastically rounded write-back; at gas = 1 the
    gradients stay bf16 (a whole-tree fp32 cast would be a second
    parameter-sized tree at the step's peak).

No host sync inside `train_batch`: the learning rate is evaluated on
the device from the device step counter (`device_schedule_fn`), the
clip factor stays a device scalar, and the loss comes back as a device
tensor. A host-side mirror of the step count serves logging.

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
> 1 and stage 3 raise NotImplementedError naming ROADMAP Queue 1 item 6,
offload item 5; checkpoints (item 2), fp16 loss scaling, client
optimizer objects, LAMB, SGD and 1-bit Adam (item 4) raise too.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.bf16_optimizer import (
    adam, adamw_bf16, stochastic_round_apply)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.config_utils import load_config_dict
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)

# the seed of the stochastic-rounding stream (the JAX engine's PRNGKey(17))
SR_SEED = 17
# the key of the per-step quant stream (the JAX engine's fold_in(rng, 0x51))
QUANT_STREAM = 0x51


def _later(what, item):
    return NotImplementedError(
        f"{what} is not in the port yet: ROADMAP Queue 1 item {item}")


class EngineState(NamedTuple):
    params: Any        # {name: tensor}: compute-dtype leaves that take grads
    master: Any        # [fp32 tensor] per leaf (mixed precision) or None
    opt_state: Any
    acc_grads: Any     # [fp32 tensor] per leaf at gas > 1, else ()
    global_steps: Any  # int32 device scalar: optimizer steps taken


def _world_size():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DeepSpeedEngine:
    """Training engine. Args mirror `deepspeed_tpu.initialize`:
      model: an object with `.loss_fn(params, batch, rngs,
        deterministic)` (e.g. `models.gpt2.GPT2ForCausalLM`);
      model_parameters: the flat parameter dict {name: tensor};
      device: where the state lives (default: the model's `device`,
        else "cuda").
    The optimizer and the LR schedule come from the config; a client
    optimizer or scheduler object raises (ROADMAP Queue 1 item 4).
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
            else _world_size()
        if world > 1:
            raise _later(f"data-parallel training (world size {world})", 6)
        if optimizer is not None or lr_scheduler is not None:
            raise _later("client optimizer and lr_scheduler objects", 4)
        self._config = DeepSpeedConfig(load_config_dict(config),
                                       world_size=1)
        if self._config.zero_cpu_offload:
            raise _later("ZeRO-Offload (zero_optimization.cpu_offload)", 5)
        if self._config.zero_optimization_stage == 3:
            raise _later("ZeRO stage 3", 6)

        self.collate_fn = collate_fn
        self._resolve_model(model, model_parameters)
        self._init_moe()
        self._init_quantized_compute()
        self.device = resolve_device(
            device if device is not None else getattr(model, "device",
                                                      "cuda"))
        if self.device.type == "cuda" and self.device.index is None:
            # the index tensors carry, so placed batches compare equal
            self.device = torch.device("cuda", torch.cuda.current_device())

        self.bf16_mode = bool(self._config.bfloat16_enabled)
        self.bf16_sr_mode = self.bf16_mode and \
            not self._config.bfloat16_master_weights
        self.mixed_precision = self.bf16_mode and not self.bf16_sr_mode
        self.compute_dtype = torch.bfloat16 if self.bf16_mode else \
            torch.float32

        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            steps_per_output=self.steps_per_print(), device=self.device)
        self.training_dataloader = self.deepspeed_io(training_data) \
            if training_data is not None else None

        self.micro_steps = 0
        self._host_steps = 0
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
        self._configure_lr_scheduler()
        self._init_state()
        self.optimizer = self   # `engine.optimizer` parity

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
        it. The `moe` monitor event and the router stats at fences come
        with the monitor (ROADMAP Queue 1 item 8)."""
        mc = self._config.moe
        self._moe_active = False
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
        logger.info(
            f"MoE: {mc['num_experts']} experts (top_k={mc['top_k']}, "
            f"cf={mc['capacity_factor']}, every_n_layers="
            f"{mc['every_n_layers']}) over expert axis {expert_axis}")

    def _init_quantized_compute(self):
        """Wire the `quantized_compute` config block into the model:
        call its `configure_quantized_compute` hook with the configured
        mode, block and stochastic_rounding, or warn when the model has
        no such hook (the block then has no effect). The JAX engine also
        emits a `quantized_matmul` monitor event here; that comes with
        the monitor (ROADMAP Queue 1 item 8)."""
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
            return
        hook(qc["mode"], block=qc["block"],
             stochastic_rounding=qc["stochastic_rounding"])

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

    # ------------------------------------------------------------------
    # optimizer, schedule, state
    # ------------------------------------------------------------------
    def _build_optimizer_transform(self):
        name = (self._config.optimizer_name or C.ADAM_OPTIMIZER).lower()
        params = dict(self._config.optimizer_params or {})
        lr = params.get("lr", 1e-3)
        betas = params.get("betas", (0.9, 0.999))
        eps = params.get("eps", 1e-8)
        weight_decay = params.get("weight_decay", 0.0)
        self._base_lr = lr
        if name not in (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER):
            raise _later(f"optimizer {name!r} (the port has Adam and "
                         "AdamW)", 4)
        if self.bf16_sr_mode:
            # master-less bf16: bf16 moments, fp32 update math,
            # stochastically rounded write-back (decoupled decay)
            return adamw_bf16(learning_rate=lr, b1=betas[0], b2=betas[1],
                              eps=eps, weight_decay=weight_decay)
        # fp32 moments: optax.adamw / optax.adam math
        if params.get("adam_w_mode", True) or name == C.ADAMW_OPTIMIZER:
            return adamw_bf16(learning_rate=lr, b1=betas[0], b2=betas[1],
                              eps=eps, weight_decay=weight_decay,
                              state_dtype=torch.float32)
        return adam(learning_rate=lr, b1=betas[0], b2=betas[1], eps=eps)

    def _configure_optimizer(self):
        self.optimizer_transform = self._build_optimizer_transform()
        self._optimizer_shim = lr_schedules._OptimizerShim(lr=self._base_lr)

    def _configure_lr_scheduler(self):
        """The device schedule (lr from the device step counter) of the
        config's scheduler block, or the constant base lr."""
        name = self.scheduler_name()
        if name is None:
            self.lr_scheduler = None
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
        self.state = EngineState(
            params=params, master=master, opt_state=opt_state,
            acc_grads=acc,
            global_steps=torch.zeros((), dtype=torch.int32, device=dev))
        self._initial_params = None   # don't pin the caller's copy
        n_params = sum(p.numel() for p in leaves)
        logger.info(f"engine initialized: {n_params / 1e6:.1f}M params, "
                    f"zero_stage={self.zero_optimization_stage()}, "
                    f"dtype={self.compute_dtype}, "
                    f"master_weights={self.mixed_precision}, device={dev}")

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _next_rngs(self):
        """One microbatch's seeds: {"dropout": int, "quant": int}."""
        return {"dropout": int(self._rng.integers(1 << 62)),
                "quant": int(self._quant_rng.integers(1 << 62))}

    def _micro_grad(self, batch, rngs):
        """(raw loss, grads) of one microbatch; the loss is divided by
        gas before differentiation, so accumulated grads are the mean."""
        params = self.state.params
        gas = self.gradient_accumulation_steps()
        with torch.enable_grad():
            loss = self._loss_fn(params, batch, rngs=rngs,
                                 deterministic=False)
            scaled = loss * (1.0 / gas) if gas > 1 else loss
            leaves = list(params.values())
            grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        if not (self.bf16_sr_mode and gas == 1):
            grads = [g.to(torch.float32) for g in grads]
        return loss.detach(), grads

    def _step_lr(self):
        """The step's learning rate as a device scalar, from the device
        step counter. Also steps the host scheduler, the mirror get_lr()
        reads."""
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        return self._device_lr_fn(self.state.global_steps)

    @torch.no_grad()
    def _unscale_clip_and_update(self, grads, lr):
        """Clip by the global norm (computed only when clipping is on),
        update, advance the step counter. Returns the grad norm (a
        device scalar) or None when nothing consumed it."""
        state = self.state
        grad_norm = None
        clip = self.gradient_clipping()
        if clip and clip > 0:
            sq = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                              for g in grads])
            grad_norm = torch.sqrt(torch.sum(sq))
            factor = torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
            factor = torch.where(torch.isfinite(factor), factor,
                                 torch.ones_like(factor))
            for g in grads:
                g.mul_(factor.to(g.dtype))
        leaves = list(state.params.values())
        target = state.master if self.mixed_precision else leaves
        updates, _ = self.optimizer_transform.update(
            grads, state.opt_state, target, lr)
        if self.bf16_sr_mode:
            stochastic_round_apply(target, updates, self._sr_gen)
        else:
            for t, u in zip(target, updates):
                t.add_(u)
        if self.mixed_precision:
            for p, m in zip(leaves, state.master):
                p.copy_(m)
        state.global_steps.add_(1)
        return grad_norm

    def _stacked(self, data_iter, batch):
        gas = self.gradient_accumulation_steps()
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs data_iter or batch")
            micro = [next(data_iter) for _ in range(gas)]
            return {k: np.stack([np.asarray(m[k]) for m in micro])
                    for k in micro[0]}
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

    def train_batch(self, data_iter=None, batch=None):
        """One optimizer step over gas microbatches: an iterator yielding
        microbatch dicts, or a stacked batch dict with leading dim
        [gas, micro_batch, ...]. Returns the mean loss as a device
        tensor; nothing in the call waits for the device."""
        gas = self.gradient_accumulation_steps()
        batch = self.stage_batch(self._stacked(data_iter, batch))
        self.tput_timer.start()
        lr = self._step_lr()
        if gas == 1:
            loss, grads = self._micro_grad(
                {k: v[0] for k, v in batch.items()}, self._next_rngs())
        else:
            losses = []
            for i in range(gas):
                loss_i, g = self._micro_grad(
                    {k: v[i] for k, v in batch.items()}, self._next_rngs())
                with torch.no_grad():
                    for a, gi in zip(self.state.acc_grads, g):
                        a.add_(gi)
                losses.append(loss_i)
                del g
            grads = self.state.acc_grads
            loss = torch.stack(losses).mean()
        self._unscale_clip_and_update(grads, lr)
        del grads
        if gas > 1:
            for a in self.state.acc_grads:
                a.zero_()
        self.micro_steps += gas
        self._host_steps += 1
        self.losses = loss
        self._after_model_step()
        self.tput_timer.stop(count=gas)
        return loss

    # ------------------------------------------------------------------
    # forward / backward / step, one microbatch at a time
    # ------------------------------------------------------------------
    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % \
            self.gradient_accumulation_steps() == 0

    def forward(self, batch, **kwargs):
        """Loss of one microbatch dict; its gradients are computed here
        too and cached for `backward`."""
        batch = self.stage_batch(batch)
        loss, grads = self._micro_grad(batch, self._next_rngs())
        self._pending = (loss, grads)
        return loss

    __call__ = forward

    def backward(self, loss=None, allreduce_gradients=True,
                 release_loss=False):
        """Fold the cached microbatch gradients into the accumulator."""
        if self._pending is None:
            raise RuntimeError("backward() called without a preceding "
                               "forward()")
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
        return loss

    def step(self, lr_kwargs=None):
        """Advance one micro step; at the accumulation boundary, take
        the optimizer step."""
        if self.is_gradient_accumulation_boundary():
            grads = self.state.acc_grads or self._ready_grads
            if grads is None:
                raise RuntimeError("step() at an accumulation boundary "
                                   "without backward()")
            self._unscale_clip_and_update(grads, self._step_lr())
            self._ready_grads = None
            for a in self.state.acc_grads:
                a.zero_()
            self._host_steps += 1
            self._after_model_step()
        self.micro_steps += 1

    def _after_model_step(self):
        if self._host_steps % self.steps_per_print() == 0:
            logger.info(f"step={self._host_steps}, lr={self.get_lr()}")

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

    def get_lr(self):
        if self.lr_scheduler is not None:
            try:
                return [float(self.lr_scheduler.get_last_lr()[0])]
            except AssertionError:
                return [float(self.lr_scheduler.get_lr()[0])]
        return [float(self._base_lr)]

    @property
    def global_steps(self):
        """Optimizer steps taken (the host mirror: every step advances
        it, and no step is skipped without fp16 loss scaling)."""
        return self._host_steps

    @property
    def params(self):
        return self.state.params

    def save_checkpoint(self, *args, **kwargs):
        raise _later("checkpoints (runtime/checkpoint.py)", 2)

    def load_checkpoint(self, *args, **kwargs):
        raise _later("checkpoints (runtime/checkpoint.py)", 2)
