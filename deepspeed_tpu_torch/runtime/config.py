"""DeepSpeedConfig: JSON config parsing and batch-triple resolution
(trimmed port of deepspeed_tpu/runtime/config.py).

What the training slice reads: the batch triple (train_batch_size =
micro batch x gradient accumulation x data-parallel world size; any two
determine the third), the `bf16` block with `master_weights`,
`zero_optimization.stage`, the `optimizer` and `scheduler` blocks,
`gradient_clipping` and `steps_per_print`.

The blocks of later slices raise NotImplementedError naming the ROADMAP
item that ports them: fp16 and loss scaling, ZeRO offload, pipeline,
MoE, quantized compute, the monitor and progressive layer drop.
"""

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import (get_scalar_param,
                                                      load_config_dict)
from deepspeed_tpu_torch.runtime.zero import config as Z


class DeepSpeedConfigError(Exception):
    pass


def _later(what, item):
    return NotImplementedError(
        f"{what} is not in the port yet: ROADMAP Queue 1 item {item}")


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


def get_bfloat16_master_weights(param_dict):
    for key in (C.BFLOAT16, C.BFLOAT16_ALIAS):
        if key in param_dict:
            return get_scalar_param(param_dict[key],
                                    C.BFLOAT16_MASTER_WEIGHTS,
                                    C.BFLOAT16_MASTER_WEIGHTS_DEFAULT)
    return C.BFLOAT16_MASTER_WEIGHTS_DEFAULT


def get_zero_config(param_dict):
    """(stage, cpu_offload) of the zero_optimization block (a bool block
    means stage 1 or 0, as in the JAX package)."""
    d = param_dict.get(Z.ZERO_OPTIMIZATION, {})
    if isinstance(d, bool):
        d = {Z.ZERO_OPTIMIZATION_STAGE: 1 if d else 0}
    stage = get_scalar_param(d, Z.ZERO_OPTIMIZATION_STAGE,
                             Z.ZERO_OPTIMIZATION_STAGE_DEFAULT)
    if not 0 <= stage <= Z.MAX_STAGE_ZERO_OPTIMIZATION:
        raise DeepSpeedConfigError(
            f"zero_optimization.stage must be in "
            f"[0,{Z.MAX_STAGE_ZERO_OPTIMIZATION}], got {stage}")
    offload = get_scalar_param(d, Z.ZERO_OPTIMIZATION_CPU_OFFLOAD,
                               Z.ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)
    return stage, bool(offload)


def _block_type_and_params(param_dict, key):
    block = param_dict.get(key) or {}
    name = block.get(C.TYPE) if isinstance(block, dict) else None
    params = block.get(C.OPTIMIZER_PARAMS) if name is not None else None
    return name, params


class DeepSpeedConfig:
    def __init__(self, json_file_or_dict, world_size=1):
        self._param_dict = load_config_dict(json_file_or_dict)
        self.world_size = world_size
        self._check_later_slices(self._param_dict)
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()

    @staticmethod
    def _check_later_slices(d):
        if _block_enabled(d, C.FP16, C.FP16_ENABLED):
            raise _later("fp16 with loss scaling "
                         "(runtime/fp16/loss_scaler.py); use bf16", 10)
        if _block_enabled(d, C.PROGRESSIVE_LAYER_DROP, C.PLD_ENABLED):
            raise _later("progressive layer drop", 10)
        if d.get(C.PIPELINE):
            raise _later("pipeline parallelism", 5)
        if _block_enabled(d, C.MOE):
            raise _later("mixture-of-experts", 8)
        qc = d.get(C.QUANTIZED_COMPUTE)
        if qc and (not isinstance(qc, dict) or
                   qc.get("mode", "off") not in ("off", False, 0, None)):
            raise _later("int8 quantized compute (kernel K6)", 7)
        if _block_enabled(d, C.MONITOR, C.MONITOR_ENABLED):
            raise _later("the monitor block", 3)

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

        self.zero_optimization_stage, self.zero_cpu_offload = \
            get_zero_config(d)
        self.zero_enabled = self.zero_optimization_stage > 0

        self.bfloat16_enabled = get_bfloat16_enabled(d)
        self.bfloat16_master_weights = get_bfloat16_master_weights(d)

        self.gradient_clipping = get_scalar_param(
            d, C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)

        self.optimizer_name, self.optimizer_params = \
            _block_type_and_params(d, C.OPTIMIZER)
        if self.optimizer_name is not None and \
                self.optimizer_name.lower() in C.DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.scheduler_name, self.scheduler_params = \
            _block_type_and_params(d, C.SCHEDULER)

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
