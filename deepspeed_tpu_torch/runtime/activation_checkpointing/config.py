"""Activation-checkpointing config block (copy of
deepspeed_tpu/runtime/activation_checkpointing/config.py: the same keys
and defaults). The flags select how `checkpointing.checkpoint` keeps
what the backward recomputes from: partition_activations -> shard the
saved inputs over the model-parallel group (world size 1 here: nothing
to shard); cpu_checkpointing -> keep them in pinned host memory until
the recompute; contiguous_memory_optimization /
synchronize_checkpoint_boundary are accepted no-op hints (the caching
allocator owns placement, CUDA streams the order).
"""

from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param

ACTIVATION_CHKPT = "activation_checkpointing"

ACT_CHKPT_PARTITION_ACTIVATIONS = "partition_activations"
ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT = False

ACT_CHKPT_NUMBER_CHECKPOINTS = "number_checkpoints"
ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT = None

ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION = "contiguous_memory_optimization"
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT = False

ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY = "synchronize_checkpoint_boundary"
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT = False

ACT_CHKPT_PROFILE = "profile"
ACT_CHKPT_PROFILE_DEFAULT = False

ACT_CHKPT_CPU_CHECKPOINTING = "cpu_checkpointing"
ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT = False

ACT_CHKPT_DEFAULT = {
    ACT_CHKPT_PARTITION_ACTIVATIONS: ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT,
    ACT_CHKPT_NUMBER_CHECKPOINTS: ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT,
    ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION:
    ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT,
    ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY:
    ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT,
    ACT_CHKPT_PROFILE: ACT_CHKPT_PROFILE_DEFAULT,
    ACT_CHKPT_CPU_CHECKPOINTING: ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT,
}


class DeepSpeedActivationCheckpointingConfig:
    def __init__(self, param_dict):
        self.partition_activations = None
        self.contiguous_memory_optimization = None
        self.cpu_checkpointing = None
        self.number_checkpoints = None
        self.synchronize_checkpoint_boundary = None
        self.profile = None

        if ACTIVATION_CHKPT in param_dict:
            act_chkpt_config_dict = param_dict[ACTIVATION_CHKPT]
        else:
            act_chkpt_config_dict = ACT_CHKPT_DEFAULT
        self._initialize(act_chkpt_config_dict)

    def _initialize(self, d):
        self.partition_activations = get_scalar_param(
            d, ACT_CHKPT_PARTITION_ACTIVATIONS,
            ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT)
        self.contiguous_memory_optimization = get_scalar_param(
            d, ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION,
            ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT)
        self.cpu_checkpointing = get_scalar_param(
            d, ACT_CHKPT_CPU_CHECKPOINTING,
            ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT)
        self.number_checkpoints = get_scalar_param(
            d, ACT_CHKPT_NUMBER_CHECKPOINTS,
            ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT)
        self.profile = get_scalar_param(d, ACT_CHKPT_PROFILE,
                                        ACT_CHKPT_PROFILE_DEFAULT)
        self.synchronize_checkpoint_boundary = get_scalar_param(
            d, ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY,
            ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT)

    def repr(self):
        return dict(
            partition_activations=self.partition_activations,
            contiguous_memory_optimization=self.contiguous_memory_optimization,
            cpu_checkpointing=self.cpu_checkpointing,
            number_checkpoints=self.number_checkpoints,
            profile=self.profile,
            synchronize_checkpoint_boundary=self.synchronize_checkpoint_boundary,
        )
