"""FLOPS-profiler config block (port of deepspeed_tpu/profiling/config.py:
the same keys, defaults and resolution).

The profile itself counts the step's aten operations in a dispatch mode
and takes each hand-written kernel's row from the kernel's own cost
function (`profiling/flops_profiler/profiler.py`).
"""

from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param

FLOPS_PROFILER = "flops_profiler"

FLOPS_PROFILER_ENABLED = "enabled"
FLOPS_PROFILER_ENABLED_DEFAULT = False

FLOPS_PROFILER_PROFILE_STEP = "profile_step"
FLOPS_PROFILER_PROFILE_STEP_DEFAULT = 1

FLOPS_PROFILER_MODULE_DEPTH = "module_depth"
FLOPS_PROFILER_MODULE_DEPTH_DEFAULT = -1

FLOPS_PROFILER_TOP_MODULES = "top_modules"
FLOPS_PROFILER_TOP_MODULES_DEFAULT = 3

FLOPS_PROFILER_DETAILED = "detailed"
FLOPS_PROFILER_DETAILED_DEFAULT = True


class DeepSpeedFlopsProfilerConfig:
    def __init__(self, param_dict):
        self.enabled = None
        self.profile_step = None
        self.module_depth = None
        self.top_modules = None
        self.detailed = None

        if FLOPS_PROFILER in param_dict:
            d = param_dict[FLOPS_PROFILER]
        else:
            d = {}
        self._initialize(d)

    def _initialize(self, d):
        self.enabled = get_scalar_param(d, FLOPS_PROFILER_ENABLED,
                                        FLOPS_PROFILER_ENABLED_DEFAULT)
        self.profile_step = get_scalar_param(d, FLOPS_PROFILER_PROFILE_STEP,
                                             FLOPS_PROFILER_PROFILE_STEP_DEFAULT)
        self.module_depth = get_scalar_param(d, FLOPS_PROFILER_MODULE_DEPTH,
                                             FLOPS_PROFILER_MODULE_DEPTH_DEFAULT)
        self.top_modules = get_scalar_param(d, FLOPS_PROFILER_TOP_MODULES,
                                            FLOPS_PROFILER_TOP_MODULES_DEFAULT)
        self.detailed = get_scalar_param(d, FLOPS_PROFILER_DETAILED,
                                         FLOPS_PROFILER_DETAILED_DEFAULT)
