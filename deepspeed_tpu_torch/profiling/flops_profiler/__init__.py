from deepspeed_tpu_torch.profiling.flops_profiler.profiler import (
    FlopsProfiler, get_model_profile)

__all__ = ["FlopsProfiler", "get_model_profile"]
