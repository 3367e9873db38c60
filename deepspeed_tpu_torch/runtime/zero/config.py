"""ZeRO config keys (trimmed copy of deepspeed_tpu/runtime/zero/config.py:
the stage and the offload switch, which is what the port's engine reads
at data-parallel world size 1). Values are identical to the JAX
package's; tests/test_torch_engine.py holds them equal."""

ZERO_OPTIMIZATION = "zero_optimization"
ZERO_OPTIMIZATION_STAGE = "stage"
ZERO_OPTIMIZATION_STAGE_DEFAULT = 0
ZERO_OPTIMIZATION_CPU_OFFLOAD = "cpu_offload"
ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT = False
MAX_STAGE_ZERO_OPTIMIZATION = 3
