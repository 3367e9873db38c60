"""ZeRO config block (trimmed copy of deepspeed_tpu/runtime/zero/config.py:
the stage, the offload switch and the offload wire, which is what the
port's engine reads at data-parallel world size 1). Values, asserts and
their words are the JAX package's; tests/test_torch_engine.py holds the
keys equal."""

from deepspeed_tpu_torch.runtime import constants as consts
from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param

ZERO_OPTIMIZATION = "zero_optimization"
ZERO_OPTIMIZATION_STAGE = "stage"
ZERO_OPTIMIZATION_STAGE_DEFAULT = 0
ZERO_OPTIMIZATION_CPU_OFFLOAD = "cpu_offload"
ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT = False
MAX_STAGE_ZERO_OPTIMIZATION = 3
ZERO_OPTIMIZATION_DEFAULT = {
    ZERO_OPTIMIZATION_STAGE: ZERO_OPTIMIZATION_STAGE_DEFAULT,
}


class DeepSpeedZeroConfig:
    """stage, cpu_offload and the offload_wire block of
    `zero_optimization` (a bool block means stage 1 or 0)."""

    def __init__(self, param_dict):
        d = param_dict.get(ZERO_OPTIMIZATION, ZERO_OPTIMIZATION_DEFAULT)
        if isinstance(d, bool):
            d = {ZERO_OPTIMIZATION_STAGE: 1 if d else 0}
        self.stage = get_scalar_param(d, ZERO_OPTIMIZATION_STAGE,
                                      ZERO_OPTIMIZATION_STAGE_DEFAULT)
        self.cpu_offload = get_scalar_param(
            d, ZERO_OPTIMIZATION_CPU_OFFLOAD,
            ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)
        self._initialize_offload_wire(d.get(consts.OFFLOAD_WIRE) or {})

    def _initialize_offload_wire(self, w):
        """zero_optimization.offload_wire: the compressed format of the
        ZeRO-Offload round trip (runtime/constants.py; implemented by
        runtime/zero/offload.py). The defaults are the native wire."""
        k = consts
        assert isinstance(w, dict), \
            f"zero_optimization.{k.OFFLOAD_WIRE} must be a dict, got {w!r}"
        self.offload_wire_grad_bits = int(get_scalar_param(
            w, k.OFFLOAD_WIRE_GRAD_BITS, k.OFFLOAD_WIRE_GRAD_BITS_DEFAULT))
        self.offload_wire_param_bits = int(get_scalar_param(
            w, k.OFFLOAD_WIRE_PARAM_BITS, k.OFFLOAD_WIRE_PARAM_BITS_DEFAULT))
        self.offload_wire_warmup_steps = int(get_scalar_param(
            w, k.OFFLOAD_WIRE_WARMUP_STEPS,
            k.OFFLOAD_WIRE_WARMUP_STEPS_DEFAULT))
        assert self.offload_wire_grad_bits in \
            k.OFFLOAD_WIRE_GRAD_BITS_VALID, (
                f"{k.OFFLOAD_WIRE}.{k.OFFLOAD_WIRE_GRAD_BITS} must be one "
                f"of {k.OFFLOAD_WIRE_GRAD_BITS_VALID}, got "
                f"{self.offload_wire_grad_bits}")
        assert self.offload_wire_param_bits in \
            k.OFFLOAD_WIRE_PARAM_BITS_VALID, (
                f"{k.OFFLOAD_WIRE}.{k.OFFLOAD_WIRE_PARAM_BITS} must be one "
                f"of {k.OFFLOAD_WIRE_PARAM_BITS_VALID}, got "
                f"{self.offload_wire_param_bits}")
        assert self.offload_wire_warmup_steps >= 0, (
            f"{k.OFFLOAD_WIRE}.{k.OFFLOAD_WIRE_WARMUP_STEPS} must be >= 0")

    def offload_wire_compressed(self):
        """True when any leg of the wire differs from the native format."""
        return (self.offload_wire_grad_bits != 32 or
                self.offload_wire_param_bits != 32)
