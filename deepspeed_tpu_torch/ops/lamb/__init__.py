from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb, LambState, lamb

__all__ = ["FusedLamb", "LambState", "lamb"]
