from deepspeed_tpu_torch.ops.sequence.ring_attention import (
    gather_sequence, ring_attention, ring_attention_local, scatter_sequence,
    ulysses_attention, ulysses_attention_local)

__all__ = ["ring_attention", "ring_attention_local", "ulysses_attention",
           "ulysses_attention_local", "scatter_sequence", "gather_sequence"]
