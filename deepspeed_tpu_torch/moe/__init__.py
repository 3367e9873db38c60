"""Mixture-of-experts (port of deepspeed_tpu/moe/ at world size 1).

  router.py          fp32 softmax top-k routing with capacity slots, the
                     Switch/GShard aux loss, the [E+2] router stats
  fused_dispatch.py  kernel K8: dispatch and combine as row gathers
                     (CUDA on the card, plain twins on the CPU), with
                     atomic-free backward passes
  dispatch.py        the one-hot einsum pair (fused_dispatch "off")
  experts.py         grouped-GEMM expert FFNs, one grouped K4 launch for
                     all experts' bias + GeLU; quantized experts as one
                     grouped K6 launch per projection
  layer.py           `MoEMLP`, `MoEConfig`, `moe_mlp_reference`

Expert-parallel meshes and their all-to-all, the ZeRO-3 scheduled MoE
path and the dispatch-byte ledger are later slices.
"""

from deepspeed_tpu_torch.moe.dispatch import (combine_tokens,
                                              dispatch_buffer_nbytes,
                                              dispatch_tokens)
from deepspeed_tpu_torch.moe.experts import (ExpertFFN,
                                             expert_ffn_reference,
                                             grouped_gemm)
from deepspeed_tpu_torch.moe.fused_dispatch import (fused_combine,
                                                    fused_dispatch,
                                                    routing_slots)
from deepspeed_tpu_torch.moe.layer import (MoEConfig, MoEMLP,
                                           moe_mlp_reference,
                                           resolve_fused_dispatch,
                                           resolve_pack_experts)
from deepspeed_tpu_torch.moe.router import (STAT_AUX, STAT_DROP,
                                            router_capacity, top_k_gating,
                                            top_k_gating_indexed)

__all__ = [
    "MoEConfig", "MoEMLP", "ExpertFFN", "grouped_gemm",
    "expert_ffn_reference", "moe_mlp_reference", "resolve_pack_experts",
    "resolve_fused_dispatch", "router_capacity", "top_k_gating",
    "top_k_gating_indexed", "fused_dispatch", "fused_combine",
    "routing_slots", "dispatch_tokens", "combine_tokens",
    "dispatch_buffer_nbytes", "STAT_AUX", "STAT_DROP",
]
