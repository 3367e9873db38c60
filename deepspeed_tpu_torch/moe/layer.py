"""MoEMLP, the mixture-of-experts MLP, and its reference (port of
deepspeed_tpu/moe/layer.py).

`MoEMLP` replaces a block's dense MLP with an fp32 softmax top-k router,
capacity-slot dispatch, grouped-GEMM expert FFNs and gate-weighted
combine, and returns `(y, stats)`: the [E+2] router stats vector rides
up to the model loss (the aux load-balancing term) without touching the
host. Dispatch and combine take one of two routes
(`resolve_fused_dispatch`): the fused row gathers of kernel K8
(`fused_dispatch.py`), or the one-hot einsum pair (`dispatch.py`).

The pair reads the `moe_dispatch` site of the overlap runtime
(`ops/overlap.py`) as the JAX layer does: the einsum route splits its
dispatch along the capacity axis by the schedule's `granularity`, the
in-flight window is recorded, and `async_collective`/`overlap_fence`
(identities in eager order) mark where the JAX layer ties the pair.

`moe_mlp_reference` is the oracle: the same gating, the einsum pair and
a per-expert loop of single GEMMs with plain epilogues.
"""

import dataclasses
from typing import Any

import torch
from torch import nn

from deepspeed_tpu_torch.moe.dispatch import (combine_tokens,
                                              dispatch_buffer_nbytes,
                                              record_dispatch_bytes,
                                              dispatch_tokens,
                                              replicate_stats)
from deepspeed_tpu_torch.moe.experts import ExpertFFN, expert_ffn_reference
from deepspeed_tpu_torch.moe.fused_dispatch import (fused_combine,
                                                    fused_dispatch,
                                                    routing_slots)
from deepspeed_tpu_torch.moe.router import (_dense_masks, _gating_core,
                                            _index_routing, router_capacity,
                                            top_k_gating)
from deepspeed_tpu_torch.ops import overlap as _overlap

EXPERT_MESH_SLICE = ("expert-parallel meshes come with world size > 1 "
                     "(ROADMAP Queue 1 item 6)")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Model-side MoE configuration (the JAX package's fields; the
    engine's `moe` block maps onto it through `configure_moe`).
    num_experts and every_n_layers shape the parameters; the router
    knobs (top_k, capacity_factor, aux_loss_weight, jitter_eps,
    fused_dispatch) can change between steps. `mesh` stays None: expert
    meshes need world size > 1."""
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    every_n_layers: int = 1
    jitter_eps: float = 0.0
    quantized_experts: str = "off"
    quant_block: int = 128
    pack_experts: Any = "auto"
    fused_dispatch: Any = "auto"
    mesh: Any = None

    def validate(self):
        if self.num_experts < 2:
            raise ValueError(
                f"moe.num_experts must be >= 2, got {self.num_experts}")
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(
                f"moe.top_k must be in [1, {self.num_experts}], got "
                f"{self.top_k}")
        if self.capacity_factor <= 0:
            raise ValueError(
                "moe.capacity_factor must be > 0, got "
                f"{self.capacity_factor}")
        if self.every_n_layers < 1:
            raise ValueError(
                "moe.every_n_layers must be >= 1, got "
                f"{self.every_n_layers}")
        if self.aux_loss_weight < 0 or self.jitter_eps < 0:
            raise ValueError(
                "moe.aux_loss_weight and moe.jitter_eps must be >= 0")
        if self.pack_experts not in (True, False, "auto"):
            raise ValueError(
                "moe.pack_experts must be True, False or 'auto', got "
                f"{self.pack_experts!r}")
        if self.fused_dispatch not in (True, False, "on", "off", "auto"):
            raise ValueError(
                "moe.fused_dispatch must be 'on', 'off' or 'auto', "
                f"got {self.fused_dispatch!r}")
        if self.mesh is not None:
            raise NotImplementedError(EXPERT_MESH_SLICE)
        return self


def resolve_pack_experts(mode):
    """`pack_experts` -> bool: True/False pass through; "auto" is False
    (the block-diagonal pairing fills a TPU's 128-wide matrix lanes and
    only adds work on the card or the CPU)."""
    if mode is True or mode is False:
        return mode
    if mode == "auto":
        return False
    raise ValueError(
        f"pack_experts must be True, False or 'auto', got {mode!r}")


def resolve_fused_dispatch(mode, mesh=None, device=None):
    """`fused_dispatch` -> bool. "on"/True: the K8 gathers (their plain
    twins on the CPU); "off"/False: the einsum pair; "auto": fused on
    CUDA, where no expert axis shards the buffers (always, at world size
    1), and the einsum pair on the CPU, as the JAX package's "auto"
    fuses on its accelerator only."""
    if mesh is not None:
        raise NotImplementedError(EXPERT_MESH_SLICE)
    if mode in (False, "off"):
        return False
    if mode in (True, "on"):
        return True
    if mode == "auto":
        return device is not None and torch.device(device).type == "cuda"
    raise ValueError(
        f"fused_dispatch must be 'on', 'off' or 'auto', got {mode!r}")


class MoEMLP(nn.Module):
    """Router + dispatch + grouped-GEMM experts + combine.

    Parameters: `wg` [H, E] router weights and `experts` (ExpertFFN:
    wi/bi/wo/bo, expert dim leading). Input [B, T, H]; returns (y
    [B, T, H] in the compute dtype, stats [E+2]). Dropped tokens give
    zeros: the caller's residual carries them.

    `route_override` (test-only, default None): an [N, k] tensor of
    expert choices that replaces the router's own top-k (gate values
    and stats still come from this call's probabilities). After each
    call `last_expert_idx` holds the choices the call used."""

    def __init__(self, moe: MoEConfig, d_model, d_ff, dtype, param_dtype):
        super().__init__()
        self.moe, self.dtype = moe, dtype
        self.wg = nn.Parameter(torch.empty((d_model, moe.num_experts),
                                           dtype=param_dtype))
        self.experts = ExpertFFN(moe.num_experts, d_model, d_ff, dtype,
                                 param_dtype,
                                 pack=resolve_pack_experts(moe.pack_experts),
                                 quantized=moe.quantized_experts,
                                 quant_block=moe.quant_block)
        self.route_override = None
        self.last_expert_idx = None

    def forward(self, x, deterministic=True, jitter_gen=None):
        moe = self.moe
        b, t, h = x.shape
        n, e = b * t, moe.num_experts
        xf = x.reshape(n, h)
        # router in fp32 (the gate decision must not move with the
        # compute dtype); matmuls run full fp32 while
        # torch.backends.cuda.matmul.allow_tf32 is False, torch's default
        logits = torch.matmul(xf.to(torch.float32),
                              self.wg.to(torch.float32))
        gen = jitter_gen if not deterministic else None
        capacity = router_capacity(n, e, moe.top_k, moe.capacity_factor)
        gate_vals, gate_idx, fits, slots, stats = _gating_core(
            logits, moe.top_k, capacity, gen, moe.jitter_eps,
            self.route_override)
        self.last_expert_idx = gate_idx.detach()
        stats = replicate_stats(stats, moe.mesh)
        nbytes = dispatch_buffer_nbytes(e, capacity, h, self.dtype)
        # the memory ledger's `moe_dispatch` accounting (a host dict
        # write, no device work)
        record_dispatch_bytes(id(self), nbytes, num_experts=e, width=h)
        sched = _overlap.schedule(_overlap.SITE_MOE, payload_bytes=nbytes,
                                  mesh=moe.mesh)
        xc = xf.to(self.dtype)
        fused = resolve_fused_dispatch(moe.fused_dispatch, moe.mesh,
                                       x.device)
        if fused:
            routing = _index_routing(gate_vals, gate_idx, fits, slots)
            src, dest = routing_slots(routing, e, capacity)
            xe = fused_dispatch(xc, src, dest, routing["keep"]).reshape(
                e, capacity, h)
        else:
            dispatch, combine = _dense_masks(capacity, gate_vals, fits,
                                             slots)
            xe = dispatch_tokens(xc, dispatch,
                                 granularity=sched["granularity"])
        if sched["overlap"]:
            xe, stats = _overlap.async_collective(xe, stats)
        ye = self.experts(xe)
        _overlap.record_inflight(_overlap.SITE_MOE, str(id(self)),
                                 nbytes if sched["overlap"] else 0)
        if fused:
            y = fused_combine(ye.reshape(e * capacity, h), dest,
                              routing["keep"], routing["w"])
        else:
            y = combine_tokens(ye, combine)
        if sched["overlap"]:
            y = _overlap.overlap_fence(y, stats)
        return y.reshape(b, t, h).to(self.dtype), stats


def moe_mlp_reference(params, x, moe: MoEConfig, dtype=torch.float32):
    """Per-expert-loop reference of MoEMLP: the same parameters (a flat
    dict as `MoEMLP.named_parameters` names them: "wg", "experts.wi",
    ...), the same gating, the einsum pair, looped single GEMMs."""
    b, t, h = x.shape
    n = b * t
    xf = x.reshape(n, h)
    logits = xf.to(torch.float32) @ params["wg"].to(torch.float32)
    capacity = router_capacity(n, moe.num_experts, moe.top_k,
                               moe.capacity_factor)
    dispatch, combine, stats = top_k_gating(logits, moe.top_k, capacity)
    xe = torch.einsum("nec,nh->ech", dispatch.to(dtype), xf.to(dtype))
    experts = {k.split(".", 1)[1]: v for k, v in params.items()
               if k.startswith("experts.")}
    ye = expert_ffn_reference(experts, xe, dtype=dtype)
    y = torch.einsum("nec,ech->nh", combine.to(dtype), ye)
    return y.reshape(b, t, h).to(dtype), stats
