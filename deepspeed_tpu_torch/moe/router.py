"""Gated top-k token routing with capacity-factor slots (port of
deepspeed_tpu/moe/router.py).

The GShard/Switch formulation, in the JAX package's order of operations:

  probs      = softmax(logits) in fp32                 [N, E]
  top-k      = the k highest-prob experts per token (ties to the lower
               expert index, as jax.lax.top_k breaks them: a stable
               descending sort), gate values renormalised over the k
               with a 1e-9 floor
  capacity   C = ceil(cf * k * N / E) slots per expert; assignments are
               ranked choice-major (every first choice before any second
               choice), token-major within a choice, by a cumsum of the
               choice's one-hot mask; assignments past C are dropped
  aux loss   E * sum_e f_e * P_e: f_e the fraction of tokens whose
               FIRST choice is e (no gradient), P_e the mean router prob

Stats vector (fp32, [E + 2]): per-expert assignment fraction over all k
choices before the capacity cut, the dropped fraction (STAT_DROP), the
aux loss (STAT_AUX). Everything stays on the device: no host syncs.

`_gating_core`'s `expert_idx` (test-only, reached through
`MoEMLP.route_override`) replaces the top-k choices by given ones: the
gate values still come from this call's probabilities, so gradients
flow as usual; an oracle uses it to hold two numeric routes to the same
(discontinuous) routing.
"""

import math

import torch

# negative column offsets into the [E + 2] stats vector
STAT_DROP = -2
STAT_AUX = -1


def router_capacity(tokens, num_experts, top_k, capacity_factor):
    """Per-expert slots C = ceil(cf * k * tokens / E), floored at 1:
    host math on the static token count (C is a shape)."""
    if tokens <= 0 or num_experts <= 0:
        raise ValueError(
            f"router_capacity needs tokens > 0 and num_experts > 0, "
            f"got tokens={tokens}, num_experts={num_experts}")
    return max(1, math.ceil(
        float(capacity_factor) * int(top_k) * int(tokens)
        / int(num_experts)))


def _jitter(logits, gen, eps):
    """Multiplicative uniform jitter logits * U(1 - eps, 1 + eps), drawn
    from the generator `gen`."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=logits.dtype)
    return logits * ((1.0 - eps) + (2.0 * eps) * u)


def _top_k(probs, k):
    """(values, indices) of the k largest probabilities per row, ties to
    the lower index (jax.lax.top_k's order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _gating_core(logits, top_k, capacity, gen, jitter_eps, expert_idx=None):
    """Softmax + top-k + renormalisation + the choice-major capacity
    assignment, per choice: (gate_vals [N, k], gate_idx [N, k], fits
    list of [N, E] 0/1, slot list of [N] int32, stats [E + 2])."""
    n, e = logits.shape
    k = int(top_k)
    if not 1 <= k <= e:
        raise ValueError(f"top_k must be in [1, {e}], got {top_k}")
    logits = logits.to(torch.float32)
    if gen is not None and jitter_eps > 0.0:
        logits = _jitter(logits, gen, float(jitter_eps))
    probs = torch.softmax(logits, dim=-1)                 # [N, E]

    if expert_idx is None:
        gate_vals, gate_idx = _top_k(probs, k)
    else:
        gate_idx = expert_idx.to(device=probs.device, dtype=torch.long)
        gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    masks = [torch.nn.functional.one_hot(gate_idx[:, j], e).to(torch.float32)
             for j in range(k)]                           # k x [N, E]
    taken = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    fits_list, slot_list = [], []
    kept = torch.zeros((), dtype=torch.float32, device=probs.device)
    for mask in masks:
        # the running count down the tokens, taken along the last axis of
        # the [E, N] transpose: torch's scan down the first axis of an
        # [N, E] tensor runs E sequential threads (2.6 ms a call at
        # N 16,384 on the H100). The sums are of 0/1 values, exact in
        # either order.
        pos = torch.cumsum(mask.t().contiguous(), dim=1).t() - 1.0 + \
            taken[None, :]                                       # [N, E]
        fits = mask * (pos < capacity)
        slot = (fits * pos).sum(dim=-1).to(torch.int32)          # [N]
        fits_list.append(fits)
        slot_list.append(slot)
        kept = kept + fits.sum()
        taken = taken + mask.sum(dim=0)

    f_e = masks[0].mean(dim=0)
    p_e = probs.mean(dim=0)
    aux = float(e) * (f_e * p_e).sum()

    load = sum(masks).sum(dim=0) / float(n * k)
    dropped = 1.0 - kept / float(n * k)
    stats = torch.cat([load, torch.stack([dropped, aux])])
    return gate_vals, gate_idx, fits_list, slot_list, stats


def _dense_masks(capacity, gate_vals, fits_list, slot_list):
    """(dispatch, combine) [N, E, C] of the per-choice assignment."""
    n, e = fits_list[0].shape
    dispatch = torch.zeros((n, e, capacity), dtype=torch.float32,
                           device=gate_vals.device)
    combine = torch.zeros_like(dispatch)
    for j, (fits, slot) in enumerate(zip(fits_list, slot_list)):
        onehot_c = torch.nn.functional.one_hot(
            slot.to(torch.long), capacity).to(torch.float32)
        d_j = fits[:, :, None] * onehot_c[:, None, :]
        dispatch = dispatch + d_j
        combine = combine + d_j * gate_vals[:, j, None, None]
    return dispatch.detach(), combine


def _index_routing(gate_vals, gate_idx, fits_list, slot_list):
    """The routing dict of the per-choice assignment (see
    top_k_gating_indexed)."""
    keep = torch.stack([f.sum(dim=-1) for f in fits_list], dim=-1)
    return {"e_idx": gate_idx.to(torch.int32),
            "slot": torch.stack(slot_list, dim=-1),
            "keep": keep.detach(),
            "w": gate_vals}


def top_k_gating(logits, top_k, capacity, gen=None, jitter_eps=0.0):
    """Dense routing masks for one batch of token logits [N, E].

    Returns (dispatch [N, E, C] fp32 0/1, no gradient; combine
    [N, E, C] fp32, dispatch weighted by the renormalised gate prob,
    differentiable through it; stats [E + 2], differentiable through the
    aux entry only). `gen`/`jitter_eps`: optional logit jitter."""
    gate_vals, _, fits_list, slot_list, stats = _gating_core(
        logits, top_k, capacity, gen, jitter_eps)
    dispatch, combine = _dense_masks(capacity, gate_vals, fits_list,
                                     slot_list)
    return dispatch, combine, stats


def top_k_gating_indexed(logits, top_k, capacity, gen=None, jitter_eps=0.0):
    """Index form of the same routing (no [N, E, C] tensors): (routing,
    stats), routing a dict of [N, k] tensors: e_idx int32 (expert of
    choice j), slot int32 (its capacity slot, meaningful where kept),
    keep fp32 0/1 (survived the capacity cut; no gradient), w fp32 (the
    renormalised gate prob, differentiable)."""
    core = _gating_core(logits, top_k, capacity, gen, jitter_eps)
    return _index_routing(*core[:4]), core[4]
