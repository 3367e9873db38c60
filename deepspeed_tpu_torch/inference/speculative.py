"""Speculative decoding: draft-model propose, batched flagship verify,
lossless acceptance on the paged KV cache (port of
deepspeed_tpu/inference/speculative.py).

The vanilla engine emits one token per flagship step; a speculative
round emits up to k+1 verified tokens per slot:

  1. draft steps (`draft_step`, k of them): a small GPT-2 draft model,
     by default the flagship's first N blocks with the shared
     embeddings, ln_f and tied head (`draft_model: "truncate:N"`, no new
     weights), proposes the next k tokens one step at a time, writing
     its own K/V into a second paged pool that shares the flagship
     cache's page tables and allocator;
  2. verify (`verify_step`, one flagship step): the decode step widened
     to k+1 positions per slot scores every proposal at once, and the
     acceptance rule runs on the device, so a round adds no host sync.

Losslessness (the output distribution is vanilla decode's):

  * temperature 0, greedy prefix match: drafted token j is accepted
    while it equals the flagship's argmax given the committed prefix;
    the first mismatch emits the flagship's argmax instead. Every
    emitted token is the flagship's greedy choice, so the stream equals
    vanilla decode's token for token, as long as a verify row computes
    the decode row's logits bit for bit (engine.py's docstring: the tied
    head runs at the decode step's row count);
  * temperature > 0, modified rejection sampling (Leviathan et al.): a
    drafted x ~ q is accepted with probability min(1, p(x)/q(x)); the
    first rejection resamples from norm(max(p - q, 0)), and a round
    that accepts everything draws a bonus token from p.

Random draws: the draft samples from its own torch.Generator and verify
draws its acceptance coins and residual samples from another, both
seeded from `inference.seed` (streams 1 and 2, utils/rng.py), in the
Gumbel-max form of the engine's sampler. The JAX package folds its key
per step and slot instead: the two packages sample alike in
distribution, not in bits.

Rollback costs no copy: K/V beyond a slot's position is masked and
value-zeroed by paged attention, so rejecting a suffix rewinds `pos` on
the device, and the fence trims the host page tables
(`PagedKVCache.rollback`, LIFO).

Adaptive k: each slot keeps an acceptance EMA on the device; a round
that accepts everything grows its k toward `speculative.k`, an EMA
below ADAPT_BACKOFF shrinks it toward `speculative.k_min`, and the
fence reads max(live k) with the rest of its one copy to dispatch fewer
draft steps when the whole batch is rejected.
"""

import dataclasses

import torch

from deepspeed_tpu_torch.inference.engine import (gumbel_argmax,
                                                  process_logits)
from deepspeed_tpu_torch.utils.rng import stream_seed

# acceptance-EMA decay and the back-off threshold for adaptive k
ADAPT_EMA = 0.8
ADAPT_BACKOFF = 0.5
# the seed streams of inference.seed the draft's samples and verify's
# draws come from (the engine's sampler takes the seed itself)
DRAFT_STREAM = 1
VERIFY_STREAM = 2


def derive_draft(model_config, weights, draft_model):
    """Resolve `speculative.draft_model` "truncate:N" to (draft_config,
    draft_weights) over the engine's loaded weights (engine.load_weights):
    the first N blocks' dicts and wte, wpe, ln_f and the tied head are
    the flagship's own tensors, its kernels already cast (or quantized)
    once, so the draft adds no device bytes."""
    if not draft_model.startswith("truncate:"):
        raise ValueError(
            f"derive_draft cannot resolve draft_model={draft_model!r} "
            '(pass draft_params/draft_model_config for "external")')
    n = int(draft_model[len("truncate:"):])
    if n > model_config.n_layer:
        raise ValueError(
            f"speculative.draft_model={draft_model!r}: the flagship has "
            f"only {model_config.n_layer} layers")
    return (dataclasses.replace(model_config, n_layer=n),
            dict(weights, layers=weights["layers"][:n]))


# ----------------------------------------------------------------------
# acceptance math
# ----------------------------------------------------------------------
def leading_accept_count(flags):
    """Length of the leading all-True run along the last axis: the
    number of drafted tokens the acceptance rule keeps."""
    return torch.cumprod(flags.to(torch.long), dim=-1).sum(dim=-1)


def residual_distribution(p_probs, q_probs):
    """The modified-rejection-sampling correction distribution
    norm(max(p - q, 0)) [S, V]; p where the residual mass is zero (p ==
    q, when the draft is never rejected anyway: the fallback only guards
    float dust)."""
    res = torch.clamp(p_probs - q_probs, min=0.0)
    norm = res.sum(dim=-1, keepdim=True)
    return torch.where(norm > 0.0, res / torch.clamp(norm, min=1e-30),
                       p_probs)


# ----------------------------------------------------------------------
# speculative device state
# ----------------------------------------------------------------------
def fresh_spec_state(engine):
    """The round state on the device: the draft KV pools (the flagship
    pools' page geometry, the draft's layer count), the round's
    proposals and their draft logits, and the per-slot counters the
    fence reads. Seeds the draft's and verify's generators."""
    cfg, mc, dev = engine.config, engine.model_config, engine.device
    s, k = cfg.max_slots, cfg.spec_k
    c = engine.cache
    pool = (engine._draft_config.n_layer, c.num_pages, c.page_size,
            mc.n_head, mc.head_dim)
    engine._draft_gen.manual_seed(stream_seed(cfg.seed, DRAFT_STREAM))
    engine._verify_gen.manual_seed(stream_seed(cfg.seed, VERIFY_STREAM))
    i64 = dict(dtype=torch.long, device=dev)
    return {
        "dk_pool": torch.zeros(pool, dtype=mc.dtype, device=dev),
        "dv_pool": torch.zeros(pool, dtype=mc.dtype, device=dev),
        "dtoks": torch.zeros((s, k), **i64),
        "dlogits": torch.zeros((s, k, mc.vocab_size), dtype=torch.float32,
                               device=dev),
        "k_slot": torch.full((s,), k, **i64),
        "acc_ema": torch.ones((s,), dtype=torch.float32, device=dev),
        "drafted_total": torch.zeros((s,), **i64),
        "accepted_total": torch.zeros((s,), **i64),
        "verified_total": torch.zeros((s,), **i64),
        "rollbacks": torch.zeros((s,), **i64),
        "rounds": torch.zeros((), **i64),
    }


# ----------------------------------------------------------------------
# the steps (enqueue only: no host read)
# ----------------------------------------------------------------------
@torch.no_grad()
def draft_step(engine, j):
    """Draft step j of a round (j a host int): ONE proposed token for
    every slot at position pos + j. Reads the flagship state without
    changing it; writes the proposal, its draft logits and the draft's
    K/V."""
    cfg, st, sp = engine.config, engine._state, engine._spec_state
    dmc = engine._draft_config
    active = st["active"]
    pos = st["pos"] + j
    # the committed token on step 0, the last proposal after it
    cur = st["cur_token"] if j == 0 else sp["dtoks"][:, j - 1]
    # never write K/V past the slot's budget: a round emits at most
    # max_new - n_gen tokens, so drafts past budget - 1 are dead weight
    # and would overrun the page table
    budget = st["max_new"] - st["n_gen"] - 1
    k_eff = torch.minimum(sp["k_slot"], torch.clamp(budget, min=0))
    valid = active & (j < k_eff)
    w = engine._draft
    hidden = engine._embed(w, cur, pos)[:, None]
    resid, boundary = engine._stack(
        w, dmc, hidden, sp["dk_pool"], sp["dv_pool"], st["tables"],
        pos[:, None], valid[:, None], pos)
    l32 = engine._logits(w, dmc, resid, boundary)[:, 0].to(torch.float32)
    greedy = torch.argmax(l32, dim=-1)
    scaled = process_logits(l32, st["top_k"], st["temperature"],
                            engine._top_k_cap)
    drawn = gumbel_argmax(scaled, engine._draft_gen)
    sp["dtoks"][:, j] = torch.where(st["temperature"] > 0.0, drawn, greedy)
    sp["dlogits"][:, j] = l32


@torch.no_grad()
def verify_step(engine, n_draft):
    """The flagship step over k+1 positions per slot (the committed
    token and the k proposals), then on the device: the acceptance rule,
    the commit of the accepted prefix and the correction (or bonus)
    token into the output ring with the EOS and budget cuts, the rewind
    of `pos` past a rejected suffix, adaptive k and the fence counters.
    `n_draft` is the draft steps dispatched this round (a host int)."""
    cfg, mc = engine.config, engine.model_config
    st, sp = engine._state, engine._spec_state
    s, k, vocab = cfg.max_slots, cfg.spec_k, mc.vocab_size
    steps = engine._steps
    active, pos0, n_gen = st["active"], st["pos"], st["n_gen"]
    budget = st["max_new"] - n_gen
    # proposals this round: capped by the slot's adaptive k, the draft
    # steps dispatched and the emission budget
    n_valid = torch.minimum(torch.clamp(sp["k_slot"], max=n_draft),
                            torch.clamp(budget - 1, min=0))
    tokens_in = torch.cat([st["cur_token"][:, None], sp["dtoks"]], dim=1)
    positions = pos0[:, None] + steps[None, :]
    write_ok = active[:, None] & (steps[None, :] <= n_valid[:, None])
    w = engine._weights
    hidden = engine._embed(w, tokens_in, positions)
    resid, boundary = engine._stack(
        w, mc, hidden, st["k_pool"], st["v_pool"], st["tables"], positions,
        write_ok, pos0 + n_valid)
    l32 = engine._logits(w, mc, resid, boundary).to(torch.float32)

    d = sp["dtoks"]                                    # [s, k]
    greedy = torch.argmax(l32, dim=-1)                 # [s, k+1]
    valid = steps[None, :k] < n_valid[:, None]
    temp = st["temperature"]
    sampling = temp > 0.0
    # -- acceptance rule ------------------------------------------------
    match_greedy = d == greedy[:, :k]
    p_probs = torch.softmax(process_logits(
        l32, st["top_k"], temp, engine._top_k_cap), dim=-1)   # [s, k+1, V]
    q_probs = torch.softmax(process_logits(
        sp["dlogits"], st["top_k"], temp, engine._top_k_cap), dim=-1)
    p_d = torch.gather(p_probs[:, :k], -1, d[..., None])[..., 0]
    q_d = torch.gather(q_probs, -1, d[..., None])[..., 0]
    u = torch.rand((s, k), generator=engine._verify_gen, device=l32.device)
    match_sample = u < p_d / torch.clamp(q_d, min=1e-30)
    match = torch.where(sampling[:, None], match_sample, match_greedy)
    a = leading_accept_count(valid & match)            # [s]
    # -- correction (or bonus) token at input position a -----------------
    a3 = a[:, None, None].expand(s, 1, vocab)
    greedy_corr = torch.gather(greedy, 1, a[:, None])[:, 0]
    pa = torch.gather(p_probs, 1, a3)[:, 0]
    q_pad = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1)
    qa = torch.gather(q_pad, 1, a3)[:, 0]
    # a == n_valid means nothing was rejected: the extra token is a bonus
    # draw from p itself, not a residual
    qa = torch.where((a >= n_valid)[:, None], 0.0, qa)
    res = residual_distribution(pa, qa)
    drawn_corr = gumbel_argmax(torch.log(torch.clamp(res, min=1e-30)),
                               engine._verify_gen)
    corr = torch.where(sampling, drawn_corr, greedy_corr)
    # -- commit: emitted tokens e_0 .. e_{m-1} ---------------------------
    d_pad = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
    e = torch.where(steps[None, :] < a[:, None], d_pad, corr[:, None])
    m0 = a + 1
    eos_hit = (e == st["eos"][:, None]) & (steps[None, :] < m0[:, None])
    any_eos = eos_hit.any(dim=1)
    first_eos = torch.argmax(eos_hit.to(torch.long), dim=1)
    m1 = torch.where(any_eos, first_eos + 1, m0)
    m = torch.where(active, torch.minimum(m1, budget), 0)
    eos_fin = active & any_eos & (first_eos + 1 <= m)
    n2 = n_gen + m
    hit_max = active & (n2 >= st["max_new"])
    rel = engine._wcols[None, :] - n_gen[:, None]
    in_win = (rel >= 0) & (rel < m[:, None])
    vals = torch.gather(e, 1, torch.clamp(rel, 0, k))
    out = torch.where(in_win, vals, st["out_tokens"])
    last = torch.gather(e, 1, torch.clamp(m - 1, 0, k)[:, None])[:, 0]
    # -- adaptive k + fence counters -------------------------------------
    frac = a.to(torch.float32) / torch.clamp(n_valid, min=1).to(
        torch.float32)
    measured = active & (n_valid > 0)
    ema = torch.where(measured,
                      ADAPT_EMA * sp["acc_ema"] + (1.0 - ADAPT_EMA) * frac,
                      sp["acc_ema"])
    k_slot = sp["k_slot"]
    if cfg.spec_adaptive:
        k_next = torch.where(a >= n_valid, k_slot + 1,
                             torch.where(ema < ADAPT_BACKOFF, k_slot - 1,
                                         k_slot))
        k_next = torch.clamp(k_next, cfg.spec_k_min, k)
        k_slot = torch.where(measured, k_next, k_slot)
    rb = measured & (a < n_valid)
    st["pos"] = pos0 + m
    st["cur_token"] = torch.where(m > 0, last, st["cur_token"])
    st["active"] = active & ~(eos_fin | hit_max)
    st["finished_eos"] = st["finished_eos"] | eos_fin
    st["n_gen"] = n2
    st["out_tokens"] = out
    st["step"] = st["step"] + 1
    sp["k_slot"] = k_slot
    sp["acc_ema"] = ema
    sp["drafted_total"] = sp["drafted_total"] + torch.where(
        active, n_valid, 0)
    sp["accepted_total"] = sp["accepted_total"] + torch.where(active, a, 0)
    sp["verified_total"] = sp["verified_total"] + active.to(torch.long)
    sp["rollbacks"] = sp["rollbacks"] + rb.to(torch.long)
    sp["rounds"] = sp["rounds"] + 1
