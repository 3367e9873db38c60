"""PyTorch port: speculative decoding against the JAX package
(inference/speculative.py), the cases of tests/test_speculative.py.

The same tiny GPT-2 weights (a JAX tree converted with
`params_from_jax`) and the same numpy-seeded requests go through the
JAX engines and the port's on the CPU, in fp32 on one torch thread.

  * temperature 0: the port's speculative stream equals the port's
    vanilla stream AND the JAX package's speculative stream token for
    token, with the truncate:1 draft (the flagship's first block), with
    a perturbed external draft (partial acceptance, rollbacks) and at
    the EOS and budget edges; the drafted,
    accepted and rollback counts equal the JAX engine's. Exact, not a
    tolerance: the streams are greedy choices, and the JAX and port
    decode logits agree to ~2e-7 (tests/test_torch_inference.py), far
    inside these models' top-2 gaps;
  * the acceptance functions against the JAX package's on the same
    arrays: fp32, atol 1e-6 (one rounding of a quotient or a
    normalisation; leading_accept_count exactly);
  * the modified rejection sampling rule, statistically: 200k draws,
    each bucket within 0.006 (~5 sigma) of p; and `verify_step`'s own
    draws (coins, correction at a = 0 and 1, bonus at a = k and at
    a = n_valid < k): 38,400 each, each bucket within 0.013 (5 sigma);
  * temperature > 0: a draft identical to the flagship is never
    rejected, and a seeded run replays itself;
  * spec_block reads nothing on the host; adaptive k backs off on a
    hopeless draft and stays at its cap on a perfect one; mixed-k
    continuous batching; `speculative.enabled` false is vanilla;
  * the draft KV pool's bytes and LIFO rollback against the JAX cache.

The random draws at temperature > 0 are torch.Generator streams, not
jax.random's (speculative.py): those cases hold the port to its own
properties. The `speculative` monitor event case waits for the monitor
(ROADMAP Queue 1 item 8).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import PagedKVCache as JCache
from deepspeed_tpu.inference import Request as JRequest
from deepspeed_tpu.inference import ServingLoop as JLoop
from deepspeed_tpu.inference import speculative as jspec
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.inference import (InferenceConfigError,
                                           InferenceEngine, PagedKVCache,
                                           Request, ServingLoop)
from deepspeed_tpu_torch.inference import speculative as tspec
from deepspeed_tpu_torch.inference.engine import process_logits
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401

ATOL = 1e-6
VOCAB = 256


def _inference_cfg(**speculative):
    block = {"max_slots": 4, "prefill_chunk": 16, "sync_every": 4,
             "max_new_tokens": 32,
             "kv_cache": {"num_pages": 120, "page_size": 4}}
    if speculative:
        block["speculative"] = dict({"enabled": True}, **speculative)
    return {"inference": block}


def _perturbed(params, scale, seed=99):
    """The JAX test's draft: the flagship with small noise on every
    block leaf (mostly agrees, diverges often enough to roll back)."""
    r = np.random.RandomState(seed)
    blocks = jax.tree_util.tree_map(
        lambda x: x + scale * r.randn(*x.shape).astype(x.dtype),
        params["h"])
    return dict(params, h=blocks)


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def weights():
    cfg = jgpt2.tiny_gpt2_config()
    params = jgpt2.GPT2ForCausalLM(cfg).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return cfg, params, _flat(params)


@pytest.fixture(scope="module")
def port(weights):
    """The port's vanilla engine and truncate:1 speculative engine over
    the same weights."""
    tc = tgpt2.tiny_gpt2_config()
    flat = weights[2]
    return tc, (InferenceEngine(tc, flat, _inference_cfg(), device="cpu"),
                InferenceEngine(tc, flat, _inference_cfg(
                    draft_model="truncate:1", k=4, k_min=1, adaptive=True),
                    device="cpu"))


@pytest.fixture(scope="module")
def ext(weights):
    """External perturbed draft, k 3: the JAX engine and the port's."""
    cfg, params, _ = weights
    draft = _perturbed(params, 0.01)
    jeng = JEngine(cfg, params, _inference_cfg(draft_model="external", k=3),
                   draft_params=draft, draft_model_config=cfg)
    tc = tgpt2.tiny_gpt2_config()
    teng = InferenceEngine(tc, weights[2], _inference_cfg(
        draft_model="external", k=3), device="cpu",
        draft_params=_flat(draft), draft_model_config=tc)
    return jeng, teng


@pytest.fixture(scope="module")
def jax_truncate(weights):
    cfg, params, _ = weights
    return JEngine(cfg, params, _inference_cfg(
        draft_model="truncate:1", k=4, k_min=1, adaptive=True))


def _serve(engine, reqs):
    engine.reset()
    res = (JLoop if isinstance(engine, JEngine) else ServingLoop)(
        engine).serve(reqs)
    return {q.rid: (q.out_tokens.tolist(), q.finish_reason) for q in res}


def _counts(engine):
    sp = engine.fetch_state()["speculative"]
    return {key: int(np.asarray(sp[key]).sum())
            for key in ("drafted", "accepted", "verified", "rollbacks")}


def _mixed(cls, seed, n=7, eos=None):
    r = np.random.RandomState(seed)
    return [cls(rid=i,
                tokens=r.randint(0, VOCAB,
                                 size=int(r.randint(3, 30))).astype(np.int32),
                max_new_tokens=int(r.randint(3, 14)), eos_token_id=eos)
            for i in range(n)]


def _three_ways(vanilla, spec, jspec_engine, make):
    """The port's speculative stream against the port's vanilla stream
    and the JAX speculative stream, and its counts against JAX's."""
    want = _serve(vanilla, make(Request))
    got = _serve(spec, make(Request))
    ref = _serve(jspec_engine, make(JRequest))
    assert got == want
    assert got == ref
    counts = _counts(spec)
    assert counts == _counts(jspec_engine)
    return counts


# ----------------------------------------------------------------------
# config validation, the draft
# ----------------------------------------------------------------------
def test_speculative_config_validation(weights):
    tc, flat = tgpt2.tiny_gpt2_config(), weights[2]
    for bad in ({"draft_model": "half"}, {"draft_model": "truncate:0"},
                {"draft_model": "truncate:x"}, {"k": 0},
                {"k": 2, "k_min": 3}):
        with pytest.raises(InferenceConfigError,
                           match="inference\\.speculative\\."):
            InferenceEngine(tc, flat, _inference_cfg(**bad), device="cpu")
    with pytest.raises(ValueError, match="only"):
        InferenceEngine(tc, flat, _inference_cfg(draft_model="truncate:9"),
                        device="cpu")
    with pytest.raises(ValueError, match="external"):
        InferenceEngine(tc, flat, _inference_cfg(draft_model="external"),
                        device="cpu")
    # a draft with another head geometry cannot share the page tables
    other = tgpt2.tiny_gpt2_config(n_head=2)
    with pytest.raises(ValueError, match="head geometry"):
        InferenceEngine(tc, flat, _inference_cfg(draft_model="external"),
                        device="cpu", draft_params=flat,
                        draft_model_config=other)


def test_derive_draft_shares_weights_and_slices_blocks(weights, port):
    """truncate:1 of the 2-layer flagship: the first block's dict and
    wte, wpe, ln_f and the cast head are the flagship's own tensors,
    and the block equals JAX derive_draft's slice."""
    cfg, params, _ = weights
    _, (_, spec) = port
    draft, flag = spec._draft, spec._weights
    assert spec._draft_config.n_layer == 1
    assert len(draft["layers"]) == 1 and draft["layers"][0] is \
        flag["layers"][0]
    for key in ("wte", "wpe", "wte_c"):
        assert draft[key] is flag[key]
    assert all(a is b for a, b in zip(draft["ln_f"], flag["ln_f"]))
    jcfg, jdraft = jspec.derive_draft(cfg, params, "truncate:1")
    assert jcfg.n_layer == 1
    for name, value in _flat(jdraft).items():
        if name.startswith("h."):
            got = draft["layers"][0][name.split(".", 2)[2]]
            np.testing.assert_array_equal(got.numpy(), value.numpy())
    with pytest.raises(ValueError, match="external"):
        tspec.derive_draft(spec.model_config, flag, "external")


# ----------------------------------------------------------------------
# acceptance math against the JAX package's, same arrays
# ----------------------------------------------------------------------
def test_leading_accept_count_matches_jax():
    r = np.random.RandomState(0)
    flags = r.rand(64, 5) < 0.7
    flags[:4] = [[1, 1, 0, 1, 1], [0, 1, 1, 1, 1], [1] * 5, [0] * 5]
    got = tspec.leading_accept_count(torch.from_numpy(flags))
    ref = np.asarray(jspec.leading_accept_count(jnp.asarray(flags)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[:4].tolist() == [2, 0, 5, 0]


def test_residual_distribution_matches_jax():
    r = np.random.RandomState(1)
    p = r.dirichlet(np.ones(16), size=3).astype(np.float32)
    q = r.dirichlet(np.ones(16), size=3).astype(np.float32)
    for a, b in ((p, q), (p, p)):
        got = tspec.residual_distribution(torch.from_numpy(a),
                                          torch.from_numpy(b)).numpy()
        ref = np.asarray(jspec.residual_distribution(jnp.asarray(a),
                                                     jnp.asarray(b)))
        np.testing.assert_allclose(got, ref, atol=ATOL)
    res = tspec.residual_distribution(torch.from_numpy(p),
                                      torch.from_numpy(q)).numpy()
    assert (res[p <= q] == 0).all()
    np.testing.assert_allclose(res.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("lead", [(), (5,)], ids=["decode", "verify"])
def test_process_logits_matches_jax(lead):
    """Per slot (top_k, temperature) on [S, V], and on the verify
    step's [S, k+1, V] (JAX vmaps over the middle axis)."""
    r = np.random.RandomState(2)
    l32 = r.randn(*((3,) + lead + (VOCAB,))).astype(np.float32)
    top_k = np.asarray([2, 0, 17], np.int32)
    temp = np.asarray([0.5, 2.0, 0.0], np.float32)
    got = process_logits(torch.from_numpy(l32),
                         torch.from_numpy(top_k.astype(np.int64)),
                         torch.from_numpy(temp), 64).numpy()
    if lead:
        ref = np.stack([np.asarray(jspec.process_logits(
            jnp.asarray(l32[:, j]), jnp.asarray(top_k), jnp.asarray(temp),
            64)) for j in range(lead[0])], axis=1)
    else:
        ref = np.asarray(jspec.process_logits(
            jnp.asarray(l32), jnp.asarray(top_k), jnp.asarray(temp), 64))
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=ATOL, atol=ATOL)


def test_modified_rejection_sampling_targets_p_statistically():
    """Drawing x ~ q, accepting when u < p(x)/q(x) and resampling from
    the port's residual on rejection emits p (the verify step's rule)."""
    r = np.random.RandomState(2)
    vocab, n = 8, 200_000
    p = r.dirichlet(np.ones(vocab) * 2).astype(np.float64)
    q = r.dirichlet(np.ones(vocab) * 2).astype(np.float64)
    x = r.choice(vocab, size=n, p=q)
    accept = r.rand(n) < (p[x] / q[x])
    res = tspec.residual_distribution(
        torch.from_numpy(p[None].astype(np.float32)),
        torch.from_numpy(q[None].astype(np.float32)))[0].numpy()
    res = res.astype(np.float64)
    res /= res.sum()
    emitted = np.where(accept, x, r.choice(vocab, size=n, p=res))
    np.testing.assert_allclose(np.bincount(emitted, minlength=vocab) / n, p,
                               atol=0.006)
    assert 0.05 < accept.mean() < 0.999


# the verify step's own draws: 128 slots from one prefilled state, 300
# rounds, k 2, temperature 1 with top-k 8
STAT_SLOTS, STAT_ROUNDS, STAT_TOP_K = 128, 300, 8
# 38,400 draws: one bucket's frequency has sigma <= 0.5 / sqrt(38400)
# = 0.00255, so 0.013 is 5 sigma at worst
STAT_ATOL = 0.013


@pytest.fixture(scope="module")
def sampled(weights):
    """A k-2 engine over the tiny flagship with STAT_SLOTS slots, and the
    flagship's sampling distribution p after a token sequence (the
    port's full forward, then the sampler's top-k and temperature)."""
    tc = tgpt2.tiny_gpt2_config()
    engine = InferenceEngine(tc, weights[2], {"inference": {
        "max_slots": STAT_SLOTS, "prefill_chunk": 16, "sync_every": 4,
        "max_new_tokens": 8,
        "kv_cache": {"num_pages": 4 * STAT_SLOTS, "page_size": 4},
        "speculative": {"enabled": True, "draft_model": "truncate:1",
                        "k": 2, "adaptive": False}}}, device="cpu")
    model = tgpt2.GPT2ForCausalLM(tc, device="cpu")

    def logits(ids):
        return model.apply(weights[2], np.asarray(ids, np.int64)[None])[
            0, -1].float()

    def probs(l32):
        return torch.softmax(process_logits(
            l32[None], torch.tensor([STAT_TOP_K]), torch.tensor([1.0]),
            engine._top_k_cap), dim=-1)[0].double().numpy()

    return engine, logits, probs


@pytest.mark.parametrize("case,n_draft", [
    ("reject_at_0", 2), ("reject_at_1", 2), ("bonus_short", 1),
    ("bonus_full", 2)])
def test_verify_step_samples_p_statistically(sampled, case, n_draft):
    """`verify_step` itself, round after round from one state: each
    slot's emitted token at index j (the first proposal that can be
    rejected, or the bonus) has the flagship's distribution p there.
    The drafts are set by hand: proposal j drawn from a perturbed q
    (logits + N(0, 0.3^2) noise: mostly the same top 8, other weights)
    or pinned to p's argmax with q's logit of it lowered by 0.1, so that
    p/q > 1 and it is always accepted.
    Covers the acceptance coins (their rate against sum min(p, q)), the
    correction draw from norm(max(p - q, 0)) at a = 0 and a = 1, and the
    bonus draw from p both at a = k (q_pad's zero row) and at a =
    n_valid < k, where q's unused row must not enter the residual."""
    from deepspeed_tpu_torch.inference.speculative import verify_step
    engine, logits, probs = sampled
    r = np.random.RandomState(71)
    prompt = r.randint(0, VOCAB, size=6).astype(np.int32)
    # j: the emitted index under test; the proposals before it are
    # pinned and always accepted
    j = {"reject_at_0": 0, "reject_at_1": 1, "bonus_short": 1,
         "bonus_full": 2}[case]
    ids, q_logits, pinned = list(prompt), [], []
    for i in range(2):
        l32 = logits(ids)
        if i < j:
            t = int(torch.argmax(l32))
            q = l32.clone()
            q[t] -= 0.1
            pinned.append(t)
            ids.append(t)
        else:
            q = l32 + 0.3 * torch.from_numpy(
                r.randn(VOCAB).astype(np.float32))
        q_logits.append(q)
    p = probs(logits(ids[:len(prompt) + j]))
    q_j = probs(q_logits[j]) if j < n_draft else None

    engine.reset()
    for slot in range(STAT_SLOTS):
        engine.start_request(slot, prompt, max_new=6, temperature=1.0,
                             top_k=STAT_TOP_K)
    st0, sp0 = dict(engine._state), dict(engine._spec_state)
    dlogits = torch.stack(q_logits)[None].expand(STAT_SLOTS, 2, VOCAB)
    emitted, accepted = [], []
    for _ in range(STAT_ROUNDS):
        dtoks = np.zeros((STAT_SLOTS, 2), np.int64)
        dtoks[:, :len(pinned)] = pinned
        if q_j is not None:
            dtoks[:, j] = r.choice(VOCAB, size=STAT_SLOTS, p=q_j / q_j.sum())
        engine._state = dict(st0)
        engine._spec_state = dict(sp0, dtoks=torch.from_numpy(dtoks),
                                  dlogits=dlogits.clone())
        verify_step(engine, n_draft)
        a = engine._spec_state["accepted_total"].numpy()
        assert (a >= len(pinned)).all()
        assert (engine._state["n_gen"].numpy() == a + 1).all()
        emitted.append(engine._state["out_tokens"][:, j].numpy())
        accepted.append(a > j)
    emitted, accepted = np.concatenate(emitted), np.concatenate(accepted)
    np.testing.assert_allclose(
        np.bincount(emitted, minlength=VOCAB) / emitted.size, p,
        atol=STAT_ATOL)
    if q_j is None:
        # the bonus: nothing was left to reject
        assert not accepted.any()
    else:
        # the coins: P(accept x ~ q) = sum min(p, q), a Bernoulli mean
        # within 5 sigma; and the draft is rejected often enough that a
        # wrong correction would show
        want = float(np.minimum(p, q_j).sum())
        assert 0.2 < want < 0.8
        assert abs(accepted.mean() - want) <= 5 * np.sqrt(
            want * (1 - want) / accepted.size)


# ----------------------------------------------------------------------
# temperature 0: the port's stream = its vanilla stream = JAX's
# ----------------------------------------------------------------------
def test_temp0_identical_perfect_draft(port, jax_truncate):
    """truncate:1, 7 mixed requests queued through 4 slots."""
    _, (vanilla, spec) = port
    counts = _three_ways(vanilla, spec, jax_truncate,
                         lambda cls: _mixed(cls, seed=31))
    assert counts["drafted"] > 0


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_temp0_identical_partial_acceptance(port, ext, seed):
    """The perturbed external draft: partial acceptance and rollbacks,
    the stream still vanilla's and JAX's, the counts JAX's."""
    _, (vanilla, _) = port
    jeng, teng = ext
    counts = _three_ways(vanilla, teng, jeng,
                         lambda cls: _mixed(cls, seed=seed, n=5))
    assert 0 < counts["accepted"] < counts["drafted"]
    assert counts["rollbacks"] > 0


def test_temp0_identical_eos_and_budget_edges(port, ext):
    """EOS inside an accepted prefix and through the correction token,
    and max_new below one round, cut as vanilla decode cuts."""
    _, (vanilla, _) = port
    jeng, teng = ext
    prompt = np.random.RandomState(55).randint(0, VOCAB,
                                               size=9).astype(np.int32)
    out = _serve(vanilla, [Request(rid="p", tokens=prompt.copy(),
                                   max_new_tokens=12)])["p"][0]
    assert len(out) == 12
    for eos in (out[0], out[2], out[5], out[11]):
        _three_ways(vanilla, teng, jeng, lambda cls: [cls(
            rid="e", tokens=prompt.copy(), max_new_tokens=12,
            eos_token_id=eos)])
        assert _serve(teng, [Request(rid="e", tokens=prompt.copy(),
                                     max_new_tokens=12,
                                     eos_token_id=eos)])["e"][1] == "eos"
    for m in (1, 2, 3):
        _three_ways(vanilla, teng, jeng, lambda cls: [cls(
            rid="b", tokens=prompt.copy(), max_new_tokens=m)])


def test_mixed_k_continuous_batching_mid_round_finish(port, ext):
    """Slots at different accepted lengths, 1- and 2-token requests
    finishing mid-round, more requests than slots."""
    _, (vanilla, _) = port
    jeng, teng = ext
    lens = [3, 17, 9, 24, 5, 12, 7, 20]
    news = [2, 13, 1, 9, 3, 11, 2, 6]

    def make(cls):
        r = np.random.RandomState(91)
        return [cls(rid=i, tokens=r.randint(0, VOCAB,
                                            size=n).astype(np.int32),
                    max_new_tokens=m)
                for i, (n, m) in enumerate(zip(lens, news))]

    _three_ways(vanilla, teng, jeng, make)
    got = _serve(teng, make(Request))
    assert sorted(len(v[0]) for v in got.values()) == sorted(news)


def test_serving_loop_sums_its_fence_windows(ext):
    """The loop's per-fence windows (the JAX loop's `speculative` event)
    sum to the engine's cumulative counters, and the fence's rollback
    trimmed pages back to the free list."""
    _, teng = ext
    teng.reset()
    loop = ServingLoop(teng)
    loop.serve(_mixed(Request, seed=44, n=5))
    counts = _counts(teng)
    stats = loop.spec_stats
    assert stats["fences"] >= 2 and loop.spec_window is not None
    for key in ("drafted", "accepted", "verified", "rollbacks"):
        assert stats[key] == counts[key], key
    assert stats["rounds"] == teng.fetch_state()["speculative"]["rounds"]
    assert stats["verify_dispatch_s"] > 0.0
    assert teng.cache.pages_in_use() == 0


# ----------------------------------------------------------------------
# temperature > 0
# ----------------------------------------------------------------------
def test_temp_positive_identical_draft_never_rejected(weights):
    """truncate:2 of the 2-layer flagship IS the flagship: p == q, so
    u < p/q == 1 always accepts, with no rollback."""
    tc = tgpt2.tiny_gpt2_config()
    engine = InferenceEngine(tc, weights[2], _inference_cfg(
        draft_model="truncate:2", k=3, adaptive=False), device="cpu")
    r = np.random.RandomState(61)
    res = ServingLoop(engine).serve(
        [Request(rid=i, tokens=r.randint(0, VOCAB, size=7 + i),
                 max_new_tokens=10, temperature=1.2, top_k=32)
         for i in range(3)])
    assert all(len(q.out_tokens) == 10 for q in res)
    assert all(0 <= t < VOCAB for q in res for t in q.out_tokens)
    counts = _counts(engine)
    assert counts["drafted"] > 0
    assert counts["accepted"] == counts["drafted"]
    assert counts["rollbacks"] == 0


def test_temp_positive_mismatched_draft_replays(ext):
    """Valid tokens, partial acceptance, and the same seed replays the
    same stream (the coins and draws ride the engine's generators)."""
    _, teng = ext
    prompt = np.random.RandomState(62).randint(0, VOCAB,
                                               size=11).astype(np.int32)

    def run():
        teng.reset()
        return ServingLoop(teng).serve(
            [Request(rid="t", tokens=prompt.copy(), max_new_tokens=10,
                     temperature=0.9, top_k=16)])[0].out_tokens.tolist()

    a = run()
    assert a == run()
    assert len(a) == 10 and all(0 <= t < VOCAB for t in a)
    counts = _counts(teng)
    assert 0 < counts["accepted"] <= counts["drafted"]
    # verified counts each slot's live rounds: one round a fence here
    teng.reset()
    for slot in range(2):
        teng.start_request(slot, prompt[:6 + slot], max_new=5 + 4 * slot,
                           temperature=0.9, top_k=16)
    live_rounds = np.zeros(4, np.int64)
    snap = teng.fetch_state()
    while snap["active"].any():
        live_rounds += snap["active"]
        teng.spec_block(1)
        snap = teng.fetch_state()
    np.testing.assert_array_equal(snap["speculative"]["verified"],
                                  live_rounds)
    assert list(snap["n_gen"][:2]) == [5, 9]


# ----------------------------------------------------------------------
# no host read between fences
# ----------------------------------------------------------------------
def test_spec_block_makes_no_host_sync(port, monkeypatch):
    """Draft chaining, acceptance, the commit and adaptive k enqueue
    only: no .item(), .cpu(), .tolist() or .numpy() in spec_block; the
    fence is one .cpu() carrying the speculative counters too."""
    _, (_, spec) = port
    spec.reset()
    r = np.random.RandomState(71)
    for slot in range(3):
        spec.start_request(slot, r.randint(0, VOCAB, size=6 + 3 * slot),
                           max_new=24)
    calls = []
    for name in ("item", "cpu", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    for _ in range(3):
        spec.spec_block(2)
    assert calls == []
    snap = spec.fetch_state()
    assert calls == ["cpu", "numpy"]   # the one copy, and its numpy view
    assert snap["n_gen"][:3].min() > 0
    assert int(snap["speculative"]["drafted"].sum()) > 0
    spec.reset()


# ----------------------------------------------------------------------
# adaptive k
# ----------------------------------------------------------------------
def test_adaptive_k_backs_off_on_hopeless_draft(weights, port):
    """A draft with ln_f zeroed has logits identically 0, so it always
    proposes token 0, which the flagship never emits here: k drops to
    k_min on the device and the host's dispatch depth follows; reset
    restores the optimistic depth."""
    _, (vanilla, _) = port
    tc, flat = tgpt2.tiny_gpt2_config(), weights[2]
    prompt = np.random.RandomState(81).randint(0, VOCAB,
                                               size=8).astype(np.int32)
    ref = _serve(vanilla, [Request(rid="v", tokens=prompt.copy(),
                                   max_new_tokens=28)])["v"][0]
    assert 0 not in ref
    zero_head = dict(flat, **{"ln_f.scale": torch.zeros_like(
        flat["ln_f.scale"]), "ln_f.bias": torch.zeros_like(flat["ln_f.bias"])})
    engine = InferenceEngine(tc, flat, _inference_cfg(
        draft_model="external", k=4, k_min=1, adaptive=True), device="cpu",
        draft_params=zero_head, draft_model_config=tc)
    engine.start_request(0, prompt, max_new=28)
    assert engine.spec_next_draft() == 4
    for _ in range(4):
        engine.spec_block(2)
        engine.fetch_state()
    snap = engine.fetch_state()["speculative"]
    assert int(snap["accepted"].sum()) == 0
    assert int(snap["k_slot"][0]) == 1
    assert engine.spec_next_draft() == 1
    engine.reset()
    assert engine.spec_next_draft() == 4


def test_adaptive_k_stays_at_cap_for_perfect_draft(port):
    _, (_, spec) = port
    spec.reset()
    spec.start_request(0, np.random.RandomState(82).randint(
        0, VOCAB, size=8).astype(np.int32), max_new=28)
    for _ in range(3):
        spec.spec_block(2)
        spec.fetch_state()
    snap = spec.fetch_state()["speculative"]
    assert int(snap["k_slot"][0]) == spec.config.spec_k
    assert spec.spec_next_draft() == spec.config.spec_k
    spec.reset()


# ----------------------------------------------------------------------
# disabled: vanilla
# ----------------------------------------------------------------------
def test_disabled_default_is_vanilla(weights, port):
    tc, (vanilla, _) = port
    assert vanilla.speculative_enabled is False
    assert not hasattr(vanilla, "_spec_state")
    assert vanilla.cache.draft_n_layer == 0
    off = InferenceEngine(tc, weights[2], {"inference": dict(
        _inference_cfg()["inference"],
        speculative={"enabled": False, "k": 8})}, device="cpu")
    assert off.speculative_enabled is False
    assert set(off._state) == set(vanilla._state)
    assert "speculative" not in off.fetch_state()
    want = _serve(vanilla, _mixed(Request, seed=101, n=4))
    assert _serve(off, _mixed(Request, seed=101, n=4)) == want


# ----------------------------------------------------------------------
# the draft pool and rollback in the cache
# ----------------------------------------------------------------------
def test_kv_cache_draft_pool_and_rollback_match_jax():
    kw = dict(n_layer=4, n_head=4, head_dim=16, num_pages=20, page_size=4,
              max_slots=3, max_pages_per_slot=8)
    ref = JCache(**kw, dtype=np.float32)
    got = PagedKVCache(**kw, dtype=torch.float32)
    for cache in (ref, got):
        cache.attach_draft(1)
    for attr in ("page_bytes", "pool_bytes", "draft_n_layer",
                 "draft_page_bytes", "draft_pool_bytes"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    ops = [("admit", 0, 30), ("ensure", 0, 29), ("admit", 1, 17),
           ("ensure", 1, 17), ("rollback", 0, 9), ("rollback", 0, 9),
           ("ensure", 0, 21), ("rollback", 1, 1), ("free", 0),
           ("admit", 2, 12), ("ensure", 2, 12), ("rollback", 2, 13),
           ("rollback", 2, 0)]
    for op in ops:
        versions = []
        outs = []
        for cache in (ref, got):
            outs.append(getattr(cache, op[0])(*op[1:]))
            versions.append(cache.table_version)
        if op[0] == "rollback":
            assert outs[0] == outs[1], op
        assert versions[0] == versions[1], op
        assert np.array_equal(got.tables, ref.tables), op
        assert got.free_pages() == ref.free_pages(), op
        for slot in range(3):
            assert got.allocated_pages(slot) == ref.allocated_pages(slot)
            assert got.draft_slot_bytes(slot) == \
                ref.allocated_pages(slot) * ref.draft_page_bytes
    with pytest.raises(ValueError):
        got.rollback(0, 4)
