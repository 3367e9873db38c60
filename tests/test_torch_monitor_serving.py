"""PyTorch port: the serving engine's monitor and request tracker against
the JAX package's.

Both packages serve gpt2-tiny from the same weights with a monitor
block (JSONL sink, trace export) and `inference.observability` on: the
same requests give the same request, token and finish counts, the same
event kinds with the same key sets, and the same `kv_cache` and
`kv_cache_draft` ledger bytes at every fence; with a speculative draft
at temperature 0 (the external perturbed draft of
tests/test_torch_speculative.py) the `speculative` events carry the
same drafted and accepted counts. Counts and bytes are exact. The
decode block stays free of host reads with the tracker on.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import Request as JRequest
from deepspeed_tpu.inference import ServingLoop as JLoop
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.inference import (InferenceEngine, Request,
                                           ServingLoop)
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401

VOCAB = 256


def _config(out, **speculative):
    block = {"max_slots": 4, "prefill_chunk": 16, "sync_every": 4,
             "max_new_tokens": 32,
             "kv_cache": {"num_pages": 120, "page_size": 4}}
    if speculative:
        block["speculative"] = dict({"enabled": True}, **speculative)
    return {"inference": block,
            "monitor": {"enabled": True, "output_path": str(out),
                        "trace": {"enabled": True}}}


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def weights():
    cfg = jgpt2.tiny_gpt2_config()
    params = jgpt2.GPT2ForCausalLM(cfg).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return cfg, params, _flat(params)


def _requests(cls, seed=5, n=6):
    r = np.random.RandomState(seed)
    return [cls(rid=i,
                tokens=r.randint(0, VOCAB,
                                 size=int(r.randint(3, 30))).astype(np.int32),
                max_new_tokens=int(r.randint(3, 14)))
            for i in range(n)]


def _events(out):
    return [json.loads(line) for line in open(os.path.join(out,
                                                           "events.jsonl"))]


def _serve_both(weights, tmp_path, draft=None, **speculative):
    cfg, params, flat = weights
    kw_j, kw_t = {}, {}
    if draft is not None:
        kw_j = dict(draft_params=draft, draft_model_config=cfg)
        kw_t = dict(draft_params=_flat(draft),
                    draft_model_config=tgpt2.tiny_gpt2_config())
    jeng = JEngine(cfg, params, _config(tmp_path / "jax", **speculative),
                   **kw_j)
    teng = InferenceEngine(tgpt2.tiny_gpt2_config(), flat,
                           _config(tmp_path / "torch", **speculative),
                           device="cpu", **kw_t)
    ref = JLoop(jeng).serve(_requests(JRequest))
    got = ServingLoop(teng).serve(_requests(Request))
    jeng.monitor.close()
    teng.monitor.close()
    return (jeng, ref, _events(tmp_path / "jax")), \
        (teng, got, _events(tmp_path / "torch"))


def _check_same_serving(jax_side, torch_side):
    (jeng, ref, jev), (teng, got, tev) = jax_side, torch_side
    assert {q.rid: (q.out_tokens.tolist(), q.finish_reason) for q in got} \
        == {q.rid: (q.out_tokens.tolist(), q.finish_reason) for q in ref}
    assert [e["kind"] for e in tev] == [e["kind"] for e in jev]
    for r, g in zip(jev, tev):
        assert sorted(g) == sorted(r), g["kind"]
        if g["kind"] == "serving_slo":
            for key in ("ttft_ms", "token_ms", "queue_ms"):
                assert sorted(g[key]) == sorted(r[key])
        if g["kind"] == "memory":
            for cat in ("kv_cache", "kv_cache_draft"):
                assert g["hbm"]["categories"].get(cat) == \
                    r["hbm"]["categories"].get(cat), cat
    jslo = [e for e in jev if e["kind"] == "serving_slo"][-1]
    tslo = [e for e in tev if e["kind"] == "serving_slo"][-1]
    for key in ("finished_eos", "finished_max_tokens", "total_tokens",
                "rejected_submit", "admission_deferred"):
        assert tslo[key] == jslo[key], key
    assert tslo["total_tokens"] == sum(len(q.out_tokens) for q in got)
    assert [e["new_tokens"] for e in tev if e["kind"] == "request_finished"] \
        == [e["new_tokens"] for e in jev if e["kind"] == "request_finished"]
    assert sorted(teng.tracker.snapshot()) == \
        sorted(jeng.tracker.snapshot())
    for cat in ("kv_cache", "kv_cache_draft"):
        assert teng.monitor.ledger.category_breakdown(cat) == \
            jeng.monitor.ledger.category_breakdown(cat), cat
    return tev


def test_vanilla_serving_events_and_ledger_equal_jax(weights, tmp_path):
    jax_side, torch_side = _serve_both(weights, tmp_path)
    tev = _check_same_serving(jax_side, torch_side)
    mem = [e for e in tev if e["kind"] == "memory"]
    pool = torch_side[0].cache.pool_bytes
    assert mem and all(e["hbm"]["categories"]["kv_cache"] == pool
                       for e in mem)
    trace = json.load(open(tmp_path / "torch" / "trace_rank0.json"))
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {f"serve/slot{s}" for s in range(4)} <= tracks


def test_speculative_counts_and_draft_ledger_equal_jax(weights, tmp_path):
    """Temperature 0, the external perturbed draft at k 3: the same
    tokens, the same drafted and accepted counts in every `speculative`
    event, and the same `kv_cache_draft` bytes."""
    cfg, params, _ = weights
    r = np.random.RandomState(99)
    draft = dict(params, h=jax.tree_util.tree_map(
        lambda x: x + 0.01 * r.randn(*x.shape).astype(x.dtype),
        params["h"]))
    jax_side, torch_side = _serve_both(weights, tmp_path, draft=draft,
                                       draft_model="external", k=3)
    tev = _check_same_serving(jax_side, torch_side)
    jspec = [e for e in jax_side[2] if e["kind"] == "speculative"]
    tspec = [e for e in tev if e["kind"] == "speculative"]
    assert len(tspec) == len(jspec) > 0
    for r_, g in zip(jspec, tspec):
        for key in ("rounds", "drafted_tokens", "accepted_tokens",
                    "rollback_events", "rollback_pages"):
            assert g[key] == r_[key], key
    snap = torch_side[0].tracker.snapshot()["speculative"]
    assert snap["drafted_tokens"] == sum(e["drafted_tokens"] for e in tspec)
    assert snap["accepted_tokens"] == sum(e["accepted_tokens"] for e in tspec)


def test_truncate_draft_registers_its_pool_not_its_views(weights, tmp_path):
    """A truncate:N draft's weights are the flagship's own tensors: the
    ledger counts the draft's KV pool and no second copy of weights."""
    flat = weights[2]
    plain = InferenceEngine(tgpt2.tiny_gpt2_config(), flat,
                            _config(tmp_path / "a"), device="cpu")
    spec = InferenceEngine(tgpt2.tiny_gpt2_config(), flat,
                           _config(tmp_path / "b", draft_model="truncate:1",
                                   k=2), device="cpu")
    tot = spec.monitor.ledger.totals()["hbm"]
    assert tot["params"] == plain.monitor.ledger.totals()["hbm"]["params"]
    assert tot["kv_cache_draft"] == spec.cache.draft_pool_bytes
    assert tot["kv_cache"] == spec.cache.pool_bytes


def test_decode_and_spec_blocks_read_nothing_with_the_tracker(
        weights, tmp_path, monkeypatch):
    """With the monitor and the tracker on, decode_block and spec_block
    enqueue only; the fence is one .cpu()."""
    flat = weights[2]
    for spec in ({}, {"draft_model": "truncate:1", "k": 2}):
        engine = InferenceEngine(tgpt2.tiny_gpt2_config(), flat,
                                 _config(tmp_path / str(len(spec)), **spec),
                                 device="cpu")
        assert engine.tracker is not None
        loop = ServingLoop(engine)
        for q in _requests(Request, n=3):
            loop.submit(q)
        loop._t0 = 0.0
        loop._admit(0.0)
        for _ in range(3):
            loop._prefill_turn()
        calls = []
        for name in ("item", "cpu", "tolist", "numpy"):
            orig = getattr(torch.Tensor, name)

            def counted(self, *a, _orig=orig, _name=name, **k):
                calls.append(_name)
                return _orig(self, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counted)
        if spec:
            engine.spec_block(2)
        else:
            engine.decode_block(4)
        assert calls == []
        engine.fetch_state()
        assert calls.count("cpu") == 1 and "item" not in calls
        monkeypatch.undo()
        engine.monitor.close()
