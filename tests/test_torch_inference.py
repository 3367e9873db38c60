"""PyTorch port: the paged-KV serving engine against the JAX package,
plus the port's guard tests.

The same tiny GPT-2 weights (a JAX tree converted with
`params_from_jax`) and the same requests go through the JAX
InferenceEngine (config as in tests/test_inference.py) and the port's
engine on the CPU. Tolerance: fp32, so per-step decode logits agree to
roundoff, atol = rtol = 1e-5 (observed ~2e-7), and greedy tokens are
identical. Tolerances, not bit equality: the JAX package's own
bit-exact serving checks do not hold on every build.

Guards: importing the port (and chip_smoke) loads no jax/flax module
and nothing of deepspeed_tpu; `decode_block` makes no host sync; CPU
runs launch no kernel; default-device construction raises without
CUDA; the serving options still out of the port raise naming their
ROADMAP item, and the ported ones (speculative decoding and int8
weights: tests/test_torch_speculative.py,
tests/test_torch_inference_int8.py) construct and decode.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import PagedKVCache as JCache
from deepspeed_tpu.inference import Request as JRequest
from deepspeed_tpu.inference import ServingLoop as JLoop
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.inference.config import \
    InferenceConfigError as JConfigError
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import constants as jconst
from deepspeed_tpu_torch.inference import (InferenceConfig,
                                           InferenceConfigError,
                                           InferenceEngine, PagedKVCache,
                                           Request, ServingLoop,
                                           serve_sequential)
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo
from deepspeed_tpu_torch.runtime import constants as tconst
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICFG = {"inference": {"max_slots": 4, "prefill_chunk": 16, "sync_every": 4,
                      "max_new_tokens": 32,
                      "kv_cache": {"num_pages": 120, "page_size": 4}}}


@pytest.fixture(scope="module")
def weights():
    cfg = jgpt2.tiny_gpt2_config()
    params = jgpt2.GPT2ForCausalLM(cfg).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return cfg, params, params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_engine(weights):
    cfg, params, _ = weights
    return JEngine(cfg, params, ICFG)


@pytest.fixture
def engine(weights):
    return InferenceEngine(tgpt2.tiny_gpt2_config(), weights[2], ICFG,
                           device="cpu")


def _prompts(lengths, seed):
    r = np.random.RandomState(seed)
    return [r.randint(0, 256, size=n).astype(np.int32) for n in lengths]


def test_decode_logits_and_tokens_match_jax_engine(jax_engine, engine):
    """Two live slots (chunked prefill of 37 and 9 tokens), 12 decode
    steps: every step's logits per slot within tolerance, greedy tokens
    identical."""
    jax_engine.reset()
    prompts = _prompts((37, 9), seed=2)
    for slot, p in enumerate(prompts):
        jax_engine.start_request(slot, p, max_new=12)
        engine.start_request(slot, p, max_new=12)
    for _ in range(12):
        ref = np.asarray(jax_engine.decode_once())[:2]
        got = engine.decode_once()[:2].numpy()
        np.testing.assert_allclose(got, ref, **TOL)
    ref_state = jax.device_get(jax_engine._state)
    state = engine.fetch_state()
    np.testing.assert_array_equal(state["out_tokens"][:2, :12],
                                  np.asarray(ref_state["out_tokens"])[:2, :12])
    np.testing.assert_array_equal(state["pos"], np.asarray(ref_state["pos"]))
    jax_engine.reset()


def _requests(cls, prompts, **kw):
    return [cls(rid=i, tokens=p, max_new_tokens=kw.get("new", 8),
                top_k=kw.get("top_k", 0))
            for i, p in enumerate(prompts)]


def test_serving_loop_tokens_match_jax(jax_engine, engine):
    """Six requests over four slots (admission waits, chunked prefill
    interleaves with decode): the same tokens out of both packages."""
    jax_engine.reset()
    prompts = _prompts((5, 20, 33, 9, 17, 40), seed=4)
    ref = {r.rid: r.out_tokens
           for r in JLoop(jax_engine).serve(_requests(JRequest, prompts))}
    got = {r.rid: r.out_tokens
           for r in ServingLoop(engine).serve(_requests(Request, prompts))}
    assert sorted(got) == sorted(ref) == list(range(6))
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    jax_engine.reset()


def test_continuous_batching_equals_isolated_runs(engine):
    prompts = _prompts((5, 20, 33, 9, 17, 40), seed=5)
    batched = {r.rid: r.out_tokens for r in
               ServingLoop(engine).serve(_requests(Request, prompts))}
    assert engine.cache.pages_in_use() == 0
    isolated = serve_sequential(engine, _requests(Request, prompts))
    iso = {r.rid: r.out_tokens for r in isolated.results}
    for rid in range(6):
        assert len(batched[rid]) == 8
        np.testing.assert_array_equal(batched[rid], iso[rid])


def test_top_k_1_equals_greedy_and_sampling_is_seeded(engine):
    prompts = _prompts((11, 23), seed=6)
    greedy = {r.rid: r.out_tokens for r in
              ServingLoop(engine).serve(_requests(Request, prompts))}
    engine.reset()
    reqs = _requests(Request, prompts, top_k=1)
    for r in reqs:
        r.temperature = 0.8
    top1 = {r.rid: r.out_tokens for r in ServingLoop(engine).serve(reqs)}
    for rid in greedy:
        np.testing.assert_array_equal(top1[rid], greedy[rid])

    def sampled():
        engine.reset()
        reqs = _requests(Request, prompts, top_k=20)
        for r in reqs:
            r.temperature = 1.0
        return {r.rid: r.out_tokens for r in ServingLoop(engine).serve(reqs)}

    a, b = sampled(), sampled()
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


def test_eos_stops_a_request(engine):
    prompt = _prompts((13,), seed=7)[0]
    free = ServingLoop(engine).serve([Request(rid=0, tokens=prompt,
                                              max_new_tokens=8)])[0]
    eos = int(free.out_tokens[2])
    first = int(np.argmax(free.out_tokens == eos))
    engine.reset()
    got = ServingLoop(engine).serve([Request(rid=0, tokens=prompt,
                                             max_new_tokens=8,
                                             eos_token_id=eos)])[0]
    assert got.finish_reason == "eos"
    np.testing.assert_array_equal(got.out_tokens,
                                  free.out_tokens[:first + 1])


CONFIGS = (
    {},
    ICFG,
    {"inference": {"max_seq_len": 64, "eos_token_id": 3, "top_k_max": 8,
                   "seed": 5, "weight_bits": 8, "weight_quant_block": 32,
                   "observability": {"enabled": False, "slo_ttft_ms": 5},
                   "speculative": {"enabled": True, "draft_model":
                                   "truncate:2", "k": 3, "k_min": 2,
                                   "adaptive": False}}},
)
BAD = (
    {"inference": []},
    {"inference": {"max_slots": 0}},
    {"inference": {"prefill_chunk": "x"}},
    {"inference": {"weight_bits": 4}},
    {"inference": {"kv_cache": {"num_pages": 1}}},
    {"inference": {"kv_cache": []}},
    {"inference": {"observability": {"slo_token_ms": -1}}},
    {"inference": {"speculative": {"draft_model": "truncate:0"}}},
    {"inference": {"speculative": {"draft_model": "mine"}}},
    {"inference": {"speculative": {"k": 2, "k_min": 3}}},
)


@pytest.mark.parametrize("config", CONFIGS)
def test_inference_config_resolves_like_jax(config):
    assert vars(InferenceConfig(config)) == vars(JConfig(config))


@pytest.mark.parametrize("config", BAD)
def test_inference_config_errors_like_jax(config):
    with pytest.raises(JConfigError) as ref:
        JConfig(config)
    with pytest.raises(InferenceConfigError) as got:
        InferenceConfig(config)
    assert str(got.value) == str(ref.value)


def test_config_constants_match_jax():
    names = [n for n in dir(tconst) if n.isupper()]
    assert len(names) > 40
    for name in names:
        assert getattr(tconst, name) == getattr(jconst, name), name


def test_paged_kv_cache_arithmetic_matches_jax():
    kw = dict(n_layer=2, n_head=4, head_dim=16, num_pages=20, page_size=4,
              max_slots=3, max_pages_per_slot=8)
    ref, got = JCache(**kw), PagedKVCache(**kw)
    ops = [("admit", 0, 17), ("ensure", 0, 5), ("admit", 1, 30),
           ("ensure", 1, 30), ("ensure", 0, 17), ("admit", 2, 9),
           ("free", 0), ("ensure", 2, 9), ("admit", 0, 12),
           ("ensure", 0, 3), ("free", 1), ("free", 2)]
    for op in ops:
        for cache in (ref, got):
            getattr(cache, op[0])(*op[1:])
        assert np.array_equal(got.tables, ref.tables), op
        for fn in ("free_pages", "reserved_unallocated", "pages_in_use",
                   "slots"):
            assert getattr(got, fn)() == getattr(ref, fn)(), (op, fn)
        for probe in (1, 17, 33, 64):
            assert got.can_admit(probe) == ref.can_admit(probe)
        for slot in range(3):
            assert got.allocated_pages(slot) == ref.allocated_pages(slot)
            assert got.reserved_tokens(slot) == ref.reserved_tokens(slot)
    with pytest.raises(RuntimeError):
        got.ensure(0, 100)
    with pytest.raises(ValueError):
        got.admit(0, 4)


def _decode_four(engine):
    """Admit one request, take its 4 new tokens through the engine's
    dispatch loop, and return them from the fence."""
    engine.start_request(0, _prompts((11,), seed=10)[0], max_new=4)
    if engine.speculative_enabled:
        engine.spec_block(4)
    else:
        engine.decode_block(4)
    state = engine.fetch_state()
    assert state["n_gen"][0] == 4 and not state["active"][0]
    return state["out_tokens"][0, :4]


def test_out_of_slice_engine_options_raise(weights, tmp_path):
    """Speculative decoding and int8 weights (ROADMAP Queue 1 item 7)
    and the monitor (item 8) construct and decode; the monitor's engine
    carries a serving tracker."""
    cfg = tgpt2.tiny_gpt2_config()
    for extra in ({"speculative": {"enabled": True}}, {"weight_bits": 8}):
        engine = InferenceEngine(
            cfg, weights[2], {"inference": dict(ICFG["inference"], **extra)},
            device="cpu")
        assert all(0 <= t < cfg.vocab_size for t in _decode_four(engine))
    engine = InferenceEngine(
        cfg, weights[2], dict(ICFG, monitor={"enabled": True,
                                             "output_path": str(tmp_path)}),
        device="cpu")
    assert engine.tracker is not None
    assert all(0 <= t < cfg.vocab_size for t in _decode_four(engine))


@pytest.mark.parametrize("extra,item", [
    ({"inference": {"speculative": {"enabled": True}}}, None),
    ({"inference": {"weight_bits": 8}}, None),
    ({"monitor": {"enabled": True}}, None),
], ids=["speculative", "int8-weights", "monitor"])
def test_out_of_slice_engine_options_name_their_roadmap_item(weights, extra,
                                                             item, tmp_path):
    """Each serving option the port does not have yet names the ROADMAP
    Queue 1 item that ports it; the options of items 7 and 8 (item None
    here) are ported: the engine constructs and decodes, speculation at
    temperature 0 giving the vanilla engine's tokens, the monitor giving
    them too and writing its events (a ServingLoop's `decode_batch` and
    `request_finished`) to its JSONL sink."""
    if "monitor" in extra:
        extra = {"monitor": dict(extra["monitor"], output_path=str(tmp_path))}
    config = dict(ICFG, **extra)
    config["inference"] = dict(ICFG["inference"], **extra.get("inference", {}))
    cfg = tgpt2.tiny_gpt2_config()
    if item is not None:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1 item {item}$"):
            InferenceEngine(cfg, weights[2], config, device="cpu")
        return
    got = _decode_four(InferenceEngine(cfg, weights[2], config,
                                       device="cpu"))
    if "speculative" in config["inference"] or "monitor" in config:
        want = _decode_four(InferenceEngine(cfg, weights[2], ICFG,
                                            device="cpu"))
        np.testing.assert_array_equal(got, want)
    if "monitor" in config:
        import json
        eng = InferenceEngine(cfg, weights[2], config, device="cpu")
        ServingLoop(eng).serve(_requests(Request, _prompts((6, 10), seed=9)))
        eng.monitor.close()
        kinds = [json.loads(line)["kind"] for line in
                 open(tmp_path / "events.jsonl")]
        assert kinds.count("request_finished") == 2
        assert "decode_batch" in kinds and "serving_slo" in kinds


def test_default_device_raises_without_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(tgpt2.tiny_gpt2_config(), weights[2], ICFG)


def test_decode_block_makes_no_host_sync(engine, monkeypatch):
    """decode_block enqueues only: no .item(), .cpu(), .tolist() or
    .numpy() on any tensor between fences; fetch_state is one .cpu()."""
    for slot, p in enumerate(_prompts((9, 21, 14), seed=8)):
        engine.start_request(slot, p, max_new=16)
    calls = []
    for name in ("item", "cpu", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    engine.decode_block(6)
    engine.decode_block(4)
    assert calls == []
    state = engine.fetch_state()
    assert calls.count("cpu") == 1
    assert list(state["n_gen"][:3]) == [10, 10, 10]


def test_cpu_serving_launches_no_kernel(engine):
    tfo.reset_launch_counts()
    tfa.reset_launch_count()
    ServingLoop(engine).serve(_requests(Request, _prompts((6, 10), seed=9)))
    assert tfo.fused_bias_residual_layernorm.launches == 0
    assert tfo.fused_bias_gelu.launches == 0
    assert tfa.flash_attention_with_lse.launches == 0


def test_port_imports_load_no_jax():
    """Importing the port and chip_smoke (with the modules it imports
    when it runs) leaves no jax/flax module and nothing of
    deepspeed_tpu in sys.modules."""
    code = (
        "import sys\n"
        "import chip_smoke, deepspeed_tpu_torch\n"
        "import deepspeed_tpu_torch.inference\n"
        "import deepspeed_tpu_torch.inference.speculative\n"
        "import deepspeed_tpu_torch.inference.quant\n"
        "import deepspeed_tpu_torch.models.gpt2\n"
        "import deepspeed_tpu_torch.models.convert\n"
        "import deepspeed_tpu_torch.ops._build\n"
        "import deepspeed_tpu_torch.ops.sparse_attention\n"
        "import deepspeed_tpu_torch.moe\n"
        "import deepspeed_tpu_torch.runtime.engine\n"
        "import deepspeed_tpu_torch.ops.transformer.quantized_matmul\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deepspeed_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
