"""PyTorch port: int8 weight-only serving against the JAX package
(inference/quant.py, `int8_matmul`, the engine's `weight_bits: 8`).

The same tiny GPT-2 weights (a JAX tree converted with
`params_from_jax`) and numpy-seeded inputs on the CPU, fp32, one torch
thread. Tolerances:
  * `quantize_param_tree`: bit for bit, values and scales (the same
    fp32 max, division and round-half-to-even);
  * `int8_matmul`: within 1e-5 of JAX's (fp32; the block partials
    summed in another order);
  * the int8 engine's decode logits against the JAX int8 engine's:
    atol = rtol = 1e-5 (fp32 roundoff through two layers, as the
    unquantized engines in tests/test_torch_inference.py), greedy tokens
    identical;
  * the int8 engine against the port's fp32 engine: within 2e-2 with
    the same argmax (tests/test_inference.py's int8 convention);
  * int8 with speculative decoding: the stream equals the int8 vanilla
    engine's and the JAX int8 speculative engine's, with its counts.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import Request as JRequest
from deepspeed_tpu.inference import ServingLoop as JLoop
from deepspeed_tpu.inference import quant as jquant
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.inference import (InferenceEngine, Request,
                                           ServingLoop)
from deepspeed_tpu_torch.inference import quant as tquant
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.transformer import quantized_matmul as tqm
from torch_one_thread import one_torch_thread  # noqa: F401

# the JAX package exports a function under the module's name
jqm = importlib.import_module(
    "deepspeed_tpu.ops.transformer.quantized_matmul")

TOL = dict(atol=1e-5, rtol=1e-5)
INT8_GAP = 2e-2
BLOCK = 32


def _icfg(weight_bits=8, **speculative):
    block = {"max_slots": 4, "prefill_chunk": 16, "sync_every": 4,
             "max_new_tokens": 32, "weight_bits": weight_bits,
             "weight_quant_block": BLOCK,
             "kv_cache": {"num_pages": 120, "page_size": 4}}
    if speculative:
        block["speculative"] = dict({"enabled": True}, **speculative)
    return {"inference": block}


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def weights():
    cfg = jgpt2.tiny_gpt2_config()
    params = jgpt2.GPT2ForCausalLM(cfg).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return cfg, params, _flat(params)


@pytest.fixture(scope="module")
def engines(weights):
    """The JAX int8 engine, the port's int8 engine and the port's fp32
    engine over the same weights."""
    cfg, params, flat = weights
    tc = tgpt2.tiny_gpt2_config()
    return (JEngine(cfg, params, _icfg()),
            InferenceEngine(tc, flat, _icfg(), device="cpu"),
            InferenceEngine(tc, flat, _icfg(weight_bits=32), device="cpu"))


def _prompts(lengths, seed):
    r = np.random.RandomState(seed)
    return [r.randint(0, 256, size=n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("block", [16, 32, 48, 128])
def test_quantize_param_tree_bit_for_bit(weights, block):
    """Per layer and projection, values and scales equal the JAX
    quantizer's on the stacked tree; other leaves pass through."""
    _, params, flat = weights
    ref = _flat(jquant.quantize_param_tree(params, block))
    got = tquant.quantize_param_tree(flat, block)
    assert sorted(got) == sorted(ref)
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(), ref[name].numpy(),
                                      err_msg=name)
        if tquant.is_quant_kernel(name):
            assert value.dtype == torch.int8
            assert got[name + "_scale"].dtype == torch.float32
        elif not name.endswith(tquant.KERNEL_SCALE):
            assert value is flat[name]


def test_quantize_all_zero_block_keeps_a_zero_scale():
    """A zero block's scale is 0 in the tree, as the JAX numpy quantizer
    writes it (the product clamps it to 1 on its own), and the products
    of the two layouts agree."""
    w = np.random.RandomState(3).randn(64, 8).astype(np.float32)
    w[:32, 2] = 0.0
    # a block whose max-abs is 127 has the scale 1 and nonzero values
    w[32:, 5] = 0.5
    w[40, 5] = 127.0
    jq, js = jqm.quantize_kernel_int8_np(w, 32)
    tree = tquant.quantize_param_tree({"h.0.c_fc.kernel":
                                       torch.from_numpy(w)}, 32)
    tq, ts = tree["h.0.c_fc.kernel"], tree["h.0.c_fc.kernel_scale"]
    assert js[0, 2] == 0.0 and js[1, 5] == 1.0
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tq.numpy(), jq)
    x = torch.from_numpy(np.random.RandomState(5).randn(3, 64).astype(
        np.float32))
    cq, cs = tqm.quantize_kernel_int8(torch.from_numpy(w), 32)
    assert cs[0, 2] == 1.0
    torch.testing.assert_close(
        tqm.int8_matmul(x, tq, ts, 32, torch.float32),
        tqm.int8_matmul(x, cq, cs, 32, torch.float32), rtol=0, atol=0)


@pytest.mark.parametrize("lead,k,n,block", [
    ((5,), 64, 192, 32), ((2, 3), 64, 64, 16), ((4, 1), 100, 30, 32),
    ((7,), 256, 64, 128)], ids=["c_attn", "3d", "ragged_k", "block128"])
def test_int8_matmul_matches_jax(lead, k, n, block):
    r = np.random.RandomState(4)
    w = (r.randn(k, n) * 0.05).astype(np.float32)
    x = r.randn(*(lead + (k,))).astype(np.float32)
    q, s = jqm.quantize_kernel_int8_np(w, block)
    ref = np.asarray(jqm.int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                     jnp.asarray(s), block, jnp.float32))
    got = tqm.int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                          torch.from_numpy(s), block, torch.float32)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # values already padded to whole blocks give the same product
    qp = torch.nn.functional.pad(torch.from_numpy(q),
                                 (0, 0, 0, -k % block))
    padded = tqm.int8_matmul(torch.from_numpy(x), qp, torch.from_numpy(s),
                             block, torch.float32)
    np.testing.assert_array_equal(padded.numpy(), got.numpy())


def test_int8_engine_decode_logits_match_jax(engines):
    """Two live slots (chunked prefill of 37 and 9 tokens), 8 decode
    steps: logits per step within tolerance, greedy tokens identical."""
    jeng, teng, _ = engines
    jeng.reset()
    teng.reset()
    for slot, p in enumerate(_prompts((37, 9), seed=12)):
        jeng.start_request(slot, p, max_new=8)
        teng.start_request(slot, p, max_new=8)
    for _ in range(8):
        ref = np.asarray(jeng.decode_once())[:2]
        got = teng.decode_once()[:2].numpy()
        np.testing.assert_allclose(got, ref, **TOL)
    ref_out = np.asarray(jax.device_get(jeng._state)["out_tokens"])[:2, :8]
    np.testing.assert_array_equal(teng.fetch_state()["out_tokens"][:2, :8],
                                  ref_out)
    jeng.reset()
    teng.reset()


def test_int8_engine_within_pinned_gap_of_fp32(engines):
    """int8 per-block-scale weights track the fp32 engine's logits
    within 2e-2 on the tiny model, with the same greedy token."""
    _, teng, t32 = engines
    prompt = _prompts((12,), seed=13)[0]
    for eng in (teng, t32):
        eng.reset()
        eng.start_request(0, prompt, max_new=6)
    for _ in range(3):
        l8 = teng.decode_once()[0].numpy()
        l32 = t32.decode_once()[0].numpy()
        assert np.abs(l32 - l8).max() < INT8_GAP, np.abs(l32 - l8).max()
        assert l32.argmax() == l8.argmax()
    teng.reset()
    t32.reset()


def test_int8_serving_loop_tokens_match_jax(engines):
    jeng, teng, _ = engines

    def reqs(cls):
        return [cls(rid=i, tokens=p, max_new_tokens=8)
                for i, p in enumerate(_prompts((5, 20, 33, 9, 17), seed=14))]

    jeng.reset()
    ref = {r.rid: r.out_tokens.tolist() for r in JLoop(jeng).serve(reqs(
        JRequest))}
    teng.reset()
    got = {r.rid: r.out_tokens.tolist()
           for r in ServingLoop(teng).serve(reqs(Request))}
    assert got == ref
    jeng.reset()


def test_int8_engine_holds_int8_values_and_scales(engines):
    """Every projection of every layer is int8, padded to whole blocks,
    with its fp32 scales; the embeddings and LayerNorms stay fp32."""
    _, teng, _ = engines
    w = teng._weights
    assert w["wte"].dtype == w["wte_c"].dtype == torch.float32
    for lp in w["layers"]:
        for mod in tquant.QUANT_KERNEL_MODULES:
            q = lp[f"{mod}.kernel"]
            s = lp[f"{mod}.{tquant.KERNEL_SCALE}"]
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            assert q.shape[0] == s.shape[0] * BLOCK
        assert lp["ln_1.scale"].dtype == torch.float32


def test_int8_with_speculative_decoding(weights, engines):
    """int8 + truncate:1: the stream equals the int8 vanilla engine's
    and the JAX int8 speculative engine's, with JAX's counts."""
    cfg, params, flat = weights
    _, teng, _ = engines
    tc = tgpt2.tiny_gpt2_config()
    spec_cfg = dict(draft_model="truncate:1", k=3)
    tspec = InferenceEngine(tc, flat, _icfg(**spec_cfg), device="cpu")
    jspec = JEngine(cfg, params, _icfg(**spec_cfg))
    # the draft shares the flagship's int8 blocks
    assert tspec._draft["layers"][0] is tspec._weights["layers"][0]

    def reqs(cls):
        r = np.random.RandomState(15)
        return [cls(rid=i, tokens=r.randint(0, 256, size=int(
            r.randint(3, 30))).astype(np.int32),
            max_new_tokens=int(r.randint(3, 14))) for i in range(6)]

    def serve(eng, cls):
        eng.reset()
        loop = JLoop if cls is JRequest else ServingLoop
        return {r.rid: r.out_tokens.tolist()
                for r in loop(eng).serve(reqs(cls))}

    want = serve(teng, Request)
    got = serve(tspec, Request)
    assert got == want
    assert got == serve(jspec, JRequest)
    counts = [{k: int(np.asarray(v).sum()) for k, v in
               e.fetch_state()["speculative"].items() if k != "k_slot"}
              for e in (tspec, jspec)]
    assert counts[0] == counts[1]
    assert counts[0]["drafted"] > 0
