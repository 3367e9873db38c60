"""PyTorch port: the CUDA kernels on the card (kernels K1-fwd, K2,
K3-fwd, K3-bwd, K4-fwd, K4-bwd) against their plain PyTorch twins, the
serving engine against the kernel-driven forward, and a training step
on the kernels against the plain-torch route.

Every test here is marked `cuda` and skips where
torch.cuda.is_available() is False. The file imports neither JAX nor
the JAX package, so on a machine with a GPU and no JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: bf16 outputs within one rounding of the twin's fp32 result
(atol = rtol = 1e-2, about one bf16 ulp); fp32 outputs and the
log2-space lse to reduction-order roundoff (atol = rtol = 1e-4).
Gradients are compared by relative L2 error, ||got - ref|| / ||ref||:
fp32 within 1e-5 (reduction order); bf16 within 1e-2 (one rounding of
each output, plus the bf16 rounding of P and dS inside attention, which
may flip by one ulp where the kernel's and the twin's fp32 scores differ
in the last bit).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo

BF16_TOL = dict(atol=1e-2, rtol=1e-2)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
pytestmark = pytest.mark.cuda


def _rel_l2(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("h", [100, 1600])
def test_bias_residual_layernorm_kernel_matches_twin(dev, h):
    g = _gen(dev)
    y, res = (torch.randn((64, h), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    bias, gamma, beta = (torch.randn((h,), generator=g, device=dev)
                         for _ in range(3))
    before = tfo.fused_bias_residual_layernorm.launches
    out, s = tfo.fused_bias_residual_layernorm(y, bias, res, gamma, beta)
    ref_out, ref_s = tfo._ln_fwd_math(y, bias, res, gamma, beta, 1e-5)
    torch.testing.assert_close(out.float(), ref_out.to(out.dtype).float(),
                               **BF16_TOL)
    torch.testing.assert_close(s.float(), ref_s.to(s.dtype).float(),
                               **BF16_TOL)
    lnf = tfo.fused_bias_residual_layernorm(
        y, bias, res, gamma, beta, out_dtype=torch.float32,
        return_sum=False)
    torch.testing.assert_close(lnf, ref_out, **F32_TOL)
    torch.cuda.synchronize()
    assert tfo.fused_bias_residual_layernorm.launches == before + 2


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_bias_gelu_kernel_matches_twin(dev, approximate):
    g = _gen(dev, 1)
    x = torch.randn((64, 6400), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((6400,), generator=g, device=dev)
    before = tfo.fused_bias_gelu.launches
    got, s = tfo.fused_bias_gelu_with_sum(x, bias, approximate=approximate)
    ref, ref_s = tfo._gelu_fwd_math(x, bias, approximate)
    torch.testing.assert_close(got.float(), ref.to(got.dtype).float(),
                               **BF16_TOL)
    torch.testing.assert_close(s.float(), ref_s.to(s.dtype).float(),
                               **BF16_TOL)
    torch.cuda.synchronize()
    assert tfo.fused_bias_gelu.launches == before + 1


@pytest.mark.parametrize("dtype,causal,d", [
    (torch.bfloat16, True, 64), (torch.bfloat16, False, 64),
    (torch.bfloat16, True, 128), (torch.float32, True, 64),
    (torch.float32, False, 128)])
def test_flash_kernel_matches_twin(dev, dtype, causal, d):
    """q/k/v as column slices of one qkv tensor (the model's strided
    layout), read in place by the kernel."""
    g = _gen(dev, 2)
    b, t, h = 2, 256, 3
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    before = tfa.flash_attention_with_lse.launches
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    ref, ref_lse = tfa._flash_fwd_plain(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_with_lse.launches == before + 1
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse[..., 0], ref_lse, **F32_TOL)


def test_cuda_tensors_never_fall_back(dev):
    """What the kernels do not take raises; nothing runs the twin."""
    q = torch.zeros((1, 96, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # T not a multiple of 64
        tfa.flash_attention(q, q, q)
    q = torch.zeros((1, 128, 2, 80), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # head_dim 80
        tfa.flash_attention(q, q, q)
    q = torch.zeros((1, 128, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q)
    y = torch.zeros((4, 8), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfo.fused_bias_gelu(y, torch.zeros(8, device=dev))
    y = torch.zeros((8, 4), device=dev).t()
    with pytest.raises(ValueError):          # not contiguous
        tfo.fused_bias_gelu(y, torch.zeros(8, device=dev))


def test_engine_matches_kernel_forward(dev):
    """Decode logits of the engine (K3/K4 in every block) against the
    model forward (K1/K3/K4) on the same tokens, in bf16 with the
    chip_smoke tolerance."""
    cfg = tgpt2.gpt2_config("gpt2-125m", n_layer=2, vocab_size=1024)
    model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
    params = model.init(seed=0)
    icfg = {"inference": {"max_slots": 2, "prefill_chunk": 32,
                          "max_new_tokens": 28,
                          "kv_cache": {"num_pages": 32, "page_size": 16}}}
    eng = InferenceEngine(cfg, params, icfg, device=dev)
    prompt = np.random.RandomState(10).randint(0, 1024, 100)
    eng.start_request(0, prompt, max_new=28)
    steps = torch.stack([eng.decode_once()[0].float() for _ in range(28)])
    toks = eng.fetch_state()["out_tokens"][0, :28]
    ids = np.zeros((1, 128), np.int64)
    ids[0, :128] = np.concatenate([prompt, toks])
    ref = model.apply(params, ids)[0, 99:127].float()
    torch.cuda.synchronize()
    assert float((steps - ref).abs().max()) <= 0.125


@pytest.mark.parametrize("dtype,causal,d", [
    (torch.bfloat16, True, 64), (torch.bfloat16, False, 64),
    (torch.bfloat16, True, 128), (torch.float32, True, 64),
    (torch.float32, False, 128)])
def test_flash_backward_kernel_matches_twin(dev, dtype, causal, d):
    """K2 against _flash_bwd_plain on the forward kernel's own (out,
    lse), with an lse cotangent, q/k/v as qkv column slices."""
    g = _gen(dev, 3)
    b, t, h = 2, 256, 3
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    lse = lse[..., 0].contiguous()
    dout = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    dlse = torch.randn((b, h, t), generator=g, device=dev)
    before = tfa.flash_attention_backward.launches
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, dlse,
                                       d ** -0.5, causal)
    ref = tfa._flash_bwd_plain(q, k, v, out, lse, dout, dlse, d ** -0.5,
                               causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_backward.launches == before + 1
    for name, x, y in zip("qkv", got, ref):
        assert x.dtype == dtype and x.shape == (b, t, h, d)
        assert _rel_l2(x, y) <= GRAD_TOL[dtype], name


@pytest.mark.parametrize("h", [100, 1600])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_dsum", [True, False])
def test_layernorm_backward_kernel_matches_twin(dev, h, dtype, with_dsum):
    g = _gen(dev, 4)
    n = 300
    s = (2.0 * torch.randn((n, h), generator=g, device=dev)).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn((h,), generator=g, device=dev)
    dout = torch.randn((n, h), generator=g, device=dev).to(dtype)
    dsum = torch.randn((n, h), generator=g, device=dev).to(dtype) \
        if with_dsum else None
    before = tfo.fused_bias_residual_layernorm_backward.launches
    got = tfo.fused_bias_residual_layernorm_backward(s, gamma, dout, dsum)
    ds, dg_rows, db_rows = tfo._ln_bwd_math(s, gamma, dout, dsum, 1e-5)
    ref = (ds.to(dtype), ds.sum(0), dg_rows.sum(0), db_rows.sum(0))
    torch.cuda.synchronize()
    assert tfo.fused_bias_residual_layernorm_backward.launches == before + 1
    assert got[0].dtype == dtype
    for x, y in zip(got, ref):
        assert _rel_l2(x, y) <= GRAD_TOL[dtype]
    # deterministic: a second launch repeats bit for bit
    again = tfo.fused_bias_residual_layernorm_backward(s, gamma, dout, dsum)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_backward_kernel_matches_twin(dev, approximate, dtype):
    g = _gen(dev, 5)
    s = (2.0 * torch.randn((300, 6400), generator=g, device=dev)).to(dtype)
    dout = torch.randn((300, 6400), generator=g, device=dev).to(dtype)
    before = tfo.fused_bias_gelu_backward.launches
    dx, dbias = tfo.fused_bias_gelu_backward(s, dout,
                                             approximate=approximate)
    ref = tfo._gelu_bwd_math(s, dout, approximate)
    torch.cuda.synchronize()
    assert tfo.fused_bias_gelu_backward.launches == before + 1
    assert dx.dtype == dtype
    assert _rel_l2(dx, ref.to(dtype)) <= GRAD_TOL[dtype]
    assert _rel_l2(dbias, ref.sum(0)) <= GRAD_TOL[torch.float32] * 10
    again = tfo.fused_bias_gelu_backward(s, dout, approximate=approximate)
    assert torch.equal(dx, again[0]) and torch.equal(dbias, again[1])


def test_training_step_matches_plain_route(dev):
    """A 2-layer gpt2-125m-wide bf16 model: loss and every gradient
    through the kernels (fused ops, flash: K1-K4 forward and backward,
    under remat) against the plain-torch route (fused_ops off, dense
    attention), on the same weights and batch; then one engine step."""
    import dataclasses
    import deepspeed_tpu_torch as dst
    cfg = tgpt2.gpt2_config("gpt2-125m", n_layer=2, vocab_size=1024,
                            n_positions=256, dropout=0.0,
                            param_dtype=torch.bfloat16)
    model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
    params = model.init(seed=0)
    plain = tgpt2.GPT2ForCausalLM(dataclasses.replace(
        cfg, fused_ops="off", attention_impl="xla"), device=dev)
    ids = torch.randint(0, 1024, (2, 256), generator=_gen(dev, 6),
                        device=dev)
    results = []
    for m in (model, plain):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = m.loss_fn(p, {"input_ids": ids}, deterministic=True)
        grads = torch.autograd.grad(loss, list(p.values()))
        results.append((loss, grads))
    (lk, gk), (lp, gp) = results
    torch.cuda.synchronize()
    assert abs(float(lk) - float(lp)) <= 1e-2 * abs(float(lp))
    for name, a, b in zip(params, gk, gp):
        assert _rel_l2(a, b) <= 5e-2, name
    engine, _, _, _ = dst.initialize(
        model=model, model_parameters=params,
        config={"train_micro_batch_size_per_gpu": 2,
                "bf16": {"enabled": True, "master_weights": False},
                "zero_optimization": {"stage": 2},
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 1e-4,
                                         "weight_decay": 0.01}}})
    loss = engine.train_batch(batch={"input_ids": ids[None]})
    assert bool(torch.isfinite(loss))


def test_tied_head_logits_keep_the_fp32_accumulator(dev):
    """The chunked loss's [chunk, vocab] logits tile from bf16 operands
    is fp32 (one GEMM with an fp32 output), equal to the fp32 product of
    the same bf16 values to reduction-order roundoff (1e-4 relative;
    TF32 off), not rounded to bf16 (~4e-3 relative)."""
    g = _gen(dev, 7)
    h = torch.randn((256, 1600), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((1000, 1600), generator=g, device=dev).to(torch.bfloat16)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = h.float() @ w.float().t()
        got = tgpt2._TiedHeadLogits.apply(h, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.dtype == torch.float32
    assert _rel_l2(got, ref) <= 1e-4
