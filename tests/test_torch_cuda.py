"""PyTorch port: the CUDA kernels on the card (kernels K1-fwd, K3-fwd,
K4-fwd) against their plain PyTorch twins, and the engine against the
kernel-driven forward.

Every test here is marked `cuda` and skips where
torch.cuda.is_available() is False. The file imports neither JAX nor
the JAX package, so on a machine with a GPU and no JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: bf16 outputs within one rounding of the twin's fp32 result
(atol = rtol = 1e-2, about one bf16 ulp); fp32 outputs and the
log2-space lse to reduction-order roundoff (atol = rtol = 1e-4).
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
pytestmark = pytest.mark.cuda


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
