"""PyTorch port: the CUDA kernels on the card (kernels K1-fwd, K2-fused,
K2, K3-fwd, K3-bwd, K4-fwd, K4-bwd, K5, K6, K7, K8; K1, K2-fused, K2, K5,
K7-fwd, K7-band, K7-dkv and K7-dq in bf16 and fp16 at head dims 64 and
128 on their Hopper bodies) against their plain
PyTorch twins, the serving engine against the kernel-driven forward,
a training step on the kernels against the plain-torch route, an
async checkpoint's side-stream snapshot against in-place steps, and
BERT pretraining's kernel forms (non-causal bf16 attention at [16, 128,
16, 64], the post-LN LayerNorm at H 1024 with the carry's dtype, the
erf GeLU at N 2048, W 4096) and a small BERT on the kernels against
the plain route; the fp16 forms of K1-K4 at the fp16 paths' shapes
(BERT-large, gpt2-1.5b), with an inf in the input and in the cotangent
reaching every output the twin's reaches, none of their instantiations
spilling, and an fp16 step skipped on the card bit for bit; the fp16
forms of K8, grouped K4, K6 (fp16 out) and K5 (with K2's given-delta
entry on both routes) beside their bf16 forms, with ragged shapes, infs
and overflows, repeated launches bit for bit, and the exact launches of
the fp16 MoE, quantized MoE and ring training steps.

K3-fwd is held at every model width, a ragged one, N 1 / 4 / 127 and
the paths' shapes, in every dtype combination, with unaligned views and
after a kernel that fills shared memory with NaNs, and one call with
bf16 vectors must run exactly one kernel (the device kernels of the
profiled cases are recorded in a process of their own,
tests/torch_profile_cases.py). K2-fused is held at T 64 to 1024 (one to
eight key blocks, a ragged last one), with a given delta, an inf in
dO, two launches bit for bit and the routing boundary at T 1024; K2's
sweeps, which the route keeps past T 1024, are held called directly
at T 128 to 1024 in bf16 and fp16 (a ragged last tile, a given delta,
an inf in dO, two launches bit for bit) and through the route and K5's
backward at T 2048.

Every test here is marked `cuda` and skips where
torch.cuda.is_available() is False. The file imports neither JAX nor
the JAX package, so on a machine with a GPU and no JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: bf16 outputs within one rounding of the twin's fp32 result
(atol = rtol = 1e-2, about one bf16 ulp); fp16 outputs within two fp16
ulps (atol = rtol = 2e-3), fp16 gradients 5e-3 relative L2; fp32 outputs and the
log2-space lse to reduction-order roundoff (atol = rtol = 1e-4).
Gradients are compared by relative L2 error, ||got - ref|| / ||ref||:
fp32 within 1e-5 (reduction order); bf16 within 1e-2 (one rounding of
each output, plus the bf16 rounding of P and dS inside attention, which
may flip by one ulp where the kernel's and the twin's fp32 scores differ
in the last bit).
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo
from deepspeed_tpu_torch.ops import sparse_attention as tsa

# the package exports a function under the module's name
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")

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


@pytest.fixture(scope="session")
def built():
    """Every kernel library built before a test profiles: a build (nvcc
    subprocesses) inside a profiled region left torch.profiler with no
    device kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    from deepspeed_tpu_torch.ops import _build
    _build.build_all()


@pytest.fixture(scope="session")
def device_kernels(built):
    """{case: [[kernel name, launches], ...]}: the device kernels that one
    call of each profiled case runs, recorded by torch.profiler in a
    process of its own (tests/torch_profile_cases.py). Late in a long
    test process the profiler recorded no device activity for most
    profiled regions (34 of 36 at the end of this file's run, the CPU
    events intact), and which ones failed varied with what ran before;
    at the start of a process it recorded every region."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_profile_cases.py")
    run = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


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


BF16, F32 = torch.bfloat16, torch.float32
# K4's cases: (N, W, rows' dtype, output dtype, bias dtype, storage
# offset of the rows in elements). W 100 and 6401 and an offset of one
# element take the scalar accesses; an offset of one row keeps the
# 16-byte vectors on a view
GELU_CASES = {
    "N64-W6400": (64, 6400, BF16, BF16, F32, 0),
    "N4-W6400-decode": (4, 6400, BF16, BF16, F32, 0),
    "N63-W100": (63, 100, BF16, BF16, F32, 0),
    "N33-W6401": (33, 6401, BF16, BF16, F32, 0),
    "N64-W6400-offset-1": (64, 6400, BF16, BF16, F32, 1),
    "N64-W6400-offset-row": (64, 6400, BF16, BF16, F32, 6400),
    "N64-W6400-fp32-out": (64, 6400, BF16, F32, F32, 0),
    "N17-W4096-fp32": (17, 4096, F32, F32, F32, 0),
    "N64-W6400-bf16-bias": (64, 6400, BF16, BF16, BF16, 0),
}


def _rows(n, w, dtype, offset, g, dev, scale=1.0):
    """[n, w] rows, a view `offset` elements into its storage."""
    flat = scale * torch.randn((n * w + offset,), generator=g, device=dev)
    return flat.to(dtype)[offset:].view(n, w)


@pytest.mark.parametrize("case", list(GELU_CASES))
@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_bias_gelu_kernel_matches_twin(dev, approximate, case):
    n, w, x_dt, out_dt, bias_dt, offset = GELU_CASES[case]
    g = _gen(dev, 1)
    x = _rows(n, w, x_dt, offset, g, dev)
    assert x.storage_offset() == offset
    bias = torch.randn((w,), generator=g, device=dev).to(bias_dt)
    before = tfo.fused_bias_gelu.launches
    got, s = tfo.fused_bias_gelu_with_sum(x, bias, approximate=approximate,
                                          out_dtype=out_dt)
    ref, ref_s = tfo._gelu_fwd_math(x, bias, approximate)
    assert got.dtype == out_dt and s.dtype == x_dt
    torch.testing.assert_close(
        got.float(), ref.to(out_dt).float(),
        **(BF16_TOL if out_dt == BF16 else F32_TOL))
    torch.testing.assert_close(
        s.float(), ref_s.to(x_dt).float(),
        **(BF16_TOL if x_dt == BF16 else F32_TOL))
    again = tfo.fused_bias_gelu_with_sum(x, bias, approximate=approximate,
                                         out_dtype=out_dt)
    torch.cuda.synchronize()
    assert tfo.fused_bias_gelu.launches == before + 2
    assert torch.equal(got, again[0]) and torch.equal(s, again[1])


# head dims 192 and 256 run the tile body's wide form
WIDE_CASES = [(torch.bfloat16, True, 192), (torch.bfloat16, False, 256),
              (torch.float32, True, 256), (torch.float32, False, 192)]


@pytest.mark.parametrize("dtype,causal,d", [
    (torch.bfloat16, True, 64), (torch.bfloat16, False, 64),
    (torch.bfloat16, True, 128), (torch.float32, True, 64),
    (torch.float32, False, 128)] + WIDE_CASES)
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
    for d in (80, 320):                      # no kernel head dim
        q = torch.zeros((1, 128, 2, d), device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            tfa.flash_attention(q, q, q)
    # fp16 has its forms since ROADMAP Queue 1 item 4; fp64 none
    q = torch.zeros((1, 128, 2, 64), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q)
    y = torch.zeros((4, 8), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        tfo.fused_bias_gelu(y, torch.zeros(8, device=dev))
    y = torch.zeros((8, 4), device=dev).t()
    with pytest.raises(ValueError):          # not contiguous
        tfo.fused_bias_gelu(y, torch.zeros(8, device=dev))
    y = torch.zeros((4, 8), device=dev)
    with pytest.raises(TypeError):           # a bias K4 does not read
        tfo.fused_bias_gelu(y, torch.zeros(8, device=dev,
                                           dtype=torch.float16))


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
    (torch.float32, False, 128)] + WIDE_CASES)
def test_flash_backward_kernel_matches_twin(dev, dtype, causal, d):
    """The backward on the forward kernel's own (out, lse), with an lse
    cotangent, q/k/v as qkv column slices, against the twin of its route
    (T 256: K2-fused in bf16 at head dims 64 and 128, K2's sweeps in fp32
    and at the wide head dims); one launch on the route's counter."""
    g = _gen(dev, 3)
    b, t, h = 2, 256, 3
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    lse = lse[..., 0].contiguous()
    dout = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    dlse = torch.randn((b, h, t), generator=g, device=dev)
    counter = _k2_counter(q)
    before = counter.launches
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, dlse,
                                       d ** -0.5, causal)
    ref = tfa._flash_bwd_twin(q, k, v, out, lse, dout, dlse, d ** -0.5,
                              causal)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for name, x, y in zip("qkv", got, ref):
        assert x.dtype == dtype and x.shape == (b, t, h, d)
        assert _rel_l2(x, y) <= GRAD_TOL[dtype], name


def _k2_counter(q):
    """The function whose `launches` counts the backward q routes to:
    K2-fused's wrapper, or `flash_attention_backward` (K2's sweeps)."""
    return tfa._flash_bwd_fused_launch if tfa._fused_route(q) else \
        tfa.flash_attention_backward


def _merge_inputs(dev, dtype, d, causal, seed, b=2, t=256, h=3):
    """q/k/v (qkv column slices) and a prior partial from K1 over a
    disjoint key block, its first rows marked empty (-1e30, out 0)."""
    g = _gen(dev, seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    k2, v2 = (torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
              for _ in range(2))
    prev, prev_lse = tfa.flash_attention_with_lse(q, k2, v2, causal=False)
    prev, prev_lse = prev.float().clone(), prev_lse.clone()
    prev[:, :7] = 0.0
    prev_lse[:, :, :7] = tfa.NEG_INF
    return q, k, v, prev, prev_lse


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_merge_kernel_matches_twin(dev, dtype, causal, d):
    """K5 against _flash_merge_plain on the same inputs: out, merged lse
    and lse_n; then the backward (the given-delta entry of the route's
    kernel: K2-fused in bf16 at head dims 64 and 128, K2's sweeps
    otherwise) through autograd against the same function on CPU copies
    (the twins)."""
    q, k, v, prev, prev_lse = _merge_inputs(dev, dtype, d, causal, seed=d)
    counter = _k2_counter(q)
    before = (tfa.flash_attention_merge.launches, counter.launches)
    out, lse, lse_n = tfa._flash_merge_launch(q, k, v, prev,
                                              prev_lse[..., 0], d ** -0.5,
                                              causal)
    ref, ref_lse, ref_lse_n = tfa._flash_merge_plain(
        q, k, v, prev, prev_lse[..., 0], d ** -0.5, causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out, ref, **tol)
    torch.testing.assert_close(lse, ref_lse, **F32_TOL)
    torch.testing.assert_close(lse_n, ref_lse_n, **F32_TOL)
    # the empty carry rows hold the block's own partial
    torch.testing.assert_close(lse[:, :, :7], lse_n[:, :, :7], **F32_TOL)

    leaves = [x.detach().clone().requires_grad_(True)
              for x in (q, k, v, prev, prev_lse)]
    cpu = [x.detach().cpu().requires_grad_(True) for x in leaves]
    gen = _gen(dev, 99)
    g_out = torch.randn(q.shape, generator=gen, device=dev)
    g_lse = torch.randn(prev_lse.shape, generator=gen, device=dev)
    o, l = tfa.flash_attention_merge(*leaves, causal=causal)
    got = torch.autograd.grad((o, l), leaves, (g_out, g_lse))
    o_c, l_c = tfa.flash_attention_merge(*cpu, causal=causal)
    want = torch.autograd.grad((o_c, l_c), cpu, (g_out.cpu(), g_lse.cpu()))
    torch.cuda.synchronize()
    assert (tfa.flash_attention_merge.launches,
            counter.launches) == (before[0] + 2, before[1] + 1)
    for name, x, y in zip(("dq", "dk", "dv", "dprev", "dprev_lse"), got,
                          want):
        assert torch.isfinite(x).all(), name
        assert _rel_l2(x, y.to(dev)) <= GRAD_TOL[dtype], name


def test_merge_kernel_empty_carry_is_k1(dev):
    """The ring's first step: against prev_lse -1e30 and prev_out 0, K5
    gives K1's out and lse to fp32 rounding."""
    g = _gen(dev, 5)
    q, k, v = (torch.randn((1, 512, 4, 64), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    ref, ref_lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    out, lse = tfa.flash_attention_merge(
        q, k, v, torch.zeros(q.shape, device=dev),
        torch.full((1, 4, 512, 1), tfa.NEG_INF, device=dev), causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.float(), **BF16_TOL)
    torch.testing.assert_close(lse, ref_lse, **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_given_delta_backward_matches_twin(dev, dtype):
    """The given-delta entry (no out) of the route's kernel (K2-fused in
    bf16 and fp16, K2's sweeps in fp32) against its twin with the same
    delta; the caller's delta is left as it was."""
    g = _gen(dev, 8)
    b, t, h, d = 2, 256, 3, 64
    q, k, v, dout = (torch.randn((b, t, h, d), generator=g, device=dev)
                     .to(dtype) for _ in range(4))
    _, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    lse = lse[..., 0].contiguous()
    delta = torch.randn((b, h, t), generator=g, device=dev)
    dlse = torch.randn((b, h, t), generator=g, device=dev)
    keep = delta.clone()
    got = tfa.flash_attention_backward(q, k, v, None, lse, dout, dlse,
                                       d ** -0.5, True, delta=delta)
    ref = tfa._flash_bwd_twin(q, k, v, None, lse, dout, dlse, d ** -0.5,
                              True, delta=delta)
    torch.cuda.synchronize()
    assert torch.equal(delta, keep)
    for name, x, y in zip("qkv", got, ref):
        assert _rel_l2(x, y) <= GRAD_TOL.get(dtype, 5e-3), name


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_hopper_kernels_at_ragged_t_match_twins(dev, causal, d):
    """The Hopper bodies (bf16, head dims 64 and 128) at T = 320, where
    the last 128-row tile runs past T (TMA reads zeros there): K1,
    K2-fused with and without an lse cotangent, and K5 with a real
    carry, on qkv
    column views, against their twins; K5 with an empty carry gives
    K1's out and lse."""
    g = _gen(dev, 11 + d)
    b, t, h = 2, 320, 3
    bf16 = torch.bfloat16
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(bf16)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    sm = d ** -0.5
    out, lse = tfa._flash_fwd_launch(q, k, v, sm, causal)
    ref, ref_lse = tfa._flash_fwd_plain(q, k, v, sm, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    torch.testing.assert_close(lse, ref_lse, **F32_TOL)

    dout = torch.randn((b, t, h, d), generator=g, device=dev).to(bf16)
    dlse = torch.randn((b, h, t), generator=g, device=dev)
    for dl in (dlse, None):
        got = tfa.flash_attention_backward(q, k, v, out, lse, dout, dl, sm,
                                           causal)
        want = tfa._flash_bwd_twin(q, k, v, out, lse, dout, dl, sm, causal)
        torch.cuda.synchronize()
        for name, x, y in zip("qkv", got, want):
            assert _rel_l2(x, y) <= GRAD_TOL[bf16], (name, dl is None)

    k2, v2 = (torch.randn((b, t, h, d), generator=g, device=dev).to(bf16)
              for _ in range(2))
    prev, prev_lse = tfa._flash_fwd_launch(q, k2, v2, sm, False)
    prev = prev.float()
    prev[:, :7] = 0.0
    prev_lse[:, :, :7] = tfa.NEG_INF
    got = tfa._flash_merge_launch(q, k, v, prev, prev_lse, sm, causal)
    want = tfa._flash_merge_plain(q, k, v, prev, prev_lse, sm, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **BF16_TOL)
    torch.testing.assert_close(got[1], want[1], **F32_TOL)
    torch.testing.assert_close(got[2], want[2], **F32_TOL)
    empty = tfa._flash_merge_launch(
        q, k, v, torch.zeros(q.shape, device=dev),
        torch.full((b, h, t), tfa.NEG_INF, device=dev), sm, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(empty[0], out.float(), **BF16_TOL)
    torch.testing.assert_close(empty[1], lse, **F32_TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_hopper_backward_repeats_bit_for_bit(dev, d):
    """The backward at T 512 (K2-fused: every dQ row summed in the
    plan's fixed order, no float atomics) repeats bit for bit: a second
    launch equals the first, for the full entry and the given-delta
    entry. K2's sweeps' repeat is `test_sweeps_backward_matches_plain`'s
    and `test_sweeps_given_delta_matches_plain`'s."""
    g = _gen(dev, 21 + d)
    b, t, h = 2, 512, 8
    q, k, v, dout = (torch.randn((b, t, h, d), generator=g, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    out, lse = tfa._flash_fwd_launch(q, k, v, d ** -0.5, True)
    dlse, delta = (torch.randn((b, h, t), generator=g, device=dev)
                   for _ in range(2))
    for kw in (dict(out=out), dict(out=None, delta=delta)):
        runs = [tfa.flash_attention_backward(
            q, k, v, kw["out"], lse, dout, dlse, d ** -0.5, True,
            delta=kw.get("delta")) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_more_than_65535_heads_match_twin(dev):
    """B*H = 65550 at T = 64: the Hopper body's 1-D grid launches it
    (grid.y, which carries B*H in the WMMA bodies, stops at 65535), and
    K1 matches its twin."""
    g = _gen(dev, 31)
    b, t, h, d = 32775, 64, 2, 64
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    before = tfa.flash_attention_with_lse.launches
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    ref, ref_lse = tfa._flash_fwd_plain(q, k, v, d ** -0.5, True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_with_lse.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    torch.testing.assert_close(lse[..., 0], ref_lse, **F32_TOL)


def test_gpt2_head_dim_256_forward_matches_cpu(dev):
    """A causal GPT-2 with head dim 256 (n_embd 1024, n_head 4): the
    CUDA forward (K1's wide form, K3, K4) against the same weights on
    the CPU (the twins, unfused), fp32."""
    cfg = tgpt2.gpt2_config("gpt2-350m", n_layer=2, n_head=4,
                            vocab_size=512, n_positions=256,
                            dtype=torch.float32, dropout=0.0)
    assert cfg.head_dim == 256
    model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
    params = model.init(seed=4)
    cpu = tgpt2.GPT2ForCausalLM(cfg, device="cpu")
    cpu_params = {n: p.cpu() for n, p in params.items()}
    ids = np.random.RandomState(4).randint(0, 512, (2, 256))
    before = tfa.flash_attention_with_lse.launches
    got = model.apply(params, ids).float()
    torch.cuda.synchronize()
    assert tfa.flash_attention_with_lse.launches == before + 2
    want = cpu.apply(cpu_params, ids)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)


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


# K3-bwd's edges: (N, H, s dtype, dout dtype, gamma dtype, with dsum,
# storage offset of dout in elements)
LN_BWD_EDGES = {
    "N1-H1600-bf16-gamma": (1, 1600, BF16, BF16, BF16, True, 0),
    "N4-H1600-fp32-gamma": (4, 1600, BF16, BF16, F32, True, 0),
    "N301-H1601-odd": (301, 1601, BF16, BF16, F32, True, 0),
    "N300-H1600-dout-offset-1": (300, 1600, BF16, BF16, BF16, True, 1),
    "N300-H1600-ln_f-fp32-dout": (300, 1600, BF16, F32, BF16, False, 0),
    "N37-H1024-bf16-gamma": (37, 1024, BF16, BF16, BF16, True, 0),
    "N33-H100-fp32": (33, 100, F32, F32, F32, True, 0),
    "N7-H2560-ten-warps-a-row": (7, 2560, BF16, BF16, BF16, True, 0),
    "N11-H5120-four-vectors-a-lane": (11, 5120, BF16, BF16, BF16, True, 0),
    "N5-H5121-four-vectors-scalar": (5, 5121, BF16, BF16, F32, True, 0),
    "N9-H4096-fp32-four-vectors": (9, 4096, F32, F32, F32, True, 0),
    "N9-H4100-fp32-four-vectors-scalar": (9, 4100, F32, BF16, F32, True, 0),
}


def _ln_bwd_edge_inputs(dev, case):
    """(s, gamma, dout, dsum) of LN_BWD_EDGES[case]."""
    n, h, s_dt, d_dt, g_dt, with_dsum, offset = LN_BWD_EDGES[case]
    g = _gen(dev, 40)
    s = (2.0 * torch.randn((n, h), generator=g, device=dev)).to(s_dt)
    gamma = (1.0 + 0.1 * torch.randn((h,), generator=g, device=dev)).to(g_dt)
    dout = torch.randn((n * h + offset,), generator=g, device=dev).to(d_dt)
    dout = dout[offset:].view(n, h)
    dsum = torch.randn((n, h), generator=g, device=dev).to(s_dt) \
        if with_dsum else None
    return s, gamma, dout, dsum


@pytest.mark.parametrize("case", list(LN_BWD_EDGES))
def test_layernorm_backward_kernel_edges(dev, device_kernels, case):
    """K3-bwd's layout at its edges against `_ln_bwd_math`: gamma in fp32
    and bf16 (read in its own dtype: the launch is the only kernel the
    wrapper runs beside the counters' zero fill, no cast), an odd H
    (scalar accesses), a view one element into its storage (unaligned:
    scalar accesses), N = 1, the ln_f form, rows of 10 warps, four
    vectors a lane (16-byte and scalar accesses; fp32 rows there fetch
    the next row after this one's math); one launch per call (the kernels
    of one profiled call, `device_kernels`), two launches
    bit-identical."""
    n, h, s_dt = LN_BWD_EDGES[case][:3]
    s, gamma, dout, dsum = _ln_bwd_edge_inputs(dev, case)
    before = tfo.fused_bias_residual_layernorm_backward.launches
    got = tfo.fused_bias_residual_layernorm_backward(s, gamma, dout, dsum)
    kernels = [k for k, _ in device_kernels[case]]
    assert kernels, "the profiler recorded no device kernels"
    assert sum("ln_bwd_kernel" in k for k in kernels) == 1, kernels
    assert not any("copy" in k for k in kernels), kernels
    again = tfo.fused_bias_residual_layernorm_backward(s, gamma, dout, dsum)
    torch.cuda.synchronize()
    assert tfo.fused_bias_residual_layernorm_backward.launches == before + 2
    ds, dg_rows, db_rows = tfo._ln_bwd_math(s, gamma, dout, dsum, 1e-5)
    ref = (ds.to(s_dt), ds.sum(0), dg_rows.sum(0), db_rows.sum(0))
    assert got[0].dtype == s_dt and got[0].shape == (n, h)
    for x, y in zip(got, ref):
        assert _rel_l2(x, y) <= GRAD_TOL[s_dt]
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# A kernel that fills the shared memory of as many CTAs as the card
# holds at once with 0xFF bytes (a NaN as fp32), so that a later kernel
# reading shared memory it never wrote sees NaNs there
POISON_SMEM_CU = r"""
#include <cuda_runtime.h>
__global__ void poison_kernel(int words) {
  extern __shared__ unsigned int smem[];
  volatile unsigned int* p = smem;
  for (int i = threadIdx.x; i < words; i += blockDim.x) p[i] = 0xffffffffu;
}
extern "C" int poison_smem(int device, void* stream) {
  int bytes = 0, sms = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaFuncSetAttribute(poison_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  poison_kernel<<<4 * sms, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(
      bytes / 4);
  return static_cast<int>(cudaGetLastError());
}
"""


@pytest.fixture(scope="module")
def poison_smem(tmp_path_factory):
    """poison_smem(): launch the 0xFF fill on the current stream."""
    import ctypes
    import subprocess
    from deepspeed_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    d = tmp_path_factory.mktemp("poison_smem")
    src, lib = d / "poison_smem.cu", d / "poison_smem.so"
    src.write_text(POISON_SMEM_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).poison_smem
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]

    def poison():
        dev = torch.cuda.current_device()
        _build.check(fn(dev, torch.cuda.current_stream().cuda_stream),
                     "poison_smem")
    return poison


@pytest.mark.parametrize("h", [1600, 1601, 100])
def test_layernorm_backward_reads_no_stale_shared_memory(dev, poison_smem,
                                                         h):
    """K3-bwd right after a kernel that leaves every SM's shared memory
    full of NaNs: lanes past the row's end (24 of 224 at H 1600 and
    23 at H 1601, 19 of 32 at H 100) own no columns and must read none
    of gamma's shared copy, whose words past the row are the partial
    row's, unwritten until after the rows. dx and the sums stay finite
    and match `_ln_bwd_math`."""
    g = _gen(dev, 41)
    n = 300
    s = (2.0 * torch.randn((n, h), generator=g, device=dev)).to(BF16)
    gamma = (1.0 + 0.1 * torch.randn((h,), generator=g, device=dev)).to(BF16)
    dout, dsum = (torch.randn((n, h), generator=g, device=dev).to(BF16)
                  for _ in range(2))
    poison_smem()
    got = tfo.fused_bias_residual_layernorm_backward(s, gamma, dout, dsum)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in got)
    ds, dg_rows, db_rows = tfo._ln_bwd_math(s, gamma, dout, dsum, 1e-5)
    ref = (ds.to(BF16), ds.sum(0), dg_rows.sum(0), db_rows.sum(0))
    for x, y in zip(got, ref):
        assert _rel_l2(x, y) <= GRAD_TOL[BF16]


def test_layernorm_backward_refuses_a_dsum_in_another_dtype(dev):
    """The kernel reads dsum in s's dtype; another dtype raises rather
    than being cast."""
    s = torch.zeros((4, 64), device=dev, dtype=BF16)
    with pytest.raises(TypeError, match="dsum"):
        tfo.fused_bias_residual_layernorm_backward(
            s, torch.ones(64, device=dev), s, s.float())


# K3-fwd on its Hopper layout (ops/csrc/fused_ln_fwd.cu, plan
# `ln_fwd_plan`): the repo's models' widths and a ragged one
LN_FWD_WIDTHS = [768, 1024, 1536, 1600, 2560, 4096, 5120, 1602]


def _ln_fwd_case(dev, n, h, y_dt, r_dt, v_dt, seed, y_off=0, r_off=0):
    """y and the residual [n, h] (views y_off / r_off elements into their
    storage), bias, gamma, beta [h] in v_dt."""
    g = _gen(dev, seed)
    y = _rows(n, h, y_dt, y_off, g, dev)
    res = _rows(n, h, r_dt, r_off, g, dev)
    bias, beta = ((0.1 * torch.randn((h,), generator=g, device=dev))
                  .to(v_dt) for _ in range(2))
    gamma = (1.0 + 0.1 * torch.randn((h,), generator=g, device=dev)) \
        .to(v_dt)
    return y, bias, res, gamma, beta


def _check_ln_fwd(args, out_dt, sum_dt, eps=1e-5):
    """One call against `_ln_fwd_math` (fp32 outputs within F32_TOL,
    reduction order; bf16 ones within BF16_TOL, one rounding), one
    launch, and a second call equal bit for bit."""
    want_sum = sum_dt is not None
    before = tfo.fused_bias_residual_layernorm.launches
    got = tfo._ln_forward(*args, eps, out_dt, sum_dt or F32, want_sum)
    again = tfo._ln_forward(*args, eps, out_dt, sum_dt or F32, want_sum)
    torch.cuda.synchronize()
    assert tfo.fused_bias_residual_layernorm.launches == before + 2
    ref_out, ref_s = tfo._ln_fwd_math(*args, eps)
    out, s = got
    assert out.dtype == out_dt and out.shape == args[0].shape
    torch.testing.assert_close(out.float(), ref_out.to(out_dt).float(),
                               **(BF16_TOL if out_dt == BF16 else F32_TOL))
    if want_sum:
        assert s.dtype == sum_dt
        torch.testing.assert_close(
            s.float(), ref_s.to(sum_dt).float(),
            **(BF16_TOL if sum_dt == BF16 else F32_TOL))
        assert torch.equal(s, again[1])
    else:
        assert s is None and again[1] is None
    assert torch.equal(out, again[0])


@pytest.mark.parametrize("n", [1, 4, 127])
@pytest.mark.parametrize("h", LN_FWD_WIDTHS)
def test_layernorm_forward_kernel_at_every_width(dev, h, n):
    """K3-fwd at each width (row groups of 3 to 20 warps; 1602 ragged:
    scalar accesses, the last lane 2 columns) and at N 1, 4 (decode) and
    127 (one row a CTA), bf16 rows, bf16 vectors, bf16 out and sum."""
    args = _ln_fwd_case(dev, n, h, BF16, BF16, BF16, seed=50)
    _check_ln_fwd(args, BF16, BF16)


@pytest.mark.parametrize("v_dt", [F32, BF16], ids=["fp32_vectors",
                                                   "bf16_vectors"])
@pytest.mark.parametrize("sum_dt", [F32, BF16, None],
                         ids=["sum_fp32", "sum_bf16", "ln_f"])
@pytest.mark.parametrize("out_dt", [F32, BF16], ids=["out_fp32",
                                                     "out_bf16"])
@pytest.mark.parametrize("r_dt", [F32, BF16], ids=["res_fp32", "res_bf16"])
@pytest.mark.parametrize("y_dt", [F32, BF16], ids=["y_fp32", "y_bf16"])
def test_layernorm_forward_kernel_dtypes(dev, y_dt, r_dt, out_dt, sum_dt,
                                         v_dt):
    """Every dtype combination of y, residual, out and sum (16
    instantiations, 16-byte accesses at H 1600), and without the sum (the
    ln_f form), vectors in fp32 and in bf16 (each read in its own
    dtype)."""
    args = _ln_fwd_case(dev, 37, 1600, y_dt, r_dt, v_dt, seed=51)
    _check_ln_fwd(args, out_dt, sum_dt)


# K3-fwd's edges and the paths' shapes: (N, H, y, residual, vectors, out,
# sum dtype or None, y's and the residual's storage offsets)
LN_FWD_EDGES = {
    "N4096-H1600-serving": (4096, 1600, BF16, BF16, F32, BF16, BF16, 0, 0),
    "N11264-H1600-training": (11264, 1600, BF16, BF16, BF16, BF16, BF16, 0,
                              0),
    "N11264-H1600-ln_f": (11264, 1600, BF16, BF16, BF16, F32, None, 0, 0),
    "N16384-H1024-moe": (16384, 1024, BF16, BF16, F32, BF16, BF16, 0, 0),
    "N2048-H1024-post-ln-bf16-residual": (2048, 1024, BF16, BF16, BF16, F32,
                                          BF16, 0, 0),
    "N2048-H1024-post-ln-fp32-residual": (2048, 1024, BF16, F32, BF16, F32,
                                          F32, 0, 0),
    "N300-H1600-y-offset-1": (300, 1600, BF16, BF16, BF16, BF16, BF16, 1, 0),
    "N300-H1600-residual-offset-1": (300, 1600, BF16, F32, BF16, F32, F32,
                                     0, 1),
    "N300-H1600-offset-row": (300, 1600, BF16, BF16, BF16, BF16, BF16, 1600,
                              1600),
    "N301-H1602-ragged-offset-1": (301, 1602, BF16, BF16, BF16, BF16, BF16,
                                   1, 0),
    "N33-H100-fp32": (33, 100, F32, F32, F32, F32, F32, 0, 0),
}


@pytest.mark.parametrize("case", list(LN_FWD_EDGES))
def test_layernorm_forward_kernel_edges(dev, case):
    """K3-fwd at the paths' shapes (serving, training and its ln_f form,
    MoE, BERT's post-LN forms) and its edges: a view one element into its
    storage (unaligned: scalar accesses), one row into it (aligned: 16-byte
    accesses on a view), a ragged width with an offset, fp32 throughout."""
    n, h, y_dt, r_dt, v_dt, out_dt, sum_dt, y_off, r_off = \
        LN_FWD_EDGES[case]
    args = _ln_fwd_case(dev, n, h, y_dt, r_dt, v_dt, seed=52, y_off=y_off,
                        r_off=r_off)
    assert args[0].storage_offset() == y_off
    assert args[2].storage_offset() == r_off
    eps = 1e-12 if "post-ln" in case else 1e-5
    _check_ln_fwd(args, out_dt, sum_dt, eps)


def test_layernorm_forward_kernel_with_unaligned_vectors(dev):
    """bias, gamma and beta one element into their storage: the plan
    takes scalar accesses for every input (vec 1), rows included, and the
    result matches `_ln_fwd_math`."""
    y, bias, res, gamma, beta = _ln_fwd_case(dev, 300, 1600, BF16, BF16,
                                             BF16, seed=55)
    bias, gamma, beta = (torch.cat([v.new_zeros(1), v])[1:]
                         for v in (bias, gamma, beta))
    assert bias.data_ptr() % 16 != 0
    assert tfo.ln_fwd_plan(300, 1600, tfo._sm_count(0),
                           tfo._aligned(y, res, bias, gamma, beta)).vec == 1
    _check_ln_fwd((y, bias, res, gamma, beta), BF16, BF16)


def _ln_fwd_bf16_vectors_inputs(dev):
    return _ln_fwd_case(dev, 300, 1600, BF16, BF16, BF16, seed=53)


def test_layernorm_forward_with_bf16_vectors_is_one_kernel(dev,
                                                          device_kernels):
    """One fused_bias_residual_layernorm call with bf16 bias, gamma and
    beta (the training paths' parameters) runs exactly one kernel on the
    card (`device_kernels`' recording of one call): no cast or copy of
    the vectors, nothing but K3-fwd."""
    kernels = [tuple(k) for k in device_kernels["ln_fwd_bf16_vectors"]]
    assert kernels, "the profiler recorded no device kernels"
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "ln_fwd_kernel" in kernels[0][0], kernels


@pytest.mark.parametrize("h", [1600, 1602, 100])
def test_layernorm_forward_reads_no_stale_shared_memory(dev, poison_smem,
                                                        h):
    """K3-fwd right after a kernel that leaves every SM's shared memory
    full of NaNs: each lane reads back only the words of gamma's and
    beta's shared copy it wrote (lanes past the row's end, 24 of 224 at
    H 1600, 23 at 1602, 19 of 32 at H 100, write and add zeros), and each
    row's exchange only the slots its row group's warps wrote for that
    row, so the outputs stay finite and match `_ln_fwd_math`."""
    args = _ln_fwd_case(dev, 300, h, BF16, BF16, BF16, seed=54)
    poison_smem()
    out, s = tfo.fused_bias_residual_layernorm(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    ref_out, ref_s = tfo._ln_fwd_math(*args, 1e-5)
    torch.testing.assert_close(out.float(), ref_out.to(BF16).float(),
                               **BF16_TOL)
    torch.testing.assert_close(s.float(), ref_s.to(BF16).float(),
                               **BF16_TOL)


def test_layernorm_forward_raises_on_what_it_does_not_take(dev):
    """Vectors it does not read (fp16, strided, on another device, of
    another width) and rows past its widest (H 5121) raise; nothing casts
    or falls back to the twin."""
    y = torch.zeros((4, 64), device=dev, dtype=BF16)
    ones = torch.ones(64, device=dev)
    with pytest.raises(TypeError, match="gamma"):
        tfo.fused_bias_residual_layernorm(y, ones, y, ones.half(), ones)
    with pytest.raises(ValueError, match="contiguous"):
        tfo.fused_bias_residual_layernorm(
            y, torch.ones(128, device=dev)[::2], y, ones, ones)
    with pytest.raises(ValueError):
        tfo.fused_bias_residual_layernorm(y, ones.cpu(), y, ones, ones)
    with pytest.raises(ValueError):
        tfo.fused_bias_residual_layernorm(y, ones[:32], y, ones, ones)
    wide = torch.zeros((2, 5121), device=dev, dtype=BF16)
    v = torch.ones(5121, device=dev)
    with pytest.raises(ValueError, match="widest row"):
        tfo.fused_bias_residual_layernorm(wide, v, wide, v, v)


# K4-bwd's cases: (N, W, storage offset of the cotangent in elements,
# dout's and dx's dtype where not s's)
GELU_BWD_CASES = {
    "N300-W6400": (300, 6400, 0, None),
    "N4-W6400-decode": (4, 6400, 0, None),
    "N63-W100": (63, 100, 0, None),
    "N33-W6401": (33, 6401, 0, None),
    "N300-W6400-offset-1": (300, 6400, 1, None),
    "N301-W6400-fp32-dout-dx": (301, 6400, 0, F32),
}


@pytest.mark.parametrize("case", list(GELU_BWD_CASES))
@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_backward_kernel_matches_twin(dev, approximate, dtype, case):
    n, w, offset, other_dt = GELU_BWD_CASES[case]
    g = _gen(dev, 5)
    s = (2.0 * torch.randn((n, w), generator=g, device=dev)).to(dtype)
    dout = _rows(n, w, other_dt or dtype, offset, g, dev)
    dx_dt = other_dt or dtype
    before = tfo.fused_bias_gelu_backward.launches
    dx, dbias = tfo.fused_bias_gelu_backward(
        s, dout, approximate=approximate, dx_dtype=dx_dt)
    ref = tfo._gelu_bwd_math(s, dout, approximate)
    again = tfo.fused_bias_gelu_backward(
        s, dout, approximate=approximate, dx_dtype=dx_dt)
    torch.cuda.synchronize()
    assert tfo.fused_bias_gelu_backward.launches == before + 2
    assert dx.dtype == dx_dt
    assert _rel_l2(dx, ref.to(dx_dt)) <= GRAD_TOL[dx_dt]
    assert _rel_l2(dbias, ref.sum(0)) <= GRAD_TOL[torch.float32] * 10
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


@pytest.mark.parametrize("gated", [True, False],
                         ids=["steps-before-the-copy", "steps-during-it"])
def test_async_snapshot_is_not_torn_by_in_place_steps(dev, tmp_path, gated):
    """An async save copies every leaf on the training stream before it
    returns; the writer thread fetches those copies to pinned host
    memory on its own stream. Steps that update the parameters and
    moments in place right after the call, before the writer's copies
    start (gated) or while they run, leave the checkpoint equal to the
    state at the call, bit for bit, and an engine resumed from it
    repeats those steps' losses bit for bit (bf16 without master
    weights: the stochastic-rounding stream comes back too)."""
    import threading
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io
    cfg = tgpt2.gpt2_config("gpt2-125m", n_layer=2, vocab_size=1024,
                            n_positions=256, dropout=0.0,
                            dtype=torch.bfloat16,
                            param_dtype=torch.bfloat16)
    config = {"train_micro_batch_size_per_gpu": 2,
              "bf16": {"enabled": True, "master_weights": False},
              "zero_optimization": {"stage": 2},
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.01}}}

    def engine(seed):
        model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
        return dst.initialize(model=model, model_parameters=model.init(seed),
                              config=config)[0]

    ids = torch.randint(0, 1024, (6, 1, 2, 256), generator=_gen(dev, 8),
                        device=dev)
    a = engine(0)
    for x in ids[:2]:
        a.train_batch(batch={"input_ids": x})
    ref = [p.detach().cpu().clone() for p in a.params.values()]
    ref_mu = [m.cpu().clone() for m in a.state.opt_state.mu]
    release = threading.Event()
    fetch = a._fetch

    def held(trees, event):
        if gated:
            assert release.wait(timeout=60)
        return fetch(trees, event)

    a._fetch = held
    assert a.save_checkpoint(str(tmp_path), tag="t") is True
    losses = [a.train_batch(batch={"input_ids": x}) for x in ids[2:]]
    release.set()
    a.wait_for_checkpoint()
    assert not all(torch.equal(p.cpu(), r)
                   for p, r in zip(a.params.values(), ref))
    b = engine(1)
    b.load_checkpoint(str(tmp_path))
    assert all(torch.equal(p.cpu(), r) for p, r in zip(b.params.values(),
                                                        ref))
    assert all(torch.equal(m.cpu(), r)
               for m, r in zip(b.state.opt_state.mu, ref_mu))
    resumed = [b.train_batch(batch={"input_ids": x}) for x in ids[2:]]
    assert all(torch.equal(x, y) for x, y in zip(resumed, losses))
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "t"


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


# ----------------------------------------------------------------------
# MoE: kernel K8 (dispatch and combine gathers), the grouped K4
# ----------------------------------------------------------------------
def _routing(dev, n, e, k, cf, seed):
    from deepspeed_tpu_torch.moe import (router_capacity, routing_slots,
                                         top_k_gating_indexed)
    g = _gen(dev, seed)
    logits = torch.randn((n, e), generator=g, device=dev)
    cap = router_capacity(n, e, k, cf)
    routing, stats = top_k_gating_indexed(logits, k, cap)
    src, dest = routing_slots(routing, e, cap)
    return routing, stats, src, dest, cap


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h", [1024, 1600, 100])
@pytest.mark.parametrize("k,cf", [(2, 1.25), (2, 0.5), (1, 1.25)])
def test_moe_dispatch_combine_kernels_match_twins(dev, dtype, h, k, cf):
    """K8 against its twins: dispatch exactly, combine within one bf16
    ulp (bf16) or 1e-6 (fp32), with empty slots (cf 1.25) and dropped
    assignments (cf 0.5, every slot full); H 1600 is no multiple of 128, H 100 (200
    bytes in bf16) takes the scalar path."""
    tfd = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")
    n, e = 512, 8
    routing, stats, src, dest, cap = _routing(dev, n, e, k, cf, 8)
    if cf < 1:
        assert float(stats[-2]) > 0               # drops present
    else:
        assert bool((src == n).any())             # empty slots present
    g = _gen(dev, 9)
    x = torch.randn((n, h), generator=g, device=dev).to(dtype)
    before = (tfd.gather_rows.launches, tfd.combine_rows.launches)
    xe = tfd.gather_rows(x, src)
    assert torch.equal(xe, tfd._gather_rows_plain(x, src))
    ye = torch.randn((e * cap, h), generator=g, device=dev).to(dtype)
    cw = (routing["keep"] * routing["w"]).float()
    y = tfd.combine_rows(ye, dest, cw)
    ref = tfd._combine_rows_plain(ye, dest, cw)
    torch.cuda.synchronize()
    assert (tfd.gather_rows.launches, tfd.combine_rows.launches) == \
        (before[0] + 1, before[1] + 1)
    assert y.dtype == dtype
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y.float(), ref.float(), atol=1e-30,
                                   rtol=2 ** -8)
    else:
        torch.testing.assert_close(y, ref, atol=1e-6, rtol=1e-6)
    sw = torch.rand((e * cap,), generator=g, device=dev)
    assert torch.equal(tfd.gather_rows(x, src, sw),
                       tfd._gather_rows_plain(x, src, sw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_fused_autograd_matches_einsum_route(dev, dtype):
    """Forward and backward of fused_dispatch/fused_combine (K8 in both
    directions) against the one-hot einsum pair on the same routing:
    gradients to the tokens and to the router weights."""
    tfd = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")
    from deepspeed_tpu_torch.moe.router import (_dense_masks, _gating_core,
                                                _index_routing,
                                                router_capacity)
    n, e, k, h = 384, 8, 2, 256
    g = _gen(dev, 10)
    x0 = torch.randn((n, h), generator=g, device=dev).to(dtype)
    wg0 = 0.1 * torch.randn((h, e), generator=g, device=dev)
    scale = 1.0 + 0.25 * torch.randn((e, 1, 1), generator=g, device=dev)
    r = torch.randn((n, h), generator=g, device=dev)
    cap = router_capacity(n, e, k, 0.75)
    outs = []
    for fused in (True, False):
        x = x0.clone().requires_grad_(True)
        wg = wg0.clone().requires_grad_(True)
        core = _gating_core(x.float() @ wg, k, cap, None, 0.0)
        if fused:
            routing = _index_routing(*core[:4])
            src, dest = tfd.routing_slots(routing, e, cap)
            xe = tfd.fused_dispatch(x, src, dest, routing["keep"])
            ye = (xe.reshape(e, cap, h).float() * scale).to(dtype)
            y = tfd.fused_combine(ye.reshape(e * cap, h), dest,
                                  routing["keep"], routing["w"])
        else:
            dispatch, combine = _dense_masks(cap, core[0], core[2], core[3])
            xe = torch.einsum("nec,nh->ech", dispatch, x.float())
            y = torch.einsum("nec,ech->nh", combine, xe * scale)
        loss = (y.float() * r).sum()
        outs.append((y.float(), *torch.autograd.grad(loss, (x, wg))))
    tol = GRAD_TOL[dtype] if dtype == torch.float32 else 2e-2
    for a, b in zip(outs[0], outs[1]):
        assert _rel_l2(a, b) <= tol


@pytest.mark.parametrize("rows,w,bias_dt", [(160, 4096, F32),
                                             (37, 4096, F32),
                                             (37, 100, F32),
                                             (160, 4096, BF16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_gelu_kernels_match_twins(dev, dtype, rows, w, bias_dt):
    """K4 forward and backward with a grouped bias [G, W] (the experts'
    form) against the twins, and G = 1 through the grouped entry point
    equal bit for bit to the dense form. 37 rows a group is no multiple
    of the plan's row runs (so a run ends at its group's end); W 100
    takes the scalar accesses; a bf16 bias is read as it is (the experts
    pass one)."""
    g = _gen(dev, 11)
    groups = 8
    x = torch.randn((groups, rows, w), generator=g, device=dev).to(dtype)
    bias = (0.1 * torch.randn((groups, w), generator=g, device=dev)).to(
        bias_dt)
    before = (tfo.fused_bias_gelu.launches,
              tfo.fused_bias_gelu_backward.launches)
    out, s = tfo.fused_bias_gelu_with_sum(x, bias, approximate=True)
    ref, ref_s = tfo._gelu_fwd_math(x, bias, True)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.float(), ref.to(dtype).float(), **tol)
    torch.testing.assert_close(s.float(), ref_s.to(dtype).float(), **tol)
    dout = torch.randn(x.shape, generator=g, device=dev).to(dtype)
    dx, dbias = tfo.fused_bias_gelu_backward(s, dout, approximate=True,
                                             groups=groups)
    d = tfo._gelu_bwd_math(s, dout, True)
    assert dbias.shape == (groups, w)
    assert _rel_l2(dx, d.to(dtype)) <= GRAD_TOL[dtype]
    assert _rel_l2(dbias, d.sum(1)) <= GRAD_TOL[torch.float32] * 10
    again = tfo.fused_bias_gelu_backward(s, dout, approximate=True,
                                         groups=groups)
    assert torch.equal(dx, again[0]) and torch.equal(dbias, again[1])
    fwd_again = tfo.fused_bias_gelu_with_sum(x, bias, approximate=True)
    assert torch.equal(out, fwd_again[0]) and torch.equal(s, fwd_again[1])
    torch.cuda.synchronize()
    assert (tfo.fused_bias_gelu.launches,
            tfo.fused_bias_gelu_backward.launches) == (before[0] + 2,
                                                       before[1] + 2)
    x1 = x.reshape(-1, w)
    dense = tfo.fused_bias_gelu_with_sum(x1, bias[0], approximate=True)
    one = tfo.fused_bias_gelu_with_sum(x1, bias[:1], approximate=True)
    assert torch.equal(dense[0], one[0]) and torch.equal(dense[1], one[1])
    torch.cuda.synchronize()


def test_moe_training_step_matches_plain_route(dev):
    """A 2-layer MoE model (one MoE layer, 8 experts, top-2) at
    gpt2-125m width, bf16: loss and every gradient through the kernels
    (K8, grouped K4, flash, fused epilogues) against the plain route
    (einsum dispatch/combine, fused_ops off, dense attention) with the
    kernel route's expert choices forced on it; then one engine step
    with the moe block, which launches K8."""
    import dataclasses
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.moe import MoEConfig, MoEMLP
    tfd = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")
    moe = MoEConfig(num_experts=8, top_k=2, every_n_layers=2).validate()
    cfg = tgpt2.gpt2_config("gpt2-125m", n_layer=2, vocab_size=1024,
                            n_positions=256, dropout=0.0,
                            param_dtype=torch.bfloat16, moe=moe)
    model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
    params = model.init(seed=0)
    plain = tgpt2.GPT2ForCausalLM(dataclasses.replace(
        cfg, fused_ops="off", attention_impl="xla",
        moe=dataclasses.replace(moe, fused_dispatch="off")), device=dev)
    ids = torch.randint(0, 1024, (2, 256), generator=_gen(dev, 12),
                        device=dev)
    results = []
    for m in (model, plain):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = m.loss_fn(p, {"input_ids": ids}, deterministic=True)
        results.append((loss, torch.autograd.grad(loss, list(p.values()))))
        if m is model:
            chosen = [x.last_expert_idx for x in m.module.modules()
                      if isinstance(x, MoEMLP)]
            for x, c in zip((x for x in plain.module.modules()
                             if isinstance(x, MoEMLP)), chosen):
                x.route_override = c
    (lk, gk), (lp, gp) = results
    torch.cuda.synchronize()
    assert abs(float(lk) - float(lp)) <= 1e-2 * abs(float(lp))
    for name, a, b in zip(params, gk, gp):
        assert _rel_l2(a, b) <= 5e-2, name
    engine, _, _, _ = dst.initialize(
        model=model, model_parameters=params,
        config={"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                "moe": {"enabled": True, "num_experts": 8,
                        "every_n_layers": 2}})
    before = (tfd.gather_rows.launches, tfd.combine_rows.launches)
    loss = engine.train_batch(batch={"input_ids": ids[None]})
    assert bool(torch.isfinite(loss))
    # forward, remat recompute and backward each launch both gathers once
    assert tfd.gather_rows.launches - before[0] == 3
    assert tfd.combine_rows.launches - before[1] == 3


# ----------------------------------------------------------------------
# quantized compute: kernel K6 (int8 GEMM, per-block dequant epilogue)
# ----------------------------------------------------------------------
def _qm():
    return importlib.import_module(
        "deepspeed_tpu_torch.ops.transformer.quantized_matmul")


@pytest.mark.parametrize("g,m,k,n,out_dtype,block", [
    (1, 300, 1600, 520, torch.bfloat16, 128),   # partial last block, ragged
    (1, 128, 256, 128, torch.float32, 128),
    (3, 77, 384, 200, torch.bfloat16, 128),     # grouped, ragged M and N
    (2, 64, 6400, 48, torch.float32, 128),
    # the flagship's four projections (M = 11 x 1024; N 1600 is no
    # multiple of 128)
    (1, 11264, 1600, 4800, torch.bfloat16, 128),
    (1, 11264, 1600, 1600, torch.bfloat16, 128),
    (1, 11264, 1600, 6400, torch.bfloat16, 128),
    (1, 11264, 6400, 1600, torch.bfloat16, 128),
    (1, 11227, 1600, 4800, torch.bfloat16, 128),  # ragged M
    (8, 77, 1024, 4096, torch.float32, 128),      # experts, ragged C 77
    (1, 1000, 1600, 1600, torch.float32, 128),    # fp32 output
    (1, 1000, 1600, 1602, torch.bfloat16, 256),   # block 256, N % 4 = 2
    (2, 200, 2048, 384, torch.float32, 512),      # block 512: cvt
])
def test_quantized_matmul_kernel_matches_twin(dev, g, m, k, n, out_dtype,
                                              block):
    """K6 equals its twin bit for bit: both sum exact int32 block
    partials and scale/add them in the same fp32 order, no FMA."""
    qm = _qm()
    gen = _gen(dev, 13)
    x = torch.randn((g, m, k), generator=gen, device=dev) * 3.0
    w = torch.randn((g, k, n), generator=gen, device=dev) * 0.05
    wq, sw = qm.quantize_kernel_int8(w, block)
    xq, sx = qm.quantize_rows_int8(x)
    xq = torch.nn.functional.pad(xq, (0, wq.shape[-2] - k)).contiguous()
    before = qm.quantized_matmul.launches
    got = qm._qmm(xq, wq, sx, sw, block, out_dtype)
    torch.cuda.synchronize()
    assert qm.quantized_matmul.launches == before + 1
    ref = qm._qmm_plain(xq, wq, sx, sw, block, out_dtype)
    assert got.dtype == out_dtype and got.shape == (g, m, n)
    assert torch.equal(got, ref), float((got.float() - ref.float()).abs().max())
    # the wrapper: quantizes x itself and pads K, the same numbers
    y = qm.quantized_matmul(x if g > 1 else x[0], wq if g > 1 else wq[0],
                            sw if g > 1 else sw[0], block=block,
                            out_dtype=out_dtype)
    assert torch.equal(y, got if g > 1 else got[0])


def test_quantized_matmul_kernel_raises_on_what_it_does_not_take(dev):
    qm = _qm()
    xq = torch.zeros((1, 64, 256), dtype=torch.int8, device=dev)
    wq = torch.zeros((1, 256, 64), dtype=torch.int8, device=dev)
    sx = torch.ones((1, 64, 1), device=dev)
    sw = torch.ones((1, 2, 64), device=dev)
    with pytest.raises(ValueError, match="multiple of 128"):
        qm._qmm(xq, wq, sx, torch.ones((1, 4, 64), device=dev), 64,
                torch.float32)
    with pytest.raises(TypeError):
        qm._qmm(xq.float(), wq, sx, sw, 128, torch.float32)
    with pytest.raises(TypeError):
        qm._qmm(xq, wq, sx, sw, 128, torch.float64)
    with pytest.raises(ValueError):
        qm._qmm(xq, wq[:, :128], sx, sw, 128, torch.float32)
    with pytest.raises(ValueError, match="multiple of 128"):
        qm.quantized_dense(torch.zeros((4, 128), device=dev),
                           torch.zeros((128, 8), device=dev), block=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quantized_dense_autograd_matches_the_cpu_twin(dev, dtype):
    """quantized_dense on the card (K6 forward, STE backward) against
    the same call on CPU copies (the twin): the forward equal to one
    rounding of the output; dx and dW to fp32 GEMM roundoff (fp32), or
    to one 16-bit rounding (bf16, fp16: dW is one 16-bit GEMM with an
    fp32 output on the card, the fp32 GEMM of the same products on the
    CPU; fp16 keeps 3 more mantissa bits, 5e-3)."""
    qm = _qm()
    gen = _gen(dev, 14)
    x = (torch.randn((4, 96, 1600), generator=gen, device=dev)).to(dtype)
    w = (0.02 * torch.randn((1600, 384), generator=gen, device=dev)).to(dtype)
    dy = torch.randn((4, 96, 384), generator=gen, device=dev).to(dtype)
    outs = []
    for d in (dev, torch.device("cpu")):
        xd = x.to(d).requires_grad_(True)
        wd = w.to(d).requires_grad_(True)
        y = qm.quantized_dense(xd, wd, block=128)
        outs.append((y.detach().cpu(),) + tuple(
            t.cpu() for t in torch.autograd.grad(y, (xd, wd), dy.to(d))))
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
           torch.float16: 5e-3}[dtype]
    for a, b in zip(outs[0], outs[1]):
        assert a.dtype == b.dtype == dtype
        assert _rel_l2(a, b) <= tol


def test_straight_through_dw_matches_the_fp32_gemm(dev):
    """The STE backward's dW in bf16 compute (one bf16 GEMM with an fp32
    output, then bf16) against the JAX package's arithmetic (the fp32
    GEMM of the same values, TF32 off, then bf16), at the gpt2-1.5b
    mlp_c_proj shape. The products are the same, only the summation
    order differs: within 1e-4 relative L2 before the rounding to bf16;
    after it, an entry differs by at most one bf16 ulp (2^-8 relative),
    so within 1e-3. Prints the measured gaps (`pytest -s`)."""
    qm = _qm()
    gen = _gen(dev, 16)
    m, k, n = 11 * 1024, 6400, 1600
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    g = (1e-3 * torch.randn((m, n), generator=gen, device=dev)) \
        .to(torch.bfloat16)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref32 = x.float().t() @ g.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got32 = torch.mm(x.t(), g, out_dtype=torch.float32)
    got, ref = qm._dw(x, g, torch.bfloat16), ref32.to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(
        got, got32.to(torch.bfloat16))
    gaps = {"fp32_rel_l2": _rel_l2(got32, ref32),
            "bf16_rel_l2": _rel_l2(got, ref),
            "bf16_entries_differing": float((got != ref).float().mean())}
    print("dw gap", gaps)
    assert gaps["fp32_rel_l2"] <= 1e-4 and gaps["bf16_rel_l2"] <= 1e-3


def test_stochastic_rounding_distribution_on_the_card(dev):
    """SR on the card: floor or ceil only, unbiased, keyed by the
    generator's seed."""
    qm = _qm()
    w = torch.full((256, 64), 0.1, device=dev)
    w[0] = 0.3
    q1, s = qm.quantize_kernel_int8(w, 256, gen=_gen(dev, 1))
    q2, _ = qm.quantize_kernel_int8(w, 256, gen=_gen(dev, 2))
    q1b, _ = qm.quantize_kernel_int8(w, 256, gen=_gen(dev, 1))
    vals = q1[1:].float()
    assert set(vals.unique().tolist()) <= {42.0, 43.0}
    assert abs(float(vals.mean()) * float(s[0, 0]) - 0.1) < 0.001
    assert torch.equal(q1, q1b) and not torch.equal(q1, q2)


def test_quantized_training_step_on_the_kernels(dev):
    """A 2-layer gpt2-125m-wide bf16 model with quantized compute: the
    kernel route (K6 and K1-K4) against the plain route (fused ops off,
    dense attention, K6's twin) within the training oracle's bounds,
    then an engine step through the quantized_compute block ("auto": on
    on the card): 16 K6 launches (4 projections x 2 layers, forward and
    remat recompute; the straight-through backward runs none)."""
    import dataclasses
    import deepspeed_tpu_torch as dst
    qm = _qm()
    cfg = tgpt2.gpt2_config("gpt2-125m", n_layer=2, vocab_size=1024,
                            n_positions=256, dropout=0.0,
                            param_dtype=torch.bfloat16,
                            quantized_compute="on")
    model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
    params = model.init(seed=0)
    plain = tgpt2.GPT2ForCausalLM(dataclasses.replace(
        cfg, fused_ops="off", attention_impl="xla"), device=dev)
    ids = torch.randint(0, 1024, (2, 256), generator=_gen(dev, 15),
                        device=dev)
    results = []
    qmm = qm._qmm
    for m in (model, plain):
        if m is plain:
            qm._qmm = qm._qmm_plain
        try:
            p = {k: v.clone().requires_grad_(True)
                 for k, v in params.items()}
            loss = m.loss_fn(p, {"input_ids": ids}, deterministic=True)
            results.append((loss, torch.autograd.grad(loss,
                                                      list(p.values()))))
        finally:
            qm._qmm = qmm
    (lk, gk), (lp, gp) = results
    torch.cuda.synchronize()
    assert abs(float(lk) - float(lp)) <= 1e-2 * abs(float(lp))
    for name, a, b in zip(params, gk, gp):
        assert _rel_l2(a, b) <= 5e-2, name
    base = tgpt2.GPT2ForCausalLM(dataclasses.replace(
        cfg, quantized_compute="off"), device=dev)
    engine, _, _, _ = dst.initialize(
        model=base, model_parameters=params,
        config={"train_micro_batch_size_per_gpu": 2,
                "bf16": {"enabled": True, "master_weights": False},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                "quantized_compute": {"enabled": True, "mode": "auto"}})
    before = qm.quantized_matmul.launches
    loss = engine.train_batch(batch={"input_ids": ids[None]})
    assert bool(torch.isfinite(loss))
    assert qm.quantized_matmul.launches - before == 16


# ----------------------------------------------------------------------
# K7: block-sparse attention
# ----------------------------------------------------------------------
def _sparse_layouts(h, t, block, causal):
    """Three layouts per (block, causal): Fixed (the band kernel,
    aligned windows), BSLongformer (the band kernel, sliding, when
    causal; the table kernel when not: its global row does not
    decompose) and BigBird (the table kernel)."""
    attention = "unidirectional" if causal else "bidirectional"
    cfgs = (tsa.FixedSparsityConfig(num_heads=h, block=block,
                                    num_local_blocks=2, attention=attention),
            tsa.BSLongformerSparsityConfig(num_heads=h, block=block,
                                           num_sliding_window_blocks=3),
            tsa.BigBirdSparsityConfig(num_heads=h, block=block))
    return [c.make_layout(t) for c in cfgs]


def _bwd_launches(hopper):
    """K7-dkv's and K7-dq's launchers on the Hopper sweeps or the WMMA
    bodies."""
    if hopper:
        return tbsa._bs_bwd_dkv_sm90_launch, tbsa._bs_bwd_dq_sm90_launch
    return tbsa._bs_bwd_dkv_launch, tbsa._bs_bwd_dq_launch


def _fwd_launches():
    """The launches of the four K7 forward kernels (band and table, each
    on the Hopper and the WMMA body)."""
    return sum(f.launches for f in (
        tbsa._band_fwd_launch, tbsa._band_fwd_sm90_launch,
        tbsa._bs_fwd_launch, tbsa._bs_fwd_sm90_launch))


def _k7_case(dev, layout, block, causal, dtype, d, seed, b=2):
    """Each K7 kernel the layout routes to, against its twin on the same
    inputs (q/k/v as column slices of one qkv tensor): the forward's out
    and lse (the band or the table forward, on the Hopper body in bf16
    and fp16 at head dims 64 and 128 with the 128 x 64 plan), then
    dq/dk/dv from the kernel's own (out, lse) (on the Hopper sweeps over
    the 128 x 64 plan's pair tables in bf16 and fp16 at head dims 64 and
    128), as the public route takes them. Returns the square plan."""
    g = _gen(dev, seed)
    h, nb, _ = layout.shape
    t = nb * block
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    dout = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    plan = tbsa._plan(layout, causal, block, tbsa.TILE, q.device)
    tiles = tbsa._hopper_tiles(dtype, d, tbsa.TILE)
    pair = tbsa._plan(layout, causal, block, tiles, q.device)
    sm = d ** -0.5
    hopper = tiles != (tbsa.TILE, tbsa.TILE)
    if plan.band is None:
        launch = tbsa._bs_fwd_sm90_launch if hopper else tbsa._bs_fwd_launch
        plain = tbsa._bs_fwd_plain
    else:
        launch = tbsa._band_fwd_sm90_launch if hopper else \
            tbsa._band_fwd_launch
        plain = tbsa._band_fwd_plain
    dkv, dq_launch = _bwd_launches(hopper)
    before = (launch.launches, dkv.launches, dq_launch.launches)
    out, lse = launch(q, k, v, pair, sm)
    dk, dv, delta = dkv(q, k, v, out, lse, dout, pair, sm)
    dq = dq_launch(q, k, v, out, lse, dout, delta, pair, sm)
    ref, ref_lse = plain(q, k, v, pair, sm)
    ref_grads = tbsa._bs_bwd_plain(q, k, v, out, lse, dout, pair, sm)
    torch.cuda.synchronize()
    assert (launch.launches, dkv.launches, dq_launch.launches) == \
        tuple(x + 1 for x in before)
    tol = {torch.bfloat16: BF16_TOL, F16: F16_TOL}.get(dtype, F32_TOL)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, **F32_TOL)
    for name, x, y in zip("qkv", (dq, dk, dv), ref_grads):
        assert x.dtype == dtype and x.shape == (b, t, h, d)
        assert _rel_l2(x, y) <= GRAD_TOL.get(dtype, F16_GRAD_TOL), name
    return plan


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
def test_block_sparse_kernels_match_twins(dev, block, causal, dtype):
    """K7-band, K7-fwd, K7-dkv and K7-dq against their twins at every
    block size the kernels take (16 and 32 put several layout blocks in
    one 64-row tile), causal and not, fp32 (the WMMA bodies) and bf16
    (the Hopper bodies for K7-band and the backward)."""
    t = max(512, 8 * block)
    routes = set()
    for i, layout in enumerate(_sparse_layouts(4, t, block, causal)):
        plan = _k7_case(dev, layout, block, causal, dtype, 64, seed=i)
        routes.add(plan.band is not None)
    assert routes == {True, False}      # both forward kernels ran


def _band_layouts(h, t, block):
    """(layout, causal) pairs on the band forward: sliding bands
    (BSLongformer: unidirectional with its global column, causal; and
    bidirectional without one, not causal) and aligned windows (Fixed,
    with its global columns, causal and not). At blocks of 64 and under a
    128-row q tile straddles layout blocks: causally its first span tile
    is unseen by its lower half, and rows of a seen tile see nothing in
    it."""
    sliding = tsa.BSLongformerSparsityConfig
    return [(sliding(num_heads=h, block=block, num_sliding_window_blocks=3,
                     attention="unidirectional").make_layout(t), True),
            (sliding(num_heads=h, block=block, num_sliding_window_blocks=3,
                     global_block_indices=[]).make_layout(t), False)] + [
        (tsa.FixedSparsityConfig(num_heads=h, block=block,
                                 num_local_blocks=4,
                                 attention=attention).make_layout(t), causal)
        for attention, causal in (("unidirectional", True),
                                  ("bidirectional", False))]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
def test_hopper_band_kernel_matches_twin(dev, block, d):
    """K7-band on the Hopper body against its twin at the 128 x 64 tile
    pair, bf16: sliding and aligned bands, causal and not, at each block;
    T = 448 (3.5 q tiles: the last runs past T) where the block divides
    it, else 8 blocks, and 3 heads (odd B*H in the grid order)."""
    t = 448 if 448 % block == 0 else 8 * block
    kinds = set()
    for i, (layout, causal) in enumerate(_band_layouts(3, t, block)):
        plan = tbsa._plan(layout, causal, block, tfa._SM90_TILES, dev)
        assert plan.band is not None
        kinds.add(plan.band[0])
        g = _gen(dev, 100 + i)
        q, k, v = (torch.randn((2, t, 3, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        before = tbsa._band_fwd_sm90_launch.launches
        out, lse = tbsa._band_fwd_sm90_launch(q, k, v, plan, d ** -0.5)
        torch.cuda.synchronize()
        assert tbsa._band_fwd_sm90_launch.launches == before + 1
        ref, ref_lse = tbsa._band_fwd_plain(q, k, v, plan, d ** -0.5)
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        torch.testing.assert_close(lse, ref_lse, **F32_TOL)
    assert kinds == {"sliding", "aligned"}


def _table_layouts(h, t, block):
    """(layout, causal) pairs that take the table forward: BigBird
    (bidirectional) and per-head Variable layouts with random blocks and
    a global column (causal)."""
    return [(tsa.BigBirdSparsityConfig(num_heads=h, block=block)
             .make_layout(t), False),
            (tsa.VariableSparsityConfig(
                num_heads=h, block=block, different_layout_per_head=True,
                num_random_blocks=1, local_window_blocks=[1, 2],
                global_block_indices=[0]).make_layout(t), True)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
def test_hopper_sparse_backward_matches_twin(dev, block, d):
    """K7-dkv and K7-dq on the Hopper sweeps against the twin on the
    pair tables, bf16: sliding and aligned bands, BigBird and per-head
    layouts, causal and not, at each block and head dim; T = 448 (the
    last 128-row tile's lower half lies past T) where the block divides
    it, else 8 blocks; B*H = 3 (odd) and q/k/v column slices of one qkv
    tensor. A second launch repeats the first bit for bit."""
    t = 448 if 448 % block == 0 else 8 * block
    for i, (layout, causal) in enumerate(_band_layouts(3, t, block) +
                                         _table_layouts(3, t, block)):
        plan = _k7_case(dev, layout, block, causal, torch.bfloat16, d,
                        seed=200 + i, b=1)
        pair = tbsa._plan(layout, causal, block, tfa._SM90_TILES, dev)
        g = _gen(dev, 300 + i)
        q, k, v, dout = (torch.randn((1, t, 3, d), generator=g, device=dev)
                         .to(torch.bfloat16) for _ in range(4))
        out, lse = tbsa._bs_fwd_launch(q, k, v, plan, d ** -0.5)
        runs = []
        for _ in range(2):
            dk, dv, delta = tbsa._bs_bwd_dkv_sm90_launch(
                q, k, v, out, lse, dout, pair, d ** -0.5)
            runs.append((dk, dv, tbsa._bs_bwd_dq_sm90_launch(
                q, k, v, out, lse, dout, delta, pair, d ** -0.5)))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
def test_hopper_table_forward_matches_twin(dev, block, d):
    """K7-fwd on the Hopper body against its twin on the forward pair
    table, bf16: BigBird (bidirectional) and per-head Variable layouts
    (causal), at each block and head dim; T = 448 (the last 128-row q
    tile's lower half lies past T) where the block divides it, else 8
    blocks; B*H = 6. One launch per call, on this kernel only."""
    t = 448 if 448 % block == 0 else 8 * block
    for i, (layout, causal) in enumerate(_table_layouts(3, t, block)):
        plan = tbsa._plan(layout, causal, block, tfa._SM90_TILES, dev)
        assert plan.band is None
        g = _gen(dev, 400 + i)
        q, k, v = (torch.randn((2, t, 3, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        before = (tbsa._bs_fwd_sm90_launch.launches, _fwd_launches())
        out, lse = tbsa._bs_fwd_sm90_launch(q, k, v, plan, d ** -0.5)
        torch.cuda.synchronize()
        assert (tbsa._bs_fwd_sm90_launch.launches, _fwd_launches()) == \
            (before[0] + 1, before[1] + 1)
        ref, ref_lse = tbsa._bs_fwd_plain(q, k, v, plan, d ** -0.5)
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        torch.testing.assert_close(lse, ref_lse, **F32_TOL)


def test_hopper_table_forward_at_the_longest_walk(dev):
    """BigBird (bidirectional, block 64) at [1, 32768, 1, 64]: its global
    row walks all 512 k tiles, the most the table forward's shared memory
    holds; at T = 32832 (513 tiles) the launch raises before the card is
    touched."""
    layout = tsa.BigBirdSparsityConfig(num_heads=1, block=64).make_layout(
        32768)
    plan = tbsa._plan(layout, False, 64, tfa._SM90_TILES, dev)
    assert plan.pairs["dq"][2] == tbsa._SM90_MAX_STEPS
    g = _gen(dev, 41)
    q, k, v = (torch.randn((1, 32768, 1, 64), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = tbsa._bs_fwd_sm90_launch(q, k, v, plan, 0.125)
    ref, ref_lse = tbsa._bs_fwd_plain(q, k, v, plan, 0.125)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    torch.testing.assert_close(lse, ref_lse, **F32_TOL)
    wide = tsa.BigBirdSparsityConfig(num_heads=1, block=64).make_layout(
        32832)
    plan = tbsa._plan(wide, False, 64, tfa._SM90_TILES, dev)
    x = torch.zeros((1, 32832, 1, 64), device=dev, dtype=torch.bfloat16)
    before = tbsa._bs_fwd_sm90_launch.launches
    with pytest.raises(ValueError, match="512"):
        tbsa._bs_fwd_sm90_launch(x, x, x, plan, 0.125)
    assert tbsa._bs_fwd_sm90_launch.launches == before


def test_block_sparse_route_takes_the_hopper_table_forward_for_bf16(dev):
    """The public route's table forward: bf16 at head dims 64 and 128
    launches the Hopper K7-fwd, fp32 the WMMA one; each matches the dense
    masked fallback."""
    layout = tsa.BigBirdSparsityConfig(num_heads=2, block=64).make_layout(
        1024)
    for dtype, d, hopper in ((torch.bfloat16, 64, True),
                             (torch.bfloat16, 128, True),
                             (torch.float32, 64, False)):
        g = _gen(dev, 50 + d)
        q, k, v = (torch.randn((2, 1024, 2, d), generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        before = (tbsa._bs_fwd_sm90_launch.launches,
                  tbsa._bs_fwd_launch.launches)
        out = tsa.block_sparse_attention(q, k, v, layout, 64)
        torch.cuda.synchronize()
        moved = (tbsa._bs_fwd_sm90_launch.launches - before[0],
                 tbsa._bs_fwd_launch.launches - before[1])
        assert moved == ((1, 0) if hopper else (0, 1))
        ref = tbsa.block_sparse_attention_dense_fallback(
            *(x.float() for x in (q, k, v)), layout, 64)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        torch.testing.assert_close(out.float(), ref, **tol)


def test_hopper_sparse_backward_at_the_longest_walk(dev):
    """BSLongformer (block 256, causal) at [1, 32768, 2, 64]: the global
    column's k tiles walk every later q tile, 512 steps, the most the
    Hopper backward's shared memory holds."""
    layout = tsa.BSLongformerSparsityConfig(
        num_heads=2, block=256, num_sliding_window_blocks=4).make_layout(
            32768)
    plan = tbsa._plan(layout, True, 256, tfa._SM90_TILES, dev)
    assert plan.pairs["dkv"][2] == tbsa._SM90_MAX_STEPS
    _k7_case(dev, layout, 256, True, torch.bfloat16, 64, seed=31, b=1)


def test_block_sparse_route_takes_the_hopper_backward_for_bf16(dev):
    """The public route's backward: bf16 at head dims 64 and 128 launches
    the Hopper K7-dkv and K7-dq, fp32 the WMMA ones; each matches the
    dense masked fallback."""
    layout = tsa.BigBirdSparsityConfig(num_heads=2, block=64).make_layout(
        1024)
    for dtype, d, hopper in ((torch.bfloat16, 64, True),
                             (torch.bfloat16, 128, True),
                             (torch.float32, 64, False)):
        g = _gen(dev, d)
        q, k, v = (torch.randn((2, 1024, 2, d), generator=g, device=dev)
                   .to(dtype).requires_grad_(True) for _ in range(3))
        dout = torch.randn((2, 1024, 2, d), generator=g, device=dev).to(dtype)
        counts = [f.launches for f in _bwd_launches(True) +
                  _bwd_launches(False)]
        out = tsa.block_sparse_attention(q, k, v, layout, 64)
        got = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        moved = [f.launches - c for f, c in
                 zip(_bwd_launches(True) + _bwd_launches(False), counts)]
        assert moved == ([1, 1, 0, 0] if hopper else [0, 0, 1, 1])
        f32 = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
        ref = tbsa.block_sparse_attention_dense_fallback(*f32, layout, 64)
        want = torch.autograd.grad(ref, f32, dout.float())
        tol = 2e-2 if dtype == torch.bfloat16 else GRAD_TOL[dtype]
        for x, y in zip(got, want):
            assert _rel_l2(x, y) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_sparse_kernels_per_head_layouts_and_d128(dev, dtype):
    """Per-head layouts (different_layout_per_head, random blocks: the
    table kernels with a head map over unique layouts) at head dims 64
    and 128."""
    for d, block in ((64, 32), (128, 64)):
        cfg = tsa.VariableSparsityConfig(
            num_heads=4, block=block, different_layout_per_head=True,
            num_random_blocks=2, local_window_blocks=[2, 3],
            global_block_indices=[1])
        layout = cfg.make_layout(512)
        assert len(np.unique(layout, axis=0)) > 1
        for causal in (True, False):
            plan = _k7_case(dev, layout, block, causal, dtype, d, seed=d)
            assert plan.band is None


def test_block_sparse_autograd_matches_dense_fallback(dev):
    """The public route on the card (K7-band forward, K7-dkv/K7-dq
    backward) against the dense masked attention, fp32."""
    g = _gen(dev, 21)
    layout = tsa.BSLongformerSparsityConfig(
        num_heads=4, block=64, num_sliding_window_blocks=4).make_layout(1024)
    q, k, v = (torch.randn((1, 1024, 4, 64), generator=g, device=dev)
               .requires_grad_(True) for _ in range(3))
    before = tbsa._band_fwd_launch.launches
    out = tsa.block_sparse_attention(q, k, v, layout, 64, causal=True)
    ref = tbsa.block_sparse_attention_dense_fallback(q, k, v, layout, 64,
                                                     causal=True)
    dout = torch.randn(out.shape, generator=g, device=dev)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    assert tbsa._band_fwd_launch.launches == before + 1
    torch.testing.assert_close(out, ref, **F32_TOL)
    for x, y in zip(got, want):
        assert _rel_l2(x, y) <= GRAD_TOL[torch.float32]


def test_block_sparse_kernels_raise_on_what_they_do_not_take(dev):
    """A head dim above 128 and blocks outside 16-256 raise; fp16 runs
    the Hopper kernels (their fp16 forms; the WMMA bodies' refusal is
    `test_fp16_block_sparse_route_matches_dense_fallback`'s); T not a
    multiple of 64 and head dims under 128 are padded (the padding tests
    below)."""
    layout = tsa.FixedSparsityConfig(num_heads=2, block=32).make_layout(256)
    q = torch.zeros((1, 256, 2, 192), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tsa.block_sparse_attention(q, q, q, layout, 32)
    q = torch.zeros((1, 256, 2, 64), device=dev, dtype=torch.float16)
    before = tbsa._band_fwd_sm90_launch.launches
    out = tsa.block_sparse_attention(q, q, q, layout, 32)
    torch.cuda.synchronize()
    assert out.dtype == torch.float16 and bool(torch.isfinite(out).all())
    assert tbsa._band_fwd_sm90_launch.launches == before + 1
    layout = tsa.FixedSparsityConfig(num_heads=2, block=32).make_layout(96)
    q = torch.zeros((1, 96, 2, 64), device=dev, dtype=torch.bfloat16)
    before = _fwd_launches()
    out = tsa.block_sparse_attention(q, q, q, layout, 32)
    torch.cuda.synchronize()
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert _fwd_launches() == before + 1
    layout = tsa.DenseSparsityConfig(num_heads=2, block=8).make_layout(256)
    q = torch.zeros((1, 256, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # block 8
        tsa.block_sparse_attention(q, q, q, layout, 8)


@pytest.mark.parametrize("t,d,dtype", [(48, 32, torch.float32),
                                       (96, 80, torch.float32),
                                       (4112, 64, torch.bfloat16)])
def test_block_sparse_kernels_pad_t_and_d(dev, t, d, dtype):
    """BSLongformer (block 16, causal) at a T that is no multiple of 64
    and head dims under 128: the kernel route pads T with invisible
    blocks and D with zeros, and holds the twins (on CPU copies) and the
    dense masked fallback, forward and dQ/dK/dV."""
    layout = tsa.BSLongformerSparsityConfig(
        num_heads=2, block=16, num_sliding_window_blocks=3).make_layout(t)
    g = _gen(dev, t)
    q, k, v = (torch.randn((1, t, 2, d), generator=g, device=dev)
               .to(dtype).requires_grad_(True) for _ in range(3))
    dout = torch.randn((1, t, 2, d), generator=g, device=dev).to(dtype)
    # bf16 at head dim 64 takes the Hopper backward
    dq_launch = _bwd_launches(dtype == torch.bfloat16 and d == 64)[1]
    before = (_fwd_launches(), dq_launch.launches)
    out = tsa.block_sparse_attention(q, k, v, layout, 16, causal=True)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (_fwd_launches(), dq_launch.launches) == \
        (before[0] + 1, before[1] + 1)
    assert out.shape == (1, t, 2, d)
    cpu = [x.detach().cpu().requires_grad_(True) for x in (q, k, v)]
    twin = tsa.block_sparse_attention(*cpu, layout, 16, causal=True)
    twin_grads = torch.autograd.grad(twin, cpu, dout.cpu())
    # the dense reference in fp32 on the same (bf16-valued) inputs
    f32 = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    ref = tbsa.block_sparse_attention_dense_fallback(*f32, layout, 16,
                                                     causal=True)
    ref_grads = torch.autograd.grad(ref, f32, dout.float())
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.float().cpu(), twin.float(), **tol)
    torch.testing.assert_close(out.float(), ref, **tol)
    # bf16 against the fp32 reference: P and dS rounded to bf16 in the
    # kernel, then each gradient's own rounding
    dense_tol = 2e-2 if dtype == torch.bfloat16 else GRAD_TOL[dtype]
    for x, y, z in zip(got, twin_grads, ref_grads):
        assert _rel_l2(x.cpu(), y) <= GRAD_TOL[dtype]
        assert _rel_l2(x, z) <= dense_tol


# ----------------------------------------------------------------------
# BERT-large pretraining's shapes and forms (micro batch 16, seq 128)
# ----------------------------------------------------------------------
def test_bert_flash_kernels_match_twins(dev):
    """K1-fwd and K2-fused, bf16 non-causal at [16, 128, 16, 64]: one
    128-row q tile over two 64-row K/V tiles; one CTA a head for the
    backward, launched twice, bit for bit."""
    g = _gen(dev, 13)
    b, t, h, d = 16, 128, 16, 64
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev) \
        .to(torch.bfloat16)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=False)
    ref, ref_lse = tfa._flash_fwd_plain(q, k, v, d ** -0.5, False)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    torch.testing.assert_close(lse[..., 0], ref_lse, **F32_TOL)
    lse = lse[..., 0].contiguous()
    dout = torch.randn((b, t, h, d), generator=g, device=dev) \
        .to(torch.bfloat16)
    before = tfa._flash_bwd_fused_launch.launches
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, None,
                                       d ** -0.5, False)
    again = tfa.flash_attention_backward(q, k, v, out, lse, dout, None,
                                         d ** -0.5, False)
    want = tfa._flash_bwd_fused_plain(q, k, v, out, lse, dout, None,
                                      d ** -0.5, False)
    torch.cuda.synchronize()
    assert tfa._flash_bwd_fused_launch.launches == before + 2
    for name, x, y, z in zip("qkv", got, want, again):
        assert _rel_l2(x, y) <= GRAD_TOL[torch.bfloat16], name
        assert torch.equal(x, z), name


@pytest.mark.parametrize("res_dtype", [torch.bfloat16, torch.float32])
def test_bert_post_ln_layernorm_kernels_match_twins(dev, res_dtype):
    """K3 in BERT's post-LN form at N 2048, H 1024: y bf16, the residual
    in the carry's dtype (bf16 into the attention LayerNorm, fp32 into
    the output LayerNorm), bf16 parameters, fp32 out and the sum for the
    backward; then K3-bwd off that sum with an fp32 dout, no dsum and a
    bf16 dx, launched twice, bit for bit."""
    g = _gen(dev, 14)
    n, h = 2048, 1024
    y = torch.randn((n, h), generator=g, device=dev).to(torch.bfloat16)
    res = torch.randn((n, h), generator=g, device=dev).to(res_dtype)
    bias, beta = ((0.1 * torch.randn((h,), generator=g, device=dev))
                  .to(torch.bfloat16) for _ in range(2))
    gamma = (1.0 + 0.1 * torch.randn((h,), generator=g, device=dev)) \
        .to(torch.bfloat16)
    before = tfo.fused_bias_residual_layernorm.launches
    out, s = tfo._ln_forward(y, bias, res, gamma, beta, 1e-12,
                             torch.float32, res_dtype, True)
    ref_out, ref_s = tfo._ln_fwd_math(y, bias, res, gamma, beta, 1e-12)
    torch.cuda.synchronize()
    assert tfo.fused_bias_residual_layernorm.launches == before + 1
    assert out.dtype == torch.float32 and s.dtype == res_dtype
    torch.testing.assert_close(out, ref_out, **F32_TOL)
    torch.testing.assert_close(
        s.float(), ref_s.to(res_dtype).float(),
        **(BF16_TOL if res_dtype == torch.bfloat16 else F32_TOL))
    dout = torch.randn((n, h), generator=g, device=dev)
    got = tfo.fused_bias_residual_layernorm_backward(
        s, gamma, dout, None, eps=1e-12, dx_dtype=torch.bfloat16)
    again = tfo.fused_bias_residual_layernorm_backward(
        s, gamma, dout, None, eps=1e-12, dx_dtype=torch.bfloat16)
    ds, dg, db = tfo._ln_bwd_math(s, gamma, dout, None, 1e-12)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16
    assert _rel_l2(got[0], ds.to(torch.bfloat16)) <= \
        GRAD_TOL[torch.bfloat16]
    for x, r in zip(got[1:], (ds.sum(0), dg.sum(0), db.sum(0))):
        assert _rel_l2(x, r) <= GRAD_TOL[torch.float32] * 10
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bert_erf_gelu_kernels_match_twins(dev):
    """K4-fwd and K4-bwd, erf, bf16 at N 2048, W 4096 (BERT-large's
    intermediate) with a bf16 bias; the backward twice, bit for bit."""
    g = _gen(dev, 15)
    n, w = 2048, 4096
    x = torch.randn((n, w), generator=g, device=dev).to(torch.bfloat16)
    bias = (0.1 * torch.randn((w,), generator=g, device=dev)) \
        .to(torch.bfloat16)
    out, s = tfo.fused_bias_gelu_with_sum(x, bias, approximate=False)
    ref_out, ref_s = tfo._gelu_fwd_math(x, bias, False)
    torch.testing.assert_close(out.float(), ref_out.to(out.dtype).float(),
                               **BF16_TOL)
    torch.testing.assert_close(s.float(), ref_s.to(s.dtype).float(),
                               **BF16_TOL)
    dout = torch.randn((n, w), generator=g, device=dev).to(torch.bfloat16)
    dx, dbias = tfo.fused_bias_gelu_backward(s, dout, approximate=False)
    again = tfo.fused_bias_gelu_backward(s, dout, approximate=False)
    ref = tfo._gelu_bwd_math(s, dout, False)
    torch.cuda.synchronize()
    assert _rel_l2(dx, ref.to(dx.dtype)) <= GRAD_TOL[torch.bfloat16]
    assert _rel_l2(dbias, ref.sum(0)) <= GRAD_TOL[torch.float32] * 10
    assert torch.equal(dx, again[0]) and torch.equal(dbias, again[1])


def test_bert_on_the_kernels_matches_plain_route(dev):
    """A 2-layer BERT at H 256 (4 heads of 64), bf16 parameters, seq 128:
    the loss and every gradient through the kernels (fused post-LN
    epilogues, erf GeLU, non-causal flash) against the plain-torch route
    (fused_ops off, an all-ones mask: dense attention), within
    chip_smoke's training-oracle tolerances; the kernel route launches
    exactly 2 K1, 2 K2-fused, 4 K3-fwd, 4 K3-bwd, 2 K4-fwd and 2 K4-bwd."""
    from deepspeed_tpu_torch.models import bert as tbert
    cfg = dict(vocab_size=1000, hidden_size=256, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=1024,
               max_position_embeddings=128, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, bf16=True)
    kernel = tbert.BertForPreTrainingLM(tbert.BertConfig(**cfg), device=dev)
    plain = tbert.BertForPreTrainingLM(
        tbert.BertConfig(**cfg, fused_ops="off"), device=dev)
    params = {k: v.to(torch.bfloat16) for k, v in kernel.init(0).items()}
    g = _gen(dev, 16)
    ids = torch.randint(0, 1000, (4, 128), generator=g, device=dev)
    labels = torch.where(torch.rand((4, 128), generator=g, device=dev) <
                         0.15, ids, torch.full_like(ids, -100))
    batch = {"input_ids": ids, "masked_lm_labels": labels,
             "next_sentence_label": torch.tensor([0, 1, 1, 0], device=dev)}
    counters = (tfa.flash_attention_with_lse, tfa._flash_bwd_fused_launch,
                tfo.fused_bias_residual_layernorm,
                tfo.fused_bias_residual_layernorm_backward,
                tfo.fused_bias_gelu, tfo.fused_bias_gelu_backward)
    results = []
    for m, b in ((kernel, batch),
                 (plain, dict(batch, attention_mask=torch.ones_like(ids)))):
        before = [c.launches for c in counters]
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = m.loss_fn(p, b, deterministic=True)
        grads = torch.autograd.grad(loss, list(p.values()))
        results.append((loss, grads,
                        [c.launches - n for c, n in zip(counters, before)]))
    (lk, gk, nk), (lp, gp, np_) = results
    torch.cuda.synchronize()
    assert nk == [2, 2, 4, 4, 2, 2] and np_ == [0] * 6
    assert abs(float(lk) - float(lp)) <= 1e-2 * abs(float(lp))
    for name, a, b in zip(params, gk, gp):
        assert _rel_l2(a, b) <= 5e-2, name


# ----------------------------------------------------------------------
# the fp16 forms of K1-K4 (paths A, B and C's shapes)
# ----------------------------------------------------------------------
# fp16 outputs within two fp16 ulps of the twin's fp32 result (fp16
# keeps 3 more mantissa bits than bf16); gradients by relative L2
F16_TOL = dict(atol=2e-3, rtol=2e-3)
F16_GRAD_TOL = 5e-3
F16 = torch.float16


def _nonfinite_covered(got, ref):
    """Every position where the twin is non-finite is non-finite in the
    kernel's output too, and the twin has some."""
    g, r = ~torch.isfinite(got.float()), ~torch.isfinite(ref.float())
    return bool(r.any()) and bool((g | ~r).all())


@pytest.mark.parametrize("b,t,h,d,causal", [
    (16, 128, 16, 64, False),    # path A, BERT-large
    (11, 1024, 25, 64, True),    # paths B and C, gpt2-1.5b
    (2, 320, 3, 128, True),      # head dim 128, ragged last q tile
], ids=["bert", "gpt2", "d128-ragged"])
def test_fp16_flash_kernels_match_twins(dev, b, t, h, d, causal):
    """K1-fwd and K2-fused's fp16 forms (q/k/v column slices of one qkv
    tensor) against the twins; the backward twice, bit for bit; an inf in
    v (the forward) and in dO (the backward) gives non-finite values
    wherever the twin's are."""
    g = _gen(dev, 21)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(F16)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    sm = d ** -0.5
    before = tfa.flash_attention_with_lse.launches
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    ref, ref_lse = tfa._flash_fwd_plain(q, k, v, sm, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_with_lse.launches == before + 1
    assert out.dtype == F16
    torch.testing.assert_close(out.float(), ref.float(), **F16_TOL)
    torch.testing.assert_close(lse[..., 0], ref_lse, **F32_TOL)
    lse = lse[..., 0].contiguous()
    dout = torch.randn((b, t, h, d), generator=g, device=dev).to(F16)
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, None, sm,
                                       causal)
    again = tfa.flash_attention_backward(q, k, v, out, lse, dout, None, sm,
                                         causal)
    want = tfa._flash_bwd_twin(q, k, v, out, lse, dout, None, sm, causal)
    for name, x, y, z in zip("qkv", got, want, again):
        assert x.dtype == F16
        assert _rel_l2(x, y) <= F16_GRAD_TOL, name
        assert torch.equal(x, z), name
    v_inf = v.clone()
    v_inf[0, 3, 0, 1] = float("inf")
    assert _nonfinite_covered(
        tfa.flash_attention_with_lse(q, k, v_inf, causal=causal)[0],
        tfa._flash_fwd_plain(q, k, v_inf, sm, causal)[0])
    dout[0, 5, 1, 2] = float("inf")
    for x, y in zip(tfa.flash_attention_backward(q, k, v, out, lse, dout,
                                                 None, sm, causal),
                    tfa._flash_bwd_twin(q, k, v, out, lse, dout, None, sm,
                                        causal)):
        assert _nonfinite_covered(x, y)


@pytest.mark.parametrize("n,h,res_dt,out_dt,sum_dt", [
    (2048, 1024, F16, torch.float32, F16),            # A: first LN
    (2048, 1024, torch.float32, torch.float32, torch.float32),  # A: second
    (11264, 1600, F16, F16, F16),                     # B, C: in block
    (127, 1602, F16, F16, F16),                       # ragged, scalar
], ids=["bert-fp16-residual", "bert-fp32-residual", "gpt2", "ragged"])
def test_fp16_layernorm_kernels_match_twins(dev, n, h, res_dt, out_dt,
                                            sum_dt):
    """K3-fwd's and K3-bwd's fp16 forms (y fp16, fp16 vectors as the
    engine holds them) against the twins, one launch a call, the
    backward twice bit for bit; an inf in y and in dout propagates."""
    g = _gen(dev, 22)
    y = (2.0 * torch.randn((n, h), generator=g, device=dev)).to(F16)
    res = (2.0 * torch.randn((n, h), generator=g, device=dev)).to(res_dt)
    bias, beta = ((0.1 * torch.randn((h,), generator=g, device=dev))
                  .to(F16) for _ in range(2))
    gamma = (1.0 + 0.1 * torch.randn((h,), generator=g, device=dev)).to(F16)
    before = tfo.fused_bias_residual_layernorm.launches
    out, s = tfo._ln_forward(y, bias, res, gamma, beta, 1e-5, out_dt,
                             sum_dt, True)
    ref_out, ref_s = tfo._ln_fwd_math(y, bias, res, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert tfo.fused_bias_residual_layernorm.launches == before + 1
    assert out.dtype == out_dt and s.dtype == sum_dt
    for x, r in ((out, ref_out), (s, ref_s)):
        torch.testing.assert_close(
            x.float(), r.to(x.dtype).float(),
            **(F16_TOL if x.dtype == F16 else F32_TOL))
    dout = torch.randn((n, h), generator=g, device=dev).to(out_dt)
    dsum = torch.randn((n, h), generator=g, device=dev).to(sum_dt)
    got = tfo.fused_bias_residual_layernorm_backward(
        s, gamma, dout, dsum, eps=1e-5, dx_dtype=F16)
    again = tfo.fused_bias_residual_layernorm_backward(
        s, gamma, dout, dsum, eps=1e-5, dx_dtype=F16)
    ds, dg, db = tfo._ln_bwd_math(s, gamma, dout, dsum, 1e-5)
    torch.cuda.synchronize()
    assert got[0].dtype == F16
    assert _rel_l2(got[0], ds.to(F16)) <= F16_GRAD_TOL
    for x, r in zip(got[1:], (ds.sum(0), dg.sum(0), db.sum(0))):
        assert _rel_l2(x, r) <= GRAD_TOL[torch.float32] * 10
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    y[3, 7] = float("inf")
    assert _nonfinite_covered(
        tfo._ln_forward(y, bias, res, gamma, beta, 1e-5, out_dt, sum_dt,
                        True)[0],
        tfo._ln_fwd_math(y, bias, res, gamma, beta, 1e-5)[0].to(out_dt))
    dout[9, 4] = float("inf")
    got = tfo.fused_bias_residual_layernorm_backward(
        s, gamma, dout, dsum, eps=1e-5, dx_dtype=F16)
    ds, dg, _ = tfo._ln_bwd_math(s, gamma, dout, dsum, 1e-5)
    assert _nonfinite_covered(got[0], ds.to(F16))
    assert _nonfinite_covered(got[2], dg.sum(0))


@pytest.mark.parametrize("n,w,approximate", [
    (2048, 4096, False),    # path A, erf
    (11264, 6400, True),    # paths B and C, tanh
    (37, 100, True),        # ragged, scalar accesses
], ids=["bert-erf", "gpt2-tanh", "ragged"])
def test_fp16_gelu_kernels_match_twins(dev, n, w, approximate):
    """K4-fwd's and K4-bwd's fp16 forms (fp16 bias) against the twins,
    the backward twice bit for bit; an inf in x and in dout
    propagates."""
    g = _gen(dev, 23)
    x = (2.0 * torch.randn((n, w), generator=g, device=dev)).to(F16)
    bias = (0.1 * torch.randn((w,), generator=g, device=dev)).to(F16)
    out, s = tfo.fused_bias_gelu_with_sum(x, bias, approximate=approximate)
    ref_out, ref_s = tfo._gelu_fwd_math(x, bias, approximate)
    torch.testing.assert_close(out.float(), ref_out.to(F16).float(),
                               **F16_TOL)
    torch.testing.assert_close(s.float(), ref_s.to(F16).float(), **F16_TOL)
    dout = torch.randn((n, w), generator=g, device=dev).to(F16)
    dx, dbias = tfo.fused_bias_gelu_backward(s, dout,
                                             approximate=approximate)
    again = tfo.fused_bias_gelu_backward(s, dout, approximate=approximate)
    ref = tfo._gelu_bwd_math(s, dout, approximate)
    torch.cuda.synchronize()
    assert dx.dtype == F16 and dbias.dtype == torch.float32
    assert _rel_l2(dx, ref.to(F16)) <= F16_GRAD_TOL
    assert _rel_l2(dbias, ref.sum(0)) <= GRAD_TOL[torch.float32] * 10
    assert torch.equal(dx, again[0]) and torch.equal(dbias, again[1])
    x[2, 9] = float("inf")
    assert _nonfinite_covered(
        tfo.fused_bias_gelu(x, bias, approximate=approximate),
        tfo._gelu_fwd_math(x, bias, approximate)[0].to(F16))
    dout[4, 1] = float("inf")
    got = tfo.fused_bias_gelu_backward(s, dout, approximate=approximate)
    ref = tfo._gelu_bwd_math(s, dout, approximate)
    assert _nonfinite_covered(got[0], ref.to(F16))
    assert _nonfinite_covered(got[1], ref.sum(0))


def test_fp16_instantiations_do_not_spill(dev):
    """ptxas's report of every fp16 instantiation (`6__half` in the
    mangled name): K1-fwd and K5 at head dims 64 and 128 (4), K2's two
    sweeps (4) and its delta pre-pass (2), K2-fused (2), K3-fwd (its 3
    fp16 forms; 16-byte or scalar: 6), K3-bwd (its 3 fp16 forms, one
    vector a lane; 16-byte or scalar: 6), K4-fwd and K4-bwd (all fp16,
    dense or grouped; tanh or erf; 16-byte or scalar: 8), K6 with an
    fp16 output (1) and K7's four Hopper kernels (8; K7-dkv's delta
    pre-pass is K2's by name, counted once): 41 entries, none spilling.
    K8 reads its dtype at run time (no template) and K2's given-delta
    entry runs the sweeps' instantiations."""
    from deepspeed_tpu_torch.ops import _build
    _build.build_all()
    entries = {}
    for lib in ("flash_attention_fwd", "flash_attention_bwd",
                "flash_attention_bwd_fused", "fused_ln_fwd", "fused_ln_bwd",
                "fused_gelu_fwd", "fused_gelu_bwd",
                "block_sparse_attention", "quantized_matmul"):
        name = None
        for line in _build.build_log(lib).splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "6__half" in line else None
            elif name is not None and "spill stores" in line:
                entries[name] = line.strip()
                name = None
    assert len(entries) == 41, sorted(entries)
    spilled = {k: v for k, v in entries.items()
               if "0 bytes spill stores" not in v}
    assert not spilled, spilled


def test_fp16_kernels_refuse_what_they_do_not_take(dev):
    """No launch mixes bf16 and fp16; the fp16 forms on no model's path
    raise naming their ROADMAP Queue 2 item (K3-bwd above H 3584: item 6;
    head dim 256: item 7); K8 and K6 refuse a dtype they do not take;
    nothing falls back to a twin."""
    g = _gen(dev, 24)
    y = torch.randn((4, 64), generator=g, device=dev).to(F16)
    ones = torch.ones(64, device=dev, dtype=F16)
    with pytest.raises(TypeError, match="residual"):
        tfo.fused_bias_residual_layernorm(y, ones, y.to(torch.bfloat16),
                                          ones, ones)
    with pytest.raises(TypeError, match="forms"):    # no path's pairing
        tfo.fused_bias_residual_layernorm(y, ones, y, ones, ones,
                                          sum_dtype=torch.float32)
    wide = torch.zeros((4, 4096), device=dev, dtype=F16)
    v = torch.ones(4096, device=dev, dtype=F16)
    with pytest.raises(NotImplementedError, match="Queue 2 item 6"):
        tfo.fused_bias_residual_layernorm_backward(wide, v, wide, wide,
                                                   dx_dtype=F16)
    with pytest.raises(TypeError, match="out"):
        tfo.fused_bias_gelu(y, ones, out_dtype=torch.float32)
    with pytest.raises(TypeError, match="bias"):    # grouped: no bf16 bias
        tfo.fused_bias_gelu(torch.zeros((8, 64), device=dev, dtype=F16),
                            torch.ones((2, 64), device=dev,
                                       dtype=torch.bfloat16))
    q = torch.zeros((1, 128, 2, 256), device=dev, dtype=F16)
    with pytest.raises(NotImplementedError, match="Queue 2 item 7"):
        tfa.flash_attention_with_lse(q, q, q, causal=True)
    tfd = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")
    with pytest.raises(TypeError, match="float16"):
        tfd.gather_rows(torch.zeros((4, 64), device=dev, dtype=torch.float64),
                        torch.zeros(4, device=dev, dtype=torch.int32))
    qm = _qm()
    with pytest.raises(TypeError, match="float16"):
        qm._qmm(torch.zeros((1, 64, 128), device=dev, dtype=torch.int8),
                torch.zeros((1, 128, 64), device=dev, dtype=torch.int8),
                torch.ones((1, 64, 1), device=dev),
                torch.ones((1, 1, 64), device=dev), 128, torch.float64)


def test_fp16_engine_skips_bit_for_bit_on_the_card(dev):
    """A 2-layer gpt2 (H 256, 4 heads of 64) in fp16 on the kernels: a
    step whose gradients overflow (a static scale of 2^40) leaves every
    parameter, master and moment bit for bit, with no host read in the
    update; the counters count it."""
    import deepspeed_tpu_torch as dst
    cfg = tgpt2.gpt2_config("gpt2-125m", vocab_size=1000, n_positions=256,
                            n_layer=2, n_embd=256, n_head=4, dropout=0.0,
                            dtype=F16)
    model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
    engine = dst.initialize(model=model, model_parameters=model.init(0),
                            config={"train_micro_batch_size_per_gpu": 4,
                                    "fp16": {"enabled": True,
                                             "loss_scale": 2 ** 40},
                                    "optimizer": {"type": "Lamb",
                                                  "params": {"lr": 1e-3}}})[0]
    ids = torch.randint(0, 1000, (1, 4, 256), generator=_gen(dev, 25),
                        device=dev)
    staged = engine.stage_batch({"input_ids": ids})
    state = engine.state
    before = [t.clone() for t in list(state.params.values()) + state.master +
              engine._state_tensors(state.opt_state)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.train_batch(batch=staged)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = list(state.params.values()) + state.master + \
        engine._state_tensors(state.opt_state)
    for a, b in zip(before, after):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    assert engine.skipped_steps == 1 and int(state.global_steps) == 0


# ----------------------------------------------------------------------
# K2-fused: the one-pass backward at T <= 1024, and K7's fp16 forms
# ----------------------------------------------------------------------
def _fused_inputs(dev, b, t, h, d, dtype, causal, seed):
    """q/k/v (qkv column slices), K1's (out, lse) on them, dO and an lse
    cotangent."""
    g = _gen(dev, seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    out, lse = tfa._flash_fwd_launch(q, k, v, d ** -0.5, causal)
    dout = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    dlse = torch.randn((b, h, t), generator=g, device=dev)
    return q, k, v, out, lse, dout, dlse


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, F16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [64, 128, 192, 512, 640, 1024])
def test_fused_backward_kernel_matches_twin(dev, t, d, dtype, causal):
    """K2-fused against `_flash_bwd_fused_plain` with an lse cotangent:
    1 key block (T 64, 128), 2 (T 192: a ragged last key block of 64
    rows), 4, 5 (causal at head dim 64: an odd cluster's middle CTA) and
    8; one launch a call, none of the sweeps', and a second launch equal
    to the first bit for bit (every dQ row summed in one fixed order)."""
    q, k, v, out, lse, dout, dlse = _fused_inputs(dev, 2, t, 3, d, dtype,
                                                  causal, seed=t + d)
    sm = d ** -0.5
    before = (tfa._flash_bwd_fused_launch.launches,
              tfa.flash_attention_backward.launches)
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, dlse, sm,
                                       causal)
    again = tfa.flash_attention_backward(q, k, v, out, lse, dout, dlse, sm,
                                         causal)
    ref = tfa._flash_bwd_fused_plain(q, k, v, out, lse, dout, dlse, sm,
                                     causal)
    torch.cuda.synchronize()
    assert (tfa._flash_bwd_fused_launch.launches,
            tfa.flash_attention_backward.launches) == (before[0] + 2,
                                                       before[1])
    tol = GRAD_TOL[dtype] if dtype == torch.bfloat16 else F16_GRAD_TOL
    for name, x, y, z in zip("qkv", got, ref, again):
        assert x.dtype == dtype and x.shape == q.shape
        assert _rel_l2(x, y) <= tol, name
        assert torch.equal(x, z), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, F16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("t", [896, 1000])
def test_fused_backward_seven_and_eight_key_blocks(dev, t, dtype):
    """K2-fused causal at head dim 64 on 7 key blocks (T 896: the middle
    one alone in its CTA) and 8 (T 1000: the last key block 104 rows, the
    last q step 40, T no multiple of 64), against the twin from the
    forward twin's (out, lse), with an lse cotangent; one launch a call,
    a second launch equal to the first bit for bit."""
    g = _gen(dev, t)
    b, h, d = 2, 3, 64
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    out, lse = tfa._flash_fwd_plain(q, k, v, d ** -0.5, True)
    dout = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    dlse = torch.randn((b, h, t), generator=g, device=dev)
    before = tfa._flash_bwd_fused_launch.launches
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, dlse)
    again = tfa.flash_attention_backward(q, k, v, out, lse, dout, dlse)
    ref = tfa._flash_bwd_fused_plain(q, k, v, out, lse, dout, dlse,
                                     d ** -0.5, True)
    torch.cuda.synchronize()
    assert tfa._flash_bwd_fused_launch.launches == before + 2
    tol = GRAD_TOL[dtype] if dtype == torch.bfloat16 else F16_GRAD_TOL
    for name, x, y, z in zip("qkv", got, ref, again):
        assert x.dtype == dtype and x.shape == q.shape
        assert _rel_l2(x, y) <= tol, name
        assert torch.equal(x, z), name


def test_fused_backward_five_launches_bit_for_bit_at_flagship_heads(dev):
    """Five back-to-back K2-fused launches at the training flagship's
    shape ([11, 1024, 25, 64] bf16 causal: 275 clusters of 4 CTAs) give
    the same dq, dk and dv bit for bit: a race in the ordered dQ adds
    would show as a rare mismatch."""
    q, k, v, out, lse, dout, _ = _fused_inputs(dev, 11, 1024, 25, 64,
                                               torch.bfloat16, True,
                                               seed=31)
    runs = [tfa.flash_attention_backward(q, k, v, out, lse, dout)
            for _ in range(5)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for name, x, y in zip("qkv", runs[0], run):
            assert torch.equal(x, y), name
    assert all(torch.isfinite(x).all() for x in runs[0])


@pytest.mark.parametrize("t,causal", [(256, True), (128, False),
                                      (1024, True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, F16], ids=["bf16", "fp16"])
def test_fused_backward_inf_reaches_what_the_twin_reaches(dev, dtype, t,
                                                          causal):
    """An inf in dO gives non-finite dq, dk and dv wherever the twin's
    are (the warpgroups that skip a step above the diagonal skip it in
    the twin too)."""
    q, k, v, out, lse, dout, _ = _fused_inputs(dev, 2, t, 3, 64, dtype,
                                               causal, seed=5)
    dout[0, t // 2 + 3, 1, 2] = float("inf")
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, None,
                                       0.125, causal)
    ref = tfa._flash_bwd_fused_plain(q, k, v, out, lse, dout, None, 0.125,
                                     causal)
    torch.cuda.synchronize()
    for name, x, y in zip("qkv", got, ref):
        assert _nonfinite_covered(x, y), name


@pytest.mark.parametrize("t", [128, 384, 1024])
def test_fused_backward_given_delta_matches_twin(dev, t):
    """K2-fused's given-delta entry (K5's backward, bf16): no out, the
    caller's delta read and left as it was, against the twin; two
    launches bit for bit."""
    q, k, v, _, lse, dout, dlse = _fused_inputs(dev, 2, t, 3, 64,
                                                torch.bfloat16, True,
                                                seed=7)
    delta = torch.randn((2, 3, t), generator=_gen(dev, 8), device=dev)
    keep = delta.clone()
    runs = [tfa.flash_attention_backward(q, k, v, None, lse, dout, dlse,
                                         0.125, True, delta=delta)
            for _ in range(2)]
    ref = tfa._flash_bwd_fused_plain(q, k, v, None, lse, dout, dlse, 0.125,
                                     True, delta=delta)
    torch.cuda.synchronize()
    assert torch.equal(delta, keep)
    for name, x, y, z in zip("qkv", runs[0], ref, runs[1]):
        assert _rel_l2(x, y) <= GRAD_TOL[torch.bfloat16], name
        assert torch.equal(x, z), name


def test_backward_routes_fused_up_to_t_1024(dev):
    """The JAX package's routing: a sequence that is one tile of the
    1024-row default block (T 1024) launches K2-fused, T 2048 the
    sweeps; fp32 and head dim 256 keep the sweeps at T 256."""
    cases = ((1024, 64, torch.bfloat16, True), (2048, 64, torch.bfloat16,
                                                 False),
             (256, 64, torch.float32, False), (256, 256, torch.bfloat16,
                                               False))
    for t, d, dtype, fused in cases:
        q, k, v, out, lse, dout, _ = _fused_inputs(dev, 1, t, 2, d, dtype,
                                                   True, seed=9)
        before = (tfa._flash_bwd_fused_launch.launches,
                  tfa.flash_attention_backward.launches)
        tfa.flash_attention_backward(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        moved = (tfa._flash_bwd_fused_launch.launches - before[0],
                 tfa.flash_attention_backward.launches - before[1])
        assert moved == ((1, 0) if fused else (0, 1)), (t, d, dtype)


# K2's sweeps (`_flash_bwd_launch`, called directly): the route sends
# them every backward past T 1024 (the ring leg's 8k and 32k, the
# emulated ring's folds), so they are held here at the shapes the
# earlier tests held them at before T <= 1024 went to K2-fused
SWEEP_CASES = [
    # (dtype, causal, head dim, T)
    (torch.bfloat16, True, 64, 256), (torch.bfloat16, False, 64, 256),
    (torch.bfloat16, True, 128, 256),
    (torch.bfloat16, True, 64, 320),     # ragged last 128-row tile
    (torch.bfloat16, False, 128, 320),
    (F16, False, 64, 128),               # path A's form, BERT-large
    (F16, True, 64, 1024),               # paths B and C's form, gpt2
    (F16, True, 128, 320),
]


@pytest.mark.parametrize("dtype,causal,d,t", SWEEP_CASES)
def test_sweeps_backward_matches_plain(dev, dtype, causal, d, t):
    """K2's sweeps against `_flash_bwd_plain` on K1's own (out, lse),
    with and without an lse cotangent, q/k/v as qkv column slices: one
    launch a call on `flash_attention_backward.launches`, a second launch
    equal to the first bit for bit (every output row owned by one CTA),
    and in fp16 an inf in dO reaching every output the twin's reaches."""
    q, k, v, out, lse, dout, dlse = _fused_inputs(dev, 2, t, 3, d, dtype,
                                                  causal, seed=t + d + 1)
    sm = d ** -0.5
    tol = GRAD_TOL.get(dtype, F16_GRAD_TOL)
    for dl in (dlse, None):
        before = (tfa._flash_bwd_fused_launch.launches,
                  tfa.flash_attention_backward.launches)
        runs = [tfa._flash_bwd_launch(q, k, v, out, lse, dout, dl, sm,
                                      causal) for _ in range(2)]
        ref = tfa._flash_bwd_plain(q, k, v, out, lse, dout, dl, sm, causal)
        torch.cuda.synchronize()
        assert (tfa._flash_bwd_fused_launch.launches,
                tfa.flash_attention_backward.launches) == (before[0],
                                                           before[1] + 2)
        for name, x, y, z in zip("qkv", runs[0], ref, runs[1]):
            assert x.dtype == dtype and x.shape == q.shape
            assert _rel_l2(x, y) <= tol, (name, dl is None)
            assert torch.equal(x, z), (name, dl is None)
    if dtype == F16:
        dout[0, t // 2 + 3, 1, 2] = float("inf")
        got = tfa._flash_bwd_launch(q, k, v, out, lse, dout, None, sm,
                                    causal)
        ref = tfa._flash_bwd_plain(q, k, v, out, lse, dout, None, sm, causal)
        torch.cuda.synchronize()
        for name, x, y in zip("qkv", got, ref):
            assert _nonfinite_covered(x, y), name


@pytest.mark.parametrize("t", [256, 320])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sweeps_given_delta_matches_plain(dev, dtype, t):
    """K2's sweeps' given-delta entry (no out; K5's backward past T
    1024) against `_flash_bwd_plain` with the same delta: the caller's
    delta left as it was, two launches bit for bit."""
    q, k, v, _, lse, dout, dlse = _fused_inputs(dev, 2, t, 3, 64, dtype,
                                                True, seed=t + 2)
    delta = torch.randn((2, 3, t), generator=_gen(dev, 8), device=dev)
    keep = delta.clone()
    runs = [tfa._flash_bwd_launch(q, k, v, None, lse, dout, dlse, 0.125,
                                  True, delta=delta) for _ in range(2)]
    ref = tfa._flash_bwd_plain(q, k, v, None, lse, dout, dlse, 0.125, True,
                               delta=delta)
    torch.cuda.synchronize()
    assert torch.equal(delta, keep)
    for name, x, y, z in zip("qkv", runs[0], ref, runs[1]):
        assert _rel_l2(x, y) <= GRAD_TOL[dtype], name
        assert torch.equal(x, z), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, F16], ids=["bf16", "fp16"])
def test_backward_past_t_1024_matches_plain(dev, dtype):
    """The public backward at T 2048 (the sweeps' route) against
    `_flash_bwd_plain`, with an lse cotangent, causal and not; in bf16
    and fp16 also K5's backward (the sweeps' given-delta entry) through
    autograd against the same function on CPU copies."""
    for causal in (True, False):
        q, k, v, out, lse, dout, dlse = _fused_inputs(dev, 1, 2048, 2, 64,
                                                      dtype, causal, seed=3)
        before = tfa.flash_attention_backward.launches
        got = tfa.flash_attention_backward(q, k, v, out, lse, dout, dlse,
                                           0.125, causal)
        ref = tfa._flash_bwd_plain(q, k, v, out, lse, dout, dlse, 0.125,
                                   causal)
        torch.cuda.synchronize()
        assert tfa.flash_attention_backward.launches == before + 1
        for name, x, y in zip("qkv", got, ref):
            assert _rel_l2(x, y) <= GRAD_TOL.get(dtype, F16_GRAD_TOL), name
    q, k, v, prev, prev_lse = _merge_inputs(dev, dtype, 64, True, seed=4,
                                            b=1, t=2048, h=2)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (q, k, v, prev, prev_lse)]
    cpu = [x.detach().cpu().requires_grad_(True) for x in leaves]
    gen = _gen(dev, 98)
    g_out = torch.randn(q.shape, generator=gen, device=dev)
    g_lse = torch.randn(prev_lse.shape, generator=gen, device=dev)
    before = tfa.flash_attention_backward.launches
    o, l = tfa.flash_attention_merge(*leaves, causal=True)
    got = torch.autograd.grad((o, l), leaves, (g_out, g_lse))
    o_c, l_c = tfa.flash_attention_merge(*cpu, causal=True)
    want = torch.autograd.grad((o_c, l_c), cpu, (g_out.cpu(), g_lse.cpu()))
    torch.cuda.synchronize()
    assert tfa.flash_attention_backward.launches == before + 1
    for name, x, y in zip(("dq", "dk", "dv", "dprev", "dprev_lse"), got,
                          want):
        assert torch.isfinite(x).all(), name
        assert _rel_l2(x, y.to(dev)) <= GRAD_TOL.get(dtype, F16_GRAD_TOL), \
            name


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("block", [16, 64, 256])
def test_fp16_block_sparse_kernels_match_twins(dev, block, causal, d):
    """K7's fp16 forms (the Hopper K7-band, K7-fwd, K7-dkv and K7-dq on
    `__half`) against their twins on Fixed, BSLongformer and BigBird
    layouts, within the fp16 tolerances; both forward kernels run."""
    t = max(512, 8 * block)
    routes = set()
    for i, layout in enumerate(_sparse_layouts(4, t, block, causal)):
        plan = _k7_case(dev, layout, block, causal, F16, d, seed=40 + i)
        routes.add(plan.band is not None)
    assert routes == {True, False}


def test_fp16_block_sparse_route_matches_dense_fallback(dev):
    """The public route in fp16 (SparseSelfAttention's call) launches the
    Hopper kernels, never the WMMA ones, and its output and gradients
    match the dense masked fallback in fp32; the WMMA route refuses
    fp16."""
    layout = tsa.BSLongformerSparsityConfig(
        num_heads=2, block=64, num_sliding_window_blocks=3).make_layout(1024)
    g = _gen(dev, 41)
    q, k, v = (torch.randn((2, 1024, 2, 64), generator=g, device=dev)
               .to(F16).requires_grad_(True) for _ in range(3))
    dout = torch.randn((2, 1024, 2, 64), generator=g, device=dev).to(F16)
    counts = [f.launches for f in _bwd_launches(True) + _bwd_launches(False)]
    out = tsa.block_sparse_attention(q, k, v, layout, 64, causal=True)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    moved = [f.launches - c for f, c in
             zip(_bwd_launches(True) + _bwd_launches(False), counts)]
    assert moved == [1, 1, 0, 0]
    f32 = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    ref = tbsa.block_sparse_attention_dense_fallback(*f32, layout, 64,
                                                     causal=True)
    torch.testing.assert_close(out.float(), ref.detach(), **F16_TOL)
    want = torch.autograd.grad(ref, f32, dout.float())
    for x, y in zip(got, want):
        assert x.dtype == F16 and _rel_l2(x, y) <= F16_GRAD_TOL
    plan = tbsa._plan(layout, True, 64, (tbsa.TILE, tbsa.TILE), dev)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        tbsa._band_fwd_launch(q.detach(), k.detach(), v.detach(), plan, 0.125)


# ----------------------------------------------------------------------
# the fp16 forms of K8, grouped K4, K6 (fp16 out) and K5 (with K2's
# given-delta entry), beside their bf16 forms
# ----------------------------------------------------------------------
# a 16-bit combine row is one rounding of the twin's fp32 sum: within
# one ulp of its dtype (2^-8 bf16, 2^-10 fp16; the atol covers fp16's
# subnormals)
K8_TOL = {torch.bfloat16: dict(atol=1e-30, rtol=2 ** -8),
          F16: dict(atol=2 ** -24, rtol=2 ** -10)}


def _nonfinite_equal(got, ref):
    """The kernel's output is non-finite at exactly the twin's non-finite
    positions, and the twin has some."""
    g, r = ~torch.isfinite(got.float()), ~torch.isfinite(ref.float())
    return bool(r.any()) and torch.equal(g, r)


@pytest.mark.parametrize("k,cf", [(2, 1.25), (2, 0.5)])
@pytest.mark.parametrize("h", [1024, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, F16], ids=["bf16", "fp16"])
def test_fp16_moe_dispatch_combine_kernels_match_twins(dev, dtype, h, k, cf):
    """K8 in bf16 and fp16 side by side against the twins at gpt2-350m-
    moe8's width (H 1024, 16-byte vectors) and H 100 (the scalar path),
    with empty slots (cf 1.25) and drops (cf 0.5): dispatch and the
    weighted gather exactly, combine within one ulp, a second combine
    bit for bit; an inf in a token row reaches exactly the slots and
    tokens the twin's reaches; an fp16 combine whose sum passes 65504 is
    inf where the twin's is."""
    tfd = importlib.import_module("deepspeed_tpu_torch.moe.fused_dispatch")
    n, e = 512, 8
    routing, stats, src, dest, cap = _routing(dev, n, e, k, cf, 30)
    g = _gen(dev, 31)
    x = torch.randn((n, h), generator=g, device=dev).to(dtype)
    before = (tfd.gather_rows.launches, tfd.combine_rows.launches)
    xe = tfd.gather_rows(x, src)
    assert xe.dtype == dtype and torch.equal(xe,
                                             tfd._gather_rows_plain(x, src))
    sw = torch.rand((e * cap,), generator=g, device=dev)
    assert torch.equal(tfd.gather_rows(x, src, sw),
                       tfd._gather_rows_plain(x, src, sw))
    ye = torch.randn((e * cap, h), generator=g, device=dev).to(dtype)
    cw = (routing["keep"] * routing["w"]).float()
    y = tfd.combine_rows(ye, dest, cw)
    ref = tfd._combine_rows_plain(ye, dest, cw)
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), ref.float(), **K8_TOL[dtype])
    assert torch.equal(y, tfd.combine_rows(ye, dest, cw))
    # an inf token row: the slots it fills, then the tokens summing them
    x_inf = x.clone()
    x_inf[int(src[src < n][0])] = float("inf")
    xe_inf = tfd.gather_rows(x_inf, src)
    assert torch.equal(~torch.isfinite(xe_inf.float()),
                       ~torch.isfinite(tfd._gather_rows_plain(
                           x_inf, src).float()))
    y_inf = tfd.combine_rows(xe_inf, dest, cw)
    assert _nonfinite_equal(y_inf, tfd._combine_rows_plain(xe_inf, dest,
                                                           cw))
    torch.cuda.synchronize()
    assert (tfd.gather_rows.launches - before[0],
            tfd.combine_rows.launches - before[1]) == (3, 3)
    if dtype == F16:
        big = torch.full((e * cap, h), 40000.0, device=dev, dtype=F16)
        ones = torch.ones_like(cw)
        got = tfd.combine_rows(big, dest, ones)
        want = tfd._combine_rows_plain(big, dest, ones)
        assert bool(torch.isinf(want).all()) and torch.equal(got, want)


@pytest.mark.parametrize("rows,w", [(160, 4096), (37, 4096), (37, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, F16], ids=["bf16", "fp16"])
def test_fp16_grouped_gelu_kernels_match_twins(dev, dtype, rows, w):
    """Grouped K4 (8 experts, a bias [8, W] and dbias [8, W], as the fp16
    MoE experts run it: x, bias, out, s, dout and dx in the one dtype) in
    bf16 and fp16 against the twins: 37 rows a group end their last row
    run early, W 100 takes the scalar accesses; forward and backward
    twice bit for bit; an inf in x and in dout reaches what the twin's
    reaches (dbias included); each call counts one grouped launch."""
    g = _gen(dev, 32)
    groups = 8
    x = torch.randn((groups, rows, w), generator=g, device=dev).to(dtype)
    bias = (0.1 * torch.randn((groups, w), generator=g, device=dev)).to(
        dtype)
    before = (tfo.fused_bias_gelu.grouped_launches,
              tfo.fused_bias_gelu_backward.grouped_launches)
    out, s = tfo.fused_bias_gelu_with_sum(x, bias, approximate=True)
    ref, ref_s = tfo._gelu_fwd_math(x, bias, True)
    tol = BF16_TOL if dtype == torch.bfloat16 else F16_TOL
    torch.testing.assert_close(out.float(), ref.to(dtype).float(), **tol)
    torch.testing.assert_close(s.float(), ref_s.to(dtype).float(), **tol)
    dout = torch.randn(x.shape, generator=g, device=dev).to(dtype)
    dx, dbias = tfo.fused_bias_gelu_backward(s, dout, approximate=True,
                                             groups=groups)
    d = tfo._gelu_bwd_math(s, dout, True)
    assert dx.dtype == dtype and dbias.dtype == torch.float32
    assert _rel_l2(dx, d.to(dtype)) <= GRAD_TOL.get(dtype, F16_GRAD_TOL)
    assert _rel_l2(dbias, d.sum(1)) <= GRAD_TOL[torch.float32] * 10
    again = tfo.fused_bias_gelu_backward(s, dout, approximate=True,
                                         groups=groups)
    assert torch.equal(dx, again[0]) and torch.equal(dbias, again[1])
    fwd_again = tfo.fused_bias_gelu_with_sum(x, bias, approximate=True)
    assert torch.equal(out, fwd_again[0]) and torch.equal(s, fwd_again[1])
    x_inf = x.clone()
    x_inf[3, 5, 7] = float("inf")
    assert _nonfinite_equal(
        tfo.fused_bias_gelu(x_inf, bias, approximate=True),
        tfo._gelu_fwd_math(x_inf, bias, True)[0].to(dtype))
    d_inf = dout.clone()
    d_inf[5, 2, 1] = float("inf")
    got = tfo.fused_bias_gelu_backward(s, d_inf, approximate=True,
                                       groups=groups)
    want = tfo._gelu_bwd_math(s, d_inf, True)
    for a, b in ((got[0], want.to(dtype)), (got[1], want.sum(1))):
        assert _nonfinite_covered(a, b)
    torch.cuda.synchronize()
    assert (tfo.fused_bias_gelu.grouped_launches - before[0],
            tfo.fused_bias_gelu_backward.grouped_launches - before[1]) == \
        (3, 3)


@pytest.mark.parametrize("g,m,k,n", [
    (1, 300, 1600, 520),      # partial last block, ragged M and N
    (3, 77, 384, 200),        # grouped, ragged
    (1, 16384, 1024, 3072),   # gpt2-350m-moe8's c_attn
    (1, 16384, 4096, 1024),   # its mlp_c_proj
    (8, 2560, 1024, 4096),    # its experts' wi (capacity 2,560)
    (8, 2560, 4096, 1024),    # and wo
])
def test_fp16_quantized_matmul_kernel_matches_twin(dev, g, m, k, n):
    """K6 with an fp16 output equals its twin bit for bit (the same fp32
    sum, one rounding), and so does its bf16 output on the same
    operands; scaled up past 65504 the fp16 output is inf exactly where
    the twin's is, finite elsewhere."""
    qm = _qm()
    gen = _gen(dev, 33)
    x = torch.randn((g, m, k), generator=gen, device=dev) * 3.0
    w = torch.randn((g, k, n), generator=gen, device=dev) * 0.05
    wq, sw = qm.quantize_kernel_int8(w, 128)
    xq, sx = qm.quantize_rows_int8(x)
    xq = torch.nn.functional.pad(xq, (0, wq.shape[-2] - k)).contiguous()
    before = qm.quantized_matmul.launches
    for dtype in (torch.bfloat16, F16):
        got = qm._qmm(xq, wq, sx, sw, 128, dtype)
        ref = qm._qmm_plain(xq, wq, sx, sw, 128, dtype)
        assert got.dtype == dtype and got.shape == (g, m, n)
        assert torch.equal(got, ref)
    big = sx * 20000.0
    got = qm._qmm(xq, wq, big, sw, 128, F16)
    ref = qm._qmm_plain(xq, wq, big, sw, 128, F16)
    torch.cuda.synchronize()
    assert qm.quantized_matmul.launches == before + 3
    assert bool(torch.isinf(ref).any()) and bool(torch.isfinite(ref).any())
    assert torch.equal(got, ref)


def test_fp16_quantized_dense_overflow_reaches_the_loss_scaler(dev):
    """An fp16 quantized projection whose product passes 65504 gives inf
    in the forward (as JAX's astype does), and its straight-through
    backward of an inf cotangent gives non-finite dx and dW, which the
    fp16 engine's overflow vote reads."""
    qm = _qm()
    gen = _gen(dev, 34)
    x = (300.0 * torch.randn((64, 1024), generator=gen, device=dev)).to(F16)
    w = (3.0 * torch.randn((1024, 256), generator=gen, device=dev)).to(F16)
    y = qm.quantized_dense(x, w, block=128)
    assert y.dtype == F16 and bool(torch.isinf(y).any())
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    y = qm.quantized_dense(xr / 300.0, wr, block=128)
    dy = torch.zeros_like(y)
    dy[3, 4] = float("inf")
    dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    assert not bool(torch.isfinite(dx).all())
    assert not bool(torch.isfinite(dw).all())


@pytest.mark.parametrize("t", [256, 320])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_fp16_merge_kernel_matches_twin(dev, d, causal, t):
    """K5 in fp16 (and bf16 on the same values, side by side) against
    the twin: out (fp32), merged lse and lse_n; T 320 ends in a ragged
    128-row q tile; a second launch bit for bit; an inf in v reaches
    exactly the rows the twin's reaches; then the backward through
    autograd (K2-fused's given-delta entry at T <= 1024) against the
    same function on CPU copies, with one K5 launch a call and one
    K2-fused launch a backward."""
    q, k, v, prev, prev_lse = _merge_inputs(dev, F16, d, causal, seed=d + t,
                                            t=t)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (F16, F16_TOL)):
        qx, kx, vx = (x.to(dtype) for x in (q, k, v))
        before = tfa.flash_attention_merge.launches
        got = tfa._flash_merge_launch(qx, kx, vx, prev, prev_lse[..., 0],
                                      d ** -0.5, causal)
        ref = tfa._flash_merge_plain(qx, kx, vx, prev, prev_lse[..., 0],
                                     d ** -0.5, causal)
        torch.testing.assert_close(got[0], ref[0], **tol)
        torch.testing.assert_close(got[1], ref[1], **F32_TOL)
        torch.testing.assert_close(got[2], ref[2], **F32_TOL)
        again = tfa._flash_merge_launch(qx, kx, vx, prev, prev_lse[..., 0],
                                        d ** -0.5, causal)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        torch.cuda.synchronize()
        assert tfa.flash_attention_merge.launches == before + 2
    v_inf = v.clone()
    v_inf[1, 9, 2, 5] = float("inf")
    assert _nonfinite_equal(
        tfa._flash_merge_launch(q, k, v_inf, prev, prev_lse[..., 0],
                                d ** -0.5, causal)[0],
        tfa._flash_merge_plain(q, k, v_inf, prev, prev_lse[..., 0],
                               d ** -0.5, causal)[0])

    leaves = [x.detach().clone().requires_grad_(True)
              for x in (q, k, v, prev, prev_lse)]
    cpu = [x.detach().cpu().requires_grad_(True) for x in leaves]
    gen = _gen(dev, 97)
    g_out = torch.randn(q.shape, generator=gen, device=dev)
    g_lse = torch.randn(prev_lse.shape, generator=gen, device=dev)
    before = (tfa.flash_attention_merge.launches,
              tfa._flash_bwd_fused_launch.launches)
    o, l = tfa.flash_attention_merge(*leaves, causal=causal)
    got = torch.autograd.grad((o, l), leaves, (g_out, g_lse))
    o_c, l_c = tfa.flash_attention_merge(*cpu, causal=causal)
    want = torch.autograd.grad((o_c, l_c), cpu, (g_out.cpu(), g_lse.cpu()))
    torch.cuda.synchronize()
    assert (tfa.flash_attention_merge.launches,
            tfa._flash_bwd_fused_launch.launches) == (before[0] + 1,
                                                     before[1] + 1)
    for name, x, y in zip(("dq", "dk", "dv", "dprev", "dprev_lse"), got,
                          want):
        assert x.dtype == y.dtype, name
        assert torch.isfinite(x).all(), name
        assert _rel_l2(x, y.to(dev)) <= F16_GRAD_TOL, name


@pytest.mark.parametrize("t", [1024, 2048])
def test_fp16_given_delta_backward_repeats_and_carries_inf(dev, t):
    """K2's given-delta entry in fp16 on both routes (K2-fused at T 1024,
    the sweeps at T 2048) beside bf16 on the same values: against the
    twin, a second launch bit for bit, and an inf in dO reaching what the
    twin's reaches."""
    q, k, v, _, lse, dout, dlse = _fused_inputs(dev, 1, t, 2, 64, F16, True,
                                                seed=35)
    delta = torch.randn((1, 2, t), generator=_gen(dev, 36), device=dev)
    counter = _k2_counter(q)
    before = counter.launches
    for dtype in (torch.bfloat16, F16):
        qx, kx, vx, dx = (x.to(dtype) for x in (q, k, v, dout))
        got = tfa.flash_attention_backward(qx, kx, vx, None, lse, dx, dlse,
                                           0.125, True, delta=delta)
        ref = tfa._flash_bwd_twin(qx, kx, vx, None, lse, dx, dlse, 0.125,
                                  True, delta=delta)
        for name, a, b in zip("qkv", got, ref):
            assert a.dtype == dtype
            assert _rel_l2(a, b) <= GRAD_TOL.get(dtype, F16_GRAD_TOL), name
        again = tfa.flash_attention_backward(qx, kx, vx, None, lse, dx,
                                             dlse, 0.125, True, delta=delta)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    d_inf = dout.clone()
    d_inf[0, 100, 1, 3] = float("inf")
    got = tfa.flash_attention_backward(q, k, v, None, lse, d_inf, dlse, 0.125,
                                       True, delta=delta)
    ref = tfa._flash_bwd_twin(q, k, v, None, lse, d_inf, dlse, 0.125, True,
                              delta=delta)
    for a, b in zip(got, ref):
        assert _nonfinite_covered(a, b)
    torch.cuda.synchronize()
    assert counter.launches == before + 5


def _chip_smoke():
    """chip_smoke.py at the repository root: the launch formulas and
    counters its fp16 paths hold the card to."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["moe", "moe_quantized"])
def test_fp16_moe_engine_step_launches_exactly(dev, quantized):
    """A 4-layer MoE GPT-2 (two MoE layers, 8 experts, top-2, capacity
    1.25) at gpt2-350m's width in fp16 with fp32 masters, through
    initialize -> train_batch (with the quantized_compute block and
    quantized experts when `quantized`): finite losses, and per step
    exactly chip_smoke's `moe_fp16_launches` of every fp16 kernel form
    (paths D and E's formula, at 4 layers)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.moe import MoEConfig
    moe = MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                    every_n_layers=2,
                    quantized_experts="on" if quantized else "off")
    cfg = tgpt2.gpt2_config("gpt2-350m", n_layer=4, vocab_size=1024,
                            n_positions=512, dropout=0.0, dtype=F16,
                            remat=True, remat_policy=None,
                            moe=moe.validate())
    model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
    config = {"train_micro_batch_size_per_gpu": 4,
              "fp16": {"enabled": True, "initial_scale_power": 16},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
              "moe": {"enabled": True, "num_experts": 8,
                      "every_n_layers": 2}}
    if quantized:
        config["quantized_compute"] = {"enabled": True, "mode": "on"}
    engine = dst.initialize(model=model, model_parameters=model.init(0),
                            config=config)[0]
    ids = torch.randint(0, 1024, (1, 4, 512), generator=_gen(dev, 37),
                        device=dev)
    staged = engine.stage_batch({"input_ids": ids})
    cs = _chip_smoke()
    engine.train_batch(batch=staged)
    torch.cuda.synchronize()
    before = cs.read_counts()
    losses = [engine.train_batch(batch=staged) for _ in range(2)]
    torch.cuda.synchronize()
    after = cs.read_counts()
    assert all(bool(torch.isfinite(x)) for x in losses)
    want = cs.moe_fp16_launches(cfg.n_layer, quantized)
    got = {k: (after[k] - before[k]) / 2 for k in want}
    assert got == {k: float(v) for k, v in want.items()}


def test_fp16_ring_engine_step_launches_exactly(dev, tmp_path):
    """A 2-layer GPT-2 at gpt2-1.5b's width in fp16 with sequence_parallel
    "ring" over a one-rank NCCL group: each step launches K5 twice a
    layer (forward and recompute; no K1) and K2-fused's given-delta
    entry once a layer, with finite losses."""
    import deepspeed_tpu_torch as dst
    cfg = tgpt2.gpt2_config("gpt2-1.5b", n_layer=2, vocab_size=1024,
                            n_positions=1024, dropout=0.0, dtype=F16,
                            remat=True, remat_policy=None,
                            sequence_parallel="ring")
    torch.cuda.set_device(0)
    dst.init_distributed("nccl", init_method="file://" + str(
        tmp_path / "rendezvous"), rank=0, world_size=1, verbose=False)
    try:
        model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
        engine = dst.initialize(
            model=model, model_parameters=model.init(0),
            config={"train_micro_batch_size_per_gpu": 2,
                    "fp16": {"enabled": True, "initial_scale_power": 16},
                    "optimizer": {"type": "AdamW",
                                  "params": {"lr": 1e-4}}})[0]
        ids = torch.randint(0, 1024, (1, 2, 1024), generator=_gen(dev, 38),
                            device=dev)
        staged = engine.stage_batch({"input_ids": ids})
        cs = _chip_smoke()
        engine.train_batch(batch=staged)
        torch.cuda.synchronize()
        before = cs.read_counts()
        loss = engine.train_batch(batch=staged)
        torch.cuda.synchronize()
        after = cs.read_counts()
    finally:
        torch.distributed.destroy_process_group()
    assert bool(torch.isfinite(loss))
    got = {k: after[k] - before[k] for k in
           ("flash_attention_merge", "flash_attention_fwd",
            "flash_attention_bwd_fused", "flash_attention_bwd")}
    assert got == {"flash_attention_merge": 4, "flash_attention_fwd": 0,
                   "flash_attention_bwd_fused": 2, "flash_attention_bwd": 0}


# ----------------------------------------------------------------------
# named remat policies, cpu_checkpointing, the prefetch loader
# ----------------------------------------------------------------------
@pytest.mark.parametrize("policy", [
    None, "dots_with_no_batch_dims_saveable",
    "save_only_these_names:attn_out,attn_lse", "save_fused_epilogues"],
    ids=["full", "dots", "attn_names", "fused_epilogues"])
def test_remat_policy_step_launches_exactly(dev, policy):
    """A 2-layer GPT-2 at gpt2-350m's width in bf16 (fused path, flash at
    head dim 64, T 512) through initialize -> train_batch under each
    remat policy: per step exactly chip_smoke's `gpt2_step_launches`
    (the JAX jaxpr's recompute, held on the CPU), and the losses of full
    remat bit for bit."""
    import deepspeed_tpu_torch as dst
    cs = _chip_smoke()
    runs = {}
    for pol in (None, policy):
        cfg = tgpt2.gpt2_config("gpt2-350m", n_layer=2, vocab_size=1024,
                                n_positions=512, dropout=0.0,
                                dtype=torch.bfloat16, remat=True,
                                remat_policy=pol)
        model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
        engine = dst.initialize(
            model=model, model_parameters=model.init(0),
            config={"train_micro_batch_size_per_gpu": 4,
                    "bf16": {"enabled": True},
                    "optimizer": {"type": "AdamW",
                                  "params": {"lr": 1e-4}}})[0]
        ids = torch.randint(0, 1024, (1, 4, 512), generator=_gen(dev, 41),
                            device=dev)
        staged = engine.stage_batch({"input_ids": ids})
        torch.cuda.synchronize()
        before = cs.read_counts()
        losses = torch.stack([engine.train_batch(batch=staged)
                              for _ in range(2)])
        torch.cuda.synchronize()
        after = cs.read_counts()
        runs[pol] = (losses, {k: (after[k] - before[k]) / 2
                              for k in after})
    losses, got = runs[policy]
    want = cs.gpt2_step_launches(policy, 2)
    assert {k: got[k] for k in want} == {k: float(v)
                                         for k, v in want.items()}
    assert bool(torch.isfinite(losses).all())
    assert torch.equal(losses, runs[None][0])


def test_cpu_checkpointing_keeps_pinned_host_inputs(dev):
    """checkpoint() under cpu_checkpointing on the card: the kept inputs
    are pinned host tensors (copied without a sync), the device memory
    between forward and backward drops by their bytes, the gradients
    equal the on-device run's bit for bit."""
    from deepspeed_tpu_torch import checkpointing as ck
    g = _gen(dev, 43)
    w = torch.randn(256, 256, generator=g, device=dev, requires_grad=True)
    x0 = torch.randn(64, 1024, 256, generator=g, device=dev)

    def fn(h):
        return torch.tanh(h @ w)

    def run(offload):
        ck.configure(None, checkpoint_in_cpu=offload)
        x = x0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.set_sync_debug_mode("error")
        try:
            h = x * 1.0
            for _ in range(3):
                h = ck.checkpoint(fn, h)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        staged = ck.host_staged_inputs()
        info = (held, len(staged), all(t.is_pinned() for t in staged),
                sum(t.numel() * t.element_size() for t in staged))
        del staged
        grads = torch.autograd.grad(h.sum(), [x, w])
        return info, grads

    try:
        (held0, n0, _, _), g0 = run(False)
        (held1, n1, pinned, nbytes), g1 = run(True)
    finally:
        ck.configure(None)
    assert n0 == 0 and n1 == 3 and pinned
    assert held0 - held1 >= nbytes == 3 * x0.numel() * 4
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_prefetch_loader_stages_on_its_side_stream(dev):
    """The PrefetchLoader stages on its own stream: each batch equals the
    host batch, the consumer's stream waits on the staging event (no
    host sync: taken under set_sync_debug_mode("error")), and the staged
    tensors are recorded on the consumer's stream."""
    from deepspeed_tpu_torch.runtime.prefetch import PrefetchLoader

    rng = np.random.default_rng(5)
    micro = [{"ids": rng.integers(0, 1000, (8, 4096)).astype(np.int32),
              "x": rng.standard_normal((8, 4096)).astype(np.float32)}
             for _ in range(6)]
    streams = []

    def stage(batch):
        streams.append(torch.cuda.current_stream(dev))
        return {k: torch.as_tensor(v).pin_memory().to(dev, non_blocking=True)
                for k, v in batch.items()}

    loader = PrefetchLoader(iter(micro), stage_fn=stage, gas=2, depth=2,
                            device=dev)
    consumer = torch.cuda.current_stream(dev)
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            batch = next(loader)
            # a consumer-stream op on the staged batch, ordered after the
            # copy by the event wait
            got.append({k: v * 1 for k, v in batch.items()})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()
    assert streams and all(s != consumer for s in streams)
    assert all(s == loader._stream for s in streams)
    for i, batch in enumerate(got):
        for k in ("ids", "x"):
            ref = np.stack([micro[2 * i][k], micro[2 * i + 1][k]])
            assert np.array_equal(batch[k].cpu().numpy(), ref)


# ----------------------------------------------------------------------
# ZeRO-Offload on the card (runtime/zero/offload.py)
# ----------------------------------------------------------------------
OFFLOAD_WIRES = {"native": None,
                 "int8": {"grad_bits": 8, "param_bits": 8},
                 "1bit": {"grad_bits": 1, "param_bits": 8,
                          "warmup_steps": 1}}


def _offload_engine(dev, wire=None, ring=2):
    """gpt2-125m's width at 2 layers (~53M parameters: 13 chunks of the
    4M-element pipeline), bf16 with fp32 parameters, micro batch 2, gas
    2, seq 256, ZeRO-2 with cpu_offload."""
    import deepspeed_tpu_torch as dst
    cfg = tgpt2.gpt2_config("gpt2-125m", n_layer=2, n_positions=256,
                            dropout=0.0, dtype=torch.bfloat16,
                            param_dtype=torch.float32, remat=True)
    model = tgpt2.GPT2ForCausalLM(cfg, device=dev)
    zero = {"stage": 2, "cpu_offload": True}
    if wire:
        zero["offload_wire"] = wire
    engine, _, _, _ = dst.initialize(
        model=model, model_parameters=model.init(3), config={
            "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "steps_per_print": 1000,
            "bf16": {"enabled": True}, "zero_optimization": zero,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}})
    engine._offload_ring = ring
    ids = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 2, 2, 256)).astype(np.int32)
    return engine, [{"input_ids": ids[i]} for i in range(3)]


@pytest.mark.parametrize("wire", list(OFFLOAD_WIRES))
def test_offload_pipeline_equals_the_serial_round_trip(dev, wire):
    """The pinned, chunk-pipelined round trip against the serial one
    (blocking copies, one chunk after another) of the same engine
    config: the same losses and masters, parameters and moments bit for
    bit over 3 steps, in each wire mode; the library is the native one."""
    piped, batches = _offload_engine(dev, OFFLOAD_WIRES[wire], ring=2)
    serial, _ = _offload_engine(dev, OFFLOAD_WIRES[wire], ring=0)
    assert piped._host_adam.native and len(piped._offload_bounds_cached) > 3
    for b in batches:
        la = float(piped.train_batch(batch=b))
        lb = float(serial.train_batch(batch=b))
        assert la == lb and np.isfinite(la)
    assert np.array_equal(piped._host_master, serial._host_master)
    assert np.array_equal(piped._host_adam.exp_avg_sq,
                          serial._host_adam.exp_avg_sq)
    assert torch.equal(piped._offload_param_flat, serial._offload_param_flat)
    assert piped.wire_stats == serial.wire_stats


def test_offload_buffers_are_pinned_and_views_aligned(dev):
    engine, batches = _offload_engine(dev)
    engine.train_batch(batch=batches[0])
    pinned = engine._offload_pinned
    for bufs in pinned["in"] + pinned["out"]:
        assert all(t.is_pinned() for t in bufs.values())
    assert pinned["scales"].is_pinned()
    for p in engine.state.params.values():
        assert p.is_cuda and p.data_ptr() % 16 == 0
    assert not engine._offload_acc.is_pinned()


@pytest.mark.parametrize("wire", list(OFFLOAD_WIRES))
def test_offload_step_syncs_the_host_once(dev, wire):
    """A step past the warm-up under set_sync_debug_mode("warn"): exactly
    one synchronizing call (the norm read); the chunk loop waits on
    events, its copies are non-blocking from pinned memory."""
    import warnings
    engine, batches = _offload_engine(dev, OFFLOAD_WIRES[wire])
    engine.train_batch(batch=batches[0])
    engine.train_batch(batch=batches[1])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.train_batch(batch=batches[2])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's one-time notice ("... is a prototype feature") is no sync
    syncs = [w for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in seen]


# ----------------------------------------------------------------------
# speculative decoding and int8 weight-only serving
# ----------------------------------------------------------------------
def _serving_engine(dev, n_layer=2, **inference):
    """gpt2-1.5b's width at `n_layer` layers, bf16 compute, random
    weights: chip_smoke's serving settings with `inference` on top."""
    cfg = tgpt2.gpt2_config("gpt2-1.5b", n_layer=n_layer)
    params = tgpt2.GPT2ForCausalLM(cfg, device=dev).init(seed=0)
    cs = _chip_smoke()
    icfg = cs.spec_serving_config(new=32)
    icfg["inference"].update(inference)
    return cs, cfg, params, InferenceEngine(cfg, params, icfg, device=dev)


@pytest.mark.parametrize("weight_bits", [32, 8], ids=["bf16", "int8"])
def test_verify_rows_equal_decode_rows_bit_for_bit(dev, weight_bits):
    """At gpt2-1.5b's widths, 4 slots x 5 positions: every op of the
    verify step gives a row the decode step's bits (the head through
    `_logits`, one GEMM per position)."""
    cs, _, _, eng = _serving_engine(dev, weight_bits=weight_bits)
    rows = cs.verify_rows(eng, _gen(dev, 21))
    torch.cuda.synchronize()
    assert {op: n for op, n in rows.items() if op != "head_one_gemm"} == \
        {op: 0 for op in rows if op != "head_one_gemm"}, rows


@pytest.mark.parametrize("weight_bits", [32, 8], ids=["bf16", "int8"])
def test_speculative_stream_equals_vanilla_on_the_card(dev, weight_bits):
    """4 layers at gpt2-1.5b's width, blocks 1.. damped as chip_smoke
    damps its flagship's: the truncate:1 speculative stream equals the
    vanilla stream at temperature 0, spec_block under
    set_sync_debug_mode("error"), with drafts accepted."""
    from deepspeed_tpu_torch.inference import Request, ServingLoop
    cfg = tgpt2.gpt2_config("gpt2-1.5b", n_layer=4)
    params = tgpt2.GPT2ForCausalLM(cfg, device=dev).init(seed=0)
    for i in range(1, 4):
        for mod in ("c_proj", "mlp_c_proj"):
            for leaf in ("kernel", "bias"):
                params[f"h.{i}.{mod}.{leaf}"].mul_(0.2)
    cs = _chip_smoke()
    spec_block = {"enabled": True, "draft_model": "truncate:1", "k": 4,
                  "k_min": 1, "adaptive": True}
    van = InferenceEngine(cfg, params, cs.spec_serving_config(weight_bits,
                                                              new=32),
                          device=dev)
    spec = InferenceEngine(cfg, params, cs.spec_serving_config(
        weight_bits, speculative=spec_block, new=32), device=dev)
    spec.spec_block = cs.no_sync(spec.spec_block, "cuda")
    r = np.random.RandomState(22)
    prompts = [r.randint(0, cfg.vocab_size, n) for n in (40, 77, 130, 9)]

    def serve(eng):
        return {q.rid: q.out_tokens.tolist() for q in ServingLoop(eng).serve(
            [Request(rid=i, tokens=p, max_new_tokens=32)
             for i, p in enumerate(prompts)])}

    assert serve(spec) == serve(van)
    totals = cs.spec_totals(spec)
    assert totals["accepted"] > 0 and totals["drafted"] > 0


def test_spec_block_reads_nothing_on_the_host(dev):
    """Several speculative rounds back to back under
    set_sync_debug_mode("error"): no synchronizing call."""
    cs, cfg, _, eng = _serving_engine(dev, speculative={
        "enabled": True, "draft_model": "truncate:1", "k": 3})
    r = np.random.RandomState(23)
    for slot in range(3):
        eng.start_request(slot, r.randint(0, cfg.vocab_size, 20 + slot),
                          max_new=24, temperature=0.7 * slot, top_k=8 * slot)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.spec_block(3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    state = eng.fetch_state()
    assert (state["n_gen"][:3] > 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_on_the_card_matches_the_cpu(dev, dtype):
    """The plain epilogue at the projections' shapes (K 1600 and 6400,
    block 128): the card's result against the CPU's on the same inputs,
    fp32 to reduction-order roundoff, bf16 within one rounding."""
    from deepspeed_tpu_torch.ops.transformer import quantized_matmul as qm
    g = _gen(dev, 24)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for k, n in ((1600, 4800), (6400, 1600)):
        w = torch.randn((k, n), generator=g, device=dev) * 0.02
        x = torch.randn((4, 5, k), generator=g, device=dev).to(dtype)
        q, s = qm.quantize_kernel_int8(w, 128)
        got = qm.int8_matmul(x, q[:k], s, 128, dtype)
        ref = qm.int8_matmul(x.cpu(), q[:k].cpu(), s.cpu(), 128, dtype)
        torch.testing.assert_close(got.cpu().float(), ref.float(), **tol)
        # the quantizer on the card is the CPU's bit for bit
        q_cpu, s_cpu = qm.quantize_kernel_int8(w.cpu(), 128)
        assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)


# ----------------------------------------------------------------------
# the monitor on the card
# ----------------------------------------------------------------------
def _monitored_engine(out, n_layer=2, seq=128, steps_per_sync=2):
    """A bf16 gpt2-125m-width engine (the training cell's settings) with
    the monitor, numerics, the trace and the memory ledger on."""
    import deepspeed_tpu_torch as dst
    cfg = tgpt2.gpt2_config("gpt2-125m", n_layer=n_layer, n_positions=seq,
                            dropout=0.0, dtype=torch.bfloat16,
                            param_dtype=torch.bfloat16, remat=True)
    model = tgpt2.GPT2ForCausalLM(cfg)
    engine, _, _, _ = dst.initialize(
        model=model, model_parameters=model.init(0),
        config={"train_micro_batch_size_per_gpu": 4, "steps_per_print": 1000,
                "bf16": {"enabled": True, "master_weights": False},
                "zero_optimization": {"stage": 2},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                "async_dispatch": {"steps_per_sync": steps_per_sync},
                "wall_clock_breakdown": True,
                "monitor": {"enabled": True, "output_path": str(out),
                            "numerics": {"enabled": True},
                            "trace": {"enabled": True}}})
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 4, seq))
    return engine, engine.stage_batch({"input_ids": ids.astype(np.int32)})


def test_monitored_step_makes_no_host_sync(dev, tmp_path):
    """With the monitor, numerics, spans and the trace on, a step that
    ends before a fence runs under set_sync_debug_mode("error"); the
    fence's step drains the window into a `metrics` event with a finite
    loss and per-group numerics."""
    engine, staged = _monitored_engine(tmp_path)
    engine.train_batch(batch=staged)
    engine.train_batch(batch=staged)
    torch.cuda.synchronize()
    for _ in range(2):
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine.train_batch(batch=staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        engine.train_batch(batch=staged)
    engine.shutdown()
    events = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    metrics = [e for e in events if e["kind"] == "metrics"]
    numerics = [e for e in events if e["kind"] == "numerics"]
    assert [e["step"] for e in metrics] == [2, 4, 6]
    assert all(np.isfinite(e["loss"]) for e in metrics)
    assert all(np.isfinite(v) for e in numerics
               for v in e["grad_norm"].values())
    assert metrics[-1]["spans"]["step"]["count"] == 2


def test_memory_ledger_reconciles_with_the_allocator(dev, tmp_path):
    """The ledger's params and optimizer state are the state's bytes;
    reconciled against torch.cuda.memory_stats' allocated bytes, the
    residual is what the allocator holds beyond them."""
    engine, staged = _monitored_engine(tmp_path)
    engine.train_batch(batch=staged)
    torch.cuda.synchronize()
    payload = engine.monitor._reconcile_memory(engine.global_steps)
    stats = torch.cuda.memory_stats()
    hbm = payload["hbm"]
    st = engine.state
    params = sum(p.numel() * p.element_size() for p in st.params.values())
    opt = sum(t.numel() * t.element_size()
              for t in engine._state_tensors(st.opt_state))
    assert hbm["categories"]["params"] == params
    assert hbm["categories"]["opt_state"] == opt
    assert hbm["device_count"] == torch.cuda.device_count()
    assert hbm["measured_in_use"] == stats["allocated_bytes.all.current"]
    assert hbm["measured_peak"] == stats["allocated_bytes.all.peak"]
    assert hbm["residual_bytes"] == hbm["measured_in_use"] - \
        hbm["ledger_bytes"]
    assert hbm["residual_bytes"] > 0
    assert stats["reserved_bytes.all.current"] >= hbm["measured_in_use"]
    engine.shutdown()


def test_provoked_oom_is_classified_and_the_engine_steps_on(dev, tmp_path):
    """A batch whose embedding alone passes the card's memory raises
    torch.OutOfMemoryError out of train_batch, leaves a flight dump
    classified `oom` with the ledger's hints, and after empty_cache the
    engine takes its next step."""
    from deepspeed_tpu_torch.monitor.flight import list_flight_dumps
    engine, staged = _monitored_engine(tmp_path, seq=1024)
    engine.train_batch(batch=staged)
    # 65536 rows of 1024 tokens at width 768 in bf16: 103 GB of
    # embedding output
    big = np.zeros((1, 65536, 1024), np.int32)
    with pytest.raises(torch.OutOfMemoryError):
        engine.train_batch(batch={"input_ids": big})
    del big
    torch.cuda.empty_cache()
    (dump,) = list_flight_dumps(str(tmp_path))
    doc = json.load(open(dump))
    assert doc["reason"] == "oom"
    assert doc["extra"]["oom"]["hints"]
    assert doc["extra"]["oom"]["hbm"]["categories"]["params"] > 0
    loss = engine.train_batch(batch=staged)
    assert np.isfinite(float(loss))
    engine.shutdown()
