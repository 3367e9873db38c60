"""PyTorch port: the int8 quantized-compute family (kernel K6's twin,
the quantizers, the straight-through `quantized_dense`, QuantizedDense,
the quantized GPT-2 and experts, the `quantized_compute` config block
and its engine wiring) against the JAX package.

Inputs come from numpy seeds and go through both packages. The JAX side
runs as its own CPU tests run it: the Pallas kernel in interpret mode,
or the XLA fallback (the default off the TPU). Reach the JAX module with
importlib: `deepspeed_tpu.ops.transformer` exports a function named
`quantized_matmul` that shadows the module of that name.

Tolerances, each with its reason:
  * quantizers: bit for bit (the same fp32 divisions, half-to-even
    rounding in both).
  * the K6 twin against the interpret-mode kernel and the XLA fallback:
    within 2e-6 of max|out|. Integer partials are exact in both; the
    twin adds the per-block scaled partials in block order, the XLA
    fallback runs one fp32 GEMM over the dequantized weights, so they
    differ in fp32 summation order (observed 2e-7 and 5e-7).
  * quantized_dense's STE gradients: fp32 roundoff (1e-5 relative L2).
  * model level (GPT-2 fp32 at gpt2-tiny, experts, the engine): int8
    rounding is discontinuous. A 1e-7 relative change of the weights
    (fp32 roundoff, which the two packages differ by in attention and
    LayerNorm) flips a few activations to the neighbouring int8 value,
    and each flip moves that entry by a whole quantization step. The
    port moves its own gradients by 1.9e-3 relative L2 under such a
    perturbation (T 128), and sits 2.5e-3 (h.1.mlp_c_proj.kernel,
    median 6e-4) from JAX at T 64; the loss 9e-6 relative. So: loss
    within 1e-4 relative, every gradient within 1e-2 relative L2; the
    10-step engine trajectory within 1e-4 relative per step (observed
    <= 2.3e-5).
  * the quantized experts alone (no attention or LayerNorm before
    them, so no flips): output and every gradient within 2e-6 relative
    L2, ten times the observed 2.2e-7 (fp32 summation order). The
    unquantized experts sit 6e-3 to 9e-3 away, so the bound tells the
    two apart.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.moe import experts as jex
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.moe import experts as tex
from deepspeed_tpu_torch.runtime import engine as engine_module
from deepspeed_tpu_torch.ops.transformer.transformer import (Dense,
                                                             QuantizedDense,
                                                             SplitDense)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
from deepspeed_tpu_torch.utils.rng import stream_generator
from torch_one_thread import one_torch_thread  # noqa: F401

jqm = importlib.import_module(
    "deepspeed_tpu.ops.transformer.quantized_matmul")
tqm = importlib.import_module(
    "deepspeed_tpu_torch.ops.transformer.quantized_matmul")

TWIN_TOL = 2e-6       # of max|out|
STE_TOL = 1e-5
LOSS_TOL = 1e-4
GRAD_TOL = 1e-2
TRAJ_TOL = 1e-4
EXPERT_TOL = 2e-6


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------------------
# quantizers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k,n,block,zeros", [
    (96, 40, 32, False), (50, 8, 32, True), (1600, 72, 128, False),
    (6400, 16, 128, False)])
def test_weight_quantizers_match_jax(k, n, block, zeros):
    w = _np((k, n), k)
    if zeros:     # all-zero blocks: raw scale 0 (numpy), clamped 1 (torch)
        w[:] = 0.0
        w[:10, 0] = 3.0
    jq, js = jqm.quantize_kernel_int8_np(w, block)
    tq, ts = tqm.quantize_kernel_int8_np(w, block)
    assert np.array_equal(jq, tq) and np.array_equal(js, ts)
    jq, js = jqm.quantize_kernel_int8(jnp.asarray(w), block)
    tq, ts = tqm.quantize_kernel_int8(_t(w), block)
    nb = -(-k // block)
    assert tq.shape == (nb * block, n) and tq.dtype == torch.int8
    assert ts.shape == (nb, n) and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert int(tq[k:].abs().max()) == 0 if nb * block > k else True
    deq = tqm.dequantize_kernel(tq, ts, block, k=k)
    jdeq = jqm.dequantize_kernel(jq, js, block, k=k)
    assert np.array_equal(np.asarray(jdeq), deq.numpy())


def test_row_quantizer_matches_jax():
    x = _np((37, 1600), 1, scale=3.0)
    x[5] = 0.0                         # a zero row: scale clamps to 1
    jq, js = jqm.quantize_rows_int8(jnp.asarray(x))
    tq, ts = tqm.quantize_rows_int8(_t(x))
    assert tq.dtype == torch.int8 and ts.shape == (37, 1)
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())


def test_stochastic_rounding_is_unbiased_and_keyed():
    # as the JAX test: row 0 pins the block scale at 0.3/127, the other
    # rows sit at 42.33 quantization steps
    w = np.full((256, 4), 0.1, np.float32)
    w[0] = 0.3
    _, s = tqm.quantize_kernel_int8(_t(w), 256)
    outs = []
    for seed in range(2):
        gen = torch.Generator().manual_seed(seed)
        q, _ = tqm.quantize_kernel_int8(_t(w), 256, gen=gen)
        outs.append(q.float().numpy())
    assert not np.array_equal(outs[0], outs[1])
    again, _ = tqm.quantize_kernel_int8(
        _t(w), 256, gen=torch.Generator().manual_seed(0))
    assert np.array_equal(outs[0], again.float().numpy())
    assert set(np.unique(outs[0][1:])) <= {42.0, 43.0}
    assert abs(outs[0][1:].mean() * float(s[0, 0]) - 0.1) < 0.005
    # the row quantizer: floor or ceil only, mean converging
    x = torch.full((1, 20000), 0.1)
    x[0, 0] = 0.3
    q, sx = tqm.quantize_rows_int8(x, gen=torch.Generator().manual_seed(3))
    vals = q[0, 1:].float()
    assert set(vals.unique().tolist()) <= {42.0, 43.0}
    assert abs(float(vals.mean()) * float(sx[0, 0]) - 0.1) < 0.001


# ----------------------------------------------------------------------
# K6's twin
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(300, 1600, 520), (5, 256, 40)])
def test_twin_matches_jax_kernel_and_fallback(m, k, n):
    """K = 1600 pads to 13 blocks (the last half zeros); M and N ragged
    against the interpret kernel's 128-tiles."""
    x = _np((m, k), 2, scale=3.0)
    w = _np((k, n), 3, scale=0.05)
    wq, sw = jqm.quantize_kernel_int8(jnp.asarray(w), 128)
    ref_i = np.asarray(jqm.quantized_matmul(
        jnp.asarray(x), wq, sw, block=128, impl="interpret", block_m=128,
        block_n=128))
    ref_x = np.asarray(jqm.quantized_matmul(
        jnp.asarray(x), wq.astype(jnp.float32), sw, block=128, impl="xla"))
    tqm.reset_launch_count()
    got = tqm.quantized_matmul(_t(x), _t(wq), _t(sw), block=128).numpy()
    assert tqm.quantized_matmul.launches == 0      # the twin, on the CPU
    scale = np.abs(ref_i).max()
    assert np.abs(got - ref_i).max() <= TWIN_TOL * scale
    assert np.abs(got - ref_x).max() <= TWIN_TOL * scale
    # bf16 output: the fp32 result rounded once
    got16 = tqm.quantized_matmul(_t(x), _t(wq), _t(sw), block=128,
                                 out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, torch.from_numpy(got).to(torch.bfloat16))


def test_grouped_twin_matches_jax_vmap():
    g, m, k, n = 3, 20, 200, 24
    x = _np((g, m, k), 4)
    w = _np((g, k, n), 5, scale=0.1)
    wq, sw = jqm.quantize_kernel_int8(jnp.asarray(w), 128)
    ref = np.asarray(jax.vmap(lambda xg, wg, sg: jqm.quantized_matmul(
        xg, wg.astype(jnp.float32), sg, block=128, impl="xla"))(
        jnp.asarray(x), wq, sw))
    tq, ts = tqm.quantize_kernel_int8(_t(w), 128)
    assert tq.shape == (g, 256, n) and ts.shape == (g, 2, n)
    got = tqm.quantized_matmul(_t(x), tq, ts, block=128).numpy()
    assert np.abs(got - ref).max() <= TWIN_TOL * np.abs(ref).max()


# ----------------------------------------------------------------------
# quantized_dense (STE), the bf16 fallback, validation
# ----------------------------------------------------------------------
@pytest.mark.parametrize("grouped", [False, True])
def test_ste_gradients_match_jax(grouped):
    shape_x, shape_w = ((2, 6, 200), (200, 32)) if not grouped else \
        ((3, 6, 200), (3, 200, 32))
    x, w = _np(shape_x, 6), _np(shape_w, 7, scale=0.1)
    dy = _np(shape_x[:-1] + (32,), 8)

    def jf(x, w):
        if grouped:
            return jax.vmap(lambda a, b: jqm.quantized_dense(
                a, b, block=128, impl="xla"))(x, w)
        return jqm.quantized_dense(x, w, block=128, impl="xla")

    ref, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    y = tqm.quantized_dense(tx, tw, block=128)
    assert _rel(y.detach().numpy(), ref) <= TWIN_TOL
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(dy))
    assert _rel(dx.numpy(), jdx) <= STE_TOL
    assert _rel(dw.numpy(), jdw) <= STE_TOL


def test_stochastic_dense_is_keyed_and_its_backward_sees_the_noise():
    """With a seed the forward rounds stochastically; the backward
    re-quantizes W with the forward's noise (dx = g @ W_eff^T with that
    W_eff), and the same seed gives the same result."""
    x = _t(_np((16, 256), 9)).requires_grad_(True)
    w = _t(_np((256, 8), 10, scale=0.1))
    y0 = tqm.quantized_dense(x, w, block=128)
    ya = tqm.quantized_dense(x, w, block=128, stochastic_rounding=True,
                             seed=11)
    yb = tqm.quantized_dense(x, w, block=128, stochastic_rounding=True,
                             seed=11)
    yc = tqm.quantized_dense(x, w, block=128, stochastic_rounding=True,
                             seed=12)
    assert torch.equal(ya, yb) and not torch.equal(ya, yc)
    assert not torch.equal(ya, y0)
    assert _rel(ya.detach().numpy(), y0.detach().numpy()) < 0.05
    g = torch.ones_like(ya)
    (dx,) = torch.autograd.grad(ya, x, g)
    wq, sw = tqm.quantize_kernel_int8(w, 128,
                                      gen=stream_generator(11, 0, "cpu"))
    w_eff = tqm.dequantize_kernel(wq, sw, 128, k=256)
    assert torch.allclose(dx, g @ w_eff.t(), atol=1e-6)
    # without a seed, stochastic_rounding rounds to nearest
    assert torch.equal(tqm.quantized_dense(x, w, block=128,
                                           stochastic_rounding=True), y0)


def test_bf16_fallback_is_bit_identical_without_sr():
    x = _t(_np((8, 64), 12)).to(torch.bfloat16)
    w = _t(_np((64, 32), 13)).to(torch.bfloat16)
    y = tqm.bf16_fallback_matmul(x, w, out_dtype=torch.bfloat16)
    assert torch.equal(y, torch.matmul(x, w))
    gen = torch.Generator().manual_seed(0)
    ysr = tqm.bf16_fallback_matmul(
        _t(_np((8, 64), 12)), _t(_np((64, 32), 13)), out_dtype=torch.bfloat16,
        stochastic_rounding=True, gen=gen)
    assert not torch.equal(ysr, y)
    assert float((ysr.float() - y.float()).abs().max()) < 0.5


def test_resolve_and_block_validation():
    r = tqm.resolve_quantized_compute
    assert r("off") is False and r("on") is True
    assert r("auto") is False and r("auto", "cpu") is False
    assert r("auto", "cuda") is True
    for mode in ("off", "on", "auto"):
        assert r(mode, "cpu") == jqm.resolve_quantized_compute(mode)
    with pytest.raises(ValueError):
        r("maybe")
    with pytest.raises(ValueError):
        tqm.quantized_dense(torch.zeros(4, 128), torch.zeros(128, 8), block=0)
    # CPU tensors take blocks finer than the kernel's 128
    y = tqm.quantized_dense(_t(_np((4, 128), 14)), _t(_np((128, 8), 15)),
                            block=64)
    assert y.shape == (4, 8)
    with pytest.raises(ValueError, match="multiple of 128"):
        tqm._check_block(64)


# ----------------------------------------------------------------------
# QuantizedDense
# ----------------------------------------------------------------------
@pytest.mark.parametrize("split", [False, True])
def test_quantized_dense_module(split):
    """Split and plain forms against quantized_dense; the parameters are
    Dense's; mode "auto" on the CPU (with and without SR, no seed) is bit
    for bit the plain projection."""
    plain = (SplitDense if split else Dense)(64, 32, torch.float32,
                                             torch.float32)
    quant = QuantizedDense(64, 32, torch.float32, torch.float32, split=split)
    assert [(n, p.shape) for n, p in plain.named_parameters()] == \
        [(n, p.shape) for n, p in quant.named_parameters()]
    params = {"kernel": _t(_np((64, 32), 16, 0.1)),
              "bias": _t(_np((32,), 17))}
    x = _t(_np((3, 5, 64), 18))
    got = torch.func.functional_call(quant, params, (x,))
    ref = tqm.quantized_dense(x, params["kernel"], block=128)
    if split:
        assert torch.equal(got[0], ref) and got[1] is params["bias"]
    else:
        assert torch.equal(got, ref + params["bias"])
    want = torch.func.functional_call(plain, params, (x,))
    for sr in (False, True):
        auto = QuantizedDense(64, 32, torch.float32, torch.float32,
                              mode="auto", stochastic_rounding=sr,
                              split=split)
        out = torch.func.functional_call(auto, params, (x,))
        for a, b in zip(out if split else (out,), want if split else (want,)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        QuantizedDense(64, 32, torch.float32, torch.float32, mode="nope")


# ----------------------------------------------------------------------
# the quantized GPT-2
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_tree():
    cfg = jgpt2.tiny_gpt2_config(n_positions=128)
    model = jgpt2.GPT2ForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _ids(seed, shape=(2, 128)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


@pytest.fixture(scope="module")
def jax_quantized_loss(jax_tree):
    """The JAX model's quantized loss and gradients (remat off: the JAX
    model computes the same values with remat on), by fused_ops."""
    ids = _ids(1, (2, 64))     # T 64: dense attention in both packages
    cache = {}

    def get(fused):
        if fused not in cache:
            jmodel = jgpt2.GPT2ForCausalLM(jgpt2.tiny_gpt2_config(
                n_positions=128, fused_ops=fused, quantized_compute="on"))
            loss, grads = jax.value_and_grad(
                lambda p: jmodel.loss_fn(p, {"input_ids": ids},
                                         deterministic=True))(jax_tree[1])
            cache[fused] = (float(loss), params_from_jax(
                jax.tree_util.tree_map(np.asarray, grads)))
        return ids, cache[fused]

    return get


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_gpt2_loss_and_grads_match_jax(jax_tree, jax_quantized_loss, fused,
                                       remat):
    ids, (ref_loss, ref_grads) = jax_quantized_loss(fused)
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(
        n_positions=128, fused_ops=fused, remat=remat,
        quantized_compute="on"), device="cpu")
    assert isinstance(model.module.h[0].mlp_c_proj, QuantizedDense)
    params = {k: v.clone().requires_grad_(True)
              for k, v in params_from_jax(jax_tree[2]).items()}
    loss = model.loss_fn(params, {"input_ids": ids}, deterministic=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(float(loss.detach()) - float(ref_loss)) <= \
        LOSS_TOL * abs(float(ref_loss))
    for name, g in zip(params, grads):
        assert _rel(g.numpy(), ref_grads[name].numpy()) <= GRAD_TOL, name


def test_configure_hook_keeps_the_parameters(jax_tree):
    """configure_quantized_compute rebuilds the module with the same
    parameter tree, adopting the same tensors; the loss changes (it
    quantized) but stays close; a bad mode raises."""
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                  device="cpu")
    params = model.load_params(params_from_jax(jax_tree[2]))
    batch = {"input_ids": _ids(2)}
    l0 = float(model.loss_fn(params, batch, deterministic=True))
    before = {n: (p.shape, p.dtype, p.data_ptr())
              for n, p in model.module.named_parameters()}
    with pytest.raises(ValueError):
        model.configure_quantized_compute("sideways")
    model.configure_quantized_compute("on", block=128,
                                      stochastic_rounding=True)
    assert model.config.quantized_compute == "on"
    assert model.config.quant_block == 128
    assert model.config.quant_stochastic_rounding is True
    after = {n: (p.shape, p.dtype, p.data_ptr())
             for n, p in model.module.named_parameters()}
    assert after == before
    assert isinstance(model.module.h[1].c_fc, QuantizedDense)
    l1 = float(model.loss_fn(model.params(), batch, deterministic=True))
    assert l1 != l0 and abs(l1 - l0) / l0 < 0.01
    # SR draws from the quant seed: seeded, reproducible, and equal
    # under remat (the recompute rebuilds the same generators)
    ls = [float(model.loss_fn(params, batch, rngs={"quant": 5},
                              deterministic=True)) for _ in range(2)]
    assert ls[0] == ls[1] and ls[0] != l1


def test_sr_remat_recompute_sees_the_forward_noise(jax_tree):
    """With stochastic rounding on, remat on and off give the same loss
    and gradients for one quant seed: the recompute and the STE backward
    draw the forward's noise again."""
    runs = []
    for remat in (False, True):
        model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(
            n_positions=128, remat=remat, quantized_compute="on",
            quant_stochastic_rounding=True), device="cpu")
        params = {k: v.clone().requires_grad_(True)
                  for k, v in params_from_jax(jax_tree[2]).items()}
        loss = model.loss_fn(params, {"input_ids": _ids(3)},
                             rngs={"quant": 7}, deterministic=True)
        runs.append((float(loss.detach()),
                     torch.autograd.grad(loss, list(params.values()))))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


def test_sr_bf16_fallback_when_quantization_resolves_off(jax_tree):
    """"auto" resolves off on the CPU; with stochastic_rounding the bf16
    fallback engages: bit for bit the plain model without a quant seed,
    perturbed but close with one (the JAX package's contract)."""
    bf16 = dict(n_positions=128, dtype=torch.bfloat16)
    params = params_from_jax(jax_tree[2])
    batch = {"input_ids": _ids(4)}
    plain = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(**bf16),
                                  device="cpu")
    sr = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(
        quantized_compute="auto", quant_stochastic_rounding=True, **bf16),
        device="cpu")
    l_plain = float(plain.loss_fn(params, batch, deterministic=True))
    assert float(sr.loss_fn(params, batch, deterministic=True)) == l_plain
    l_rng = float(sr.loss_fn(params, batch, rngs={"quant": 1},
                             deterministic=True))
    assert l_rng != l_plain and abs(l_rng - l_plain) / l_plain < 0.01


# ----------------------------------------------------------------------
# experts
# ----------------------------------------------------------------------
def test_quantized_expert_ffn_matches_jax():
    e, c, h, f = 4, 12, 128, 256
    rng = np.random.default_rng(19)
    xe = rng.standard_normal((e, c, h)).astype(np.float32)
    dy = rng.standard_normal((e, c, h)).astype(np.float32)
    mod = jex.ExpertFFN(num_experts=e, d_model=h, d_ff=f, pack=False,
                        quantized="on")
    jp = mod.init(jax.random.PRNGKey(0), jnp.asarray(xe))["params"]
    jp = {k: np.asarray(v) + (0.1 if k.startswith("b") else 0.0)
          for k, v in jp.items()}
    ref, vjp = jax.vjp(lambda p, x: mod.apply({"params": p}, x), jp,
                       jnp.asarray(xe))
    j_dp, j_dx = vjp(jnp.asarray(dy))
    ffn = tex.ExpertFFN(e, h, f, torch.float32, torch.float32,
                        quantized="on")
    params = {k: _t(v).requires_grad_(True) for k, v in jp.items()}
    x = _t(xe).requires_grad_(True)
    got = torch.func.functional_call(ffn, params, (x,))
    assert _rel(got.detach().numpy(), ref) <= EXPERT_TOL
    grads = torch.autograd.grad(got, [x] + list(params.values()), _t(dy))
    assert _rel(grads[0].numpy(), j_dx) <= EXPERT_TOL
    for name, g in zip(params, grads[1:]):
        assert _rel(g.numpy(), j_dp[name]) <= EXPERT_TOL, name
    # it quantized: the unquantized FFN misses the bound on the output,
    # dx and every weight gradient (bo's is sum(dy) either way)
    plain = tex.ExpertFFN(e, h, f, torch.float32, torch.float32)
    got = torch.func.functional_call(plain, params, (x,))
    assert _rel(got.detach().numpy(), ref) > EXPERT_TOL
    grads = torch.autograd.grad(got, [x] + list(params.values()), _t(dy))
    assert _rel(grads[0].numpy(), j_dx) > EXPERT_TOL
    for name, g in zip(params, grads[1:]):
        if name != "bo":
            assert _rel(g.numpy(), j_dp[name]) > EXPERT_TOL, name


# ----------------------------------------------------------------------
# the config block and the engine
# ----------------------------------------------------------------------
_BASE = {"train_micro_batch_size_per_gpu": 1,
         "gradient_accumulation_steps": 1}


@pytest.mark.parametrize("block", [
    {}, {"quantized_compute": {}},
    {"quantized_compute": {"enabled": True}},
    {"quantized_compute": {"enabled": False, "mode": "auto"}},
    {"quantized_compute": {"enabled": True, "mode": "on", "block": 256,
                           "stochastic_rounding": True}},
    {"quantized_compute": {"enabled": True, "mode": "off", "block": 64}}])
def test_config_block_resolves_like_jax(block):
    j = JConfig({**_BASE, **block}, world_size=1)
    t = TConfig({**_BASE, **block})
    assert t.quantized_compute == j.quantized_compute


@pytest.mark.parametrize("bad", [
    {"quantized_compute": {"mode": "nope"}},
    {"quantized_compute": {"block": 0}},
    {"quantized_compute": {"block": True}},
    {"quantized_compute": {"block": 1.5}},
    {"quantized_compute": "yes"}])
def test_config_block_rejects_like_jax(bad):
    from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JErr
    with pytest.raises(JErr):
        JConfig({**_BASE, **bad}, world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        TConfig({**_BASE, **bad})


def test_engine_trajectory_matches_jax(jax_tree):
    """initialize -> train_batch with the quantized_compute block (mode
    "on": the twin route on the CPU) tracks the JAX engine over 10
    steps, fp32, AdamW with clipping and warm-up, single thread."""
    jmodel, jparams, tree = jax_tree
    config = {"train_batch_size": 8, "gradient_accumulation_steps": 1,
              "steps_per_print": 1000, "gradient_clipping": 0.5,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 3e-3, "weight_decay": 0.01}},
              "scheduler": {"type": "WarmupLR",
                            "params": {"warmup_num_steps": 5,
                                       "warmup_max_lr": 3e-3}},
              "quantized_compute": {"enabled": True, "mode": "on"}}
    jengine, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=jparams, config=config)
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                  device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine, _, _, _ = dst.initialize(
            model=model, model_parameters=params_from_jax(tree),
            config=dict(config, train_micro_batch_size_per_gpu=8))
        assert isinstance(model.module.h[0].c_attn, QuantizedDense)
        rng = np.random.RandomState(1)
        batches = [{"input_ids": rng.randint(0, 256, (1, 8, 128))
                    .astype(np.int32)} for _ in range(3)]
        ref, got = [], []
        for step in range(10):
            ref.append(float(jengine.train_batch(batch=batches[step % 3])))
            got.append(float(engine.train_batch(batch=batches[step % 3])))
    finally:
        torch.set_num_threads(threads)
    ref, got = np.array(ref), np.array(got)
    assert np.all(np.abs(got - ref) <= TRAJ_TOL * np.abs(ref)), (got, ref)
    assert got[-1] < got[0]


def test_engine_quant_seeds_and_a_model_without_the_hook(jax_tree,
                                                         monkeypatch):
    """Each step hands the model a "quant" seed beside "dropout", from
    its own host stream (the dropout seeds are the same with or without
    quantized compute); a model without the hook warns and still
    trains."""
    seen = []

    class Recorder:
        def __init__(self):
            self.inner = tgpt2.GPT2ForCausalLM(
                tgpt2.tiny_gpt2_config(n_positions=128), device="cpu")
            self.device = "cpu"

        def loss_fn(self, params, batch, rngs=None, deterministic=False):
            seen.append(dict(rngs))
            return self.inner.loss_fn(params, batch, rngs=rngs,
                                      deterministic=deterministic)

    params = params_from_jax(jax_tree[2])
    config = {"train_micro_batch_size_per_gpu": 2,
              "quantized_compute": {"enabled": True, "mode": "on"}}
    warned = []
    monkeypatch.setattr(engine_module.logger, "warning", warned.append)
    engine, _, _, _ = dst.initialize(model=Recorder(),
                                     model_parameters=params, config=config)
    assert any("configure_quantized_compute" in w for w in warned)
    ids = {"input_ids": _ids(5, (1, 2, 128))}
    engine.train_batch(batch=ids)
    engine.train_batch(batch=ids)
    assert [set(r) for r in seen] == [{"dropout", "quant"}] * 2
    assert seen[0]["quant"] != seen[1]["quant"]
    assert seen[0]["quant"] != seen[0]["dropout"]
    plain, _, _, _ = dst.initialize(
        model=tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=128),
                                    device="cpu"),
        model_parameters=params, config={"train_micro_batch_size_per_gpu": 2})
    assert [plain._next_rngs()["dropout"] for _ in range(2)] == \
        [r["dropout"] for r in seen]
