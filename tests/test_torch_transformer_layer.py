"""PyTorch port: DeepSpeedTransformerLayer against the JAX package.

A JAX `DeepSpeedTransformerLayer` is initialized, its parameters carried
into the port's layer (the same names, `core.<leaf>`, [in, out]
kernels), and both run the same numpy-seeded input, with and without a
[B, 1, 1, T] padding mask: pre-LN and post-LN, fp32 and bf16, fused ops
"on" (the JAX package's XLA form of the fused epilogues and flash
attention as its CPU tests run them; the port's plain twins) and "off".
T 128 takes flash attention without a mask; T 120 and every masked case
take dense attention. For fp32, the gradients of every parameter and of
the input under a random output cotangent are held to JAX's too. Then
the memory flags (the same values and gradients as without them, and
JAX's), the quantized projections resolved off with stochastic rounding
(the JAX package's sr_fallback), dropout by seeded reproducibility and
rate statistics (the streams are torch's, not JAX's), and fp16 with the
quantized projections building and running (fp16 itself is held in
`test_torch_fp16_kernels.py`, quantized compute in fp16 in
`test_torch_fp16_quant.py`).

The widths are small (H 128, 2 heads of 64: flash attention takes head
dims that are multiples of 64).

Tolerances, as in `test_torch_gpt2_train.py` for the same dtypes: fp32
outputs within 1e-5 (absolute and relative; the packages differ in
reduction order only, observed <= 7.2e-7) and gradients within 1e-4
relative L2 (observed <= 5.9e-7). bf16: both packages round the same tensors
to bf16 at the same places, and an fp32 value that lands on a rounding
point in one package's reduction order and not the other's flips one
bf16 ulp (2^-8 relative): outputs within 2e-3 relative L2, the bf16
model-parity tolerance of `test_torch_checkpoint.py` (observed <= 2e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import (
    DeepSpeedTransformerConfig as JConfig,
    DeepSpeedTransformerLayer as JLayer)
from deepspeed_tpu_torch.ops.transformer import (
    DeepSpeedTransformerConfig as TConfig,
    DeepSpeedTransformerLayer as TLayer)
from deepspeed_tpu_torch.ops.transformer import transformer as ttr
from torch_one_thread import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-3
# head dim 64: the smallest flash attention takes (D a multiple of 64)
H, HEADS, INTER, B = 128, 2, 512, 2


def _cfg(**over):
    base = dict(hidden_size=H, heads=HEADS, intermediate_size=INTER,
                attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
                num_hidden_layers=2, initializer_range=0.02, training=True)
    base.update(over)
    return base


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", torch.from_numpy(
                np.array(value, np.float32))


def _rel_l2(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _inputs(t, seed=0, with_mask=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, t, H) * 0.5).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.zeros((B, 1, 1, t), np.float32)
        for i, keep in enumerate(rng.randint(t // 2, t, size=B)):
            mask[i, :, :, keep:] = -1e9
    return x, mask


def _pair(t=128, seed=0, **over):
    """(JAX layer, its params, the port's layer holding them)."""
    kw = _cfg(**over)
    jlayer = JLayer(JConfig(**kw))
    x, _ = _inputs(t, seed)
    params = jlayer.init({"params": jax.random.PRNGKey(seed)},
                         jnp.asarray(x), None, True)
    layer = TLayer(TConfig(**kw), device="cpu")
    layer.load_state_dict(dict(_flat(jax.tree_util.tree_map(
        np.asarray, params["params"]))))
    return jlayer, params, layer


def _port_out(layer, x, mask, **kw):
    return layer(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask), True,
                 **kw)


def _jax_out(jlayer, params, x, mask):
    return np.asarray(jlayer.apply(
        params, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        True), np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("pre_ln", [True, False], ids=["preln", "postln"])
def test_forward_matches_jax(pre_ln, dtype, fused, masked):
    jlayer, params, layer = _pair(pre_layer_norm=pre_ln, fused_ops=fused,
                                  bf16=dtype == "bf16")
    x, mask = _inputs(128, seed=1, with_mask=masked)
    ref = _jax_out(jlayer, params, x, mask)
    with torch.no_grad():
        got = _port_out(layer, x, mask)
    # the post-LN fused chain returns fp32; the unfused bf16 pre-LN
    # stream stays fp32 too (the input's dtype)
    assert got.dtype == torch.float32
    got = got.numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert _rel_l2(got, ref) <= BF16_TOL
    if masked:
        # the mask changes the output (keys past the padding are out)
        with torch.no_grad():
            free = _port_out(layer, x, None).numpy()
        assert not np.allclose(free, got)


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("pre_ln", [True, False], ids=["preln", "postln"])
@pytest.mark.parametrize("t,masked", [(128, False), (128, True),
                                      (120, True)],
                         ids=["flash", "mask", "t120"])
def test_fp32_gradients_match_jax(pre_ln, fused, t, masked):
    """d<out, ct>/d(every parameter, the input) against jax.grad of the
    same scalar."""
    jlayer, params, layer = _pair(t=t, pre_layer_norm=pre_ln,
                                  fused_ops=fused)
    x, mask = _inputs(t, seed=2, with_mask=masked)
    ct = np.random.RandomState(3).randn(B, t, H).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(p, xx):
        return jnp.sum(jlayer.apply(p, xx, jmask, True) * ct)

    ref_p, ref_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    ref = dict(_flat(jax.tree_util.tree_map(np.asarray, ref_p["params"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt, None if mask is None else torch.from_numpy(mask), True)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                [xt] + [p for _, p in
                                        layer.named_parameters()])
    assert _rel_l2(grads[0].numpy(), np.asarray(ref_x)) <= GRAD_TOL
    for name, g in zip(names, grads[1:]):
        assert _rel_l2(g.numpy(), ref[name].numpy()) <= GRAD_TOL, name


@pytest.mark.parametrize("flag", ["normalize_invertible", "gelu_checkpoint",
                                  "attn_dropout_checkpoint"])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_memory_flags_keep_the_values(flag, fused):
    """Remat under each flag (per fusion under fused ops, as JAX's
    layer: save_fused_epilogues; else the whole block): the output and
    every gradient equal the layer's without the flag bit for bit (the
    kept outputs are the forward's, the rest runs again), and the output
    matches JAX's layer with the flag."""
    jlayer, params, layer = _pair(pre_layer_norm=False, fused_ops=fused,
                                  **{flag: True})
    plain = TLayer(TConfig(**_cfg(pre_layer_norm=False, fused_ops=fused)),
                   device="cpu")
    plain.load_state_dict(layer.state_dict())
    assert layer.config.any_checkpointing
    x, _ = _inputs(128, seed=4)
    results = []
    for lay in (layer, plain):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = lay(xt, None, True)
        grads = torch.autograd.grad(out.square().sum(),
                                    [xt] + list(lay.parameters()))
        results.append((out.detach(), grads))
    (out_f, g_f), (out_p, g_p) = results
    assert torch.equal(out_f, out_p)
    assert all(torch.equal(a, b) for a, b in zip(g_f, g_p))
    np.testing.assert_allclose(out_f.numpy(),
                               _jax_out(jlayer, params, x, None),
                               atol=F32_TOL, rtol=F32_TOL)


def test_memory_flag_recomputes_the_block():
    """Under a flag and gradients the core runs once more in the
    backward (the full-block recompute); without gradients it runs
    once."""
    layer = TLayer(TConfig(**_cfg(gelu_checkpoint=True)), device="cpu")
    layer.init_params(0)
    calls = []
    # a pre-hook: the recompute stops once it has what the backward
    # needs, before the core's forward returns
    layer.core.register_forward_pre_hook(lambda *a: calls.append(1))
    x = torch.randn(B, 128, H, requires_grad=True)
    layer(x, None, True).sum().backward()
    assert len(calls) == 2
    calls.clear()
    with torch.no_grad():
        layer(x, None, True)
    assert len(calls) == 1


@pytest.mark.parametrize("fused", ["on", "off"])
def test_sr_fallback_matches_jax_without_a_seed(fused):
    """quantized_compute "auto" resolves off on the CPU; with stochastic
    rounding configured the projections are the JAX package's
    sr_fallback. Without a quant stream both packages round to nearest,
    bit for bit the unquantized layer; with the port's seed the operand
    casts round stochastically: reproducible, different, and within a
    few bf16 roundings of round-to-nearest."""
    over = dict(pre_layer_norm=False, fused_ops=fused, bf16=True,
                quantized_compute="auto", quant_stochastic_rounding=True)
    jlayer, params, layer = _pair(**over)
    assert isinstance(layer.core.inter_w, ttr.QuantizedDense)
    plain = TLayer(TConfig(**_cfg(pre_layer_norm=False, fused_ops=fused,
                                  bf16=True)), device="cpu")
    plain.load_state_dict(layer.state_dict())
    assert isinstance(plain.core.inter_w, ttr.SplitDense)
    x, _ = _inputs(128, seed=5)
    with torch.no_grad():
        nearest = _port_out(layer, x, None)
        assert torch.equal(nearest, _port_out(plain, x, None))
        sr = _port_out(layer, x, None, quant_seed=11)
        again = _port_out(layer, x, None, quant_seed=11)
        other = _port_out(layer, x, None, quant_seed=12)
    assert _rel_l2(nearest.numpy(), _jax_out(jlayer, params, x, None)) <= \
        BF16_TOL
    assert torch.equal(sr, again) and not torch.equal(sr, other)
    assert not torch.equal(sr, nearest)
    # each operand cast moves a value by under one bf16 ulp (2^-8
    # relative), so the output moves by a few such roundings
    assert _rel_l2(sr.numpy(), nearest.numpy()) <= 2e-2


def _dropout_layer(hidden=0.0, attn=0.0):
    """Pre-LN, unfused, with projections that make dropout countable:
    hidden dropout sees the attn_ow and output_w biases (ones) alone;
    attention dropout sees v = 1 in every column, so each context entry
    is the kept probability mass over (1 - rate)."""
    layer = TLayer(TConfig(**_cfg(hidden_dropout_ratio=hidden,
                                  attn_dropout_ratio=attn,
                                  pre_layer_norm=True, fused_ops="auto")),
                   device="cpu")
    layer.init_params(0)
    core = layer.core
    with torch.no_grad():
        for proj in (core.attn_qkvw, core.attn_ow, core.inter_w,
                     core.output_w):
            proj.kernel.zero_()
            proj.bias.zero_()
        if hidden:
            core.attn_ow.bias.fill_(1.0)
            core.output_w.bias.fill_(1.0)
        else:
            core.attn_qkvw.bias[2 * H:].fill_(1.0)   # v = 1
            core.attn_ow.kernel.copy_(torch.eye(H))
    return layer


def test_hidden_dropout_rate_and_reproducibility():
    rate = 0.3
    layer = _dropout_layer(hidden=rate)
    x = torch.zeros(B, 128, H)
    with torch.no_grad():
        out = layer(x, None, False, dropout_seed=5)
        again = layer(x, None, False, dropout_seed=5)
        other = layer(x, None, False, dropout_seed=6)
        det = layer(x, None, True)
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert torch.equal(det, torch.full_like(det, 2.0))
    n = out.numel()
    # two independent masks: P(both dropped) = rate^2; the mean stays 2
    zeros = float((out == 0).float().mean())
    assert abs(zeros - rate ** 2) <= 4 * np.sqrt(rate ** 2 / n) + 1e-3
    assert abs(float(out.mean()) - 2.0) <= 0.02
    with pytest.raises(ValueError, match="dropout seed"):
        layer(x, None, False)


def test_attention_dropout_rate_and_reproducibility():
    rate = 0.25
    layer = _dropout_layer(attn=rate)
    x = torch.randn(B, 120, H, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        det = layer(x, None, True) - x
        out = layer(x, None, False, dropout_seed=7) - x
        again = layer(x, None, False, dropout_seed=7) - x
    torch.testing.assert_close(det, torch.ones_like(det))
    assert torch.equal(out, again) and not torch.equal(out, det)
    # each context entry is a sum of kept probabilities / (1 - rate):
    # unbiased, with a spread
    assert abs(float(out.mean()) - 1.0) <= 0.01
    assert float(out.std()) > 0.05


def test_attention_routes():
    """Flash without a mask and without attention dropout where usable
    (T a multiple of 128); dense attention with a mask, at T 120, and
    with attention dropout."""
    layer = TLayer(TConfig(**_cfg(attn_dropout_ratio=0.1)), device="cpu")
    layer.init_params(0)
    routes = []
    real_flash, real_dense = ttr.flash_attention, ttr.dense_attention

    def flash(*a, **k):
        routes.append("flash")
        assert k["causal"] is False
        return real_flash(*a, **k)

    def dense(*a, **k):
        routes.append("dense")
        return real_dense(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(ttr, "flash_attention", flash)
    mp.setattr(ttr, "dense_attention", dense)
    try:
        with torch.no_grad():
            layer(torch.randn(1, 128, H), None, True)
            layer(torch.randn(1, 128, H), torch.zeros(1, 1, 1, 128), True)
            layer(torch.randn(1, 120, H), None, True)
            layer(torch.randn(1, 128, H), None, False, dropout_seed=1)
    finally:
        mp.undo()
    assert routes == ["flash", "dense", "dense", "dense"]


def test_fp16_raises_naming_item_4():
    """fp16 builds the layer in fp16 (item 4 is ported), and with the
    quantized projections too (K6's fp16 output is ported): its
    projections are QuantizedDense and a forward gives finite fp16
    values."""
    layer = TLayer(TConfig(**_cfg(fp16=True)), device="cpu")
    assert layer.config.compute_dtype == torch.float16
    layer = TLayer(TConfig(**_cfg(fp16=True, quantized_compute="on")),
                   device="cpu")
    layer.init_params(0)
    assert isinstance(layer.core.attn_qkvw, ttr.QuantizedDense)
    out = layer(torch.randn(1, 128, H).half(), None, True)
    assert out.dtype == torch.float16 and bool(torch.isfinite(out).all())


def test_the_layer_defaults_to_cuda():
    """The layer is an entry point: it is built on CUDA unless the caller
    asks for the CPU, and raises where there is no CUDA."""
    if torch.cuda.is_available():
        layer = TLayer(TConfig(**_cfg()))
        assert layer.core.attn_qkvw.kernel.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TLayer(TConfig(**_cfg()))


def test_config_from_dict_and_flags():
    cfg = TConfig.from_dict({"hidden_size": 128, "heads": 2,
                             "gelu_checkpoint": True, "extra_key": 3})
    assert cfg.intermediate_size == 512 and cfg.extra_key == 3
    assert cfg.any_checkpointing and not TConfig(hidden_size=8).\
        any_checkpointing
    jcfg = JConfig(hidden_size=128, heads=2)
    assert vars(TConfig(hidden_size=128, heads=2)) == vars(jcfg)


def test_init_params_follows_the_jax_init():
    cfg = TConfig(**_cfg(num_hidden_layers=8))
    params = TLayer(cfg, device="cpu").init_params(3)
    assert set(params) == {f"core.{m}.{leaf}" for m, leaves in (
        ("attn_qkvw", ("kernel", "bias")), ("attn_ow", ("kernel", "bias")),
        ("inter_w", ("kernel", "bias")), ("output_w", ("kernel", "bias")),
        ("attn_layer_norm", ("scale", "bias")),
        ("layer_norm", ("scale", "bias"))) for leaf in leaves}
    assert abs(float(params["core.inter_w.kernel"].std()) - 0.02) < 2e-3
    assert abs(float(params["core.output_w.kernel"].std()) -
               0.02 / 4.0) < 5e-4
    assert float(params["core.layer_norm.scale"].min()) == 1.0
    assert float(params["core.attn_ow.bias"].abs().max()) == 0.0
