"""PyTorch port: the fp16 forms of K1-K4 and the fp16 models against the
JAX package, on the CPU.

The port's wrappers run their plain twins on the CPU; in fp16 these
tests hold them against the JAX package's kernels as its own tests run
them (the Pallas kernels in interpret mode), on numpy-seeded inputs:
K3-fwd in the fp16 paths' dtype pairings (GPT-2's all-fp16 rows,
BERT's post-LN forms with an fp16 and then an fp32 residual and fp32
out), K3-bwd and K4 (tanh and erf) through autograd, K1-fwd and K2
(causal and not). Overflow must survive every kernel: an inf in y (the
forward) or in the output cotangent (the backward) gives non-finite
values at exactly the positions where the JAX kernel gives them.
Then the fused transformer layer (pre-LN and post-LN, fused "on") and
BERT's pretraining loss and gradients in fp16 against the JAX package's.

Tolerances. fp16 rows carry 10 mantissa bits: a value on a rounding
point in one package's reduction order and not the other's lands one
ulp (2^-10 relative) away, so fp16 outputs and row cotangents are held
to 2e-3 relative L2 (two ulps) and fp32 outputs of fp16 inputs to 1e-5
(the same fp32 chain); the vectors' gradients are fp32 sums of the same
terms, 1e-4. Attention: P rounds to fp16 before P.V in both packages,
each against its own running max: 2e-3 on out, 5e-3 on the gradients
(dS rounds too). The layer and BERT chain many fp16 roundings in each
package's order: 5e-3 relative L2 on outputs, losses and gradients
(observed below 2e-3), the fp16 model-parity tolerance.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops.transformer import (
    DeepSpeedTransformerConfig as JConfig,
    DeepSpeedTransformerLayer as JLayer)
from deepspeed_tpu.ops.transformer import fused_ops as jfo
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models.convert import (bert_config_from_jax,
                                                bert_params_from_jax)
from deepspeed_tpu_torch.ops.transformer import (
    DeepSpeedTransformerConfig as TConfig,
    DeepSpeedTransformerLayer as TLayer)
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo
from torch_one_thread import one_torch_thread  # noqa: F401

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

DT = {"fp16": (jnp.float16, torch.float16), "fp32": (jnp.float32,
                                                    torch.float32)}
ROW_TOL = {"fp16": 2e-3, "fp32": 1e-5}
VEC_TOL = 1e-4
ATTN_TOL, ATTN_GRAD_TOL = 2e-3, 5e-3
MODEL_TOL = 5e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_l2(got, ref):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _same_nonfinite(got, ref):
    return np.array_equal(~np.isfinite(_np(got)), ~np.isfinite(_np(ref)))


# K3-fwd's fp16 forms on the paths: (y, residual, vectors, out, sum)
LN_FP16 = {
    "gpt2": ("fp16", "fp16", "fp16", "fp16", "fp16"),
    "bert-fp16_residual": ("fp16", "fp16", "fp16", "fp32", "fp16"),
    "bert-fp32_residual": ("fp16", "fp32", "fp16", "fp32", "fp32"),
}


@pytest.mark.parametrize("form", list(LN_FP16))
def test_layernorm_fp16_twin_matches_jax(form):
    """K3-fwd's outputs and K3-bwd's gradients (y, bias, residual, gamma,
    beta, through out and the sum) against the JAX kernel's, then an inf
    in one y row: the same non-finite outputs."""
    y_dt, r_dt, v_dt, o_dt, s_dt = LN_FP16[form]
    h, n = 64, 16
    r = np.random.RandomState(len(form))
    y, res = (r.randn(n, h).astype(np.float32) for _ in range(2))
    bias, beta = ((0.1 * r.randn(h)).astype(np.float32) for _ in range(2))
    gamma = (1.0 + 0.1 * r.randn(h)).astype(np.float32)
    g_out, g_sum = (r.randn(n, h).astype(np.float32) for _ in range(2))

    def jrun(y, bias, res, gamma, beta):
        return jfo.fused_bias_residual_layernorm(
            y, bias, res, gamma, beta, eps=1e-5, out_dtype=DT[o_dt][0],
            sum_dtype=DT[s_dt][0], impl="interpret")

    def jloss(*args):
        o, s = jrun(*args)
        return jnp.sum(o.astype(jnp.float32) * g_out) + \
            jnp.sum(s.astype(jnp.float32) * g_sum)

    jargs = (jnp.asarray(y, DT[y_dt][0]), jnp.asarray(bias, DT[v_dt][0]),
             jnp.asarray(res, DT[r_dt][0]), jnp.asarray(gamma, DT[v_dt][0]),
             jnp.asarray(beta, DT[v_dt][0]))
    targs = [torch.from_numpy(a).to(dt).requires_grad_(True) for a, dt in
             ((y, DT[y_dt][1]), (bias, DT[v_dt][1]), (res, DT[r_dt][1]),
              (gamma, DT[v_dt][1]), (beta, DT[v_dt][1]))]
    ref_o, ref_s = jrun(*jargs)
    out, s = tfo.fused_bias_residual_layernorm(
        *targs, eps=1e-5, out_dtype=DT[o_dt][1], sum_dtype=DT[s_dt][1])
    assert out.dtype == DT[o_dt][1] and s.dtype == DT[s_dt][1]
    assert _rel_l2(out, ref_o) <= ROW_TOL[o_dt]
    assert _rel_l2(s, ref_s) <= ROW_TOL[s_dt]
    ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*jargs)
    got = torch.autograd.grad(
        (out.float() * torch.from_numpy(g_out)).sum() +
        (s.float() * torch.from_numpy(g_sum)).sum(), targs)
    for name, a, b, dt in zip(("y", "bias", "residual", "gamma", "beta"),
                              got, ref, (y_dt, v_dt, r_dt, v_dt, v_dt)):
        assert a.dtype == DT[dt][1], name
        tol = max(ROW_TOL[dt], VEC_TOL)
        assert _rel_l2(a, b) <= tol, (name, _rel_l2(a, b))
    y[3, 5] = np.inf
    jargs = (jnp.asarray(y, DT[y_dt][0]),) + jargs[1:]
    ref_o, ref_s = jrun(*jargs)
    out, s = tfo.fused_bias_residual_layernorm(
        torch.from_numpy(y).to(DT[y_dt][1]), *targs[1:], eps=1e-5,
        out_dtype=DT[o_dt][1], sum_dtype=DT[s_dt][1])
    assert not np.isfinite(_np(out)[3]).any()
    assert _same_nonfinite(out, ref_o) and _same_nonfinite(s, ref_s)


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_gelu_fp16_twin_matches_jax(approximate):
    """K4-fwd and K4-bwd in fp16 (fp16 bias, as the engine holds it),
    then an inf in x and one in the cotangent."""
    w, n = 64, 16
    r = np.random.RandomState(3 + approximate)
    x = (2.0 * r.randn(n, w)).astype(np.float32)
    bias = (0.1 * r.randn(w)).astype(np.float32)
    g = r.randn(n, w).astype(np.float32)

    def jrun(x, b):
        return jfo.fused_bias_gelu(x, b, approximate=approximate,
                                   impl="interpret")

    jx, jb = jnp.asarray(x, jnp.float16), jnp.asarray(bias, jnp.float16)
    tx = torch.from_numpy(x).half().requires_grad_(True)
    tb = torch.from_numpy(bias).half().requires_grad_(True)
    out = tfo.fused_bias_gelu(tx, tb, approximate=approximate)
    assert out.dtype == torch.float16
    assert _rel_l2(out, jrun(jx, jb)) <= ROW_TOL["fp16"]
    ref = jax.grad(lambda a, b: jnp.sum(jrun(a, b).astype(jnp.float32) * g),
                   argnums=(0, 1))(jx, jb)
    got = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(),
                              (tx, tb))
    assert got[0].dtype == got[1].dtype == torch.float16
    assert _rel_l2(got[0], ref[0]) <= ROW_TOL["fp16"]
    assert _rel_l2(got[1], ref[1]) <= ROW_TOL["fp16"]
    x[2, 7] = np.inf
    g[5, 1] = np.inf
    jx = jnp.asarray(x, jnp.float16)
    assert _same_nonfinite(
        tfo.fused_bias_gelu(torch.from_numpy(x).half(), tb.detach(),
                            approximate=approximate), jrun(jx, jb))
    ref = jax.grad(lambda a, b: jnp.sum(jrun(a, b).astype(jnp.float32) * g),
                   argnums=(0, 1))(jnp.asarray(x * 0 + 1, jnp.float16), jb)
    tx = torch.from_numpy(x * 0 + 1).half().requires_grad_(True)
    got = torch.autograd.grad(
        (tfo.fused_bias_gelu(tx, tb, approximate=approximate).float() *
         torch.from_numpy(g)).sum(), (tx, tb))
    assert not np.isfinite(_np(got[0])[5]).all()
    assert _same_nonfinite(got[0], ref[0])
    assert _same_nonfinite(got[1], ref[1])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_fp16_twin_matches_jax(causal):
    """K1-fwd and K2 in fp16 at D 64 (the Hopper body's tiles), then an
    inf in the output cotangent: non-finite gradients in both."""
    b, t, h, d = 1, 128, 2, 64
    r = np.random.RandomState(11 + causal)
    q, k, v, g = (r.randn(b, t, h, d).astype(np.float32) for _ in range(4))

    def jout(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                            interpret=True)[0]

    jq, jk, jv = (jnp.asarray(x, jnp.float16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).half().requires_grad_(True)
                  for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == torch.float16
    assert _rel_l2(out, jout(jq, jk, jv)) <= ATTN_TOL
    for gg in (g, np.where(np.arange(t)[None, :, None, None] == 9, np.inf,
                           g).astype(np.float32)):
        ref = jax.grad(lambda *a: jnp.sum(jout(*a).astype(jnp.float32) *
                                          gg), argnums=(0, 1, 2))(jq, jk, jv)
        got = torch.autograd.grad((out.float() * torch.from_numpy(gg)).sum(),
                                  (tq, tk, tv), retain_graph=True)
        for name, a, bb in zip(("dq", "dk", "dv"), got, ref):
            assert a.dtype == torch.float16
            if np.isfinite(gg).all():
                assert _rel_l2(a, bb) <= ATTN_GRAD_TOL, name
            else:
                assert not np.isfinite(_np(a)).all(), name
                assert not np.isfinite(_np(bb)).all(), name


# ----------------------------------------------------------------------
# the fused layer and BERT in fp16
# ----------------------------------------------------------------------
H, HEADS, INTER, B, T = 128, 2, 512, 2, 128


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", torch.from_numpy(
                np.array(value, np.float32))


@pytest.mark.parametrize("pre_ln", [True, False], ids=["preln", "postln"])
def test_fp16_layer_matches_jax(pre_ln):
    """The fused layer (K1-K4's twins) in fp16 against the JAX layer in
    fp16: the output and every gradient under a random cotangent."""
    kw = dict(hidden_size=H, heads=HEADS, intermediate_size=INTER,
              attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
              num_hidden_layers=2, initializer_range=0.02, training=True,
              pre_layer_norm=pre_ln, fused_ops="on", fp16=True)
    jlayer = JLayer(JConfig(**kw))
    r = np.random.RandomState(5 + pre_ln)
    x = (0.5 * r.randn(B, T, H)).astype(np.float32)
    ct = r.randn(B, T, H).astype(np.float32)
    params = jlayer.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x),
                         None, True)
    layer = TLayer(TConfig(**kw), device="cpu")
    layer.load_state_dict(dict(_flat(jax.tree_util.tree_map(
        np.asarray, params["params"]))))

    def jloss(p, xx):
        return jnp.sum(jlayer.apply(p, xx, None, True).astype(jnp.float32)
                       * ct)

    ref_out = jax.jit(lambda p, xx: jlayer.apply(p, xx, None, True))(
        params, jnp.asarray(x))
    ref_p, ref_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    ref = dict(_flat(jax.tree_util.tree_map(np.asarray, ref_p["params"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt, None, True)
    assert _rel_l2(out, ref_out) <= MODEL_TOL
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((out.float() * torch.from_numpy(ct)).sum(),
                                [xt] + [p for _, p in
                                        layer.named_parameters()])
    assert _rel_l2(grads[0], ref_x) <= MODEL_TOL
    for name, gr in zip(names, grads[1:]):
        assert _rel_l2(gr, ref[name]) <= MODEL_TOL, (name,
                                                     _rel_l2(gr, ref[name]))


def test_fp16_bert_loss_and_grads_match_jax():
    """bert-tiny in fp16 on fp16 parameters (as the engine holds them),
    fused "on" (K3/K4's twins; flash needs head dim 64, so dense
    attention at bert-tiny's 16): the pretraining loss and every
    gradient against the JAX model's."""
    jcfg = jbert.tiny_bert_config(fp16=True, bf16=False, fused_ops="on",
                                  max_position_embeddings=64)
    jmodel = jbert.BertForPreTrainingLM(jcfg)
    r = np.random.RandomState(9)
    ids = r.randint(0, 256, (2, 64)).astype(np.int32)
    batch = {"input_ids": ids,
             "masked_lm_labels": np.where(r.rand(2, 64) < 0.2, ids, -100)
             .astype(np.int32),
             "next_sentence_label": r.randint(0, 2, (2,)).astype(np.int32)}
    params = jmodel.init(jax.random.PRNGKey(0), {"input_ids": ids})
    half = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float16),
                                  params)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch, deterministic=True)))(half)
    model = tbert.BertForPreTrainingLM(bert_config_from_jax(jcfg),
                                       device="cpu")
    tparams = {k: v.half().requires_grad_(True) for k, v in
               bert_params_from_jax(jax.tree_util.tree_map(
                   np.asarray, params)).items()}
    loss = model.loss_fn(tparams, {k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                         deterministic=True)
    assert abs(float(loss.detach()) - float(jloss)) <= \
        MODEL_TOL * abs(float(jloss))
    grads = torch.autograd.grad(loss, list(tparams.values()))
    ref = bert_params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jgrads))
    for (name, _), g in zip(tparams.items(), grads):
        assert g.dtype == torch.float16, name
        if float(np.linalg.norm(ref[name].numpy())) == 0.0:
            assert float(g.float().abs().max()) == 0.0, name
            continue
        assert _rel_l2(g, ref[name]) <= MODEL_TOL, (name,
                                                    _rel_l2(g, ref[name]))
