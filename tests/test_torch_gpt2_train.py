"""PyTorch port: the GPT-2 training loss and its gradients against the
JAX package.

A JAX GPT-2 tree (tiny config) goes through
`models.convert.params_from_jax` into the port; both packages then take
the causal-LM loss of the same numpy-seeded batch and its gradient in
every parameter: `jax.value_and_grad(GPT2ForCausalLM.loss_fn)` against
the port's `loss_fn` under torch autograd. The JAX side runs flash
attention and the fused ops as its CPU tests run them (Pallas interpret
mode / the XLA form); the port runs its plain twins. Both phrasings
(fused_ops "on" with the boundary carry, "off" op by op) and remat on
and off are covered; dropout 0 there, and dropout > 0 by its
statistics and by its reproducibility under remat.

Tolerance: fp32 throughout, two layers; the packages differ in
reduction order only, so the loss agrees to 1e-5 relative and every
gradient to 1e-4 relative L2 (observed ~1e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.transformer.flash_attention import dropout

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jgpt2.tiny_gpt2_config(n_positions=128)
    params = jgpt2.GPT2ForCausalLM(cfg).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return jax.tree_util.tree_map(np.asarray, params)


def _rel_l2(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _port(tree, **overrides):
    cfg = tgpt2.tiny_gpt2_config(n_positions=128, **overrides)
    model = tgpt2.GPT2ForCausalLM(cfg, device="cpu")
    params = {k: v.clone().requires_grad_(True)
              for k, v in params_from_jax(tree).items()}
    return model, params


def _ids(seed, shape=(2, 128)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_loss_and_grads_match_jax(jax_tree, fused, remat):
    ids = _ids(1)
    jcfg = jgpt2.tiny_gpt2_config(n_positions=128, fused_ops=fused,
                                  remat=remat)
    tree = jax_tree
    if remat:
        # the remat scan cell's name; same leaves
        tree = dict(tree, h={"CheckpointGPT2Block_0":
                             tree["h"]["GPT2Block_0"]})
    jmodel = jgpt2.GPT2ForCausalLM(jcfg)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {"input_ids": ids},
                                 deterministic=True))(tree)
    ref_grads = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       ref_grads))

    model, params = _port(tree, fused_ops=fused, remat=remat)
    loss = model.loss_fn(params, {"input_ids": ids}, deterministic=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - float(ref_loss)) <= \
        LOSS_TOL * abs(float(ref_loss))
    for name, g in zip(params, grads):
        assert _rel_l2(g.numpy(), ref_grads[name].numpy()) <= GRAD_TOL, name


def test_labels_and_the_chunked_head(jax_tree):
    """Explicit labels (with ignored positions) match the JAX loss; the
    chunked head with a chunk that does not divide the tokens equals the
    plain cross-entropy over the full logits, in both packages."""
    ids = _ids(2)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :10] = -100
    jmodel = jgpt2.GPT2ForCausalLM(jgpt2.tiny_gpt2_config(n_positions=128))
    ref = float(jmodel.loss_fn(jax_tree, {"input_ids": ids,
                                          "labels": labels},
                               deterministic=True))
    model, params = _port(jax_tree)
    with torch.no_grad():
        got = float(model.loss_fn(params, {"input_ids": ids,
                                           "labels": labels},
                                  deterministic=True))
        assert abs(got - ref) <= LOSS_TOL * abs(ref)
        logits = model.apply(params, ids)
        lab = torch.from_numpy(labels).long()
        full = tgpt2.cross_entropy_loss(logits, lab)
        hidden, wte = torch.func.functional_call(
            model.module, params, (torch.from_numpy(ids).long(),),
            {"return_hidden": True})
        chunked = tgpt2.chunked_tied_head_loss(hidden, wte, lab,
                                               chunk_tokens=100)
    jfull = float(jgpt2.cross_entropy_loss(
        jnp.asarray(logits.numpy()), jnp.asarray(labels)))
    assert abs(float(full) - jfull) <= LOSS_TOL * abs(jfull)
    assert abs(float(chunked) - float(full)) <= LOSS_TOL * abs(float(full))
    assert abs(float(full) - ref) <= LOSS_TOL * abs(ref)


@pytest.mark.parametrize("chunk", [64, 1024], ids=["chunk64", "chunk1024"])
def test_chunked_head_bf16_matches_jax(chunk):
    """bf16 hidden states and tied embedding: the [chunk, vocab] logits
    are fp32 from bf16 operands in both packages (JAX:
    preferred_element_type=float32), so the losses differ in summation
    order only: 1e-5 relative (observed 0; logits rounded to bf16
    before the logsumexp miss by 2.4e-4 here). The gradients are bf16;
    the port rounds the fp32 logits cotangent to bf16 for its two
    GEMMs, JAX does not, and each gradient is rounded to bf16 once:
    2e-2 relative L2 (observed 2.3e-3 to 2.6e-3)."""
    rng = np.random.RandomState(5)
    b, t, c, vocab = 2, 96, 64, 512
    hidden = (2.0 * rng.randn(b, t, c)).astype(np.float32)
    wte = (0.5 * rng.randn(vocab, c)).astype(np.float32)
    labels = rng.randint(0, vocab, (b, t)).astype(np.int32)
    labels[0, :7] = -100

    def jloss(h, w):
        return jgpt2.chunked_tied_head_loss(h, w, jnp.asarray(labels),
                                            chunk_tokens=chunk)

    jh, jw = (jnp.asarray(x, jnp.bfloat16) for x in (hidden, wte))
    ref, (ref_dh, ref_dw) = jax.value_and_grad(jloss, argnums=(0, 1))(jh,
                                                                      jw)
    th, tw = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
              for x in (hidden, wte))
    got = tgpt2.chunked_tied_head_loss(th, tw,
                                       torch.from_numpy(labels).long(),
                                       chunk_tokens=chunk)
    got.backward()
    assert got.dtype == torch.float32
    assert abs(float(got.detach()) - float(ref)) <= \
        LOSS_TOL * abs(float(ref))
    assert th.grad.dtype == tw.grad.dtype == torch.bfloat16
    assert _rel_l2(th.grad.float().numpy(),
                   np.asarray(ref_dh, np.float32)) <= 2e-2
    assert _rel_l2(tw.grad.float().numpy(),
                   np.asarray(ref_dw, np.float32)) <= 2e-2


def test_dropout_statistics():
    """flax Dropout's law: each element kept with probability 1 - rate
    and scaled by 1 / (1 - rate), so the mean is kept in expectation."""
    gen = torch.Generator()
    gen.manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.1, gen)
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.9) < 0.005
    assert torch.allclose(y[y != 0], torch.tensor(1.0 / 0.9))
    assert abs(float(y.mean()) - 1.0) < 0.01


def test_dropout_loss_is_seeded_and_reproducible_under_remat(jax_tree):
    """With dropout 0.1 the loss depends on rngs["dropout"] only: the
    same seed gives the same loss and gradients with and without remat
    (a block's recompute draws the same masks), another seed or the
    deterministic forward gives another loss."""
    ids = _ids(3)
    batch = {"input_ids": ids}
    runs = {}
    for remat in (False, True):
        model, params = _port(jax_tree, dropout=0.1, remat=remat)
        loss = model.loss_fn(params, batch, rngs={"dropout": 7})
        grads = torch.autograd.grad(loss, list(params.values()))
        runs[remat] = (float(loss.detach()), grads)
        with torch.no_grad():
            other = float(model.loss_fn(params, batch, rngs={"dropout": 8}))
            det = float(model.loss_fn(params, batch, deterministic=True))
        assert other != runs[remat][0] and det != runs[remat][0]
    assert runs[False][0] == runs[True][0]
    for a, b in zip(runs[False][1], runs[True][1]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
    model, params = _port(jax_tree, dropout=0.1)
    with pytest.raises(ValueError, match="seed"):
        model.loss_fn(params, batch)


def test_out_of_slice_training_options_raise(jax_tree):
    model, params = _port(jax_tree, remat=True,
                          remat_policy="save_fused_epilogues")
    with pytest.raises(NotImplementedError, match="remat"):
        model.loss_fn(params, {"input_ids": _ids(4)}, deterministic=True)
    model, params = _port(jax_tree)
    with pytest.raises(NotImplementedError, match="layer drop"):
        model.loss_fn(params, {"input_ids": _ids(4)},
                      layer_keep_prob=0.9)


def test_params_from_jax_converts_a_bf16_remat_training_tree():
    """The flagship trains a bf16 tree under remat (the scan child is
    CheckpointGPT2Block_0, leaves numpy bfloat16); it converts to
    torch.bfloat16 with the same values."""
    cfg = jgpt2.tiny_gpt2_config(n_positions=128, remat=True,
                                 param_dtype=jnp.bfloat16,
                                 dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jgpt2.GPT2ForCausalLM(
        cfg).init(jax.random.PRNGKey(1),
                  {"input_ids": np.zeros((1, 8), np.int32)}))
    assert list(tree["h"]) == ["CheckpointGPT2Block_0"]
    params = params_from_jax(tree)
    assert all(v.dtype == torch.bfloat16 for v in params.values())
    stacked = tree["h"]["CheckpointGPT2Block_0"]
    np.testing.assert_array_equal(
        params["h.1.c_fc.kernel"].float().numpy(),
        stacked["c_fc"]["kernel"][1].astype(np.float32))
    model = tgpt2.GPT2ForCausalLM(dataclasses.replace(
        tgpt2.tiny_gpt2_config(n_positions=128),
        param_dtype=torch.bfloat16), device="cpu")
    loaded = model.load_params(params)
    assert torch.equal(loaded["wte"], params["wte"])
