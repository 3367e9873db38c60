"""PyTorch port: BERT pretraining (`models/bert.py`) against the JAX
package.

A JAX bert-tiny tree (`tiny_bert_config`: 2 layers, H 64, 4 heads,
vocab 256, dropout 0, fp32) goes through `bert_params_from_jax` into the
port; both packages take the MLM and NSP logits, the pretraining loss
(with and without `next_sentence_label`) and every gradient on the same
numpy-seeded batch with a padding mask and token types, on the fused
("on": the port's plain twins, the JAX package's XLA form) and unfused
routes, post-LN and pre-LN; on bf16 parameters, as the engines hold
them, the encoder's carry is bf16 in both. `bert_params_to_jax` inverts
`bert_params_from_jax`. The engines' trajectory at gradient
accumulation 2 (`_ds_config`, TRAJ_TOL) is held in
tests/test_torch_bert_engine.py. Last, what raises: the ZeRO-3 scheduler (Queue 1 item 6); fp16,
ported since, builds (it is held in `test_torch_fp16_kernels.py`).

Tolerances (fp32; the packages differ in reduction order only): logits
within 1e-5 absolute and relative (observed <= 1.7e-6), the loss within
1e-5 relative (observed <= 8.5e-8) and every gradient within 1e-4
relative L2 (observed <= 6.1e-7), as in `test_torch_gpt2_train.py`; the
engines' losses within 1e-5 relative at every step, as in
`test_torch_engine.py` (observed <= 7.7e-7).
"""

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models.convert import (bert_config_from_jax,
                                                bert_params_from_jax,
                                                bert_params_to_jax)
from torch_one_thread import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TRAJ_TOL = 1e-5
BF16_CARRY_TOL = 1e-2
T = 64


def _batch(bs=4, t=T, vocab=256, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (bs, t)).astype(np.int32)
    labels = np.where(rng.rand(bs, t) < 0.15, ids, -100).astype(np.int32)
    mask = np.ones((bs, t), np.int32)
    mask[1, t - 20:] = 0
    types = np.zeros((bs, t), np.int32)
    types[:, t // 2:] = 1
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": types, "masked_lm_labels": labels,
            "next_sentence_label": rng.randint(0, 2, (bs,)).astype(np.int32)}


def _rel_l2(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module", params=[False, True],
                ids=["postln", "preln"])
def jax_bert(request):
    cfg = jbert.tiny_bert_config(pre_layer_norm=request.param)
    model = jbert.BertForPreTrainingLM(cfg)
    params = model.init(jax.random.PRNGKey(0), _batch())
    return cfg, model, params, jax.tree_util.tree_map(np.asarray, params)


def _port(jcfg, tree, **over):
    model = tbert.BertForPreTrainingLM(bert_config_from_jax(jcfg, **over),
                                       device="cpu")
    params = {k: v.clone().requires_grad_(True)
              for k, v in bert_params_from_jax(tree).items()}
    return model, params


def test_params_round_trip(jax_bert):
    _, _, _, tree = jax_bert
    flat = bert_params_from_jax(tree)
    model, _ = _port(jax_bert[0], tree)
    assert set(flat) == set(model.params())
    assert "bert.encoder.layer.1.core.attn_qkvw.kernel" in flat
    back = bert_params_to_jax(flat)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == {p for p, _ in want}
    for path, value in want:
        assert np.array_equal(got[path].numpy(), value), path
    via_model = dict(jax.tree_util.tree_flatten_with_path(
        model.params_to_jax(flat))[0])
    assert all(torch.equal(via_model[p], got[p]) for p in got)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_logits_match_jax(jax_bert, fused):
    jcfg, jmodel, jparams, tree = jax_bert
    batch = _batch(seed=1)
    ref_mlm, ref_nsp = jmodel.module.apply(
        {"params": jparams}, batch["input_ids"], batch["attention_mask"],
        batch["token_type_ids"], True)
    model, params = _port(jcfg, tree, fused_ops=fused)
    mlm, nsp = model.apply(params, batch["input_ids"],
                           batch["attention_mask"], batch["token_type_ids"])
    assert mlm.shape == (4, T, 256) and nsp.shape == (4, 2)
    assert mlm.dtype == torch.float32 and nsp.dtype == torch.float32
    np.testing.assert_allclose(mlm.numpy(), np.asarray(ref_mlm),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(ref_nsp),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("nsp", [True, False], ids=["mlm+nsp", "mlm"])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_loss_and_grads_match_jax(jax_bert, fused, nsp):
    jcfg, jmodel, jparams, tree = jax_bert
    batch = _batch(seed=2)
    if not nsp:
        del batch["next_sentence_label"]
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch, deterministic=True))(jparams)
    ref_grads = bert_params_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_grads))
    model, params = _port(jcfg, tree, fused_ops=fused)
    loss = model.loss_fn(params, batch, deterministic=True)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - float(ref_loss)) <= \
        LOSS_TOL * abs(float(ref_loss))
    for name, g in zip(params, grads):
        ref = ref_grads[name].numpy()
        if g is None:
            # the pooler and the NSP head without next_sentence_label
            assert not nsp and not np.any(ref), name
            continue
        assert _rel_l2(g.numpy(), ref) <= GRAD_TOL, name


def test_loss_without_mask_takes_the_flash_route(jax_bert):
    """No attention mask and no dropout at T 128: flash attention in both
    packages (the port's twin on the CPU, the JAX kernel as its CPU
    tests run it)."""
    jcfg, jmodel, jparams, tree = jax_bert
    batch = _batch(t=128, seed=3)
    del batch["attention_mask"]
    ref = float(jmodel.loss_fn(jparams, batch, deterministic=True))
    model, params = _port(jcfg, tree, fused_ops="on")
    with torch.no_grad():
        got = float(model.loss_fn(params, batch, deterministic=True))
    assert abs(got - ref) <= LOSS_TOL * abs(ref)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_bf16_parameters_keep_a_bf16_carry(jax_bert, fused):
    """bf16 compute on bf16 parameters, as both engines hold them under
    `bf16.enabled`: the embedding LayerNorm's output, and so the
    encoder's carry, is bf16 in both packages (flax's LayerNorm without
    a dtype takes its input's and parameters' promotion), the post-LN
    layers' K3 sees a bf16 residual at the attention LayerNorm and an
    fp32 one at the output LayerNorm. The sequence output and the logits
    agree within BF16_CARRY_TOL relative L2: each carry entry is rounded
    to bf16 (2^-8 relative) once a layer, and the unfused GeLU rounds
    its bf16 intermediates in JAX but once in torch (observed 6e-7 fused,
    6.2e-4 unfused pre-LN, 4.5e-3 unfused post-LN)."""
    jcfg, jmodel, _, tree = jax_bert
    jcfg = jcfg.__class__(**dict(vars(jcfg), bf16=True, fused_ops=fused))
    jmodel = jbert.BertForPreTrainingLM(jcfg)
    jparams = jax.tree_util.tree_map(
        lambda x: jax.numpy.asarray(x, jax.numpy.bfloat16), tree)
    batch = _batch(seed=5)
    del batch["attention_mask"]
    seq, _ = jbert.BertModel(jcfg).apply(
        {"params": jparams["bert"]}, batch["input_ids"], None,
        batch["token_type_ids"], True)
    ref_mlm, _ = jmodel.module.apply({"params": jparams}, batch["input_ids"],
                                     None, batch["token_type_ids"], True)
    model = tbert.BertForPreTrainingLM(bert_config_from_jax(jcfg),
                                       device="cpu")
    params = {k: v.to(torch.bfloat16)
              for k, v in bert_params_from_jax(tree).items()}
    ids = torch.from_numpy(batch["input_ids"]).long()
    types = torch.from_numpy(batch["token_type_ids"]).long()
    with torch.no_grad():
        got_seq, _ = torch.func.functional_call(
            model.module.bert, {k[len("bert."):]: v for k, v in
                                params.items() if k.startswith("bert.")},
            (ids, None, types))
        mlm, _ = model.apply(params, ids, None, types)
    assert seq.dtype == jax.numpy.bfloat16 and got_seq.dtype == torch.bfloat16
    assert _rel_l2(got_seq.float().numpy(), np.asarray(seq, np.float32)) \
        <= BF16_CARRY_TOL
    assert _rel_l2(mlm.float().numpy(), np.asarray(ref_mlm, np.float32)) \
        <= BF16_CARRY_TOL


def _ds_config(gas):
    return {"train_batch_size": 8 * gas,
            "gradient_accumulation_steps": gas,
            "steps_per_print": 1000,
            "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 3,
                                     "warmup_max_lr": 1e-3}}}


def test_init_fills_every_parameter():
    model = tbert.BertForPreTrainingLM(tbert.tiny_bert_config(), device="cpu")
    params = model.init(seed=1)
    for name, p in params.items():
        assert bool(torch.isfinite(p).all()), name
    assert abs(float(params["bert.embeddings.word_embeddings"].std()) -
               0.02) < 2e-3
    # flax's lecun_normal: variance 1 / fan_in
    assert abs(float(params["decoder.kernel"].std()) - 64 ** -0.5) < 0.01
    assert float(params["transform_ln.scale"].min()) == 1.0
    assert float(params["decoder.bias"].abs().max()) == 0.0
    again = tbert.BertForPreTrainingLM(tbert.tiny_bert_config(),
                                       device="cpu").init(seed=1)
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_dropout_is_seeded():
    cfg = tbert.tiny_bert_config(hidden_dropout_prob=0.1,
                                 attention_probs_dropout_prob=0.1)
    model = tbert.BertForPreTrainingLM(cfg, device="cpu")
    params = model.init(seed=0)
    batch = _batch(seed=4)
    with torch.no_grad():
        a = model.loss_fn(params, batch, rngs={"dropout": 3})
        b = model.loss_fn(params, batch, rngs={"dropout": 3})
        c = model.loss_fn(params, batch, rngs={"dropout": 4})
        det = model.loss_fn(params, batch, deterministic=True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, det)
    with pytest.raises(ValueError, match="dropout seed"):
        model.loss_fn(params, batch)


def test_mlm_head_dtype_is_keyed_to_cuda():
    cfg = tbert.bert_config("bert-tiny")
    assert tbert.mlm_head_dtype(cfg, "cpu") == torch.float32
    assert tbert.mlm_head_dtype(cfg, "cuda") == torch.bfloat16
    assert tbert.mlm_head_dtype(
        tbert.bert_config("bert-tiny", bf16=False), "cuda") == torch.float32
    forced = tbert.bert_config("bert-tiny", mlm_head_in_compute_dtype=True)
    assert tbert.mlm_head_dtype(forced, "cpu") == torch.bfloat16


def test_config_matches_jax():
    for name in tbert.BERT_SIZES:
        assert vars(tbert.bert_config(name)) == \
            vars(jbert.bert_config(name))
        assert vars(tbert._ds_layer_config(tbert.bert_config(name))) == \
            vars(jbert._ds_layer_config(jbert.bert_config(name)))
    assert vars(tbert.tiny_bert_config()) == vars(jbert.tiny_bert_config())
    assert bert_config_from_jax(jbert.bert_config("bert-large")) == \
        tbert.bert_config("bert-large")


def test_additive_mask_matches_jax():
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    got = tbert.additive_attention_mask(torch.from_numpy(mask))
    ref = np.asarray(jbert.additive_attention_mask(mask))
    assert got.shape == (2, 1, 1, 3)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tbert.additive_attention_mask(None) is None


def test_zero3_scheduler_raises_naming_item_6():
    model = tbert.BertForPreTrainingLM(tbert.tiny_bert_config(), device="cpu")
    model.bind_zero3_scheduler(None)
    with pytest.raises(NotImplementedError, match="item 6"):
        model.bind_zero3_scheduler(object())


def test_fp16_raises_naming_item_4():
    """fp16 (item 4) no longer raises: the model builds, computes in fp16
    and puts the MLM head's matmuls in fp16 where asked."""
    assert tbert.mlm_head_dtype(tbert.tiny_bert_config(
        fp16=True, mlm_head_in_compute_dtype=True), "cpu") == torch.float16
    assert tbert.mlm_head_dtype(tbert.tiny_bert_config(fp16=True),
                                "cpu") == torch.float32
    tbert.BertForPreTrainingLM(tbert.tiny_bert_config(fp16=True),
                                   device="cpu")
