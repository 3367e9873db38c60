"""PyTorch port: BERT checkpoints against the JAX package, both ways
(bert-tiny, fp32, the model's own converters `params_to_jax` /
`params_from_jax`; split out of tests/test_torch_checkpoint.py to spread
the test clock over workers): the JAX engine's directory loads into the
port and the port's into the JAX engine, every leaf and moment bit for
bit, and the next loss within 1e-5 relative (observed <= 1.5e-7).
"""

from unittest import mock

import numpy as np
import pytest

import jax

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models.convert import bert_config_from_jax
from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io

from test_torch_checkpoint import (FP32_TOL, SEQ, _bits, _ds_config,
                                   _flat, _jax_flat)
from torch_one_thread import one_torch_thread  # noqa: F401


# ----------------------------------------------------------------------
# BERT: the model's own tree converters
# ----------------------------------------------------------------------
def _bert_batches(n=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 256, (1, 8, SEQ)).astype(np.int32)
        labels = np.where(rng.rand(1, 8, SEQ) < 0.15, ids, -100)
        out.append({"input_ids": ids,
                    "masked_lm_labels": labels.astype(np.int32),
                    "next_sentence_label":
                        rng.randint(0, 2, (1, 8)).astype(np.int32)})
    return out


@pytest.fixture(scope="module")
def bert_run(tmp_path_factory):
    """The JAX engine on bert-tiny (fp32) after two steps and a save to
    `<dir>/jax` (tag "t"), then one more step, with the initial tree."""
    jcfg = jbert.tiny_bert_config()
    model = jbert.BertForPreTrainingLM(jcfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, SEQ), np.int32)})
    engine = deepspeed_tpu.initialize(model=model, model_parameters=params,
                                      config=_ds_config("fp32"))[0]
    batches = _bert_batches()
    for b in batches[:2]:
        engine.train_batch(batch=b)
    root = tmp_path_factory.mktemp("ckpt_bert")
    engine.save_checkpoint(str(root / "jax"), tag="t", async_save=False)
    next_loss = float(engine.train_batch(batch=batches[2]))
    return dict(jcfg=jcfg, engine=engine, root=root, batches=batches,
                next_loss=next_loss,
                tree=jax.tree_util.tree_map(np.asarray, params))


def _bert_port_engine(run):
    model = tbert.BertForPreTrainingLM(bert_config_from_jax(run["jcfg"]),
                                       device="cpu")
    return dst.initialize(
        model=model, model_parameters=model.params_from_jax(run["tree"]),
        config=_ds_config("fp32", micro_batch=8))[0]


def test_bert_jax_checkpoint_loads_into_port(bert_run):
    src = str(bert_run["root"] / "jax")
    engine = _bert_port_engine(bert_run)
    with mock.patch.object(ckpt_io.logger, "warning") as warn:
        path, client = engine.load_checkpoint(src)
    assert path.endswith("t") and client == {}
    assert not warn.called, warn.call_args_list
    engine.save_checkpoint(str(bert_run["root"] / "reload"), tag="t",
                           async_save=False)
    jflat, _, _ = _flat(src)
    pflat, _, _ = _flat(str(bert_run["root"] / "reload"))
    assert set(pflat) == set(jflat)
    assert any("['encoder']['layer']['DeepSpeedTransformerLayer_0']" in k
               for k in jflat)
    lr_key = "optim.hyperparams['learning_rate']"
    for key, value in jflat.items():
        if key == lr_key:
            np.testing.assert_allclose(pflat[key], value, rtol=1e-6)
        else:
            assert _bits(pflat[key]) == _bits(value), key
    assert any(".mu[" in k for k in jflat)
    loss = float(engine.train_batch(batch=bert_run["batches"][2]))
    ref = bert_run["next_loss"]
    assert abs(loss - ref) <= FP32_TOL * abs(ref), (loss, ref)


def test_bert_port_checkpoint_loads_into_jax(bert_run):
    port = _bert_port_engine(bert_run)
    for b in bert_run["batches"][:2]:
        port.train_batch(batch=b)
    src = str(bert_run["root"] / "port")
    port.save_checkpoint(src, tag="t", async_save=False)
    jengine = bert_run["engine"]
    with mock.patch("deepspeed_tpu.runtime.engine.logger") as log:
        jengine.load_checkpoint(src, tag="t")
    warnings = [str(c.args[0]) for c in log.warning.call_args_list]
    assert not any("reset" in w for w in warnings), warnings
    assert jengine.global_steps == 2
    pflat, _, _ = _flat(src)
    payload = jengine._ckpt_payload(jengine.state)
    jmodule = _jax_flat(payload["module"], "module")
    jopt = _jax_flat(payload["opt_state"], "optim")
    assert set(jmodule) | set(jopt) == {k for k in pflat
                                        if not k.startswith("aux/")}
    for key, value in {**jmodule, **jopt}.items():
        assert _bits(pflat[key]) == _bits(value), key
    batch = bert_run["batches"][3]
    ref = float(port.train_batch(batch=batch))
    loss = float(jengine.train_batch(batch=batch))
    assert abs(loss - ref) <= FP32_TOL * abs(ref), (loss, ref)


# ----------------------------------------------------------------------
# the layout pieces
# ----------------------------------------------------------------------
