"""PyTorch port: BERT pretraining through the engines against the JAX
package: `initialize` -> `train_batch` at gradient accumulation 2 in
both engines (AdamW, WarmupLR, clipping) on the same batches, post-LN
and pre-LN (split out of tests/test_torch_bert.py, whose module fixture
it shares, to spread the test clock over workers). The engines' losses
within 1e-5 relative at every step, as in `test_torch_engine.py`
(observed <= 7.7e-7).
"""

import numpy as np

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models.convert import (bert_config_from_jax,
                                                bert_params_from_jax)

from test_torch_bert import TRAJ_TOL, _batch, _ds_config
from test_torch_bert import jax_bert  # noqa: F401 (the module fixture)
from torch_one_thread import one_torch_thread  # noqa: F401


def test_engine_losses_match_jax_engine(jax_bert):
    """Five steps of `train_batch` at gas 2 on three batches in turn:
    each step's loss in both engines (the JAX engine spreads the global
    batch over its virtual devices; the port runs micro batches of 8)."""
    jcfg, jmodel, jparams, tree = jax_bert
    gas = 2
    config = _ds_config(gas)
    jengine = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                       config=config)[0]
    model = tbert.BertForPreTrainingLM(bert_config_from_jax(jcfg),
                                       device="cpu")
    engine = dst.initialize(model=model,
                            model_parameters=bert_params_from_jax(tree),
                            config=dict(config,
                                        train_micro_batch_size_per_gpu=8))[0]
    batches = []
    for i in range(3):
        micro = [_batch(bs=8, seed=10 + 2 * i + j) for j in range(gas)]
        batches.append({k: np.stack([m[k] for m in micro])
                        for k in micro[0]})
    ref, got = [], []
    for step in range(5):
        ref.append(float(jengine.train_batch(batch=batches[step % 3])))
        got.append(float(engine.train_batch(batch=batches[step % 3])))
    ref, got = np.array(ref), np.array(got)
    assert np.all(np.abs(got - ref) <= TRAJ_TOL * np.abs(ref)), (got, ref)
    assert got[-1] < got[0]
    assert engine.global_steps == 5 and engine.micro_steps == 10
