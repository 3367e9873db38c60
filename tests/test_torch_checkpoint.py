"""PyTorch port: checkpoints against the JAX package, both ways.

One JAX engine per mode (built once per module) trains two steps from a
gpt2-tiny tree and saves; the port loads that directory, and a port
engine started from the same tree trains the same two steps, saves,
and the JAX engine loads it. The modes: fp32; bf16 with fp32 master
weights; bf16 without them (bf16 moments, stochastic rounding, ZeRO-2,
so the JAX save writes zero_pp_rank bucket files, and remat, so the
scanned child is "CheckpointGPT2Block_0"); MoE (every other layer, 4
experts, top-2, fp32, remat). In each mode:
  * the port writes the JAX engine's entries: the same keys, shapes and
    logical dtypes, the same metadata keys (plus `torch_rng`);
  * every leaf the port loads equals the file's bytes, and so do the
    JAX engine's after loading the port's file; the moments are among
    them, so neither side reset them (JAX resets them, with a warning
    only, when the optimizer tree does not match);
  * the next loss on the same batch agrees across the packages: fp32
    within 1e-5 relative, the engines' trajectory tolerance
    (`test_torch_engine.py`; observed below 1e-7 here); bf16 within
    2e-3 relative, the bf16 model-parity tolerance
    (`test_torch_moe_train.py`; observed below 2e-5 here): the same
    parameters, with several bf16 roundings of the residual stream in
    each package's own order.

BERT (bert-tiny, fp32, the model's own converters `params_to_jax` /
`params_from_jax`): the JAX engine's directory loads into the port and
the port's into the JAX engine, every leaf and moment bit for bit, and
the next loss within 1e-5 relative (observed <= 1.5e-7).

Then the port against itself: save, load into a fresh engine, continue,
bit for bit the uninterrupted run, at fp32 and at bf16 without master
weights (the dropout, quant and stochastic-rounding streams restored);
the single-process cases of the JAX package's `test_async_checkpoint.py`
on the port's engine; the bf16 npz encoding without ml_dtypes; the npz
writer against np.savez; legacy pickles; the tag vote.
"""

import dataclasses
import os
import pickle
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.moe import MoEConfig as JMoE
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import (bert_config_from_jax,
                                                params_from_jax,
                                                params_to_jax)
from deepspeed_tpu_torch.moe import MoEConfig as TMoE
from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io

SEQ = 32
FP32_TOL = 1e-5
BF16_TOL = 2e-3
MOE = dict(num_experts=4, top_k=2, capacity_factor=1.0, every_n_layers=2)
MODES = {
    "fp32": dict(model={}, bf16=None, stage=0),
    "bf16_master": dict(model={"dtype": "bf16"}, bf16=True, stage=0),
    "bf16_sr": dict(model={"dtype": "bf16", "remat": True}, bf16=False,
                    stage=2),
    "moe": dict(model={"n_layer": 4, "moe": True, "remat": True},
                bf16=None, stage=0),
}


def _model_cfgs(mode):
    over = dict(MODES[mode]["model"])
    jover, tover = dict(n_positions=SEQ), dict(n_positions=SEQ)
    if over.pop("dtype", None):
        jover["dtype"], tover["dtype"] = jnp.bfloat16, torch.bfloat16
    if over.pop("moe", None):
        jover["moe"] = JMoE(**MOE).validate()
        tover["moe"] = TMoE(**MOE).validate()
    jover.update(over)
    tover.update(over)
    return jgpt2.tiny_gpt2_config(**jover), tgpt2.tiny_gpt2_config(**tover)


def _ds_config(mode, micro_batch=None, **extra):
    m = MODES[mode]
    cfg = {"train_batch_size": 8, "steps_per_print": 1000,
           "zero_optimization": {"stage": m["stage"]},
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 5,
                                    "warmup_max_lr": 3e-3}}}
    if micro_batch is not None:
        cfg["train_micro_batch_size_per_gpu"] = micro_batch
    if m["bf16"] is not None:
        cfg["bf16"] = {"enabled": True, "master_weights": m["bf16"]}
    if mode == "moe":
        cfg["moe"] = dict(MOE, enabled=True)
    cfg.update(extra)
    return cfg


def _batches(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, 256, (1, 8, SEQ)).astype(np.int32)}
            for _ in range(n)]


def _port_engine(mode, tree, **extra):
    _, tcfg = _model_cfgs(mode)
    model = tgpt2.GPT2ForCausalLM(tcfg, device="cpu")
    return dst.initialize(model=model, model_parameters=params_from_jax(tree),
                          config=_ds_config(mode, micro_batch=8, **extra))[0]


@pytest.fixture(scope="module", params=list(MODES))
def jax_run(request, tmp_path_factory):
    """The JAX engine of a mode after two steps and a save to
    `<dir>/jax` (tag "t"), then one more step (its loss is the next
    loss after the save), with the initial tree."""
    mode = request.param
    jcfg, _ = _model_cfgs(mode)
    model = jgpt2.GPT2ForCausalLM(jcfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    engine = deepspeed_tpu.initialize(model=model, model_parameters=params,
                                      config=_ds_config(mode))[0]
    batches = _batches()
    for b in batches[:2]:
        engine.train_batch(batch=b)
    root = tmp_path_factory.mktemp(f"ckpt_{mode}")
    engine.save_checkpoint(str(root / "jax"), tag="t", async_save=False)
    next_loss = float(engine.train_batch(batch=batches[2]))
    return dict(mode=mode, engine=engine, root=root, batches=batches,
                next_loss=next_loss,
                tree=jax.tree_util.tree_map(np.asarray, params))


def _flat(path, tag="t"):
    flat, meta, optim_meta, _ = ckpt_io.load_checkpoint_flat(path, tag)
    return flat, meta, optim_meta


def _port_save_after_two_steps(run):
    """A port engine from the run's initial tree, two steps, saved to
    `<dir>/port` (tag "t"); returns the engine (once, per run)."""
    if "port" not in run:
        engine = _port_engine(run["mode"], run["tree"])
        for b in run["batches"][:2]:
            engine.train_batch(batch=b)
        engine.save_checkpoint(str(run["root"] / "port"), tag="t",
                               async_save=False)
        run["port"] = engine
    return run["port"]


def _loss_tol(mode):
    return BF16_TOL if MODES[mode]["bf16"] is not None else FP32_TOL


def _jax_flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {prefix + jax.tree_util.keystr(p): np.asarray(v)
            for p, v in leaves}


def _bits(x):
    """The raw bytes of a tensor or array (bf16 through its uint16)."""
    if isinstance(x, torch.Tensor):
        arr, _ = ckpt_io._npz_encode(x)
        return arr.tobytes()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.view(np.uint16)
    return arr.tobytes()


def test_port_writes_the_jax_entries(jax_run):
    _port_save_after_two_steps(jax_run)
    jflat, jmeta, jopt = _flat(str(jax_run["root"] / "jax"))
    pflat, pmeta, popt = _flat(str(jax_run["root"] / "port"))

    def layout(flat):
        return {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}

    assert layout(pflat) == layout(jflat)
    assert set(pmeta) == set(jmeta) | {"torch_rng"}
    assert popt == jopt
    for key in ("global_steps", "skipped_steps", "micro_steps",
                "lr_scheduler"):
        assert pmeta[key] == jmeta[key], key
    assert pmeta["rng"].dtype == np.uint32 and pmeta["rng"].shape == (2,)
    if MODES[jax_run["mode"]]["stage"]:
        # the JAX save sharded the moments into bucket files
        assert any(n.startswith("zero_pp_rank") for n in
                   os.listdir(jax_run["root"] / "jax" / "t"))


def test_jax_checkpoint_loads_into_port(jax_run):
    mode = jax_run["mode"]
    src = str(jax_run["root"] / "jax")
    engine = _port_engine(mode, jax_run["tree"])
    with mock.patch.object(ckpt_io.logger, "warning") as warn:
        path, client = engine.load_checkpoint(src)
    assert path.endswith("t") and client == {}
    assert not warn.called, warn.call_args_list
    # the loaded state, written back, holds the file's bytes in every
    # entry but the injected learning rate (each package evaluates its
    # schedule)
    engine.save_checkpoint(str(jax_run["root"] / "reload"), tag="t",
                           async_save=False)
    jflat, jmeta, _ = _flat(src)
    pflat, pmeta, _ = _flat(str(jax_run["root"] / "reload"))
    lr_key = "optim.hyperparams['learning_rate']"
    for key, value in jflat.items():
        if key == lr_key:
            np.testing.assert_allclose(pflat[key], value, rtol=1e-6)
        else:
            assert _bits(pflat[key]) == _bits(value), key
    moments = [k for k in jflat if ".mu[" in k or ".nu[" in k]
    assert moments and all(bool(torch.any(jflat[k] != 0))
                           for k in moments if ".nu[" in k)
    assert engine.global_steps == 2 and engine.micro_steps == 2
    loss = float(engine.train_batch(batch=jax_run["batches"][2]))
    ref = jax_run["next_loss"]
    assert abs(loss - ref) <= _loss_tol(mode) * abs(ref), (loss, ref)


def test_port_checkpoint_loads_into_jax(jax_run):
    mode = jax_run["mode"]
    port = _port_save_after_two_steps(jax_run)
    jengine = jax_run["engine"]
    src = str(jax_run["root"] / "port")
    with mock.patch("deepspeed_tpu.runtime.engine.logger") as log:
        path, client = jengine.load_checkpoint(src, tag="t")
    warnings = [str(c.args[0]) for c in log.warning.call_args_list]
    assert not any("reset" in w for w in warnings), warnings
    assert set(client) == {"torch_rng"}
    assert jengine.global_steps == 2
    pflat, _, _ = _flat(src)
    # the checkpoint-facing trees (ZeRO's padding taken off)
    payload = jengine._ckpt_payload(jengine.state)
    jmodule = _jax_flat(payload["module"], "module")
    jopt = _jax_flat(payload["opt_state"], "optim")
    assert set(jmodule) | set(jopt) == {k for k in pflat
                                        if not k.startswith("aux/")}
    for key, value in {**jmodule, **jopt}.items():
        assert _bits(pflat[key]) == _bits(value), key
    batch = jax_run["batches"][3]
    ref = float(port.train_batch(batch=batch))
    loss = float(jengine.train_batch(batch=batch))
    assert abs(loss - ref) <= _loss_tol(mode) * abs(ref), (loss, ref)


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
@pytest.mark.parametrize("mode,remat", [("fp32", False), ("fp32", True),
                                        ("moe", True)])
def test_params_to_jax_inverts_params_from_jax(mode, remat):
    jcfg, _ = _model_cfgs(mode)
    params = jgpt2.GPT2ForCausalLM(jcfg).init(
        jax.random.PRNGKey(1), {"input_ids": np.zeros((1, 8), np.int32)})
    tree = jax.tree_util.tree_map(np.asarray, params)
    if remat != ("Checkpoint" in "".join(tree["h"])):
        tree = dict(tree, h={("Checkpoint" + k if remat else k): v
                             for k, v in tree["h"].items()})
    back = params_to_jax(params_from_jax(tree), remat=remat)
    ref = _jax_flat(tree, "")
    got = {k: v.numpy() for k, v in ckpt_io.tree_to_entries(back)}
    assert set(got) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("opt", ["adamw", "adam", "adamw_bf16"])
def test_optimizer_entries_match_optax(opt, tmp_path):
    """The port's optimizer entries against the optax state the JAX
    engine builds for its optimizer: optax.inject_hyperparams over
    optax.adamw / optax.adam (fp32 moments), the JAX package's
    adamw_bf16 (bf16 moments) without master weights."""
    import optax
    from deepspeed_tpu.runtime.bf16_optimizer import adamw_bf16
    jcfg, tcfg = _model_cfgs("fp32")
    params = jax.tree_util.tree_map(np.asarray, jgpt2.GPT2ForCausalLM(
        jcfg).init(jax.random.PRNGKey(0),
                   {"input_ids": np.zeros((1, 8), np.int32)}))
    hp = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    if opt == "adamw":
        jstate = optax.inject_hyperparams(optax.adamw)(
            weight_decay=0.0, **hp).init(params)
    elif opt == "adam":
        jstate = optax.inject_hyperparams(optax.adam)(**hp).init(params)
    else:
        jstate = adamw_bf16(weight_decay=0.0, **hp).init(
            jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                   params))
    config = {"train_batch_size": 8, "optimizer": {
        "type": "Adam", "params": {"lr": 1e-3,
                                   "adam_w_mode": opt != "adam"}}}
    if opt == "adamw_bf16":
        config["bf16"] = {"enabled": True, "master_weights": False}
        tcfg = tgpt2.tiny_gpt2_config(n_positions=SEQ, dtype=torch.bfloat16)
    engine = dst.initialize(
        model=tgpt2.GPT2ForCausalLM(tcfg, device="cpu"),
        model_parameters=params_from_jax(params), config=config)[0]
    engine.save_checkpoint(str(tmp_path), tag="t", async_save=False)
    flat, _, _ = _flat(str(tmp_path))
    ref = _jax_flat(jstate, "optim")
    got = {k: v for k, v in flat.items() if k.startswith("optim")}
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert tuple(got[key].shape) == value.shape, key
        assert str(got[key].dtype).replace("torch.", "") == \
            value.dtype.name, key


def test_bf16_npz_round_trip_without_ml_dtypes():
    """bf16 leaves go to disk as their uint16 bits with "bfloat16" in
    npz_dtypes, exactly as the JAX package encodes its ml_dtypes
    arrays, and decode back bit for bit through torch alone."""
    from deepspeed_tpu.runtime import checkpoint as jckpt
    values = np.random.RandomState(0).randn(5, 7).astype(np.float32)
    values[0, :2] = [np.inf, -0.0]
    x = torch.from_numpy(values).to(torch.bfloat16)
    arr, enc = ckpt_io._npz_encode(x)
    assert enc == "bfloat16" and arr.dtype == np.uint16
    jarr, jenc = jckpt._npz_encode(np.asarray(jnp.asarray(values,
                                                          jnp.bfloat16)))
    assert jenc == enc and jarr.dtype == arr.dtype
    assert jarr.tobytes() == arr.tobytes()
    back = ckpt_io._npz_decode(jarr, jenc)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    x[0, 2] = float("nan")   # any payload comes back as it went
    arr, enc = ckpt_io._npz_encode(x)
    assert torch.equal(ckpt_io._npz_decode(arr, enc).view(torch.int16),
                       x.view(torch.int16))
    f32, enc = ckpt_io._npz_encode(torch.ones(3))
    assert enc is None and f32.dtype == np.float32


def test_savez_writes_np_savez_members(tmp_path):
    """The writer's npz holds the members np.savez writes, byte for
    byte, for the C-ordered arrays a checkpoint holds (0-d, empty,
    bf16 bits, "aux/" names); another order loads to equal values."""
    import zipfile
    arrays = {"module['x']": np.arange(12, dtype=np.float32).reshape(3, 4),
              "optim.count": np.asarray(3, np.int32),
              "empty": np.zeros((0, 5), np.uint16),
              "aux/scale.loss_scale": np.asarray(1.0, np.float32),
              "bits": ckpt_io._npz_encode(torch.randn(7, 3).to(
                  torch.bfloat16))[0],
              "rng": np.array([1, 2], np.uint32)}
    ckpt_io._savez(str(tmp_path / "mine.npz"), arrays)
    np.savez(str(tmp_path / "ref.npz"), **arrays)
    with zipfile.ZipFile(tmp_path / "mine.npz") as a, \
            zipfile.ZipFile(tmp_path / "ref.npz") as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    f_order = np.arange(6, dtype=np.int8).reshape(2, 3).T
    ckpt_io._savez(str(tmp_path / "f.npz"), {"t": f_order})
    with np.load(tmp_path / "f.npz") as z:
        np.testing.assert_array_equal(z["t"], f_order)


class _Foreign:
    pass


@pytest.mark.parametrize("content", ["numpy", "foreign", "engine"])
def test_legacy_pickle(content, tmp_path):
    """A round-1 pickle of numpy arrays and Python objects loads, with
    the deprecation warning, in the loader and into an engine (a module
    tree without optimizer state); any other class raises, naming the
    format, and is never instantiated."""
    d = tmp_path / "old"
    d.mkdir()
    module = {"w": np.zeros(2, np.float32)}
    if content == "foreign":
        module["x"] = _Foreign()
    if content == "engine":
        src = _engine()
        module = params_to_jax({n: p.detach().numpy().copy()
                                for n, p in src.params.items()},
                               stack=np.stack)
        with open(d / "mp_rank_00_model_states.pt", "wb") as f:
            pickle.dump({"module": module, "global_steps": 3}, f)
        engine = _engine(seed=7)
        assert engine.load_checkpoint(str(tmp_path), tag="old") == (
            f"{tmp_path}/old", {})
        assert engine.global_steps == 3
        for name, p in src.params.items():
            assert torch.equal(engine.params[name], p), name
        return
    with open(d / "mp_rank_00_model_states.pt", "wb") as f:
        pickle.dump({"module": module, "global_steps": 1}, f)
    with mock.patch.object(ckpt_io.logger, "warning") as warn:
        if content == "foreign":
            with pytest.raises(ValueError, match="legacy .*pickle.*_Foreign"):
                ckpt_io.load_checkpoint_files(str(tmp_path), "old")
            return
        sd, optim_sd = ckpt_io.load_checkpoint_files(str(tmp_path), "old")
    assert any("legacy" in str(c.args[0]) and "pickle" in str(c.args[0])
               for c in warn.call_args_list)
    assert optim_sd is None and sd["global_steps"] == 1
    assert list(sd["module_flat"]) == ["module['w']"]
    assert torch.equal(sd["module_flat"]["module['w']"], torch.zeros(2))


def test_validate_checkpoint_tag(monkeypatch):
    """A no-op at world size 1; over a group, the all-gathered hashes
    must agree: Fail raises, Warn warns and returns False."""
    assert ckpt_io.validate_checkpoint_tag("step5") is True
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)

    def gather(out, obj, group=None):
        out[0], out[1] = obj, obj + "x"

    monkeypatch.setattr(dist, "all_gather_object", gather)
    with pytest.raises(ValueError, match="not consistent across all"):
        ckpt_io.validate_checkpoint_tag("tag_rank0", fail_on_mismatch=True)
    with mock.patch.object(ckpt_io.logger, "warning") as warn:
        assert ckpt_io.validate_checkpoint_tag("tag_rank0") is False
    assert warn.called
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj, group=None: out.__setitem__(
                            slice(None), [obj, obj]))
    assert ckpt_io.validate_checkpoint_tag("same",
                                           fail_on_mismatch=True) is True


# ----------------------------------------------------------------------
# the port against itself
# ----------------------------------------------------------------------
@pytest.fixture
def one_thread():
    """One CPU thread: the CPU's embedding backward adds its rows in a
    thread-dependent order, so bit-for-bit runs need one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_resume_is_bit_exact(mode, one_thread, tmp_path):
    """Save after 3 steps, load into a fresh engine (other weights,
    other seed), continue 3 steps: the losses and the final state equal
    the uninterrupted run's bit for bit. Dropout on, so the dropout
    stream must come back too; without master weights the
    stochastic-rounding stream as well."""
    tcfg = dataclasses.replace(_model_cfgs(mode)[1], dropout=0.1)
    config = _ds_config(mode, micro_batch=8, gradient_accumulation_steps=1)
    batches = _batches(6, seed=3)

    def engine(seed):
        model = tgpt2.GPT2ForCausalLM(tcfg, device="cpu")
        return dst.initialize(model=model, model_parameters=model.init(seed),
                              config=config)[0]

    a = engine(0)
    for b in batches[:3]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path), client_state={"epoch": 7})
    ref = [a.train_batch(batch=b) for b in batches[3:]]
    a.wait_for_checkpoint()
    b_ = dst.DeepSpeedEngine(model=tgpt2.GPT2ForCausalLM(tcfg, device="cpu"),
                             model_parameters=tgpt2.GPT2ForCausalLM(
                                 tcfg, device="cpu").init(5),
                             config=config, rng_seed=99)
    path, client = b_.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and client == {"epoch": 7}
    got = [b_.train_batch(batch=b) for b in batches[3:]]
    assert all(torch.equal(x, y) for x, y in zip(got, ref)), (got, ref)
    for name, p in a.params.items():
        assert torch.equal(p, b_.params[name]), name
    for m, n in zip(a.state.opt_state.mu + a.state.opt_state.nu,
                    b_.state.opt_state.mu + b_.state.opt_state.nu):
        assert torch.equal(m, n)
    assert b_.global_steps == 6 and a.get_lr() == b_.get_lr()


def test_mismatched_optimizer_keeps_the_moments(tmp_path):
    """An fp32 checkpoint into an engine without master weights: the
    module loads (cast to bf16), the optimizer tree does not match, so
    the moments stay as they were and a warning says so — the JAX
    engine's behaviour, and why the tests above compare moments."""
    tree = jax.tree_util.tree_map(np.asarray, jgpt2.GPT2ForCausalLM(
        _model_cfgs("fp32")[0]).init(
            jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)}))
    src = _port_engine("fp32", tree)
    src.train_batch(batch=_batches(1)[0])
    src.save_checkpoint(str(tmp_path), tag="t", async_save=False)
    dst_engine = _port_engine("bf16_sr", tree)
    before = [m.clone() for m in dst_engine.state.opt_state.mu]
    with mock.patch.object(ckpt_io.logger, "warning") as warn:
        dst_engine.load_checkpoint(str(tmp_path))
    assert any("moments not loaded" in str(c.args[0])
               for c in warn.call_args_list)
    assert all(torch.equal(a, b) for a, b in
               zip(before, dst_engine.state.opt_state.mu))
    for name, p in src.params.items():
        assert torch.equal(dst_engine.params[name], p.to(torch.bfloat16))
    # load_optimizer_states=False keeps them too, silently
    dst_engine.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert all(torch.equal(a, b) for a, b in
               zip(before, dst_engine.state.opt_state.mu))


# ----------------------------------------------------------------------
# async saves: the single-process cases of test_async_checkpoint.py
# ----------------------------------------------------------------------
def _engine(checkpoint=None, gas=1, seed=0):
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=SEQ),
                                  device="cpu")
    config = {"train_micro_batch_size_per_gpu": 4,
              "gradient_accumulation_steps": gas, "steps_per_print": 1000,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    if checkpoint is not None:
        config["checkpoint"] = checkpoint
    return dst.initialize(model=model, model_parameters=model.init(seed),
                          config=config)[0]


def _train(engine, steps, start=0):
    gas = engine.gradient_accumulation_steps()
    for i in range(steps):
        ids = np.random.RandomState(start + i).randint(0, 256, (gas, 4, SEQ))
        engine.train_batch(batch={"input_ids": ids})


def _case_atomic_commit(tmp_path):
    engine = _engine()
    _train(engine, 2)
    assert engine.save_checkpoint(str(tmp_path), tag="t1") is True
    engine.wait_for_checkpoint()
    assert os.path.isdir(tmp_path / "t1")
    assert not os.path.exists(tmp_path / ("t1" + ckpt_io.STAGING_SUFFIX))
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "t1"
    path, _ = engine.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("t1")


def _case_async_equals_sync_under_training(tmp_path):
    """A sync and an async save of the same state are bit-identical
    although training steps (in place) while the writer serializes."""
    engine = _engine()
    _train(engine, 2)
    engine.save_checkpoint(str(tmp_path), tag="sync_ref", async_save=False,
                           save_latest=False)
    orig = engine._write_checkpoint
    gate = threading.Event()

    def gated(*a, **k):
        assert gate.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = gated
    engine.save_checkpoint(str(tmp_path), tag="async_ref", async_save=True)
    ref_mu = [m.clone() for m in engine.state.opt_state.mu]
    _train(engine, 3, start=100)
    gate.set()
    engine.wait_for_checkpoint()
    assert ckpt_io.checkpoint_dirs_bit_identical(
        str(tmp_path / "sync_ref"), str(tmp_path / "async_ref"))
    engine2 = _engine(seed=7)
    engine2.load_checkpoint(str(tmp_path), tag="async_ref")
    assert all(torch.equal(a, b)
               for a, b in zip(ref_mu, engine2.state.opt_state.mu))


def _case_backpressure_blocks(tmp_path):
    engine = _engine()   # writer_queue_depth defaults to 1
    _train(engine, 1)
    orig = engine._write_checkpoint

    def slow(*a, **k):
        time.sleep(0.5)
        return orig(*a, **k)

    engine._write_checkpoint = slow
    t0 = time.perf_counter()
    engine.save_checkpoint(str(tmp_path), tag="a")
    first = time.perf_counter() - t0
    t1 = time.perf_counter()
    engine.save_checkpoint(str(tmp_path), tag="b")
    second = time.perf_counter() - t1
    engine.wait_for_checkpoint()
    assert first < 0.4 <= second, (first, second)
    assert os.path.isdir(tmp_path / "a") and os.path.isdir(tmp_path / "b")
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "b"


def _case_backpressure_drops(tmp_path):
    engine = _engine({"queue_policy": "drop"})
    _train(engine, 1)
    orig = engine._write_checkpoint
    started, release = threading.Event(), threading.Event()

    def gated(*a, **k):
        started.set()
        assert release.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = gated
    assert engine.save_checkpoint(str(tmp_path), tag="a") is True
    assert started.wait(timeout=10)
    # dropped BEFORE paying for the snapshot
    with mock.patch.object(engine, "_checkpoint_snapshot") as snap:
        assert engine.save_checkpoint(str(tmp_path), tag="b") is False
    assert snap.call_count == 0
    release.set()
    engine.wait_for_checkpoint()
    assert os.path.isdir(tmp_path / "a")
    assert not os.path.exists(tmp_path / "b")
    assert not os.path.exists(tmp_path / ("b" + ckpt_io.STAGING_SUFFIX))


def _case_same_tag_serializes(tmp_path):
    engine = _engine({"writer_queue_depth": 2})
    _train(engine, 1)
    orig = engine._write_checkpoint
    started, release = threading.Event(), threading.Event()

    def gated(*a, **k):
        if not started.is_set():
            started.set()
            assert release.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = gated
    assert engine.save_checkpoint(str(tmp_path), tag="t") is True
    assert started.wait(timeout=10)
    threading.Timer(0.5, release.set).start()
    t0 = time.perf_counter()
    assert engine.save_checkpoint(str(tmp_path), tag="t") is True
    assert time.perf_counter() - t0 >= 0.3
    engine.wait_for_checkpoint()
    assert sorted(os.listdir(tmp_path)) == ["latest", "t"]


def _case_submission_order(tmp_path):
    engine = _engine({"writer_queue_depth": 2, "keep_last": 1})
    _train(engine, 1)
    orig = engine._write_checkpoint
    first = threading.Event()

    def stagger(*a, **k):
        if not first.is_set():
            first.set()
            time.sleep(0.5)   # the first job serializes slowly
        return orig(*a, **k)

    engine._write_checkpoint = stagger
    assert engine.save_checkpoint(str(tmp_path), tag="older") is True
    assert engine.save_checkpoint(str(tmp_path), tag="newer") is True
    engine.wait_for_checkpoint()
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "newer"
    assert os.path.isdir(tmp_path / "newer")
    assert not os.path.isdir(tmp_path / "older")   # rotated out


def _case_later_failure_no_deadlock(tmp_path):
    engine = _engine({"writer_queue_depth": 2})
    _train(engine, 1)
    orig = engine._write_checkpoint

    def hooked(save_dir, tag, snap, save_latest, **k):
        if tag == "a":
            time.sleep(0.5)
            return orig(save_dir, tag, snap, save_latest, **k)
        raise OSError("disk full")   # job b dies before its gate

    engine._write_checkpoint = hooked
    assert engine.save_checkpoint(str(tmp_path), tag="a") is True
    assert engine.save_checkpoint(str(tmp_path), tag="b") is True
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        engine.wait_for_checkpoint()
    assert os.path.isdir(tmp_path / "a")


def _case_writer_error_reraised(tmp_path):
    engine = _engine()
    _train(engine, 1)

    def boom(*a, **k):
        raise OSError("disk full")

    engine._write_checkpoint = boom
    engine.save_checkpoint(str(tmp_path), tag="t")
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        engine.wait_for_checkpoint()
    engine.wait_for_checkpoint()   # consumed; the writer is usable


def _case_sync_drains_async(tmp_path):
    engine = _engine()
    _train(engine, 1)
    orig = engine._write_checkpoint
    release = threading.Event()

    def gated(save_dir, tag, snap, save_latest, **k):
        if tag == "slow":
            assert release.wait(timeout=30)
        return orig(save_dir, tag, snap, save_latest, **k)

    engine._write_checkpoint = gated
    engine.save_checkpoint(str(tmp_path), tag="slow")
    threading.Timer(0.4, release.set).start()
    t0 = time.perf_counter()
    engine.save_checkpoint(str(tmp_path), tag="final", async_save=False)
    assert time.perf_counter() - t0 >= 0.3
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "final"
    assert os.path.isdir(tmp_path / "slow")


def _case_gas_change_across_reload(tmp_path):
    eng_a = _engine(gas=2)
    _train(eng_a, 2)
    assert eng_a.global_steps == 2 and eng_a.micro_steps == 4
    eng_a.save_checkpoint(str(tmp_path), tag="t")
    eng_a.wait_for_checkpoint()
    eng_b = _engine(seed=7)   # gas 1
    eng_b.load_checkpoint(str(tmp_path), tag="t")
    assert eng_b.global_steps == 2   # micro_steps // gas would say 4
    assert int(eng_b.state.global_steps) == 2


def _case_resave_existing_tag(tmp_path):
    engine = _engine()
    _train(engine, 1)
    engine.save_checkpoint(str(tmp_path), tag="t")
    engine.wait_for_checkpoint()
    _train(engine, 1, start=50)
    engine.save_checkpoint(str(tmp_path), tag="t")
    engine.wait_for_checkpoint()
    assert sorted(os.listdir(tmp_path)) == ["latest", "t"]
    assert engine.load_checkpoint(str(tmp_path))[0].endswith("t")


def _case_client_state_isolated(tmp_path):
    engine = _engine()
    _train(engine, 1)
    orig = engine._write_checkpoint
    gate = threading.Event()

    def slow(*a, **k):
        assert gate.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = slow
    state = {"metrics": {"acc": 1}}
    engine.save_checkpoint(str(tmp_path), tag="t", client_state=state)
    state["metrics"]["acc"] = 999   # mutate while the writer waits
    gate.set()
    engine.wait_for_checkpoint()
    sd, _ = ckpt_io.load_checkpoint_files(str(tmp_path), "t")
    assert sd["metrics"] == {"acc": 1}
    assert engine.load_checkpoint(str(tmp_path))[1] == {
        "metrics": {"acc": 1}}


def _case_interrupted_save_raises(tmp_path):
    os.makedirs(tmp_path / ("t" + ckpt_io.STAGING_SUFFIX))
    with pytest.raises(ckpt_io.CheckpointStagingOnlyError,
                       match="interrupted save"):
        ckpt_io.load_checkpoint_flat(str(tmp_path), "t")
    with pytest.raises(ckpt_io.CheckpointNotFoundError):
        _engine().load_checkpoint(str(tmp_path), tag="never")


def _case_latest_skips_staging(tmp_path):
    (tmp_path / "latest").write_text("t" + ckpt_io.STAGING_SUFFIX)
    assert ckpt_io.read_latest_tag(str(tmp_path)) is None
    assert _engine().load_checkpoint(str(tmp_path)) == (None, {})
    ckpt_io.write_latest_tag(str(tmp_path), "real")
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "real"
    assert sorted(os.listdir(tmp_path)) == ["latest"]


def _case_keep_last_rotation(tmp_path):
    engine = _engine({"keep_last": 2})
    _train(engine, 1)
    for i in range(3):
        engine.save_checkpoint(str(tmp_path), tag=f"t{i}")
        engine.wait_for_checkpoint()
        time.sleep(0.05)   # distinct mtimes on coarse filesystems
    dirs = sorted(d for d in os.listdir(tmp_path)
                  if os.path.isdir(tmp_path / d))
    assert dirs == ["t1", "t2"], dirs
    assert engine.load_checkpoint(str(tmp_path))[0].endswith("t2")


def _case_timeout_abandon_and_shutdown(tmp_path):
    """A wedged writer: the bounded wait raises, abandonment frees the
    engine, the abandoned job still commits its tag but not `latest`,
    and a save to the tag it holds is skipped."""
    engine = _engine()
    _train(engine, 1)
    engine.save_checkpoint(str(tmp_path), tag="good", async_save=False)
    orig = engine._write_checkpoint
    release = threading.Event()

    def wedged(*a, **k):
        assert release.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = wedged
    engine.save_checkpoint(str(tmp_path), tag="stuck")
    with pytest.raises(ckpt_io.CheckpointWaitTimeout) as err:
        engine.wait_for_checkpoint(timeout=0.1)
    assert err.value.pending == 1
    assert engine.abandon_checkpoint_writers() == 1
    engine._write_checkpoint = orig
    assert engine.save_checkpoint(str(tmp_path), tag="stuck") is False
    engine.shutdown()   # nothing tracked: returns at once
    release.set()
    for w in engine._abandoned_ckpt_writers:
        w.wait(timeout=30)
    assert os.path.isdir(tmp_path / "stuck")
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "good"
    engine.save_checkpoint(str(tmp_path), tag="next")
    engine.shutdown()   # drains the new writer
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "next"


ASYNC_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
               if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(ASYNC_CASES))
def test_async_checkpoint(case, tmp_path):
    ASYNC_CASES[case](tmp_path)
