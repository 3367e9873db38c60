"""PyTorch port: checkpoints against the JAX package, both ways.

(The interop tests below are in tests/test_torch_checkpoint_interop.py,
split out to spread the test clock over workers; this file keeps the
modes, the helpers they share and the rest.) One JAX engine per mode
(built once per module) trains two steps from a
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

BERT's checkpoints are held in tests/test_torch_checkpoint_bert.py, the
async writer's cases in tests/test_torch_checkpoint_async.py, and the
fp16 engine's and LAMB's, SGD's and 1-bit Adam's in
tests/test_torch_fp16.py and tests/test_torch_optimizers.py (each with
the JAX engine of its own trajectory test).

Then the port against itself: save, load into a fresh engine, continue,
bit for bit the uninterrupted run, at fp32 and at bf16 without master
weights (the dropout, quant and stochastic-rounding streams restored);
the bf16 npz encoding without ml_dtypes; the npz writer against
np.savez; legacy pickles; the tag vote.
"""

import dataclasses
import pickle
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.moe import MoEConfig as JMoE
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_jax)
from deepspeed_tpu_torch.moe import MoEConfig as TMoE
from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io
from torch_one_thread import one_torch_thread  # noqa: F401

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


def _flat(path, tag="t"):
    flat, meta, optim_meta, _ = ckpt_io.load_checkpoint_flat(path, tag)
    return flat, meta, optim_meta


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
# a small engine of its own weights (the legacy pickle case here, the
# async cases in tests/test_torch_checkpoint_async.py)
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
