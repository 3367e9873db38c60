"""PyTorch port: user-facing activation checkpointing against the JAX
package (runtime/activation_checkpointing/).

The config block resolves as the JAX package resolves it; `configure`
takes a dict, a JSON path or a DeepSpeedConfig with kwargs overriding
them, and leaves the module's switches as the JAX module's; the policy
names resolve in the JAX order, and each argument-free
`jax.checkpoint_policies` name keeps what the JAX policy keeps (a
product without batch dims, a batched one, a named value);
`checkpoint(fn, *args)` gives JAX's `checkpoint` values and gradients on
the same function and inputs, under each switch; the RNG tracker keeps
named streams; `cpu_checkpointing` keeps the inputs as host copies until
the recompute.

Tolerance: fp32 on both sides, a 16 x 48 x 32 product and an
elementwise tail (tanh, sin: the two libraries' fp32 transcendentals
differ by an ulp or two), so 1e-5 absolute and relative on values of
order 1 (observed <= 2e-6 absolute). Within the port every switch gives
the same bits (the recompute runs the same ops
on the same inputs, on one torch thread).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.runtime.activation_checkpointing import \
    checkpointing as jck
from deepspeed_tpu.runtime.activation_checkpointing import config as jcfg
from deepspeed_tpu_torch import checkpointing as tck
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    config as tcfg
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5
_SWITCHES = ("PARTITION_ACTIVATIONS", "CPU_CHECKPOINTING",
             "CONTIGUOUS_CHECKPOINTING", "SYNCHRONIZE", "PROFILE_TIME",
             "num_layers")


@pytest.fixture(autouse=True)
def fresh_modules():
    """Both modules keep global switches: start and end each test with
    the defaults."""
    for mod in (jck, tck):
        mod.configure()
    yield
    for mod in (jck, tck):
        mod.configure()


BLOCKS = [
    {},
    {"activation_checkpointing": {}},
    {"activation_checkpointing": {"partition_activations": True,
                                  "cpu_checkpointing": True}},
    {"activation_checkpointing": {"contiguous_memory_optimization": True,
                                  "number_checkpoints": 4,
                                  "synchronize_checkpoint_boundary": True,
                                  "profile": True}},
]


@pytest.mark.parametrize("d", BLOCKS, ids=["absent", "empty", "offload",
                                           "hints"])
def test_config_block_resolves_like_jax(d):
    mine = tcfg.DeepSpeedActivationCheckpointingConfig(d)
    ref = jcfg.DeepSpeedActivationCheckpointingConfig(d)
    assert mine.repr() == ref.repr()
    names = [n for n in dir(jcfg) if n.startswith("ACT")]
    assert len(names) >= 14
    for name in names:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert DeepSpeedConfig(dict(d, train_batch_size=2)) \
        .activation_checkpointing_config.repr() == ref.repr()


def _switches(mod):
    return {k: getattr(mod, k) for k in _SWITCHES}


@pytest.mark.parametrize("source", ["dict", "path", "config"])
def test_configure_from_dict_path_or_config(source, tmp_path):
    d = {"train_batch_size": 8,
         "activation_checkpointing": {"cpu_checkpointing": True,
                                      "number_checkpoints": 3,
                                      "profile": True}}
    if source == "path":
        path = tmp_path / "ds.json"
        path.write_text(json.dumps(d))
        arg = str(path)
    elif source == "config":
        arg = DeepSpeedConfig(d)
    else:
        arg = d
    tck.configure(None, deepspeed_config=arg)
    jck.configure(None, deepspeed_config=d)
    assert tck.is_configured()
    assert _switches(tck) == _switches(jck)
    # explicit kwargs override the block, in both
    tck.configure(None, deepspeed_config=arg, checkpoint_in_cpu=False,
                  num_checkpoints=7, synchronize=True)
    jck.configure(None, deepspeed_config=d, checkpoint_in_cpu=False,
                  num_checkpoints=7, synchronize=True)
    assert _switches(tck) == _switches(jck)
    tck.set_num_layers(5)
    jck.set_num_layers(5)
    tck.partition_activations_in_checkpoint(True)
    jck.partition_activations_in_checkpoint(True)
    assert _switches(tck) == _switches(jck)
    tck.reset()


def test_configure_refuses_a_model_parallel_group():
    class MPU:
        def get_model_parallel_world_size(self):
            return 2

    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 6"):
        tck.configure(MPU(), partition_activations=True)

    class One(MPU):
        def get_model_parallel_world_size(self):
            return 1

    tck.configure(One(), partition_activations=True)
    assert tck.PARTITION_ACTIVATIONS


def _jax_eqn(fn, *shapes):
    jaxpr = jax.make_jaxpr(fn)(*[jnp.zeros(s, jnp.float32)
                                 for s in shapes]).jaxpr
    return jaxpr.eqns[-1]


def _jax_saves(policy, eqn):
    return bool(policy(eqn.primitive, *[v.aval for v in eqn.invars],
                       **eqn.params))


@pytest.mark.parametrize("name", ["everything_saveable", "nothing_saveable",
                                  "dots_saveable", "checkpoint_dots",
                                  "dots_with_no_batch_dims_saveable",
                                  "checkpoint_dots_with_no_batch_dims"])
def test_jax_policy_names_keep_what_jax_keeps(name):
    """A product without batch dims (the projections), a batched one
    (dense attention), a named value: the port's policy keeps each
    exactly when the JAX policy does."""
    from jax.ad_checkpoint import checkpoint_name
    jpol = jck.resolve_checkpoint_policy(name)
    mine = tck.resolve_checkpoint_policy(name)
    mm = _jax_eqn(lambda a, b: a @ b, (8, 4), (4, 6))
    bmm = _jax_eqn(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                   (2, 8, 4), (2, 4, 6))
    named = _jax_eqn(lambda a: checkpoint_name(a, "attn_out"), (8, 4))

    def port_saves(op):
        if mine.everything:
            return True
        if not mine.dots:
            return False
        return tck._sac_policy_fn(mine.dots)(None, op.default) == \
            torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE

    assert port_saves(torch.ops.aten.mm) == _jax_saves(jpol, mm)
    assert port_saves(torch.ops.aten.addmm) == _jax_saves(jpol, mm)
    assert port_saves(torch.ops.aten.bmm) == _jax_saves(jpol, bmm)
    assert mine.saves("attn_out") == _jax_saves(jpol, named)


def test_policy_resolution_order_and_unknown_names():
    from jax.ad_checkpoint import checkpoint_name
    fused = tck.resolve_checkpoint_policy("save_fused_epilogues")
    from deepspeed_tpu.ops.transformer import fused_ops as jfo
    assert fused.names == {"attn_out", "attn_lse",
                           *jfo.FUSED_EPILOGUE_SAVE_NAMES}
    assert tfo.FUSED_EPILOGUE_SAVE_NAMES == jfo.FUSED_EPILOGUE_SAVE_NAMES
    jfused = jck.resolve_checkpoint_policy("save_fused_epilogues")
    for name in ("attn_out", "attn_lse", "fused_ln_out", "fused_ln_sum",
                 "fused_gelu_sum", "fused_gelu_out"):
        eqn = _jax_eqn(lambda a: checkpoint_name(a, name), (4,))
        assert fused.saves(name) == _jax_saves(jfused, eqn), name
    spec = tck.resolve_checkpoint_policy(
        "save_only_these_names:attn_out,attn_lse")
    assert spec.names == {"attn_out", "attn_lse"} and not spec.dots
    # a registered name is found before the built-in forms
    keep = tck.save_only_these_names("fused_ln_sum")
    tck.register_checkpoint_policy("dots_saveable", keep)
    try:
        assert tck.resolve_checkpoint_policy("dots_saveable") is keep
    finally:
        del tck._NAMED_POLICIES["dots_saveable"]
    assert tck.resolve_checkpoint_policy(None) is None
    with pytest.raises(ValueError) as mine:
        tck.resolve_checkpoint_policy("save_fused_epilogue")
    with pytest.raises(ValueError) as ref:
        jck.resolve_checkpoint_policy("save_fused_epilogue")

    def words(e):   # the registered names between the parentheses vary
        text = str(e.value)
        return text[:text.index("(")] + text[text.index(")"):]
    assert words(mine) == words(ref)
    with pytest.raises(TypeError):
        tck.register_checkpoint_policy("bad", lambda *a: True)


W = np.random.RandomState(3).randn(48, 32).astype(np.float32) * 0.2


def _fn_jax(x, y):
    return jnp.tanh(x @ jnp.asarray(W)) * y + jnp.sin(x[:, :32])


def _fn_torch(w):
    def fn(x, y):
        return torch.tanh(x @ w) * y + torch.sin(x[:, :32])
    return fn


def _inputs():
    r = np.random.RandomState(7)
    return (r.randn(16, 48).astype(np.float32),
            r.randn(16, 32).astype(np.float32),
            r.randn(16, 32).astype(np.float32))


@pytest.mark.parametrize("switches", [
    {}, {"checkpoint_in_cpu": True}, {"profile": True},
    {"partition_activations": True, "contiguous_checkpointing": True,
     "synchronize": True, "num_checkpoints": 2},
    {"checkpoint_policy": "dots_with_no_batch_dims_saveable"},
    {"checkpoint_policy": "everything_saveable"},
], ids=["plain", "cpu_checkpointing", "profile", "hints", "dots",
        "everything"])
def test_checkpoint_matches_jax(switches):
    x, y, ct = _inputs()
    jck.configure(None, **switches)

    def jloss(x, y, w):
        out = jck.checkpoint(lambda a, b: jnp.tanh(a @ w) * b +
                             jnp.sin(a[:, :32]), x, y)
        return (out * ct).sum(), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(x, y, W)

    tck.configure(None, **switches)
    w = torch.from_numpy(W).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    out = tck.checkpoint(_fn_torch(w), xt * 1.0, yt)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                [xt, yt, w])
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=TOL,
                               atol=TOL)
    for g, ref in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), ref, rtol=TOL, atol=TOL)
    # every switch gives the bits of plain autograd
    w2 = torch.from_numpy(W).requires_grad_(True)
    x2 = torch.from_numpy(x).requires_grad_(True)
    y2 = torch.from_numpy(y).requires_grad_(True)
    plain = _fn_torch(w2)(x2, y2)
    pgrads = torch.autograd.grad((plain * torch.from_numpy(ct)).sum(),
                                 [x2, y2, w2])
    assert torch.equal(plain, out.detach())
    assert all(torch.equal(a, b) for a, b in zip(grads, pgrads))


def test_cpu_checkpointing_keeps_the_inputs_on_the_host():
    """The inputs checkpoint() keeps are host copies while the graph
    lives (pinned on a card; the CPU has no pinned kind), the forward's
    own inputs are not held, and the copies go with the graph."""
    x, y, ct = _inputs()
    tck.configure(None, checkpoint_in_cpu=True)
    w = torch.from_numpy(W).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    h = xt * 2.0
    out = tck.checkpoint(_fn_torch(w), h, torch.from_numpy(y))
    staged = tck.host_staged_inputs()
    assert len(staged) == 2
    assert {tuple(t.shape) for t in staged} == {(16, 48), (16, 32)}
    assert all(t.device.type == "cpu" and not t.requires_grad
               for t in staged)
    held = [s for s in staged if s.shape == h.shape][0]
    assert torch.equal(held, h.detach())
    assert held.data_ptr() != h.data_ptr()
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                [xt, w])
    del out, staged, held
    assert tck.host_staged_inputs() == []
    tck.configure(None)
    w2 = torch.from_numpy(W).requires_grad_(True)
    x2 = torch.from_numpy(x).requires_grad_(True)
    ref = torch.autograd.grad(
        (_fn_torch(w2)(x2 * 2.0, torch.from_numpy(y)) *
         torch.from_numpy(ct)).sum(), [x2, w2])
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))


def test_rng_tracker_streams():
    tracker = tck.RNGStatesTracker(device="cpu")
    tracker.add("a", 5)
    with pytest.raises(Exception, match="already exists"):
        tracker.add("a", 6)
    with pytest.raises(Exception, match="is not added"):
        with tracker.fork("b"):
            pass
    with tracker.fork("a") as gen:
        first = torch.rand(4, generator=gen)
    with tracker.fork("a") as gen:
        second = torch.rand(4, generator=gen)
    assert not torch.equal(first, second)   # the stream advances
    saved = tracker.get_states()
    with tracker.fork("a") as gen:
        third = torch.rand(4, generator=gen)
    tracker.set_states(saved)
    with tracker.fork("a") as gen:
        assert torch.equal(torch.rand(4, generator=gen), third)
    ref = torch.Generator().manual_seed(5)
    assert torch.equal(first, torch.rand(4, generator=ref))
    tracker.reset()
    assert tracker.get_states() == {}

    # the model-parallel seed: seed + 2718 + rank, as in JAX; the
    # default stream is the seed itself
    gen = tck.model_parallel_manual_seed(11, model_parallel_rank=1,
                                         device="cpu")
    jkey = jck.model_parallel_manual_seed(11, model_parallel_rank=1)
    assert np.array_equal(np.asarray(jkey),
                          np.asarray(jax.random.PRNGKey(11)))
    assert sorted(tck.get_rng_tracker().states_) == \
        sorted(jck.get_rng_tracker().states_) == ["model-parallel-rng"]
    with tck.get_cuda_rng_tracker().fork() as mp:
        got = torch.rand(3, generator=mp)
    assert torch.equal(got, torch.rand(
        3, generator=torch.Generator().manual_seed(11 + 2718 + 1)))
    assert torch.equal(torch.rand(3, generator=gen), torch.rand(
        3, generator=torch.Generator().manual_seed(11)))
    assert tck.CudaRNGStatesTracker is tck.RNGStatesTracker
    assert tck.model_parallel_cuda_manual_seed is \
        tck.model_parallel_manual_seed


def test_engine_configures_the_module():
    """initialize() with the block configures the checkpointing module,
    as the JAX engine does (runtime/engine.py:262-271)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=32),
                                  device="cpu")
    dst.initialize(model=model, model_parameters=model.init(0),
                   config={"train_batch_size": 2,
                           "activation_checkpointing": {
                               "cpu_checkpointing": True, "profile": True,
                               "number_checkpoints": 2}})
    assert tck.is_configured() and tck.CPU_CHECKPOINTING and \
        tck.PROFILE_TIME and tck.num_layers == 2
    assert dst.checkpointing is tck
