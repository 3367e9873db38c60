"""PyTorch port: the named remat policies against the JAX package.

GPT-2 (dense, and one mixture-of-experts case) trains under each remat
policy the JAX package's configs use: None (full-block remat),
"dots_with_no_batch_dims_saveable", "save_only_these_names:attn_out,
attn_lse" and "save_fused_epilogues", on the fused path (fused ops "on",
flash attention at head dim 64, T 128). Held against the JAX package:

* the loss and every gradient under the same policy, from the same tree;
* which forward kernels the backward runs again: the port's launches of
  K1-fwd, K3-fwd and K4-fwd inside the backward (their CPU twins,
  counted) equal the number of each kernel's `pallas_call` equations in
  the JAX package's rematted grad jaxpr less those in its forward jaxpr
  (the JAX trace takes the Pallas kernels in interpret mode; a scan body
  counts its length), and `chip_smoke.REMAT_RECOMPUTE`, the table the
  card's exact launch gates use, says the same;
* which GEMMs the backward runs again: the port's `aten.mm` calls on
  real tensors in loss-and-grad, less those under everything_saveable,
  equal JAX's `dot_general` equations counted the same way (the dots
  policy keeps the projections' products; under the named policies the
  GEMMs that feed only a kept kernel output are not recomputed);
* the fused transformer layer's memory flags under fused ops
  (save_fused_epilogues, as the JAX layer): the kernels its backward runs
  again, against the JAX layer's jaxpr.

Within the port every policy gives the loss and gradients of full remat
bit for bit (one torch thread), and an engine's trajectory under a
policy equals full remat's bit for bit.

Tolerance (fp32, two layers; reduction order only), as in
`test_torch_gpt2_train.py`: the loss within 1e-5 relative, every
gradient within 1e-4 relative L2 (observed ~1e-6).
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.extend
import jax.numpy as jnp

import chip_smoke
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.moe import MoEConfig as JMoE
from deepspeed_tpu.ops.transformer import (
    DeepSpeedTransformerConfig as JLayerConfig,
    DeepSpeedTransformerLayer as JLayer)
from deepspeed_tpu.ops.transformer import fused_ops as jfo
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.moe import MoEConfig as TMoE
from deepspeed_tpu_torch.ops.transformer import (
    DeepSpeedTransformerConfig as TLayerConfig,
    DeepSpeedTransformerLayer as TLayer)
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo
from torch.utils._python_dispatch import TorchDispatchMode
from torch_one_thread import one_torch_thread  # noqa: F401

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
POLICIES = [None, "dots_with_no_batch_dims_saveable",
            "save_only_these_names:attn_out,attn_lse",
            "save_fused_epilogues"]
POLICY_IDS = ["full", "dots", "attn_names", "fused_epilogues"]
# head dim 64 (flash attention), T 128
WIDTH = dict(n_positions=128, n_embd=128, n_head=2)
MOE = dict(num_experts=4, top_k=2, capacity_factor=1.0, every_n_layers=2)
# the JAX kernels (pallas_call `name`, or the kernel function's name) ->
# the port's forward twins
JAX_KERNELS = {"_fwd_kernel": "flash_fwd",
               "fused_bias_residual_layernorm_fwd": "ln_fwd",
               "fused_bias_gelu_fwd": "gelu_fwd"}
# chip_smoke.py's launch counters -> the port's forward twins
CARD_NAMES = {"flash_attention_fwd": "flash_fwd",
              "fused_bias_residual_layernorm_fwd": "ln_fwd",
              "fused_bias_gelu_fwd": "gelu_fwd"}


def _ids(seed=1, rows=2):
    return np.random.RandomState(seed).randint(0, 256, (rows, 128)) \
        .astype(np.int32)


def _rel_l2(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _jcfg(policy, moe=False, **over):
    kw = dict(WIDTH, fused_ops="on", remat=True, remat_policy=policy,
              dtype=jnp.float32)
    if moe:
        kw.update(n_layer=4, moe=JMoE(**MOE).validate())
    kw.update(over)
    return jgpt2.tiny_gpt2_config(**kw)


def _tcfg(policy, moe=False, **over):
    kw = dict(WIDTH, fused_ops="on", remat=True, remat_policy=policy)
    if moe:
        kw.update(n_layer=4, moe=TMoE(**MOE, fused_dispatch="on")
                  .validate())
    kw.update(over)
    return tgpt2.tiny_gpt2_config(**kw)


@pytest.fixture(scope="module")
def trees():
    """{moe: JAX param tree under remat (Checkpoint* children)}."""
    out = {}
    for moe in (False, True):
        model = jgpt2.GPT2ForCausalLM(_jcfg(None, moe))
        out[moe] = model.init(jax.random.PRNGKey(0),
                              {"input_ids": _ids()})
    return out


def _port(tree, policy, moe=False, **over):
    model = tgpt2.GPT2ForCausalLM(_tcfg(policy, moe, **over), device="cpu")
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    params = {k: v.clone().requires_grad_(True) for k, v in
              model.load_params(flat).items()}
    return model, params


def _port_loss_and_grads(tree, policy, moe=False, ids=None, **over):
    model, params = _port(tree, policy, moe, **over)
    ids = _ids() if ids is None else ids
    loss = model.loss_fn(params, {"input_ids": ids}, deterministic=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _jax_loss_fn(policy, moe=False, ids=None):
    model = jgpt2.GPT2ForCausalLM(_jcfg(policy, moe))
    ids = _ids() if ids is None else ids
    return lambda p: model.loss_fn(p, {"input_ids": ids},
                                   deterministic=True)


@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
def test_dense_loss_and_grads_match_jax(trees, policy):
    ref_loss, ref_grads = jax.value_and_grad(
        _jax_loss_fn(policy))(trees[False])
    ref_grads = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       ref_grads))
    loss, grads = _port_loss_and_grads(trees[False], policy)
    assert abs(float(loss) - float(ref_loss)) <= \
        LOSS_TOL * abs(float(ref_loss))
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert _rel_l2(g.numpy(), ref_grads[name].numpy()) <= GRAD_TOL, \
            name


def test_moe_loss_and_grads_match_jax(trees):
    policy = "save_fused_epilogues"
    ref_loss, ref_grads = jax.value_and_grad(
        _jax_loss_fn(policy, moe=True))(trees[True])
    ref_grads = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       ref_grads))
    loss, grads = _port_loss_and_grads(trees[True], policy, moe=True)
    assert abs(float(loss) - float(ref_loss)) <= \
        LOSS_TOL * abs(float(ref_loss))
    for name, g in grads.items():
        assert _rel_l2(g.numpy(), ref_grads[name].numpy()) <= GRAD_TOL, \
            name


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_every_policy_gives_full_remats_bits(trees, moe):
    """The kept outputs are the forward's own: every policy (and
    everything_saveable, no remat) gives full remat's loss and gradients
    bit for bit."""
    ref_loss, ref = _port_loss_and_grads(trees[moe], None, moe)
    for policy in POLICIES[1:] + ["everything_saveable"]:
        loss, grads = _port_loss_and_grads(trees[moe], policy, moe)
        assert torch.equal(loss, ref_loss), policy
        assert all(torch.equal(grads[k], ref[k]) for k in ref), policy


# ----------------------------------------------------------------------
# which kernels and GEMMs the backward runs again
# ----------------------------------------------------------------------
def _walk(jaxpr, visit, mult=1):
    """visit(eqn, multiplicity) over every equation, into sub-jaxprs (not
    into a kernel's body); a scan body counts its length."""
    for eqn in jaxpr.eqns:
        visit(eqn, mult)
        if eqn.primitive.name == "pallas_call":
            continue
        inner = mult * (eqn.params["length"]
                        if eqn.primitive.name == "scan" else 1)
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (list, tuple))
                        else [value]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    _walk(sub.jaxpr, visit, inner)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    _walk(sub, visit, inner)


def _jax_counts(fn, *args):
    """{port twin name: pallas_call count}, and the dot_general count."""
    counts = collections.Counter()

    def visit(eqn, mult):
        if eqn.primitive.name == "pallas_call":
            name = eqn.params.get("name") or getattr(
                eqn.params["jaxpr"].debug_info, "func_name", None)
            if name in JAX_KERNELS:
                counts[JAX_KERNELS[name]] += mult
        elif eqn.primitive.name == "dot_general":
            counts["gemm"] += mult
    _walk(jax.make_jaxpr(fn)(*args).jaxpr, visit)
    return counts


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX fused epilogues as Pallas kernels (interpret mode), for
    tracing: on the CPU the JAX package runs their XLA form."""
    monkeypatch.setattr(jfo, "_resolve_impl", lambda impl: (True, True))


class _Gemms(TorchDispatchMode):
    """Counts aten.mm / addmm on real tensors (a skipped GEMM's output is
    shaped on the meta device)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm) \
                and args[0].device.type != "meta":
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def port_twins(monkeypatch):
    """Counts the port's forward twin calls by kernel."""
    counts = collections.Counter()

    def counting(mod, attr, key):
        real = getattr(mod, attr)

        def call(*a, **k):
            counts[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, attr, call)
    counting(tfa, "_flash_forward", "flash_fwd")
    counting(tfo, "_ln_forward", "ln_fwd")
    counting(tfo, "_gelu_forward", "gelu_fwd")
    return counts


def _port_counts(counts, run_forward, run_backward):
    """{twin: calls in the backward}, forward counts, backward GEMMs."""
    counts.clear()
    with _Gemms() as fwd_gemms:
        out = run_forward()
    forward = dict(counts)
    counts.clear()
    with _Gemms() as bwd_gemms:
        run_backward(out)
    return dict(counts), forward, fwd_gemms.n + bwd_gemms.n


def _gpt2_port_run(tree, policy, moe):
    model, params = _port(tree, policy, moe)

    def fwd():
        return model.loss_fn(params, {"input_ids": _ids()},
                             deterministic=True)
    return fwd, lambda loss: torch.autograd.grad(loss,
                                                 list(params.values()))


@pytest.mark.parametrize("moe,policy", [
    (False, None), (False, "dots_with_no_batch_dims_saveable"),
    (False, "save_only_these_names:attn_out,attn_lse"),
    (False, "save_fused_epilogues"), (False, "everything_saveable"),
    (True, None), (True, "save_fused_epilogues"),
], ids=["dense-full", "dense-dots", "dense-attn_names",
        "dense-fused_epilogues", "dense-everything", "moe-full",
        "moe-fused_epilogues"])
def test_backward_reruns_the_kernels_jax_reruns(trees, jax_pallas,
                                                port_twins, moe, policy):
    jloss = _jax_loss_fn(policy, moe)
    fwd = _jax_counts(jloss, trees[moe])
    grad = _jax_counts(jax.grad(jloss), trees[moe])
    again, forward, _ = _port_counts(
        port_twins, *_gpt2_port_run(trees[moe], policy, moe))
    for kernel in ("flash_fwd", "ln_fwd", "gelu_fwd"):
        assert forward.get(kernel, 0) == fwd[kernel], kernel
        assert again.get(kernel, 0) == grad[kernel] - fwd[kernel], \
            (kernel, again, dict(grad), dict(fwd))
    if policy in ("save_fused_epilogues",
                  "save_only_these_names:attn_out,attn_lse"):
        assert again.get("flash_fwd", 0) == 0
    if not moe and policy in chip_smoke.REMAT_RECOMPUTE:
        # the card's launch gates (chip_smoke.py) count this recompute
        table = chip_smoke.REMAT_RECOMPUTE[policy]
        n_layer = _tcfg(policy).n_layer
        assert {CARD_NAMES[k]: v * n_layer for k, v in table.items()} == \
            {k: again.get(k, 0) for k in CARD_NAMES.values()}


def test_backward_reruns_the_gemms_jax_reruns(trees, port_twins):
    """The GEMMs a policy's backward runs again, beyond no remat's."""
    tree = trees[False]
    jax_gemms, port_gemms = {}, {}
    for policy in POLICIES + ["everything_saveable"]:
        jax_gemms[policy] = _jax_counts(jax.grad(_jax_loss_fn(policy)),
                                        tree)["gemm"]
        port_gemms[policy] = _port_counts(
            port_twins, *_gpt2_port_run(tree, policy, False))[2]
    base_j, base_p = jax_gemms.pop("everything_saveable"), \
        port_gemms.pop("everything_saveable")
    again_j = {p: n - base_j for p, n in jax_gemms.items()}
    again_p = {p: n - base_p for p, n in port_gemms.items()}
    assert again_p == again_j
    # two layers: c_attn, c_proj and c_fc a layer under full remat; none
    # under the dots policy; c_attn and c_fc under save_fused_epilogues
    # (c_proj only feeds ln_2's kept K3); mlp_c_proj never
    assert again_p == {None: 6, "dots_with_no_batch_dims_saveable": 0,
                       "save_only_these_names:attn_out,attn_lse": 6,
                       "save_fused_epilogues": 4}


# ----------------------------------------------------------------------
# the fused layer's memory flags
# ----------------------------------------------------------------------
def _layer_cfg(**over):
    base = dict(hidden_size=128, heads=2, intermediate_size=512,
                attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
                num_hidden_layers=2, initializer_range=0.02, training=True,
                fused_ops="on")
    base.update(over)
    return base


@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre_ln", "post_ln"])
@pytest.mark.parametrize("flag", ["normalize_invertible", "gelu_checkpoint",
                                  "attn_dropout_checkpoint"])
def test_memory_flags_rerun_the_kernels_jax_reruns(jax_pallas, port_twins,
                                                   flag, pre_ln):
    """Under fused ops a memory flag remats per fusion in both packages:
    the backward launches no K3-fwd again, and K4-fwd (its output is not
    kept) and K1-fwd (the layer's flash outputs carry no names, in the
    JAX layer as here) once, as the JAX layer's rematted jaxpr."""
    kw = _layer_cfg(pre_layer_norm=pre_ln, **{flag: True})
    jlayer = JLayer(JLayerConfig(**kw))
    x = (np.random.RandomState(4).randn(2, 128, 128) * 0.5) \
        .astype(np.float32)
    params = jlayer.init({"params": jax.random.PRNGKey(0)},
                         jnp.asarray(x), None, True)

    def jloss(p):
        return jlayer.apply(p, jnp.asarray(x), None, True).sum()
    fwd = _jax_counts(jloss, params)
    grad = _jax_counts(jax.grad(jloss), params)

    layer = TLayer(TLayerConfig(**kw), device="cpu")
    layer.init_params(0)
    xt = torch.from_numpy(x).requires_grad_(True)
    again, forward, _ = _port_counts(
        port_twins, lambda: layer(xt, None, True).sum(),
        lambda y: torch.autograd.grad(y, [xt] + list(layer.parameters())))
    for kernel in ("flash_fwd", "ln_fwd", "gelu_fwd"):
        assert forward.get(kernel, 0) == fwd[kernel], kernel
        assert again.get(kernel, 0) == grad[kernel] - fwd[kernel], kernel
    assert again == {"flash_fwd": 1, "gelu_fwd": 1}


# ----------------------------------------------------------------------
# the engine under a policy
# ----------------------------------------------------------------------
def test_engine_trajectory_under_a_policy_is_full_remats(trees):
    """initialize -> train_batch, 4 steps of AdamW under
    save_fused_epilogues and under dots_with_no_batch_dims_saveable: the
    losses and the parameters equal full remat's bit for bit."""
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, trees[False]))
    batches = [{"input_ids": _ids(seed=s, rows=4)[None]} for s in range(4)]
    config = {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 100,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 3e-3, "weight_decay": 0.01}}}
    runs = {}
    for policy in (None, "save_fused_epilogues",
                   "dots_with_no_batch_dims_saveable"):
        model = tgpt2.GPT2ForCausalLM(_tcfg(policy), device="cpu")
        engine, *_ = dst.initialize(model=model, model_parameters=flat,
                                    config=config)
        losses = [engine.train_batch(batch=b) for b in batches]
        runs[policy] = (torch.stack(losses),
                        {k: v.detach().clone()
                         for k, v in engine.state.params.items()})
    ref_losses, ref_params = runs.pop(None)
    assert bool(torch.isfinite(ref_losses).all())
    for policy, (losses, params) in runs.items():
        assert torch.equal(losses, ref_losses), policy
        assert all(torch.equal(params[k], ref_params[k])
                   for k in ref_params), policy
