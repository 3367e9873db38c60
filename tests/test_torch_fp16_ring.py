"""PyTorch port: fp16 sequence parallelism (kernel K5's and K2's
given-delta fp16 twins, ring and Ulysses attention, GPT-2 and the
engine with `sequence_parallel`) against the JAX package, on the CPU.

* `flash_attention_merge` in fp16 (K5's twin, then K2's given-delta
  twin in its backward) against the JAX kernel in merge mode in
  interpret mode: out, lse and the VJP in all five inputs.
* A gloo group of 2 CPU processes (tests/torch_sp_workers.py's
  `worker_fp16`, spawned once by a module-scoped fixture) runs ring
  attention on the flash twins, causal and not, Ulysses on the flash
  twins, and a tiny GPT-2 in fp16 under ring and Ulysses; the ranks'
  chunks, concatenated, are held against the JAX functions on a
  Mesh(jax.devices()[:2], ("seq",)) (fp16 inputs; JAX's Pallas kernels
  in interpret mode) and the JAX model without sequence parallelism.
* `initialize` -> `train_batch` with fp16 and GPT-2's
  `sequence_parallel` "ring" and "ulysses" in a one-rank gloo group
  against the JAX engine (no sequence parallelism): per step the loss,
  the scale automaton's state and the skipped steps.

K5's backward hands K2 the block's output cotangent in q's dtype, fp16
here, where the JAX VJP keeps it fp32 (ROADMAP Queue 3, known
deviations). It cannot overflow fp16 there: the merge weight a_n =
2^(lse_n - lse) is at most 1, so |d o_n| <= |d out|, and d out reaches
attention as the cotangent of an fp16 cast. It rounds once more, which
the gradient tolerances below cover.

Tolerances. fp16 carries 10 mantissa bits. Merge out (fp32 of fp16
inputs, P rounded to fp16 before P.V in both packages, each against
its own running max): 2e-3; lse 2e-5 (fp32 chains). The VJP: 5e-3
relative L2 (dS and d o_n round to fp16). The ring and Ulysses cases:
out within 2e-3 (one fp16 rounding of the output on top), the
gradients of sum(out ** 2) 1e-2 relative L2 (the cotangent 2 out is
itself an fp16-rounded value, and the merge rounds d o_n at every
fold). GPT-2: loss 5e-3 relative, gradients 1e-2 relative L2 (fp16
activations in each package's own order, the ring merging in another
order than one pass); every rank's loss and gradients equal rank 0's
bit for bit. The engine: the loss within 5e-3 relative per step.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import Mesh

import deepspeed_tpu
import deepspeed_tpu_torch as dst
import torch_sp_workers as W
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.sequence import ring_attention, ulysses_attention
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

OUT_TOL = dict(atol=2e-3, rtol=2e-3)
LSE_TOL = dict(atol=2e-5, rtol=2e-5)
MERGE_GRAD_TOL = 5e-3
SP_GRAD_TOL = 1e-2
LOSS_TOL = 5e-3
P = 2


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_l2(got, ref):
    got, ref = _f(got).astype(np.float64), _f(ref).astype(np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _merge_inputs(seed, b=2, t=256, h=2, d=64):
    """fp16 q, k, v and an fp32 prior partial of q over a disjoint key
    block, its first rows an empty partial."""
    r = np.random.RandomState(seed)
    q, k, v, k2, v2 = (r.randn(b, t, h, d).astype(np.float16)
                       for _ in range(5))
    prev, prev_lse = jfa.flash_attention_with_lse(
        q, k2, v2, causal=False, interpret=True)
    prev = np.array(prev, np.float32)
    prev_lse = np.array(prev_lse)
    prev[:, :9] = 0.0
    prev_lse[:, :, :9] = tfa.NEG_INF
    return q, k, v, prev, prev_lse


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_fp16_merge_matches_jax_interpret(causal):
    q, k, v, prev, prev_lse = _merge_inputs(40 + causal)
    ref_out, ref_lse = jfa.flash_attention_merge(
        q, k, v, prev, prev_lse, causal=causal, interpret=True)
    out, lse = tfa.flash_attention_merge(
        *(torch.from_numpy(x) for x in (q, k, v, prev, prev_lse)),
        causal=causal)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_f(out), _f(ref_out), **OUT_TOL)
    np.testing.assert_allclose(_f(lse), _f(ref_lse), **LSE_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_fp16_merge_vjp_matches_jax_in_all_five_inputs(causal):
    """The merge backward in fp16: host math, then K2's given-delta twin
    with d o_n in fp16, against the JAX VJP (d o_n fp32 there)."""
    q, k, v, prev, prev_lse = _merge_inputs(50 + causal)
    r = np.random.RandomState(60 + causal)
    g_out = r.randn(*q.shape).astype(np.float32)
    g_lse = r.randn(*prev_lse.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda *a: jfa.flash_attention_merge(*a, causal=causal,
                                             interpret=True),
        *(jnp.asarray(x) for x in (q, k, v, prev, prev_lse)))
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (q, k, v, prev, prev_lse)]
    out, lse = tfa.flash_attention_merge(*leaves, causal=causal)
    got = torch.autograd.grad((out, lse), leaves,
                              (torch.from_numpy(g_out),
                               torch.from_numpy(g_lse)))
    for name, x, y in zip(("q", "k", "v", "prev_out", "prev_lse"), got,
                          want):
        assert x.dtype == (torch.float16 if name in "qkv" else
                           torch.float32), name
        assert np.isfinite(_f(x)).all(), name
        assert _rel_l2(x, y) <= MERGE_GRAD_TOL, name


# ----------------------------------------------------------------------
# ring and Ulysses over a gloo group of 2 processes
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_gpt2_16():
    """The tiny GPT-2's tree, and the JAX fp16 model's loss and fp16
    gradients on fp16 parameters without sequence parallelism."""
    model = jgpt2.GPT2ForCausalLM(jgpt2.tiny_gpt2_config(
        n_layer=2, n_head=8, dropout=0.0, dtype=jnp.float16))
    ids = W.gpt2_ids().astype(np.int32)
    tree = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), {"input_ids": ids}))
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float16), tree)
    loss, grads = jax.value_and_grad(
        lambda p: model.loss_fn(p, {"input_ids": ids},
                                deterministic=True))(p16)
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    return model, tree, float(loss), grads


@pytest.fixture(scope="module")
def ranks16(tmp_path_factory, jax_gpt2_16):
    out_dir = str(tmp_path_factory.mktemp("sp16"))
    param_file = os.path.join(out_dir, "params.npz")
    np.savez(param_file, **{n: t.numpy() for n, t in
                            params_from_jax(jax_gpt2_16[1]).items()})
    try:
        tmp.start_processes(W.worker_fp16, args=(P, out_dir, param_file),
                            nprocs=P, join=True, start_method="spawn")
    except Exception:
        errs = [open(os.path.join(out_dir, f)).read()
                for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
        pytest.fail("sequence-parallel workers failed:\n" + "\n".join(errs))
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(P)]


def _chunks(results, key):
    return np.concatenate([res[key] for res in results], axis=1)


@pytest.mark.parametrize("case", W.FP16_CASES, ids=lambda c: c[0])
def test_fp16_sequence_parallel_attention_matches_jax(ranks16, case):
    """The ranks' concatenated out and grads of sum(out ** 2) against the
    JAX ring (flash body, interpret mode) or Ulysses (flash) on the
    global fp16 inputs."""
    name, tl, h, d, causal, _ = case
    mesh = Mesh(np.asarray(jax.devices()[:P]), ("seq",))
    if name.startswith("ulysses"):
        def fn(q, k, v):
            return ulysses_attention(q, k, v, mesh, axis_name="seq",
                                     causal=causal, use_flash=True)
    else:
        def fn(q, k, v):
            return ring_attention(q, k, v, mesh, axis_name="seq",
                                  causal=causal, use_flash=True,
                                  interpret=True)
    q, k, v = (jnp.asarray(x, jnp.float16) for x in
               W.global_qkv(tl * P, h, d, W.case_seed(name)))

    @jax.jit
    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(2.0 * out)

    out, grads = out_and_grads(q, k, v)
    np.testing.assert_allclose(_chunks(ranks16, f"{name}/out"), _f(out),
                               **OUT_TOL)
    for n, g in zip("qkv", grads):
        assert _rel_l2(_chunks(ranks16, f"{name}/d{n}"), g) <= \
            SP_GRAD_TOL, n


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_fp16_gpt2_sequence_parallel_matches_jax(ranks16, jax_gpt2_16, impl):
    _, _, ref_loss, ref_grads = jax_gpt2_16
    first = ranks16[0]
    loss = float(first[f"gpt2_{impl}/loss"])
    assert abs(loss - ref_loss) <= LOSS_TOL * abs(ref_loss)
    prefix = f"gpt2_{impl}/grad/"
    names = [k[len(prefix):] for k in first if k.startswith(prefix)]
    assert sorted(names) == sorted(ref_grads)
    for n in names:
        assert _rel_l2(first[prefix + n], ref_grads[n]) <= SP_GRAD_TOL, n
    for res in ranks16[1:]:
        assert np.array_equal(res[f"gpt2_{impl}/loss"],
                              first[f"gpt2_{impl}/loss"])
        for n in names:
            assert np.array_equal(res[prefix + n], first[prefix + n]), n


# ----------------------------------------------------------------------
# the engine with sequence parallelism in fp16 (one-rank gloo group)
# ----------------------------------------------------------------------
STEP_KINDS = "uurrurr"


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_fp16_sequence_parallel_engine_matches_jax_engine(tmp_path, impl):
    """initialize() with fp16 and a GPT-2 whose sequence_parallel is
    `impl` succeeds in a one-rank gloo group, and its steps track the
    JAX engine without sequence parallelism: the loss per step, the
    scale automaton's state, skipped_steps and the step count."""
    seq = 64
    config = {"train_batch_size": 8, "steps_per_print": 1000,
              "fp16": {"enabled": True, "initial_scale_power": 17,
                       "loss_scale_window": 2, "hysteresis": 2},
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    jmodel = jgpt2.GPT2ForCausalLM(jgpt2.tiny_gpt2_config(
        n_positions=seq, dtype=jnp.float16))
    params = jmodel.init(jax.random.PRNGKey(3),
                         {"input_ids": np.zeros((1, 8), np.int32)})
    tree = jax.tree_util.tree_map(np.asarray, params)
    jengine = deepspeed_tpu.initialize(model=jmodel, model_parameters=params,
                                       config=config)[0]
    dst.init_distributed("gloo", init_method="file://" + str(
        tmp_path / "rendezvous"), rank=0, world_size=1, verbose=False)
    try:
        model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(
            n_positions=seq, dtype=torch.float16, sequence_parallel=impl),
            device="cpu")
        engine = dst.initialize(
            model=model, model_parameters=params_from_jax(tree),
            config=dict(config, train_micro_batch_size_per_gpu=8))[0]
        assert engine.fp16_enabled()
        rng = np.random.RandomState(5)
        for i, kind in enumerate(STEP_KINDS):
            ids = np.zeros((1, 8, seq), np.int32) if kind == "u" else \
                rng.randint(0, 256, (1, 8, seq)).astype(np.int32)
            ref = float(jengine.train_batch(batch={"input_ids": ids}))
            got = float(engine.train_batch(batch={"input_ids": ids}))
            assert abs(got - ref) <= LOSS_TOL * abs(ref), (i, got, ref)
            assert float(engine.state.scale.loss_scale) == \
                float(jengine.state.scale.loss_scale), i
            assert engine.skipped_steps == jengine.skipped_steps, i
            assert int(engine.state.global_steps) == \
                int(jengine.state.global_steps), i
        assert 0 < engine.skipped_steps < len(STEP_KINDS)
    finally:
        torch.distributed.destroy_process_group()
