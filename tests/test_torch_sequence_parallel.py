"""PyTorch port: sequence parallelism (ring and Ulysses attention over
torch.distributed, GPT-2 `sequence_parallel`) against the JAX package.

Gloo groups of P = 2 and P = 4 CPU processes run every case once per P
(a module-scoped fixture spawns them with a `file://` rendezvous under a
temporary directory; the workers, in tests/torch_sp_workers.py, import
torch and the port only), each rank on its chunk of the same
numpy-seeded global inputs. The JAX reference runs here on a
Mesh(jax.devices()[:P], ("seq",)) of the virtual CPU devices, and the
ranks' chunks, concatenated in rank order, are held against it:

- ring attention, flash body (local chunk 128; the port's flash twins,
  JAX's Pallas kernel in interpret mode) and fallback body (local chunk
  24), causal and not; Ulysses, causal, 4 heads;
- GPT-2 (tiny, 2 layers, 8 heads) with sequence_parallel "ring" and
  "ulysses" against the JAX model without sequence parallelism, on the
  JAX weights carried across by models/convert.py; every rank's loss
  and gradients equal every other rank's bit for bit (each rank
  computes them from the same inputs in the same order);
- heads the group size does not divide and chunks of unequal length
  raise; a group of one rank is flash attention.

Tolerances: fp32 outputs within 2e-5 (the port's 64-row tiles and the
JAX kernel's or XLA's sums run in other orders, and the ring merges in
another order than one pass); gradients of sum(out ** 2) within 1e-4
relative L2 (the same roundoff carried through the backward's
products); GPT-2's loss within 1e-5 relative and its gradients within
1e-4 relative L2 (tests/test_torch_gpt2_train.py's tolerances).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as tmp
from jax.sharding import Mesh

import torch_sp_workers as W
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.sequence import ring_attention, ulysses_attention
from deepspeed_tpu_torch.models.convert import config_from_jax, \
    params_from_jax

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


def _rel_l2(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def jax_gpt2():
    """The tiny GPT-2's JAX tree, its loss and gradients without
    sequence parallelism, and the model's JAX config."""
    cfg = jgpt2.tiny_gpt2_config(n_layer=2, n_head=8, dropout=0.0)
    model = jgpt2.GPT2ForCausalLM(cfg)
    ids = W.gpt2_ids().astype(np.int32)
    tree = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), {"input_ids": ids}))
    loss, grads = jax.value_and_grad(
        lambda p: model.loss_fn(p, {"input_ids": ids},
                                deterministic=True))(tree)
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    return tree, float(loss), grads, cfg


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def ranks(request, tmp_path_factory, jax_gpt2):
    """Spawn the gloo group of P ranks once and return (P, [rank r's
    results])."""
    p = request.param
    out_dir = str(tmp_path_factory.mktemp(f"sp{p}"))
    param_file = os.path.join(out_dir, "params.npz")
    np.savez(param_file, **{n: t.numpy() for n, t in
                            params_from_jax(jax_gpt2[0]).items()})
    try:
        tmp.start_processes(W.worker, args=(p, out_dir, param_file),
                            nprocs=p, join=True, start_method="spawn")
    except Exception:
        errs = [open(os.path.join(out_dir, f)).read()
                for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
        pytest.fail("sequence-parallel workers failed:\n" + "\n".join(errs))
    return p, [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
               for r in range(p)]


def _mesh(p):
    return Mesh(np.asarray(jax.devices()[:p]), ("seq",))


def _chunks(results, key):
    return np.concatenate([res[key] for res in results], axis=1)


def _check_case(results, name, fn, t_local, h, d):
    """The ranks' concatenated out and grads of sum(out ** 2) against
    `fn` (the JAX call on the global inputs)."""
    p = len(results)
    q, k, v = (jnp.asarray(x) for x in
               W.global_qkv(t_local * p, h, d, W.case_seed(name)))

    @jax.jit
    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(2.0 * out)

    out, grads = out_and_grads(q, k, v)
    np.testing.assert_allclose(_chunks(results, f"{name}/out"),
                               np.asarray(out), **OUT_TOL)
    for n, g in zip("qkv", grads):
        assert _rel_l2(_chunks(results, f"{name}/d{n}"), g) <= GRAD_TOL, n


@pytest.mark.parametrize("case", W.RING_CASES, ids=lambda c: c[0])
def test_ring_attention_matches_jax(ranks, case):
    p, results = ranks
    name, tl, h, d, causal, flash = case
    kw = dict(use_flash=True, interpret=True) if flash else \
        dict(use_flash=False)

    def fn(q, k, v):
        return ring_attention(q, k, v, _mesh(p), axis_name="seq",
                              causal=causal, **kw)

    _check_case(results, name, fn, tl, h, d)


def test_ulysses_attention_matches_jax(ranks):
    p, results = ranks
    name, tl, h, d, causal, _ = W.ULYSSES_CASE

    def fn(q, k, v):
        return ulysses_attention(q, k, v, _mesh(p), axis_name="seq",
                                 causal=causal, use_flash=False)

    _check_case(results, name, fn, tl, h, d)


def test_what_jax_refuses_raises_on_every_rank(ranks):
    p, results = ranks
    for res in results:
        assert f"heads {p + 1} divisible" in str(res["raise/heads"])
        for key in ("raise/ring_chunks", "raise/ulysses_chunks"):
            assert "sequence length" in str(res[key]), key


def test_a_group_of_one_rank_is_flash_attention(ranks):
    _, results = ranks
    for res in results:
        np.testing.assert_allclose(res["single/out"], res["single/ref"],
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gpt2_sequence_parallel_matches_jax(ranks, jax_gpt2, impl):
    """Loss and every gradient of GPT-2 under sequence parallelism equal
    the JAX model's without it, and every rank's equal rank 0's."""
    _, results = ranks
    _, ref_loss, ref_grads, _ = jax_gpt2
    first = results[0]
    loss = float(first[f"gpt2_{impl}/loss"])
    assert abs(loss - ref_loss) <= LOSS_TOL * abs(ref_loss)
    prefix = f"gpt2_{impl}/grad/"
    names = [k[len(prefix):] for k in first if k.startswith(prefix)]
    assert sorted(names) == sorted(ref_grads)
    for n in names:
        assert _rel_l2(first[prefix + n], ref_grads[n].numpy()) <= \
            GRAD_TOL, n
    for res in results[1:]:
        assert np.array_equal(res[f"gpt2_{impl}/loss"],
                              first[f"gpt2_{impl}/loss"])
        for n in names:
            assert np.array_equal(res[prefix + n], first[prefix + n]), n


def test_config_from_jax_carries_sequence_parallel(jax_gpt2):
    """models/convert.py: the JAX config's fields by name, the dtypes as
    torch's, sequence_parallel kept, sp_mesh/sp_axis dropped for
    sp_group."""
    import torch
    jcfg = jax_gpt2[3]
    for sp in ("ring", "ulysses", None):
        cfg = config_from_jax(jgpt2.tiny_gpt2_config(
            n_layer=2, n_head=8, dropout=0.0, sequence_parallel=sp,
            dtype=jnp.bfloat16), sp_group="group")
        assert cfg.sequence_parallel == sp and cfg.sp_group == "group"
        assert cfg.dtype == torch.bfloat16
        assert cfg.param_dtype == torch.float32
        assert not hasattr(cfg, "sp_mesh") and not hasattr(cfg, "sp_axis")
        assert (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size) == \
            (jcfg.n_layer, jcfg.n_head, jcfg.n_embd, jcfg.vocab_size)
