"""PyTorch port: the overlap runtime (deepspeed_tpu_torch/ops/overlap.py)
against the JAX package's ops/overlap.py, and its two ported sites.

- Schedule resolution: enabled off, a pinned site list, and "auto" (with
  the JAX package's autotune table empty, which is what the port's
  "auto" reads until ops/autotune.py is ported) give the same schedule
  in both packages for every site; bad sites and issue distances raise
  ValueError with the JAX package's words.
- In-flight bytes: the same records give the same sum of per-site maxima.
- tie / fence / async_collective return their values.
- The ring site: a gloo group of 4 CPU processes (tests/torch_sp_workers.
  py) runs the fallback ring body at issue distances 1, 2 and 3 and with
  overlap off. Distance 2 and overlap off equal distance 1 bit for bit,
  outputs and gradients (the same hops, posted earlier or later); at
  distance 3 blocks 1 and 2 come straight from their owners, so the
  outputs are equal bit for bit and the gradients sum in another order
  (within 1e-6 relative L2). Distance 1 holds to the JAX ring on a
  4-device mesh within tests/test_torch_sequence_parallel.py's ring
  tolerances (2e-5 on outputs, 1e-4 relative L2 on gradients). The
  window each rank records is the distance times the K/V bytes.
- The MoE site: granularity 2 splits the einsum dispatch along the
  capacity axis; the layer's output and gradients equal granularity 1's
  bit for bit, as JAX's dispatch_tokens does at granularity 2.
- The engine wires the `overlap` block into the runtime.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import Mesh

import torch_sp_workers as W
from deepspeed_tpu.ops import autotune as jautotune
from deepspeed_tpu.ops import overlap as joverlap
from deepspeed_tpu.ops.sequence import ring_attention as jring_attention
from deepspeed_tpu_torch.moe import dispatch as tdispatch
from deepspeed_tpu_torch.moe.layer import MoEConfig, MoEMLP
from deepspeed_tpu_torch.ops import overlap
from torch_one_thread import one_torch_thread  # noqa: F401

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = 1e-4
REORDER_TOL = 1e-6
P = 4


@pytest.fixture(autouse=True)
def clean(tmp_path):
    overlap.reset()
    joverlap.reset()
    jautotune.reset()
    jautotune.configure(table_path=str(tmp_path / "table.json"))
    yield
    overlap.reset()
    joverlap.reset()
    jautotune.reset()


CONFIGS = [dict(), dict(enabled=False), dict(sites=["ring"]),
           dict(sites="moe_dispatch,zero3_leaf", issue_distance=3),
           dict(sites="auto", issue_distance=2), dict(sites=[])]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["default", "off", "ring_only",
                                               "two_sites", "auto_d2",
                                               "none"])
def test_schedule_resolves_like_jax(cfg):
    overlap.configure(**cfg)
    joverlap.configure(**cfg)
    assert overlap.enabled() == joverlap.enabled()
    for site in overlap.SITES:
        assert overlap.schedule(site, payload_bytes=1 << 20) == \
            joverlap.schedule(site, payload_bytes=1 << 20), site


@pytest.mark.parametrize("call", [
    lambda m: m.configure(sites=["ring", "nowhere"]),
    lambda m: m.configure(sites="ring,bogus"),
    lambda m: m.configure(issue_distance=0),
    lambda m: m.schedule("nowhere"),
], ids=["site_list", "site_string", "distance", "schedule"])
def test_validation_errors_are_worded_as_jax(call):
    with pytest.raises(ValueError) as mine:
        call(overlap)
    with pytest.raises(ValueError) as ref:
        call(joverlap)
    assert str(mine.value) == str(ref.value)


def test_inflight_bytes_is_the_sum_of_site_maxima():
    records = [("ring", "seq", 100), ("ring", "seq2", 300),
               ("moe_dispatch", "a", 50), ("moe_dispatch", "b", 70),
               ("ring", "seq", 200)]
    for site, key, n in records:
        overlap.record_inflight(site, key, n)
        joverlap.record_inflight(site, key, n)
    assert overlap.inflight_bytes() == joverlap.inflight_bytes() == 370
    overlap.reset_inflight()
    assert overlap.inflight_bytes() == 0


def test_primitives_return_their_values():
    a, b = torch.ones(3), torch.zeros(2)
    assert overlap.tie(a) is a
    assert overlap.tie(a, b) == (a, b)
    assert overlap.fence(a, b, None) is a
    assert overlap.overlap_fence is overlap.fence
    assert overlap.async_collective(a, b) == (a, b)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("overlap"))
    try:
        tmp.start_processes(W.worker_overlap, args=(P, out_dir), nprocs=P,
                            join=True, start_method="spawn")
    except Exception:
        errs = [open(os.path.join(out_dir, f)).read()
                for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
        pytest.fail("overlap workers failed:\n" + "\n".join(errs))
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(P)]


def _cat(results, key):
    return np.concatenate([res[key] for res in results], axis=1)


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("case", W.OVERLAP_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("label", ["d2", "off", "d3"])
def test_ring_issue_distance_matches_distance_1(ranks, case, label):
    name = case[0]
    for part in ("out", "dq", "dk", "dv"):
        got = _cat(ranks, f"{name}/{label}/{part}")
        ref = _cat(ranks, f"{name}/d1/{part}")
        if label == "d3" and part in ("dk", "dv"):
            assert _rel_l2(got, ref) <= REORDER_TOL, part
        else:
            assert np.array_equal(got, ref), part


@pytest.mark.parametrize("case", W.OVERLAP_CASES, ids=lambda c: c[0])
def test_ring_at_distance_1_matches_jax_and_records_its_window(ranks, case):
    name, tl, h, d, causal = case
    q, k, v = (jnp.asarray(x) for x in
               W.global_qkv(tl * P, h, d, W.case_seed(name)))
    mesh = Mesh(np.asarray(jax.devices()[:P]), ("seq",))

    @jax.jit
    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(lambda q, k, v: jring_attention(
            q, k, v, mesh, axis_name="seq", causal=causal,
            use_flash=False), q, k, v)
        return out, vjp(2.0 * out)

    out, grads = out_and_grads(q, k, v)
    np.testing.assert_allclose(_cat(ranks, f"{name}/d1/out"),
                               np.asarray(out), **OUT_TOL)
    for n, g in zip("qkv", grads):
        assert _rel_l2(_cat(ranks, f"{name}/d1/d{n}"),
                       np.asarray(g)) <= GRAD_TOL, n
    kv_bytes = 2 * tl * h * d * 4
    for label, want in (("d1", 1), ("d2", 2), ("d3", 3), ("off", 0)):
        for res in ranks:
            assert int(res[f"{name}/{label}/inflight"]) == want * kv_bytes


def test_dispatch_granularity_is_bit_exact_as_in_jax():
    from deepspeed_tpu.moe.dispatch import dispatch_tokens as jdispatch
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 16)).astype(np.float32)
    mask = (rng.random((37, 4, 11)) < 0.1).astype(np.float32)
    one = tdispatch.dispatch_tokens(torch.from_numpy(x),
                                    torch.from_numpy(mask))
    for g in (2, 3, 11, 12):
        got = tdispatch.dispatch_tokens(torch.from_numpy(x),
                                        torch.from_numpy(mask),
                                        granularity=g)
        assert torch.equal(got, one), g
        ref = np.asarray(jdispatch(jnp.asarray(x), jnp.asarray(mask),
                                   granularity=g))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_moe_site_at_granularity_2_is_bit_exact(monkeypatch):
    torch.manual_seed(0)
    moe = MoEConfig(num_experts=4, top_k=2, capacity_factor=1.25,
                    fused_dispatch="off")
    layer = MoEMLP(moe, 16, 32, torch.float32, torch.float32)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = torch.randn(2, 24, 16)

    def run():
        xi = x.clone().requires_grad_(True)
        y, stats = layer(xi)
        grads = torch.autograd.grad((y ** 2).sum() + stats.sum(),
                                    [xi] + list(layer.parameters()))
        return y.detach(), stats.detach(), grads

    base = run()
    real = overlap.schedule
    monkeypatch.setattr(overlap, "schedule", lambda site, **kw: dict(
        real(site, **kw), granularity=2))
    split = run()
    assert torch.equal(base[0], split[0]) and torch.equal(base[1], split[1])
    assert all(torch.equal(a, b) for a, b in zip(base[2], split[2]))
    # the site's window: the [E, C, H] send and expert-output tensors
    from deepspeed_tpu_torch.moe.router import router_capacity
    cap = router_capacity(48, 4, 2, 1.25)
    assert overlap.inflight_bytes() == 2 * 4 * cap * 16 * 4


def test_engine_configures_the_runtime():
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(n_positions=32),
                                  device="cpu")
    dst.initialize(model=model, model_parameters=model.init(0), config={
        "train_batch_size": 2,
        "overlap": {"sites": ["moe_dispatch"], "issue_distance": 3}})
    assert overlap.schedule("ring") == {"overlap": False,
                                        "issue_distance": 3,
                                        "granularity": 1}
    assert overlap.schedule("moe_dispatch")["overlap"]
