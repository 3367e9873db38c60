"""PyTorch port: flash attention merged with a prior softmax partial
(`flash_attention_merge`, kernel K5) against the JAX package.

On the CPU the port's `flash_attention_merge` runs its plain twins
(`_flash_merge_plain` forward; K2's twin `_flash_bwd_plain` with a given
delta in the backward); these tests hold it against deepspeed_tpu's
`flash_attention_merge(..., interpret=True)` (the Pallas kernel in merge
mode, in interpret mode) on the same numpy-seeded inputs. The prior
partial is `flash_attention_with_lse` over a disjoint key block, with
some rows marked as an empty partial (prev_lse -1e30, prev_out 0), as
the ring's carry holds before a rank's first fold. The CUDA kernel is
held against the twin on the card in tests/test_torch_cuda.py.

Tolerances: fp32 out and lse within 2e-5 (the twin walks 64-key tiles,
the JAX kernel one T-wide tile, so the online-softmax sums run in
another order); the VJP in all five inputs within 1e-4 relative L2 (the
same roundoff through the backward's products). bf16 inputs: out
(fp32) within 1e-2, about one bf16 ulp, as in
tests/test_torch_flash_attention.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
GRAD_TOL = 1e-4
EMPTY_ROWS = slice(0, 9)


def _rel_l2(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _inputs(seed, b=2, t=256, h=2, d=64):
    """q, k, v and the prior partial (out, lse) of q over a disjoint key
    block, its first rows an empty partial; numpy fp32."""
    r = np.random.RandomState(seed)
    q, k, v, k2, v2 = (r.randn(b, t, h, d).astype(np.float32)
                       for _ in range(5))
    prev, prev_lse = jfa.flash_attention_with_lse(
        q, k2, v2, causal=False, interpret=True)
    prev, prev_lse = np.array(prev), np.array(prev_lse)
    prev[:, EMPTY_ROWS] = 0.0
    prev_lse[:, :, EMPTY_ROWS] = tfa.NEG_INF
    return q, k, v, prev, prev_lse


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_merge_matches_jax_interpret(causal):
    q, k, v, prev, prev_lse = _inputs(int(causal))
    ref_out, ref_lse = jfa.flash_attention_merge(
        q, k, v, prev, prev_lse, causal=causal, interpret=True)
    out, lse = tfa.flash_attention_merge(
        *(torch.from_numpy(x) for x in (q, k, v, prev, prev_lse)),
        causal=causal)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert lse.shape == prev_lse.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **F32_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_merge_vjp_matches_jax_in_all_five_inputs(causal):
    q, k, v, prev, prev_lse = _inputs(10 + causal)
    r = np.random.RandomState(20 + causal)
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
        assert x.shape == y.shape, name
        assert _rel_l2(x.numpy(), y) <= GRAD_TOL, name


def test_merge_bf16_matches_jax_interpret():
    q, k, v, prev, prev_lse = _inputs(30)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref_out, ref_lse = jfa.flash_attention_merge(
        jq, jk, jv, prev, prev_lse, causal=True, interpret=True)
    out, lse = tfa.flash_attention_merge(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        torch.from_numpy(prev), torch.from_numpy(prev_lse), causal=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out, np.float32),
                               **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               **BF16_TOL)


def test_empty_partials_through_the_twin(monkeypatch):
    """An empty carry (prev_lse -1e30, prev_out 0, the ring's first step)
    leaves the block's own partial: K1's out and lse, and lse_n equal to
    the merged lse; such rows give prev_out and prev_lse no gradient. A
    row of the block that sees nothing (lse_n = +inf, K1's mark) merges
    as an empty partial: out = prev, lse = prev_lse."""
    q, k, v, prev, prev_lse = (torch.from_numpy(x) for x in _inputs(40))
    sm = 64 ** -0.5
    empty_out = torch.zeros_like(prev)
    empty_lse = torch.full(prev_lse.shape, tfa.NEG_INF)
    out, lse, lse_n = tfa._flash_merge_plain(q, k, v, empty_out,
                                             empty_lse[..., 0], sm, True)
    ref, ref_lse = tfa._flash_fwd_plain(q, k, v, sm, True)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)
    torch.testing.assert_close(lse_n, ref_lse, atol=0, rtol=0)

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, prev,
                                                      prev_lse)]
    out, lse = tfa.flash_attention_merge(*leaves, causal=True)
    assert torch.isfinite(lse).all()
    d_prev, d_lse = torch.autograd.grad(
        (out.sum() + lse.sum()), leaves[3:])
    assert not d_prev[:, EMPTY_ROWS].any()
    assert not d_lse[:, :, EMPTY_ROWS].any()

    # a row of the block that saw nothing: l = 0 in the epilogue
    b, t, h, d = q.shape
    m = torch.full((b, h, 64, 1), tfa.NEG_INF)
    l = torch.zeros((b, h, 64, 1))
    acc = torch.zeros((b, h, 64, d))
    tiles = [(slice(i * 64, (i + 1) * 64), m, l, acc) for i in range(t // 64)]
    monkeypatch.setattr(tfa, "_flash_tiles_plain",
                        lambda *a, **kw: iter(tiles))
    out, lse, lse_n = tfa._flash_merge_plain(q, k, v, prev,
                                             prev_lse[..., 0], sm, True)
    torch.testing.assert_close(out, prev, atol=0, rtol=0)
    torch.testing.assert_close(lse, prev_lse[..., 0], atol=0, rtol=0)
    assert torch.isposinf(lse_n).all()


@pytest.mark.parametrize("carry", ["empty", "real"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t", [192, 320])
def test_hopper_walk_merge_matches_jax_at_ragged_t(t, causal, carry):
    """K5 on the Hopper body's walk (128-row q tiles over 64-row K/V
    tiles, the last q tile past T at T = 192 and 320) against the Pallas
    kernel's merge mode in interpret mode, with an empty carry (the
    ring's first step: prev_lse -1e30 everywhere) and a real one: fp32
    through the twin with those tiles, bf16 through the public function,
    which takes them."""
    q, k, v, prev, prev_lse = _inputs(50 + t + causal, t=t)
    if carry == "empty":
        prev, prev_lse = np.zeros_like(prev), np.full_like(prev_lse,
                                                           tfa.NEG_INF)
    ref_out, ref_lse = jfa.flash_attention_merge(
        q, k, v, prev, prev_lse, causal=causal, interpret=True)
    out, lse, _ = tfa._flash_merge_plain(
        *(torch.from_numpy(x) for x in (q, k, v, prev)),
        torch.from_numpy(prev_lse)[..., 0], 64 ** -0.5, causal, 128, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **F32_TOL)

    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref_out, ref_lse = jfa.flash_attention_merge(
        jq, jk, jv, prev, prev_lse, causal=causal, interpret=True)
    out, lse = tfa.flash_attention_merge(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        torch.from_numpy(prev), torch.from_numpy(prev_lse), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out, np.float32),
                               **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               **BF16_TOL)
