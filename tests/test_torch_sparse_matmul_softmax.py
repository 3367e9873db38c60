"""PyTorch port: the standalone block-sparse MatMul / Softmax primitives
against the JAX package's (plain XLA there, plain torch here): the
sdd/dsd/dds x trans_a x trans_b sweep, to_sparse/to_dense, the softmax
with rpe, key-padding and attention masks in both modes, empty rows, and
the sdd -> softmax -> dsd attention composition with its gradient.
Inputs come from a numpy seed; both packages get the same arrays.

Tolerance, fp32: atol = rtol = 1e-5 (the same products summed in
another order; the softmax's exp and its segment sums likewise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from torch_one_thread import one_torch_thread  # noqa: F401

B, H, BLOCK = 2, 3, 16
R = C = 4   # block grid
M = R * BLOCK
K = 24
TOL = dict(atol=1e-5, rtol=1e-5)


def _layout(seed=0, density=0.5):
    rng = np.random.RandomState(seed)
    lay = (rng.rand(H, R, C) < density).astype(np.int64)
    lay[:, 0, 0] = 1   # no empty layout
    return lay


def _dense_mask(lay):
    return np.kron(lay, np.ones((BLOCK, BLOCK)))  # [H, M, M]


def _both(fn_j, fn_t, *arrays):
    """fn_j on jnp arrays and fn_t on torch tensors of the same arrays,
    both results as numpy."""
    want = fn_j(*(jnp.asarray(a) for a in arrays))
    got = fn_t(*(torch.from_numpy(np.array(a)) for a in arrays))
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("trans_b", [False, True])
def test_sdd_matches_jax(trans_a, trans_b):
    lay = _layout()
    rng = np.random.RandomState(1)
    a = rng.randn(B, H, *((K, M) if trans_a else (M, K))).astype(np.float32)
    b = rng.randn(B, H, *((M, K) if trans_b else (K, M))).astype(np.float32)
    got, want = _both(jsa.MatMul(lay, BLOCK, "sdd", trans_a, trans_b),
                      tsa.MatMul(lay, BLOCK, "sdd", trans_a, trans_b), a, b)
    np.testing.assert_allclose(got, want, **TOL)
    # and the dense view through to_dense agrees with the masked product
    ad = np.swapaxes(a, -1, -2) if trans_a else a
    bd = np.swapaxes(b, -1, -2) if trans_b else b
    ref = np.einsum("bhmk,bhkn->bhmn", ad, bd) * _dense_mask(lay)[None]
    np.testing.assert_allclose(
        tsa.to_dense(torch.from_numpy(got), lay, BLOCK).numpy(), ref,
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("trans_a", [False, True])
def test_dsd_matches_jax(trans_a, trans_b):
    lay = _layout(2)
    rng = np.random.RandomState(3)
    a_dense = (rng.randn(B, H, M, M) * _dense_mask(lay)[None]).astype(
        np.float32)
    a_sparse = np.asarray(jsa.to_sparse(jnp.asarray(a_dense), lay, BLOCK))
    np.testing.assert_array_equal(
        tsa.to_sparse(torch.from_numpy(a_dense), lay, BLOCK).numpy(),
        a_sparse)
    b = rng.randn(B, H, *((K, M) if trans_b else (M, K))).astype(np.float32)
    got, want = _both(jsa.MatMul(lay, BLOCK, "dsd", trans_a, trans_b),
                      tsa.MatMul(lay, BLOCK, "dsd", trans_a, trans_b),
                      a_sparse, b)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("trans_a", [False, True])
def test_dds_matches_jax(trans_a, trans_b):
    lay = _layout(4)
    rng = np.random.RandomState(5)
    b_dense = (rng.randn(B, H, M, M) * _dense_mask(lay)[None]).astype(
        np.float32)
    b_sparse = np.asarray(jsa.to_sparse(jnp.asarray(b_dense), lay, BLOCK))
    a = rng.randn(B, H, *((M, K) if trans_a else (K, M))).astype(np.float32)
    got, want = _both(jsa.MatMul(lay, BLOCK, "dds", trans_a, trans_b),
                      tsa.MatMul(lay, BLOCK, "dds", trans_a, trans_b),
                      a, b_sparse)
    np.testing.assert_allclose(got, want, **TOL)


def test_to_dense_round_trip_matches_jax():
    lay = _layout(12)
    sp = np.random.RandomState(13).randn(B, int(lay.sum()), BLOCK,
                                         BLOCK).astype(np.float32)
    for fill in (0.0, -1.0):
        got = tsa.to_dense(torch.from_numpy(sp), lay, BLOCK, fill=fill)
        want = jsa.to_dense(jnp.asarray(sp), lay, BLOCK, fill=fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            tsa.to_sparse(got, lay, BLOCK).numpy(), sp)
    with pytest.raises(ValueError):
        tsa.MatMul(lay[0], BLOCK, "sdd")
    with pytest.raises(NotImplementedError):
        tsa.MatMul(lay, BLOCK, "ddd")


@pytest.mark.parametrize("kpm_mode", ["add", "mul"])
@pytest.mark.parametrize("am_mode", ["add", "mul"])
def test_softmax_with_masks_matches_jax(kpm_mode, am_mode):
    lay = _layout(6)
    rng = np.random.RandomState(7)
    scores = rng.randn(B, H, M, M).astype(np.float32)
    sp = np.asarray(jsa.to_sparse(jnp.asarray(scores), lay, BLOCK))
    rpe = (rng.randn(*sp.shape) * 0.1).astype(np.float32)
    if kpm_mode == "add":
        kpm = np.where(rng.rand(B, M) < 0.2, -1e30, 0.0).astype(np.float32)
    else:
        kpm = (rng.rand(B, M) > 0.2).astype(np.float32)
    if am_mode == "add":
        am = np.where(rng.rand(M, M) < 0.1, -1e30, 0.0).astype(np.float32)
    else:
        am = (rng.rand(M, M) > 0.1).astype(np.float32)

    def run(pkg):
        return lambda x, r, k, a: pkg.Softmax(lay, BLOCK)(
            x, scale=0.5, rpe=r, key_padding_mask=k, attn_mask=a,
            key_padding_mask_mode=kpm_mode, attn_mask_mode=am_mode)

    got, want = _both(run(jsa), run(tsa), sp, rpe, kpm, am)
    np.testing.assert_allclose(got, want, **TOL)


def test_softmax_mul_mode_and_empty_rows_match_jax():
    lay = _layout(8)
    rng = np.random.RandomState(9)
    sp = np.asarray(jsa.to_sparse(
        jnp.asarray(rng.randn(B, H, M, M).astype(np.float32)), lay, BLOCK))
    kpm = np.zeros((B, M), np.float32)   # mul mode: 0 masks EVERYTHING

    def run(pkg):
        return lambda x, k: pkg.Softmax(lay, BLOCK)(
            x, key_padding_mask=k, key_padding_mask_mode="mul")

    got, want = _both(run(jsa), run(tsa), sp, kpm)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, 0.0, atol=1e-6)


def test_attention_composition_and_grad_match_jax():
    """sdd -> softmax -> dsd, and d(sum)/dq, in both packages."""
    lay = _layout(10, density=0.6)
    d = 32
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(B, H, M, d).astype(np.float32) for _ in range(3))

    def attn(pkg):
        sdd = pkg.MatMul(lay, BLOCK, "sdd", trans_b=True)
        sm = pkg.Softmax(lay, BLOCK)
        dsd = pkg.MatMul(lay, BLOCK, "dsd")
        return lambda q, k, v: dsd(sm(sdd(q, k), scale=d ** -0.5), v)

    got, want = _both(attn(jsa), attn(tsa), q, k, v)
    np.testing.assert_allclose(got, want, **TOL)
    gj = jax.grad(lambda q: attn(jsa)(q, jnp.asarray(k),
                                      jnp.asarray(v)).sum())(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    attn(tsa)(qt, torch.from_numpy(k), torch.from_numpy(v)).sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gj), **TOL)
