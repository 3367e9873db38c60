"""PyTorch port: flash attention forward (kernel K1-fwd) against the JAX
package.

On the CPU the port's `flash_attention_with_lse` runs its plain twin
(the kernel's tiled online softmax in PyTorch); these tests hold it
against deepspeed_tpu's `flash_attention_with_lse(..., interpret=True)`
(the Pallas kernel in interpret mode) on the same numpy-seeded inputs,
comparing out and the log2-space lse. The CUDA kernel is held against
the twin on the card in tests/test_torch_cuda.py.

Tolerances: fp32 out and lse agree to roundoff (the twin walks 64-key
tiles, the JAX kernel one T-wide tile, so the online-softmax sums run
in another order): atol = rtol = 1e-5. bf16 out is one rounding of that
fp32 result (plus p rounded to bf16 before P·V in both): atol = rtol =
1e-2, about one bf16 ulp.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401

# the JAX package's ops.transformer re-exports a function under the
# module's name, so the module is fetched by its full path
jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _qkv(b, t, h, d, seed):
    r = np.random.RandomState(seed)
    return [r.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "full"])
@pytest.mark.parametrize("t", [128, 256])
def test_flash_with_lse_matches_jax_interpret(t, causal):
    q, k, v = _qkv(2, t, 4, 64, seed=t + causal)
    ref_out, ref_lse = jfa.flash_attention_with_lse(
        q, k, v, causal=causal, interpret=True)
    out, lse = tfa.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert out.shape == (2, t, 4, 64) and lse.shape == (2, 4, t, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **F32_TOL)


def test_flash_bf16_matches_jax_interpret():
    q, k, v = _qkv(2, 128, 4, 64, seed=7)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref_out, ref_lse = jfa.flash_attention_with_lse(jq, jk, jv, causal=True,
                                                    interpret=True)
    out, lse = tfa.flash_attention_with_lse(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref_out.astype(jnp.float32)),
                               **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **F32_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_dense_attention_matches_jax(causal):
    q, k, v = _qkv(2, 40, 4, 16, seed=3)
    ref = jfa.dense_attention(q, k, v, causal=causal)
    got = tfa.dense_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_flash_matches_dense_attention():
    """The twin's tiled online softmax is the dense softmax."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 192, 2, 64, seed=5))
    torch.testing.assert_close(tfa.flash_attention(q, k, v, causal=True),
                               tfa.dense_attention(q, k, v, causal=True),
                               **F32_TOL)


def test_routing_gate_and_block_fit_match_jax():
    for t in (64, 100, 128, 136, 256, 384, 1024, 1536, 2048, 3072):
        assert tfa._fit_block(1024, t) == jfa._fit_block(1024, t)
        for d in (32, 64, 96, 128, 192, 256, 320):
            tq = torch.zeros((1, t, 2, d))
            jq = np.zeros((1, t, 2, d), np.float32)
            for no_drop in (True, False):
                assert tfa.flash_attention_usable(tq, no_drop) == \
                    jfa.flash_attention_usable(jq, no_drop), (t, d)


def test_every_routed_head_dim_up_to_256_has_a_kernel():
    """The gate admits any head dim that is a multiple of 64; the CUDA
    kernels take each of them up to 256 (a GPT-2 with head dim 192 or
    256 runs flash on the card as JAX does), and their twins compute the
    same function at those widths."""
    routed = [d for d in range(64, 257, 32)
              if tfa.flash_attention_usable(torch.zeros((1, 128, 2, d)),
                                            True)]
    assert routed == [64, 128, 192, 256]
    assert set(routed) <= set(tfa._KERNEL_HEAD_DIMS)
    for d in (192, 256):
        q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 2, d, seed=d))
        torch.testing.assert_close(
            tfa.flash_attention(q, k, v, causal=True),
            tfa.dense_attention(q, k, v, causal=True), **F32_TOL)


def test_head_packing_validation_and_routing():
    """Every head_packing value computes the same function (one kernel,
    one twin); "packed" with d != 64 raises as in the JAX package."""
    for mode in ("auto", "packed", "off", None, True, False):
        assert tfa._resolve_head_packing(mode, 64) == \
            jfa._resolve_head_packing(mode, 64, interpret=False)
    for mode in ("packed", True):
        with pytest.raises(ValueError):
            tfa._resolve_head_packing(mode, 128)
        with pytest.raises(ValueError):
            jfa._resolve_head_packing(mode, 128, interpret=False)
    with pytest.raises(ValueError):
        tfa._resolve_head_packing("twice", 64)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 2, 64, seed=9))
    outs = [tfa.flash_attention(q, k, v, head_packing=m)
            for m in ("auto", "packed", "off")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_cpu_tensors_count_no_launch():
    tfa.reset_launch_count()
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 2, 64, seed=11))
    tfa.flash_attention(q, k, v)
    assert tfa.flash_attention_with_lse.launches == 0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t", [192, 320])
def test_hopper_walk_matches_jax_interpret_at_ragged_t(t, causal, d):
    """The Hopper body's walk (128-row q tiles over 64-row K/V tiles;
    at T = 192 and 320 the last q tile runs past T) against the Pallas
    kernel in interpret mode: fp32 through the twin with those tiles,
    to roundoff; bf16 through the public function, which takes them at
    head dims 64 and 128."""
    assert tfa._kernel_tiles(torch.bfloat16, d) == (128, 64)
    q, k, v = _qkv(2, t, 2, d, seed=t + d + causal)
    ref_out, ref_lse = jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                                    interpret=True)
    out, lse = tfa._flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                    d ** -0.5, causal, 128, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **F32_TOL)

    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref_out, ref_lse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal,
                                                    interpret=True)
    out, lse = tfa.flash_attention_with_lse(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=causal)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref_out.astype(jnp.float32)),
                               **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **F32_TOL)


def test_kernel_shape_check_takes_more_than_65535_heads_on_the_hopper_body():
    """B*H = 65550: the Hopper bodies (bf16, head dims 64 and 128) fold
    B*H into a 1-D grid and take it; the WMMA bodies (fp32, head dims
    192 and 256) carry it on grid.y and raise. Meta tensors: the check
    reads shapes and dtypes only."""
    for d in (64, 128):
        tfa._check_kernel_shape(torch.empty((32775, 64, 2, d),
                                            dtype=torch.bfloat16,
                                            device="meta"))
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 256)):
        q = torch.empty((32775, 64, 2, d), dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="65535"):
            tfa._check_kernel_shape(q)
    tfa._check_kernel_shape(torch.empty((65535, 64, 1, 64),
                                        dtype=torch.float32, device="meta"))
