"""PyTorch port: block-sparse attention's fp16 forms (kernels K7 in fp16)
against the JAX package.

The JAX package runs its four block-sparse kernels in whatever dtype it
is given; the port's fp16 forms are the Hopper kernels on `__half`
(bf16's plans: 128-row resident tiles over 64-row streamed ones). On the
CPU `block_sparse_attention` runs their twins at the same tile pairs,
which round P to dO's dtype and dS to q's before their products, as the
kernels do; these tests hold the twins' out and dQ/dK/dV in fp16 against
deepspeed_tpu's `block_sparse_attention(..., interpret=True)` (the
Pallas kernels in interpret mode) on the same numpy-seeded inputs, for a
band layout (K7-band) and a table layout (K7-fwd), with the backward
kernels K7-dkv and K7-dq. The CUDA kernels are held against the twins on
the card in tests/test_torch_cuda.py.

Tolerances, by relative L2 error ||port - jax|| / ||jax||: 1e-3 for the
output and each gradient. Both sides round p and dS to fp16 (2^-11
relative) before their products, each against its own running max and
sum order (64-row tiles in log2 space here, super-rows with natural exp
there), and round the results to fp16 once: observed below 2e-4. The
same inputs through the bf16 route land 3e-3 to 5e-3 from JAX's fp16
results, so a twin that rounded to bf16 would fail.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import sparse_attention as tsa
from torch_one_thread import one_torch_thread  # noqa: F401

jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")
tfa = importlib.import_module(
    "deepspeed_tpu_torch.ops.transformer.flash_attention")

REL_TOL = 1e-3
T, H, D, BLOCK = 512, 2, 64, 64


def _rel_l2(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _layout(kind, causal):
    if kind == "fixed":
        cfg = tsa.FixedSparsityConfig(
            num_heads=H, block=BLOCK, num_local_blocks=4,
            attention="unidirectional" if causal else "bidirectional")
    elif kind == "bslongformer":
        cfg = tsa.BSLongformerSparsityConfig(
            num_heads=H, block=BLOCK, num_sliding_window_blocks=3,
            attention="unidirectional")
    else:
        cfg = tsa.BigBirdSparsityConfig(num_heads=H, block=BLOCK,
                                        num_random_blocks=1)
    return cfg.make_layout(T)


@pytest.mark.parametrize("kind,causal,band", [
    ("fixed", True, True), ("bslongformer", True, True),
    ("bigbird", True, False), ("bigbird", False, False)],
    ids=["fixed-causal", "bslongformer-causal", "bigbird-causal",
         "bigbird-full"])
def test_fp16_twins_match_jax_kernels(kind, causal, band):
    """out, dq, dk, dv in fp16 through the public route (the band or the
    table forward, then the backward twin) against JAX in fp16."""
    layout = _layout(kind, causal)
    assert (tbsa._band_decompose(layout, causal) is not None) == band
    r = np.random.RandomState(len(kind) + causal)
    q, k, v, g = (r.randn(1, T, H, D).astype(np.float32) for _ in range(4))

    def jf(q, k, v):
        return jbsa.block_sparse_attention(q, k, v, layout, BLOCK,
                                           causal=causal, interpret=True)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    want = [jout, *vjp(jnp.asarray(g, jnp.float16))]
    tq, tk, tv = (torch.from_numpy(x).to(torch.float16).requires_grad_(True)
                  for x in (q, k, v))
    out = tsa.block_sparse_attention(tq, tk, tv, layout, BLOCK,
                                     causal=causal)
    got = [out, *torch.autograd.grad(out, (tq, tk, tv),
                                     torch.from_numpy(g).to(torch.float16))]
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        assert x.dtype == torch.float16, name
        assert _rel_l2(x.detach().float().numpy(),
                       np.asarray(y, np.float32)) <= REL_TOL, name


def test_fp16_takes_the_hopper_kernels_and_the_wmma_route_refuses_it():
    """fp16 plans at the Hopper kernels' tile pair, as bf16's; the WMMA
    kernels' argument check refuses fp16 naming ROADMAP Queue 2, the
    Hopper kernels' takes it."""
    assert tbsa._hopper_tiles(torch.float16, 64, tbsa.TILE) == \
        tfa._SM90_TILES
    assert tbsa._hopper_tiles(torch.float16, 128, tbsa.TILE) == \
        tfa._SM90_TILES
    q = torch.zeros((1, 256, 2, 64), dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        tbsa._check_kernel_args(q, 64, ("q", q))
    tbsa._check_kernel_args(q, 64, ("q", q), grid_y=False, hopper=True)
