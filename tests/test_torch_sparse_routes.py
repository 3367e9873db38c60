"""PyTorch port: the block-sparse twins' forward and gradients on each
route, and the table forward's pair-table twin, against the JAX package
(split out of tests/test_torch_sparse_attention.py to spread the test
clock over workers; tolerances as set out there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_sparse_cases import (BF16_OUT_TOL, GRAD_TOL, HOPPER_TILES,
                                OUT_TOL, PAIR_FWD_ROUTES, PAIR_FWD_T, ROUTES,
                                _jax_fwd_bwd, _qkv, _torch_fwd_bwd, jbsa,
                                tbsa, tsa)
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name,make,t,h,block,causal,kind", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_twin_forward_and_grads_match_jax(name, make, t, h, block, causal,
                                          kind):
    layout = make(h, block).make_layout(t)
    band = tbsa._band_decompose(layout, causal)
    assert (band[0] if band else None) == kind
    q, k, v, g = _qkv(1, t, h, 32, seed=t + h + block + causal)
    want = _jax_fwd_bwd(q, k, v, g, layout, block, causal)
    got = _torch_fwd_bwd(q, k, v, g, layout, block, causal)
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **GRAD_TOL)




@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name,make,block,causal", PAIR_FWD_ROUTES,
                         ids=[r[0] for r in PAIR_FWD_ROUTES])
def test_pair_table_forward_twin_matches_jax(name, make, block, causal, d):
    """K7-fwd's twin on the forward pair table (the Hopper table
    forward's walk: 128-row q tiles over 64-row k tiles, one sub-block
    mask per half) against the JAX package's forward in interpret mode:
    fp32 by the twin itself, to OUT_TOL; bf16 through the public route on
    the CPU, which takes the pair table for these layouts, to
    BF16_OUT_TOL, and bit for bit the twin at the pair. Rows past T see
    nothing; every real row's lse is finite."""
    t = PAIR_FWD_T
    layout = make(block).make_layout(t)
    cpu = torch.device("cpu")
    pair = tbsa._plan(layout, causal, block, HOPPER_TILES, cpu)
    assert pair.band is None
    q, k, v, _ = _qkv(1, t, 2, d, seed=block + d + causal)

    def jax_fwd(dtype):
        return np.asarray(jbsa.block_sparse_attention(
            *(jnp.asarray(x, dtype) for x in (q, k, v)), layout, block,
            causal=causal, sm_scale=d ** -0.5, interpret=True)
            .astype(jnp.float32))

    out, lse = tbsa._bs_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                  pair, d ** -0.5)
    np.testing.assert_allclose(out.numpy(), jax_fwd(jnp.float32), **OUT_TOL)
    assert bool(torch.isfinite(lse).all())
    xs = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = tsa.block_sparse_attention(*xs, layout, block, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), jax_fwd(jnp.bfloat16),
                               **BF16_OUT_TOL)
    assert torch.equal(got, tbsa._bs_fwd_plain(*xs, pair, d ** -0.5)[0])
