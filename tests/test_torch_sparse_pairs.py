"""PyTorch port: the K7 backward's twin on the Hopper pair tables against
the JAX package's VJP (split out of tests/test_torch_sparse_attention.py
to spread the test clock over workers; tolerances as set out there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_sparse_cases import (GRAD_TOL, HOPPER_TILES, PAIR_ROUTES,
                                _jax_fwd_bwd, _qkv, jbsa, tbsa, tsa)
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name,make,t,block,causal", PAIR_ROUTES,
                         ids=[r[0] for r in PAIR_ROUTES])
def test_pair_table_backward_twin_matches_jax(name, make, t, block, causal,
                                              dtype):
    """The backward twin on the Hopper pair tables (the walk and rounding
    order of the Hopper K7-dkv and K7-dq) against the JAX package's VJP
    in interpret mode: fp32 by the twin itself, to GRAD_TOL; bf16 through
    the public route on the CPU, which takes the pair tables for the
    backward, to 1e-2 relative L2 (the bf16 gradient tolerance of the
    flash backward's tests: one rounding of each output and of P and dS),
    and bit for bit the twin at the pair."""
    layout = make(block).make_layout(t)
    q, k, v, g = _qkv(1, t, 2, 64, seed=t + block + causal)
    cpu = torch.device("cpu")
    pair = tbsa._plan(layout, causal, block, HOPPER_TILES, cpu)
    if dtype == "fp32":
        want = _jax_fwd_bwd(q, k, v, g, layout, block, causal)
        xs = [torch.from_numpy(x) for x in (q, k, v)]
        out, lse = tbsa._bs_fwd_plain(*xs, tbsa._plan(layout, causal, block,
                                                      tbsa.TILE, cpu), 0.125)
        got = tbsa._bs_bwd_plain(*xs, out, lse, torch.from_numpy(g), pair,
                                 0.125)
        for a, b in zip(got, want[1:]):
            np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)
        return

    def jax_bf16(q, k, v):
        return jbsa.block_sparse_attention(q, k, v, layout, block,
                                           causal=causal, interpret=True)
    _, vjp = jax.vjp(jax_bf16, *(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)))
    want = [np.asarray(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(g, jnp.bfloat16))]
    xs = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
          for x in (q, k, v)]
    gt = torch.from_numpy(g).to(torch.bfloat16)
    out = tsa.block_sparse_attention(*xs, layout, block, causal=causal)
    got = torch.autograd.grad(out, xs, gt)
    for a, b in zip(got, want):
        a = a.float().numpy()
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-2
    plain = tbsa._band_fwd_plain if pair.band is not None else \
        tbsa._bs_fwd_plain
    d = [x.detach() for x in xs]
    o, lse = plain(*d, pair, 0.125)
    assert torch.equal(o, out.detach())
    twin = tbsa._bs_bwd_plain(*d, o, lse, gt, pair, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, twin))
