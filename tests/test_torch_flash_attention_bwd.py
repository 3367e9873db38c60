"""PyTorch port: flash attention backward (kernel K2) against the JAX
package.

On the CPU the port's autograd Function runs the backward's plain twin
(`_flash_bwd_plain`, the kernel's 64x64 tiled algorithm); these tests
hold its dq, dk, dv against `jax.grad` of deepspeed_tpu's
`flash_attention_with_lse(..., interpret=True)` (the Pallas backward in
interpret mode) on the same numpy-seeded inputs. The loss is
sum(out * g) + sum(lse * g_lse), so the lse cotangent (the delta shift)
is exercised too. Two JAX paths: the single-tile fused backward
(T = 256 with the default blocks) and the two-sweep dK/dV + dQ kernels
(block_q = block_k = 128). The CUDA kernel is held against the twin on
the card in tests/test_torch_cuda.py.

Tolerances, by relative L2 error ||port - jax|| / ||jax||: fp32 to
roundoff, the sums run in another order (observed ~4e-7): 1e-5. bf16:
both round P and dS to bf16 before their products and each gradient
once at the end, so an fp32 sum that lands on the other side of a
rounding point moves an element by one bf16 ulp (observed ~1.5e-3):
1e-2.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa

# the JAX package's ops.transformer re-exports a function under the
# module's name, so the module is fetched by its full path
jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

REL_TOL = {"fp32": 1e-5, "bf16": 1e-2}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel_l2(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _inputs(b, t, h, d, seed):
    r = np.random.RandomState(seed)
    q, k, v, g = (r.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    g_lse = r.randn(b, h, t, 1).astype(np.float32)
    return q, k, v, g, g_lse


def _port_grads(q, k, v, g, g_lse, dt, causal):
    tdt = DTYPES[dt][1]
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    loss = (out.float() * torch.from_numpy(g)).sum()
    if g_lse is not None:
        loss = loss + (lse * torch.from_numpy(g_lse)).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))
    assert all(x.dtype == tdt for x in grads)
    return [x.float().numpy() for x in grads]


def _jax_grads(q, k, v, g, g_lse, dt, causal, block):
    jdt = DTYPES[dt][0]

    def f(q, k, v):
        out, lse = jfa.flash_attention_with_lse(
            q, k, v, causal=causal, block_q=block, block_k=block,
            interpret=True)
        loss = jnp.sum(out.astype(jnp.float32) * g)
        if g_lse is not None:
            loss = loss + jnp.sum(lse * g_lse)
        return loss

    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


@pytest.mark.parametrize("causal,dt,d,block", [
    (True, "fp32", 64, None), (True, "bf16", 64, 128),
    (True, "fp32", 128, None), (True, "bf16", 128, 128),
    (False, "fp32", 128, 128), (False, "bf16", 64, None)],
    ids=["causal-fp32-d64-single", "causal-bf16-d64-sweeps",
         "causal-fp32-d128-single", "causal-bf16-d128-sweeps",
         "full-fp32-d128-sweeps", "full-bf16-d64-single"])
def test_flash_grads_match_jax(causal, dt, d, block):
    """dq, dk, dv through both outputs (out and the log2-space lse)."""
    q, k, v, g, g_lse = _inputs(1, 256, 2, d, seed=d + int(causal))
    got = _port_grads(q, k, v, g, g_lse, dt, causal)
    ref = _jax_grads(q, k, v, g, g_lse, dt, causal, block)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_l2(a, b) <= REL_TOL[dt], name


def test_flash_attention_grads_without_lse_match_jax():
    """`flash_attention` (out only): the lse path carries no cotangent."""
    q, k, v, g, _ = _inputs(2, 128, 2, 64, seed=5)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                              (tq, tk, tv))
    ref = _jax_grads(q, k, v, g, None, "fp32", True, None)
    for a, b in zip(got, ref):
        assert _rel_l2(a.numpy(), b) <= REL_TOL["fp32"]


def test_backward_wrapper_equals_autograd_and_counts_no_launch():
    """The public K2 wrapper on CPU tensors is the twin: the autograd
    Function's backward calls it, and no kernel launch is counted."""
    tfa.reset_launch_count()
    q, k, v, g, g_lse = (torch.from_numpy(x)
                         for x in _inputs(1, 128, 2, 64, seed=7))
    out, lse = tfa._flash_fwd_plain(q, k, v, 0.125, True)
    dlse = g_lse[..., 0]
    got = tfa.flash_attention_backward(q, k, v, out, lse, g, dlse,
                                       causal=True)
    ref = tfa._flash_bwd_plain(q, k, v, out, lse, g, dlse, 0.125, True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    tq, tk, tv = (x.clone().requires_grad_(True) for x in (q, k, v))
    o, lse4 = tfa.flash_attention_with_lse(tq, tk, tv, causal=True)
    auto = torch.autograd.grad((o * g).sum() + (lse4 * g_lse).sum(),
                               (tq, tk, tv))
    assert all(torch.equal(a, b) for a, b in zip(auto, ref))
    assert tfa.flash_attention_backward.launches == 0
    assert tfa.flash_attention_with_lse.launches == 0
