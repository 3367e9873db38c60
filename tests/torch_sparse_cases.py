"""The block-sparse attention test cases shared by
tests/test_torch_sparse_*.py: the numpy-seeded inputs, the JAX
package's forward and VJP (Pallas kernels in interpret mode), the
port's route, the band, route and pair-table case tables, and the
band twin's check. The tolerances are set out in
tests/test_torch_sparse_attention.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa

# the packages export functions under the module names
jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")
tfa = importlib.import_module(
    "deepspeed_tpu_torch.ops.transformer.flash_attention")

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_OUT_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
# the band forward's tile pair on the Hopper body: 128-row q tiles over
# 64-row k tiles
HOPPER_TILES = tfa._SM90_TILES



# the band layouts of the Hopper walk's cases, by (block, kind, causal):
# sliding = BSLongformer (unidirectional with its global column when
# causal, bidirectional without globals when not), aligned = Fixed with
# 4-block windows and their global columns; T takes 5-8 layout blocks and
# is no multiple of 128 at blocks 16-64 (the last q tile runs past T),
# where a 128-row q tile also straddles layout blocks
BAND_T = {16: 320, 32: 320, 64: 448, 128: 768, 256: 1536}


def _band_layout(block, kind, causal, h=2):
    t = BAND_T[block]
    if kind == "sliding":
        cfg = tsa.BSLongformerSparsityConfig(
            num_heads=h, block=block, num_sliding_window_blocks=3,
            **({"attention": "unidirectional"} if causal else
               {"global_block_indices": []}))
    else:
        cfg = tsa.FixedSparsityConfig(
            num_heads=h, block=block, num_local_blocks=4,
            attention="unidirectional" if causal else "bidirectional")
    layout = cfg.make_layout(t)
    assert tbsa._band_decompose(layout, causal)[0] == kind
    return layout, t


def _qkv(b, t, h, d, seed):
    r = np.random.RandomState(seed)
    return [r.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


def _jax_fwd_bwd(q, k, v, g, layout, block, causal):
    def f(q, k, v):
        return jbsa.block_sparse_attention(q, k, v, layout, block,
                                           causal=causal, interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


def _torch_fwd_bwd(q, k, v, g, layout, block, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = tsa.block_sparse_attention(qt, kt, vt, layout, block,
                                     causal=causal)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    return [x.detach().numpy() for x in (out, *grads)]


ROUTES = [
    # (id, config, T, H, block, causal, expected band kind or None)
    ("sliding-b32", lambda h, b: jsa.BSLongformerSparsityConfig(
        num_heads=h, block=b, num_sliding_window_blocks=3), 256, 2, 32,
     True, "sliding"),
    ("sliding-b64", lambda h, b: jsa.BSLongformerSparsityConfig(
        num_heads=h, block=b, num_sliding_window_blocks=4), 512, 2, 64,
     True, "sliding"),
    ("aligned-b32-full", lambda h, b: jsa.FixedSparsityConfig(
        num_heads=h, block=b, num_local_blocks=2), 256, 2, 32, False,
     "aligned"),
    ("aligned-b64-causal", lambda h, b: jsa.FixedSparsityConfig(
        num_heads=h, block=b, num_local_blocks=4), 512, 2, 64, True,
     "aligned"),
    ("table-bigbird-causal", lambda h, b: jsa.BigBirdSparsityConfig(
        num_heads=h, block=b), 256, 2, 32, True, None),
    ("table-bigbird-full-b64", lambda h, b: jsa.BigBirdSparsityConfig(
        num_heads=h, block=b), 512, 2, 64, False, None),
    ("table-per-head", lambda h, b: jsa.VariableSparsityConfig(
        num_heads=h, block=b, num_random_blocks=1,
        local_window_blocks=[2], different_layout_per_head=True), 256, 2,
     32, False, None),
    ("lse2d-eight-heads", lambda h, b: jsa.FixedSparsityConfig(
        num_heads=h, block=b, num_local_blocks=2, num_global_blocks=1),
     256, 8, 32, True, "sliding"),
    # blocks under 16 take no kernel: the twins walk tiles of one block
    ("sliding-b8-twin-only", lambda h, b: jsa.BSLongformerSparsityConfig(
        num_heads=h, block=b, num_sliding_window_blocks=3), 128, 2, 8,
     True, "sliding"),
    ("table-b8-twin-only", lambda h, b: jsa.BigBirdSparsityConfig(
        num_heads=h, block=b), 128, 2, 8, False, None),
]


# the pair tables' twin against the JAX VJP: (id, config, T, block,
# causal) at H 2, D 64; T 448 where the last 128-row tile's lower half
# lies past T
PAIR_ROUTES = [
    ("sliding-b32-causal", lambda b: jsa.BSLongformerSparsityConfig(
        num_heads=2, block=b, num_sliding_window_blocks=3), 448, 32, True),
    ("aligned-b64-full", lambda b: jsa.FixedSparsityConfig(
        num_heads=2, block=b, num_local_blocks=2), 448, 64, False),
    ("bigbird-b16-causal", lambda b: jsa.BigBirdSparsityConfig(
        num_heads=2, block=b), 448, 16, True),
    ("per-head-b32-full", lambda b: jsa.VariableSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1, local_window_blocks=[2],
        global_block_indices=[0], different_layout_per_head=True), 448, 32,
     False),
    ("bigbird-b128-full", lambda b: jsa.BigBirdSparsityConfig(
        num_heads=2, block=b), 512, 128, False),
    ("sliding-b256-causal", lambda b: jsa.BSLongformerSparsityConfig(
        num_heads=2, block=b, num_sliding_window_blocks=3), 768, 256, True),
]


# the table forward's pair-table twin against the JAX forward: (id,
# config, block, causal) at H 2 and T 320 (the last 128-row q tile's
# lower half lies past T), layouts `_band_decompose` rejects
PAIR_FWD_ROUTES = [
    ("bigbird-b64-full", lambda b: jsa.BigBirdSparsityConfig(
        num_heads=2, block=b), 64, False),
    ("bigbird-b32-causal", lambda b: jsa.BigBirdSparsityConfig(
        num_heads=2, block=b), 32, True),
    ("per-head-b32-full", lambda b: jsa.VariableSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1, local_window_blocks=[2],
        global_block_indices=[0], different_layout_per_head=True), 32,
     False),
    ("per-head-b64-causal", lambda b: jsa.VariableSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1, local_window_blocks=[1, 2],
        global_block_indices=[0], different_layout_per_head=True), 64, True),
]
PAIR_FWD_T = 320



def band_twin_case(block, kind, causal, dtype):
    """The band twin at the Hopper body's 128 x 64 tile pair (the walk
    and rounding order of K7-band on the card) against the JAX package's
    band kernel in interpret mode, forward, at D 64. In bf16 the public
    route on the CPU takes that pair too and gives the same bits."""
    layout, t = _band_layout(block, kind, causal)
    q, k, v, _ = _qkv(1, t, 2, 64, seed=block + causal)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jbsa.block_sparse_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), layout, block,
        causal=causal, interpret=True)
    xs = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    plan = tbsa._plan(layout, causal, block, HOPPER_TILES,
                      torch.device("cpu"))
    got, _ = tbsa._band_fwd_plain(*xs, plan, 64 ** -0.5)
    tol = BF16_OUT_TOL if dtype == torch.bfloat16 else OUT_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    if dtype == torch.bfloat16:
        assert torch.equal(tsa.block_sparse_attention(*xs, layout, block,
                                                      causal=causal), got)


