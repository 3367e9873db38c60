"""PyTorch port: block-sparse attention (kernels K7) against the JAX
package.

On the CPU the port's `block_sparse_attention` runs its plain twins (the
K7 kernels' tile walks in PyTorch); these tests hold them against
deepspeed_tpu's `block_sparse_attention` (the Pallas kernels in
interpret mode, as the JAX package's own tests run them) on the same
numpy-seeded inputs, forward and dQ/dK/dV, for the sliding-band, the
aligned-window and the table routes, causal and bidirectional. They also
hold the host code (layouts, tables, band decomposition), the
SparseSelfAttention / BertSparseSelfAttention modules, the utils, the
`sparse_attention` config block and `dense_attention(mask=...)` against
their JAX counterparts. The CUDA kernels are held against the twins on
the card in tests/test_torch_cuda.py.

Tolerances, fp32: outputs atol = rtol = 2e-5 and gradients 1e-4: the
twin walks 64-row tiles in log2 space, the JAX kernel super-rows of up
to 4 layout blocks with natural exp, so the online-softmax sums and the
gradient sums run in another order (the JAX package's own kernel tests
hold the kernel to its dense fallback at 2e-5 and 5e-4). bf16 outputs
(the band twin at the Hopper body's 128 x 64 tile pair against the JAX
kernel in bf16): atol = rtol = 2^-6, two bf16 ulps at |x| in [1, 2):
both round p to bf16 before P.V, each against its own running max (so
at different points), and round the output to bf16 once. Layouts,
tables, walks and config blocks are compared exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa

# the packages export functions under the module names
jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")
jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")
tfa = importlib.import_module(
    "deepspeed_tpu_torch.ops.transformer.flash_attention")

from torch_sparse_cases import GRAD_TOL, HOPPER_TILES, OUT_TOL, _qkv
from torch_one_thread import one_torch_thread  # noqa: F401


def _configs(pkg, h, block):
    """The same configurations built from either package."""
    return [
        pkg.DenseSparsityConfig(num_heads=h, block=block),
        pkg.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=2),
        pkg.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=4,
                                attention="unidirectional"),
        pkg.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=4,
                                horizontal_global_attention=True),
        pkg.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=4,
                                different_layout_per_head=True,
                                num_different_global_patterns=2),
        pkg.VariableSparsityConfig(num_heads=h, block=block,
                                   local_window_blocks=[1, 2],
                                   global_block_indices=[0]),
        pkg.VariableSparsityConfig(num_heads=h, block=block,
                                   num_random_blocks=2,
                                   local_window_blocks=[2, 3],
                                   global_block_indices=[1, 4],
                                   global_block_end_indices=[2, 6],
                                   attention="unidirectional",
                                   different_layout_per_head=True),
        pkg.BigBirdSparsityConfig(num_heads=h, block=block),
        pkg.BigBirdSparsityConfig(num_heads=h, block=block,
                                  num_random_blocks=2,
                                  attention="unidirectional",
                                  different_layout_per_head=True),
        pkg.BSLongformerSparsityConfig(num_heads=h, block=block),
        pkg.BSLongformerSparsityConfig(num_heads=h, block=block,
                                       num_sliding_window_blocks=5,
                                       global_block_indices=[0, 3],
                                       global_block_end_indices=[1, 5],
                                       attention="unidirectional"),
    ]


CONFIG_IDS = ["dense", "fixed", "fixed-uni", "fixed-horizontal",
              "fixed-per-head", "variable", "variable-random-uni-per-head",
              "bigbird", "bigbird-uni-per-head", "bslongformer",
              "bslongformer-uni-ranges"]


@pytest.mark.parametrize("i", range(len(CONFIG_IDS)), ids=CONFIG_IDS)
@pytest.mark.parametrize("t,block", [(512, 32), (512, 128)])
def test_layouts_match_jax(i, t, block):
    got = _configs(tsa, 4, block)[i].make_layout(t)
    want = _configs(jsa, 4, block)[i].make_layout(t)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_layout_seq_len_must_divide():
    with pytest.raises(ValueError):
        tsa.FixedSparsityConfig(num_heads=2, block=32).make_layout(100)


@pytest.mark.parametrize("i", range(len(CONFIG_IDS)), ids=CONFIG_IDS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tables_and_band_decomposition_match_jax(i, causal):
    layout = _configs(jsa, 4, 32)[i].make_layout(512)
    for qt in (1, 2, 4):
        got = tbsa._build_tables(layout, causal, qt)
        want = jbsa._build_tables(layout, causal, qt)
        for a, b in zip(got, want[:9]):      # JAX's last entry is g
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tbsa._band_decompose(layout, causal) == \
        jbsa._band_decompose(layout, causal)
    np.testing.assert_array_equal(
        tbsa.layout_to_dense_mask(layout, 512, 32),
        jbsa.layout_to_dense_mask(layout, 512, 32))


def test_hopper_backward_raises_past_its_longest_walk():
    """The Hopper backward's shared memory holds a walk of 512 steps
    (every 64-row tile of T = 32768); a longer transpose row (a global
    column at T = 32832) raises on the host before any launch."""
    layout = tsa.BSLongformerSparsityConfig(
        num_heads=1, block=64, num_sliding_window_blocks=3).make_layout(32832)
    plan = tbsa._plan(layout, True, 64, HOPPER_TILES, torch.device("cpu"))
    assert plan.pairs["dkv"][2] == 513 > tbsa._SM90_MAX_STEPS
    x = torch.zeros((1, 32832, 1, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 32832))
    with pytest.raises(ValueError, match="512"):
        tbsa._bs_bwd_dkv_sm90_launch(x, x, x, x, lse, x, plan, 0.125)


def test_cpu_route_takes_the_pair_table_forward_for_bf16(monkeypatch):
    """A bf16 call at head dim 64 on a layout without a band runs the
    table forward's twin on the 128 x 64 pair plan (the Hopper kernel's
    walk), with and without gradients; fp32 keeps the 64-row tables."""
    layout = tsa.BigBirdSparsityConfig(num_heads=2, block=64).make_layout(256)
    walks = []
    real = tbsa._walk_fwd_plain

    def spy(q, k, v, steps, q_tile, tile, sm_scale):
        walks.append((q.dtype, q_tile, tile))
        return real(q, k, v, steps, q_tile, tile, sm_scale)

    monkeypatch.setattr(tbsa, "_walk_fwd_plain", spy)
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(1, 256, 2, 64, seed=5))
    for dtype in (torch.bfloat16, torch.float32):
        xs = [x.to(dtype) for x in (q, k, v)]
        tsa.block_sparse_attention(*xs, layout, 64)
        xs = [x.requires_grad_(True) for x in xs]
        tsa.block_sparse_attention(*xs, layout, 64).float().sum().backward()
    assert walks == [(torch.bfloat16, 128, 64)] * 2 + \
        [(torch.float32, 64, 64)] * 2


def test_hopper_table_forward_raises_past_its_longest_walk():
    """The table forward's shared memory holds a walk of 512 steps; a
    global row of a bidirectional BigBird layout at T = 32832 walks all
    513 k tiles and raises on the host before any launch."""
    layout = tsa.BigBirdSparsityConfig(
        num_heads=1, block=64, num_random_blocks=0,
        num_sliding_window_blocks=1).make_layout(32832)
    plan = tbsa._plan(layout, False, 64, HOPPER_TILES, torch.device("cpu"))
    assert plan.band is None and plan.pairs["dq"][2] == 513
    x = torch.zeros((1, 32832, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="512"):
        tbsa._bs_fwd_sm90_launch(x, x, x, plan, 0.125)


def test_twins_match_the_dense_fallback_at_blocks_16_and_256():
    """Blocks the JAX tests do not reach: 16 (four sub-blocks per 64-row
    tile side, 16-bit masks) and 256 (one block over four tiles)."""
    for block, t in ((16, 256), (256, 512)):
        cfg = tsa.BSLongformerSparsityConfig(num_heads=2, block=block,
                                             num_sliding_window_blocks=3)
        layout = cfg.make_layout(t)
        q, k, v, g = (torch.from_numpy(x).requires_grad_(True)
                      for x in _qkv(1, t, 2, 32, seed=block))
        for causal in (True, False):
            out = tsa.block_sparse_attention(q, k, v, layout, block,
                                             causal=causal)
            ref = tbsa.block_sparse_attention_dense_fallback(
                q, k, v, layout, block, causal=causal)
            torch.testing.assert_close(out, ref, **OUT_TOL)
            for a, b in zip(torch.autograd.grad(out, (q, k, v), g),
                            torch.autograd.grad(ref, (q, k, v), g)):
                torch.testing.assert_close(a, b, **GRAD_TOL)


def test_dense_attention_mask_matches_jax():
    q, k, v, _ = _qkv(2, 64, 2, 16, seed=3)
    mask = np.where(np.random.RandomState(4).rand(2, 1, 64, 64) < 0.3,
                    -1e30, 0.0).astype(np.float32)
    for causal in (True, False):
        want = jfa.dense_attention(q, k, v, mask=jnp.asarray(mask),
                                   causal=causal)
        got = tfa.dense_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  mask=torch.from_numpy(mask),
                                  causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_sparse_self_attention_with_and_without_masks_matches_jax():
    """Both mask modes of both masks; the attention mask hides one whole
    query row, which both packages then spread evenly over every key."""
    h, t, block = 2, 256, 32
    q, k, v, _ = _qkv(1, t, h, 32, seed=5)
    r = np.random.RandomState(6)
    kpm_add = np.where(np.arange(t) >= t // 2, -1e9, 0.0)[None].astype(
        np.float32)
    kpm_mul = (kpm_add == 0).astype(np.float32)
    am = (r.rand(t, t) < 0.9).astype(np.float32)
    am[7] = 0.0
    rpe = r.randn(1, h, t, t).astype(np.float32) * 0.1
    cases = [("add", "mul", dict()),
             ("add", "mul", dict(key_padding_mask=kpm_add)),
             ("add", "mul", dict(attn_mask=am)),
             ("add", "mul", dict(rpe=rpe, key_padding_mask=kpm_add,
                                 attn_mask=am)),
             ("mul", "add", dict(rpe=rpe, key_padding_mask=kpm_mul,
                                 attn_mask=np.log(am + 1e-3)))]
    for causal in (False, True):
        for kp_mode, am_mode, kw in cases:
            modes = dict(key_padding_mask_mode=kp_mode,
                         attn_mask_mode=am_mode)
            jmod = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(
                num_heads=h, block=block, num_local_blocks=2), **modes)
            tmod = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
                num_heads=h, block=block, num_local_blocks=2), **modes)
            want = jmod(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                        **{n: jnp.asarray(x) for n, x in kw.items()})
            got = tmod(*(torch.from_numpy(x) for x in (q, k, v)),
                       causal=causal,
                       **{n: torch.from_numpy(x) for n, x in kw.items()})
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **OUT_TOL)


def test_bert_sparse_self_attention_matches_jax_with_carried_params():
    from deepspeed_tpu_torch.models.convert import \
        bert_sparse_params_from_jax
    hid, nh, t = 64, 2, 256
    x = np.random.RandomState(7).randn(1, t, hid).astype(np.float32)
    mask = (np.random.RandomState(8).rand(t, t) < 0.95).astype(np.float32)
    jmod = jsa.BertSparseSelfAttention(
        hidden_size=hid, num_attention_heads=nh,
        sparsity_config=jsa.FixedSparsityConfig(num_heads=nh, block=32,
                                                num_local_blocks=2))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tmod = tsa.BertSparseSelfAttention(
        hidden_size=hid, num_attention_heads=nh,
        sparsity_config=tsa.FixedSparsityConfig(num_heads=nh, block=32,
                                                num_local_blocks=2),
        device="cpu")
    tmod.load_state_dict(bert_sparse_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    for attn_mask in (None, mask):
        def loss(p):
            return jnp.sum(jmod.apply(p, jnp.asarray(x), attn_mask if
                                      attn_mask is None else
                                      jnp.asarray(attn_mask)) ** 2)
        want_loss, want_grads = jax.value_and_grad(loss)(params)
        tmod.zero_grad()
        out = tmod(torch.from_numpy(x), None if attn_mask is None else
                   torch.from_numpy(attn_mask))
        got_loss = (out ** 2).sum()
        got_loss.backward()
        np.testing.assert_allclose(got_loss.item(), float(want_loss),
                                   rtol=1e-5)
        got_grads = bert_sparse_params_from_jax(jax.tree_util.tree_map(
            np.asarray, want_grads))
        for name, p in tmod.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(),
                                       got_grads[name].numpy(), **GRAD_TOL)


def test_bert_sparse_self_attention_init_matches_flax_dense():
    """Fresh projections start as flax nn.Dense's: lecun-normal weights
    (std 1/sqrt(fan_in) = 0.03125 at hidden 1024, within 10%; at most
    two truncated stds) and zero biases, against the JAX module's own
    init statistics; the same seed gives the same weights."""
    hid, nh = 1024, 16
    jmod = jsa.BertSparseSelfAttention(hidden_size=hid,
                                       num_attention_heads=nh)
    jparams = jmod.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 256, hid), jnp.float32))["params"]
    tmod = tsa.BertSparseSelfAttention(hid, nh, device="cpu", seed=3)
    for name in ("query", "key", "value"):
        w = getattr(tmod, name).weight.detach()
        jw = np.asarray(jparams[name]["kernel"])
        for std in (float(w.std()), float(jw.std())):
            assert abs(std - 0.03125) <= 0.1 * 0.03125, (name, std)
        limit = 2 * 0.03125 / 0.87962566103423978 + 1e-6
        assert float(w.abs().max()) <= limit
        assert not getattr(tmod, name).bias.detach().any()
        assert not np.asarray(jparams[name]["bias"]).any()
    again = tsa.BertSparseSelfAttention(hid, nh, device="cpu", seed=3)
    assert torch.equal(again.query.weight, tmod.query.weight)


def test_sparse_attention_utils_match_jax():
    ids = np.arange(200).reshape(2, 100).astype(np.int64)
    mask = np.ones((2, 100), np.int64)
    emb = np.random.RandomState(9).randn(2, 100, 8).astype(np.float32)
    table = np.random.RandomState(10).randn(16, 8).astype(np.float32)
    want = jsa.SparseAttentionUtils.pad_to_block_size(
        64, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        inputs_embeds=jnp.asarray(emb), pad_token_id=9,
        model_embeddings=jnp.asarray(table))
    got = tsa.SparseAttentionUtils.pad_to_block_size(
        64, input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(mask),
        inputs_embeds=torch.from_numpy(emb), pad_token_id=9,
        model_embeddings=torch.from_numpy(table))
    assert got[0] == want[0] == 28
    for a, b in zip(got[1:], want[1:]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = tsa.SparseAttentionUtils.unpad_sequence_output(
        28, torch.zeros((2, 128, 8)))
    assert out.shape == (2, 100, 8)
    pe = np.random.RandomState(11).randn(128, 16).astype(np.float32)
    np.testing.assert_array_equal(
        tsa.SparseAttentionUtils.extend_position_embedding(
            torch.from_numpy(pe), 300).numpy(),
        np.asarray(jsa.SparseAttentionUtils.extend_position_embedding(
            pe, 300)))


@pytest.mark.parametrize("block", [
    {"mode": "bigbird", "block": 32, "num_random_blocks": 2},
    {"mode": "bslongformer", "num_sliding_window_blocks": 5, "bogus": 1},
    {"block": 64},
])
def test_sparse_attention_config_block_matches_jax(block):
    from deepspeed_tpu.runtime.config import \
        get_sparse_attention as jget
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    get_sparse_attention)
    d = {"train_batch_size": 2, "sparse_attention": block}
    assert get_sparse_attention(d) == jget(d)
    assert DeepSpeedConfig(d).sparse_attention == jget(d)
    assert get_sparse_attention({}) is None


def test_sparse_attention_config_rejects_unknown_mode():
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfigError,
                                                    get_sparse_attention)
    with pytest.raises(DeepSpeedConfigError):
        get_sparse_attention({"sparse_attention": {"mode": "random"}})


def test_block_sparse_attention_validates_as_jax():
    layout = tsa.FixedSparsityConfig(num_heads=2, block=32).make_layout(256)
    q = torch.zeros((1, 256, 2, 32))
    with pytest.raises(ValueError):
        tsa.block_sparse_attention(q, q, q, layout, 32,
                                   head_packing="packed")
    with pytest.raises(ValueError):
        tsa.block_sparse_attention(q, q, q, layout, 32, head_packing="x")
    with pytest.raises(ValueError):           # layout shape
        tsa.block_sparse_attention(q, q, q, layout[:1], 32)
    no_diag = layout.copy()
    no_diag[:, 3, 3] = 0
    with pytest.raises(ValueError):
        tsa.block_sparse_attention(q, q, q, no_diag, 32, causal=True)
    empty_row = layout.copy()
    empty_row[:, 2] = 0
    with pytest.raises(ValueError):
        tsa.block_sparse_attention(q, q, q, empty_row, 32)
    out = tsa.block_sparse_attention(q, q, q, layout, 32, head_packing="off")
    assert out.shape == q.shape


def test_tables_are_built_once_per_layout():
    layout = tsa.BigBirdSparsityConfig(num_heads=2, block=32).make_layout(256)
    a = tbsa._plan(layout, True, 32, 64, torch.device("cpu"))
    b = tbsa._plan(layout.copy(), True, 32, 64, torch.device("cpu"))
    c = tbsa._plan(layout, False, 32, 64, torch.device("cpu"))
    assert a is b and a is not c
    # the Hopper band forward's plan: its own entry in the one cache,
    # keyed by the tile pair
    band = tsa.FixedSparsityConfig(num_heads=2, block=32).make_layout(256)
    d = tbsa._plan(band, True, 32, HOPPER_TILES, torch.device("cpu"))
    e = tbsa._plan(band, True, 32, 64, torch.device("cpu"))
    assert d is tbsa._plan(band.copy(), True, 32, (128, 64),
                           torch.device("cpu"))
    assert d is not e and (d.q_tile, d.tile) == (128, 64)
    assert (e.q_tile, e.tile) == (64, 64)
    # a layout that does not decompose has a Hopper plan too: the
    # backward's pair tables, built from the cached square plan's
    f = tbsa._plan(layout, True, 32, HOPPER_TILES, torch.device("cpu"))
    assert f.band is None and set(f.pairs) == {"dq", "dkv"}
    assert f.head_map is a.head_map
