"""InferenceEngine — chunked prefill + single-token decode over a paged
KV cache, with device-side sampling and no per-token host sync (port
of deepspeed_tpu/inference/engine.py).

The JAX engine compiles two programs ahead of time; PyTorch runs
eagerly, so the two steps here are plain methods that enqueue work on
the current stream:

  * the **prefill** step: one prompt chunk of one request through the
    stack, writing each layer's K/V into the request's cache pages and
    attending over everything cached so far;
  * the **decode** step: one token for EVERY request slot at once
    ([max_slots] lockstep), paged attention over each slot's cached
    prefix, logits through the tied head, and greedy /
    temperature+top-k sampling on the device. The sampled token, the
    EOS/max-tokens flags and the output ring stay on the device, so
    `decode_block` enqueues `sync_every` steps back-to-back and reads
    nothing until `fetch_state`, the one host sync.

The block math is GPT2Block's fused phrasing (models/gpt2.py), which is
the same function as the JAX engine's unfused `_block_paged`: ln_1 via
the boundary carry (a zero first boundary in wte's dtype), c_attn as a
plain matmul plus bias, write-before-read of the chunk's K/V into the
page pool, paged attention in plain PyTorch (the JAX package left it
to XLA too), c_proj without its bias then kernel K3 (bias + residual +
ln_2), c_fc without its bias then kernel K4 (bias + tanh-GeLU), and
mlp_c_proj handed on as the next boundary; the last boundary goes
into K3 as ln_f. Serving and the full-sequence forward share one set
of kernels.

Projection kernels are cast to the compute dtype once, at
construction: `x @ W.to(dtype)` is the same product whether the cast
happens once or every step, and casting every step would move the
fp32 weights through memory on each decode step.

Out of this slice (NotImplementedError): speculative decoding, int8
weight-only serving (`inference.weight_bits: 8`), and the monitor.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache
from deepspeed_tpu_torch.models.gpt2 import (check_supported,
                                             stacked_block_params)
from deepspeed_tpu_torch.ops.transformer.fused_ops import (
    fused_bias_gelu, fused_bias_residual_layernorm)
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.utils.device import resolve_device

NEG_INF = -1e30
_KERNELS = ("c_attn.kernel", "c_proj.kernel", "c_fc.kernel",
            "mlp_c_proj.kernel")


def paged_attention(q, kc, vc, q_pos, kv_limit):
    """Causal attention of q [B, Tq, H, D] against a gathered page
    window kc/vc [B, Tk, H, D], phrased like `dense_attention` (the
    score product in the input dtype, fp32 softmax, -1e30 masking). Key
    positions are their indices, queries sit at absolute positions
    `q_pos` [B, Tq], and keys beyond `kv_limit` [B] (pages not yet
    written, or the scratch page) are masked AND value-zeroed: their
    probability is 0, and zeroing the values keeps garbage out of the
    product (a NaN in an unwritten page times 0 would still be NaN)."""
    sm_scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kc).to(torch.float32)
    scores = scores * sm_scale
    kpos = torch.arange(kc.shape[1], device=q.device)
    mask = kpos[None, None, None, :] <= q_pos[:, None, :, None]
    scores = torch.where(mask, scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=q.device))
    probs = torch.softmax(scores, dim=-1).to(vc.dtype)
    v_ok = (kpos[None, :] <= kv_limit[:, None])[:, :, None, None]
    vc = torch.where(v_ok, vc, torch.zeros((), dtype=vc.dtype,
                                           device=vc.device))
    out = torch.matmul(probs, vc.transpose(1, 2))
    return out.transpose(1, 2)


def _block_paged(cfg, lp, hidden, boundary, kl, vl, tables, positions,
                 valid, kv_limit, page_size):
    """One pre-LN block in GPT2Block's fused phrasing over the true
    hidden state `hidden + boundary` [B, Tq, C]: writes this chunk's K/V
    into the layer's page pool (kl/vl: [P, page, H, D], updated in
    place) and attends through the page tables ([B, max_pages]). Rows
    with valid=False (inactive decode slots) write to scratch page 0.
    Returns (residual_stream, (mlp_y, mlp_b)), the next boundary."""
    b, t, c = hidden.shape
    h, d = cfg.n_head, cfg.head_dim
    eps = cfg.layer_norm_epsilon
    sum_dtype = torch.promote_types(hidden.dtype, cfg.dtype)

    x, hidden = fused_bias_residual_layernorm(
        boundary[0], boundary[1], hidden, lp["ln_1.scale"],
        lp["ln_1.bias"], eps=eps, out_dtype=cfg.dtype, sum_dtype=sum_dtype)
    qkv = torch.matmul(x, lp["c_attn.kernel"]) + lp["c_attn.bias_c"]
    q, k, v = (part.view(b, t, h, d) for part in qkv.split(c, dim=-1))

    # write-before-read: the chunk's own keys are part of its causal
    # window. index_put_ writes the pool in place, where the JAX
    # engine's .at[].set relied on buffer donation to avoid a second
    # copy of the pool.
    pidx = torch.clamp(positions // page_size, max=tables.shape[1] - 1)
    off = (positions % page_size).reshape(-1)
    phys = torch.gather(tables, 1, pidx)
    phys = torch.where(valid, phys, torch.zeros_like(phys)).reshape(-1)
    kl.index_put_((phys, off), k.reshape(b * t, h, d))
    vl.index_put_((phys, off), v.reshape(b * t, h, d))

    kc = kl[tables].reshape(b, -1, h, d)
    vc = vl[tables].reshape(b, -1, h, d)
    attn = paged_attention(q, kc, vc, positions, kv_limit).reshape(b, t, c)
    attn_y = torch.matmul(attn, lp["c_proj.kernel"])
    y, hidden = fused_bias_residual_layernorm(
        attn_y, lp["c_proj.bias"], hidden, lp["ln_2.scale"],
        lp["ln_2.bias"], eps=eps, out_dtype=cfg.dtype, sum_dtype=sum_dtype)
    fc_y = torch.matmul(y, lp["c_fc.kernel"])
    y = fused_bias_gelu(fc_y, lp["c_fc.bias"], approximate=True,
                        out_dtype=cfg.dtype)
    mlp_y = torch.matmul(y, lp["mlp_c_proj.kernel"])
    return hidden, (mlp_y, lp["mlp_c_proj.bias"])


class InferenceEngine:
    """Serving engine for a GPT-2 family model.

    `start_request`/`prefill_chunk`/`activate_slot` manage slots
    (fence-side host work), `decode_block` enqueues N sync-free decode
    steps, and `fetch_state` is the ONE host<->device rendezvous.
    `params` is the flat parameter dict of models/gpt2.py (from
    `GPT2ForCausalLM.init`/`params()` or `models.convert.params_from_jax`)."""

    def __init__(self, model_config, params, config=None, device="cuda"):
        check_supported(model_config)
        config = config or {}
        cfg = InferenceConfig(config)
        if cfg.spec_enabled:
            raise NotImplementedError(
                "inference.speculative is not in the port yet: ROADMAP "
                "Queue 1 item 7")
        if cfg.weight_bits == 8:
            raise NotImplementedError(
                "inference.weight_bits: 8 (int8 weight-only serving) is not "
                "in the port yet: ROADMAP Queue 1 item 7")
        mon = config.get(C.MONITOR, {})
        if isinstance(mon, dict) and mon.get(C.MONITOR_ENABLED,
                                             C.MONITOR_ENABLED_DEFAULT):
            raise NotImplementedError(
                "an enabled monitor block is not in the port yet: ROADMAP "
                "Queue 1 item 8")
        self.device = resolve_device(device)
        self.model_config = model_config
        self.config = cfg

        max_seq = model_config.n_positions
        if cfg.max_seq_len is not None:
            max_seq = min(max_seq, cfg.max_seq_len)
        self.max_seq_len = max_seq
        max_pages = -(-max_seq // cfg.kv_page_size)
        self.cache = PagedKVCache(
            n_layer=model_config.n_layer, n_head=model_config.n_head,
            head_dim=model_config.head_dim, num_pages=cfg.kv_num_pages,
            page_size=cfg.kv_page_size, max_slots=cfg.max_slots,
            max_pages_per_slot=max_pages)
        self._load_params(params)
        self._top_k_cap = min(cfg.top_k_max, model_config.vocab_size)
        self._rows = torch.arange(cfg.max_slots, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._tables_version = self.cache.table_version
        self._state = self._fresh_state()

    def _load_params(self, params):
        mc, dev = self.model_config, self.device

        def on_device(x):
            return torch.as_tensor(x).detach().to(dev)

        self._wte = on_device(params["wte"])
        self._wpe = on_device(params["wpe"])
        # the tied head's operand, cast once
        self._wte_c = self._wte.to(mc.dtype)
        self._ln_f = (on_device(params["ln_f.scale"]),
                      on_device(params["ln_f.bias"]))
        self._layers = []
        for lp in stacked_block_params(params, mc.n_layer):
            lp = {name: on_device(v) for name, v in lp.items()}
            for name in _KERNELS:
                lp[name] = lp[name].to(mc.dtype)
            lp["c_attn.bias_c"] = lp["c_attn.bias"].to(mc.dtype)
            self._layers.append(lp)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def _fresh_state(self):
        cfg, mc, dev = self.config, self.model_config, self.device
        s, w = cfg.max_slots, cfg.max_new_tokens
        c = self.cache
        pool = (c.n_layer, c.num_pages, c.page_size, c.n_head, c.head_dim)
        self._gen.manual_seed(cfg.seed)
        i64 = dict(dtype=torch.long, device=dev)
        return {
            "k_pool": torch.zeros(pool, dtype=mc.dtype, device=dev),
            "v_pool": torch.zeros(pool, dtype=mc.dtype, device=dev),
            "tables": torch.as_tensor(self.cache.tables, **i64),
            "pos": torch.zeros((s,), **i64),
            "cur_token": torch.zeros((s,), **i64),
            "active": torch.zeros((s,), dtype=torch.bool, device=dev),
            "finished_eos": torch.zeros((s,), dtype=torch.bool, device=dev),
            "n_gen": torch.zeros((s,), **i64),
            "out_tokens": torch.zeros((s, w), **i64),
            "max_new": torch.full((s,), w, **i64),
            "temperature": torch.zeros((s,), dtype=torch.float32,
                                       device=dev),
            "top_k": torch.zeros((s,), **i64),
            "eos": torch.full((s,), -1, **i64),
            "step": torch.zeros((), **i64),
        }

    def reset(self):
        """Drop all slots and cached pages."""
        for slot in self.cache.slots():
            self.cache.free(slot)
        self._state = self._fresh_state()
        self._tables_version = self.cache.table_version

    # ------------------------------------------------------------------
    # the two steps
    # ------------------------------------------------------------------
    def _zero_boundary(self, shape):
        mc = self.model_config
        return (torch.zeros(shape, dtype=mc.dtype, device=self.device),
                torch.zeros((mc.n_embd,), dtype=self._wte.dtype,
                            device=self.device))

    def _stack(self, hidden, tables, positions, valid, kv_limit):
        """All layers over hidden [B, Tq, C]; returns the last boundary
        carry (residual_stream, (mlp_y, mlp_b))."""
        mc, st = self.model_config, self._state
        prev = self._zero_boundary(hidden.shape)
        for i, lp in enumerate(self._layers):
            hidden, prev = _block_paged(
                mc, lp, hidden, prev, st["k_pool"][i], st["v_pool"][i],
                tables, positions, valid, kv_limit, self.cache.page_size)
        return hidden, prev

    def _sample(self, logits):
        """Greedy, or temperature + top-k sampling, per slot on the
        device. The draw is the Gumbel-max form of categorical sampling
        (what jax.random.categorical computes), from the engine's
        torch.Generator."""
        st = self._state
        cap = self._top_k_cap
        l32 = logits.to(torch.float32)
        greedy = torch.argmax(l32, dim=-1)
        vals = torch.topk(l32, cap, dim=-1).values
        idx = torch.clamp(st["top_k"] - 1, 0, cap - 1)
        kth = torch.gather(vals, 1, idx[:, None])[:, 0]
        masked = torch.where(
            (st["top_k"] > 0)[:, None] & (l32 < kth[:, None]),
            torch.tensor(float("-inf"), device=l32.device), l32)
        temp = st["temperature"]
        scaled = masked / torch.clamp(temp, min=1e-6)[:, None]
        u = torch.rand(scaled.shape, generator=self._gen,
                       device=scaled.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        drawn = torch.argmax(scaled + gumbel, dim=-1)
        return torch.where(temp > 0.0, drawn, greedy)

    @torch.no_grad()
    def _decode_step(self):
        """One token for every slot; enqueues only (no host sync).
        Returns the pre-sampling logits [max_slots, vocab]."""
        mc, st = self.model_config, self._state
        out_w = self.config.max_new_tokens
        active, pos = st["active"], st["pos"]
        hidden = (self._wte[st["cur_token"]].to(mc.dtype) +
                  self._wpe[pos].to(mc.dtype))[:, None, :]
        resid, (mlp_y, mlp_b) = self._stack(
            hidden, st["tables"], pos[:, None], active[:, None], pos)
        hidden = fused_bias_residual_layernorm(
            mlp_y, mlp_b, resid, *self._ln_f, eps=mc.layer_norm_epsilon,
            out_dtype=torch.float32, return_sum=False)
        logits = torch.matmul(hidden.to(mc.dtype), self._wte_c.t())[:, 0]
        next_tok = self._sample(logits)

        n = st["n_gen"]
        idx = torch.clamp(n, 0, out_w - 1)
        prev = st["out_tokens"][self._rows, idx]
        st["out_tokens"].index_put_((self._rows, idx),
                                    torch.where(active, next_tok, prev))
        act = active.to(torch.long)
        n2 = n + act
        hit_eos = active & (next_tok == st["eos"])
        hit_max = active & (n2 >= st["max_new"])
        st["pos"] = pos + act
        st["cur_token"] = torch.where(active, next_tok, st["cur_token"])
        st["active"] = active & ~(hit_eos | hit_max)
        st["finished_eos"] = st["finished_eos"] | hit_eos
        st["n_gen"] = n2
        st["step"] = st["step"] + 1
        return logits

    # ------------------------------------------------------------------
    # fence-side slot management (host work, runs between blocks)
    # ------------------------------------------------------------------
    def push_tables(self):
        """Upload the page tables iff they changed since the last
        push."""
        if self._tables_version != self.cache.table_version:
            self._state["tables"] = torch.as_tensor(
                self.cache.tables, dtype=torch.long, device=self.device)
            self._tables_version = self.cache.table_version

    @torch.no_grad()
    def prefill_chunk(self, slot, tokens, start):
        """Cache `tokens` (<= prefill_chunk of them) for `slot` at
        positions [start, start+len). Pages must already be ensured."""
        mc, dev = self.model_config, self.device
        n = len(tokens)
        if n > self.config.prefill_chunk:
            raise ValueError(f"{n} tokens exceed inference.prefill_chunk="
                             f"{self.config.prefill_chunk}")
        ids = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        posv = torch.arange(start, start + n, device=dev)
        hidden = (self._wte[ids].to(mc.dtype) +
                  self._wpe[posv].to(mc.dtype))[None]
        tables = torch.as_tensor(self.cache.tables[slot][None],
                                 dtype=torch.long, device=dev)
        valid = torch.ones((1, n), dtype=torch.bool, device=dev)
        kv_limit = torch.full((1,), start + n - 1, dtype=torch.long,
                              device=dev)
        self._stack(hidden, tables, posv[None], valid, kv_limit)

    def activate_slot(self, slot, cur_token, pos, max_new, temperature,
                      top_k, eos):
        """Flip a fully-prefilled slot live for the decode batch."""
        st = self._state
        st["cur_token"][slot] = int(cur_token)
        st["pos"][slot] = int(pos)
        st["active"][slot] = True
        st["finished_eos"][slot] = False
        st["n_gen"][slot] = 0
        st["max_new"][slot] = int(max_new)
        st["temperature"][slot] = float(temperature)
        st["top_k"][slot] = int(top_k)
        st["eos"][slot] = -1 if eos is None else int(eos)

    def start_request(self, slot, prompt, max_new, temperature=0.0,
                      top_k=0, eos=None):
        """Admit + fully prefill + activate one request in one call
        (ServingLoop does the same piecewise, chunk-interleaved with
        decode)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        t = len(prompt)
        if t < 1:
            raise ValueError("empty prompt")
        if t + max_new > self.max_seq_len:
            raise ValueError(
                f"prompt ({t}) + max_new_tokens ({max_new}) exceeds "
                f"max_seq_len {self.max_seq_len}")
        if max_new > self.config.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {max_new} exceeds the device output "
                "ring width inference.max_new_tokens="
                f"{self.config.max_new_tokens}")
        if top_k > self.config.top_k_max:
            raise ValueError(
                f"top_k {top_k} exceeds the sampling cap "
                f"inference.top_k_max={self.config.top_k_max}")
        self.cache.admit(slot, t + max_new)
        chunk = self.config.prefill_chunk
        n_prefill = t - 1
        # direct (scheduler-less) use runs decode_block without a
        # fence-side capacity step, so assign the worst case up front
        self.cache.ensure(slot, t + max_new)
        self.push_tables()
        for start in range(0, n_prefill, chunk):
            end = min(start + chunk, n_prefill)
            self.prefill_chunk(slot, prompt[start:end], start)
        self.activate_slot(slot, prompt[-1], t - 1, max_new,
                           temperature, top_k, eos)

    def ensure_decode_capacity(self, slot, known_pos, iters):
        """Assign pages covering `iters` more positions for a live
        slot before a decode block (reservation-backed: cannot fail)."""
        worst = self.cache.reserved_tokens(slot)
        self.cache.ensure(slot, min(known_pos + iters, worst))

    # ------------------------------------------------------------------
    # the hot dispatch loop + the serving fence
    # ------------------------------------------------------------------
    def decode_block(self, n):
        """Enqueue n decode steps back-to-back: no host sync, nothing
        read until `fetch_state`."""
        for _ in range(n):
            self._decode_step()

    def decode_once(self):
        """One decode step, returning the pre-sampling logits
        [max_slots, vocab] (parity checks read these)."""
        return self._decode_step()

    def fetch_state(self):
        """THE serving fence: one device->host copy of the per-slot
        progress the scheduler needs (active flags, eos flags,
        positions, generated counts, output rings), packed into one
        tensor so the copy is one sync."""
        st = self._state
        s, w = self.config.max_slots, self.config.max_new_tokens
        packed = torch.cat([
            st["active"].to(torch.long), st["finished_eos"].to(torch.long),
            st["pos"], st["n_gen"], st["out_tokens"].reshape(-1)])
        host = packed.cpu().numpy()
        return {"active": host[:s].astype(bool),
                "finished_eos": host[s:2 * s].astype(bool),
                "pos": host[2 * s:3 * s].astype(np.int32),
                "n_gen": host[3 * s:4 * s].astype(np.int32),
                "out_tokens": host[4 * s:].reshape(s, w).astype(np.int32)}
