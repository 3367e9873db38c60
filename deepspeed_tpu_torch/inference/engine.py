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
fp32 weights through memory on each decode step. With
`inference.weight_bits: 8` they are quantized once instead
(inference/quant.py) and every projection runs the weight-only int8
epilogue `int8_matmul`; the biases still go into K3 and K4, and wte,
wpe, the LayerNorms and the tied head stay in full precision.

Speculative decoding (`inference.speculative`, inference/speculative.py)
adds a draft model over a second KV pool on the same page tables and
`spec_block`, the speculative counterpart of `decode_block`. The tied
head runs one GEMM per query position of a step (`_logits`), each of
the decode step's own [max_slots, C] shape: cuBLAS picks the head's
kernel by the row count and its bits move with it on the card, so a
verify row must see the decode row's GEMM for the speculative stream to
equal vanilla decode at temperature 0 (every other product of a step
gives a row the same bits at either row count: tests/test_torch_cuda.py,
chip_smoke.py's `verify_rows`).

Telemetry: a `monitor` block on the config gives the engine a
`Monitor` (deepspeed_tpu_torch/monitor/) whose memory ledger holds the
weights and the KV pools (`kv_cache`, `kv_cache_draft`, per request);
the ServingLoop emits the monitor's serving events, and with
`inference.observability` (on by default under an enabled monitor) a
`ServingTracker` stamps every request's lifecycle — all host-side, so
the decode and speculative blocks keep their zero host reads.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache
from deepspeed_tpu_torch.inference.quant import (KERNEL_SCALE,
                                                 QUANT_KERNEL_MODULES,
                                                 int8_matmul,
                                                 quantize_param_tree)
from deepspeed_tpu_torch.monitor import DeepSpeedMonitorConfig, Monitor
from deepspeed_tpu_torch.monitor import memory as memory_mod
from deepspeed_tpu_torch.models.gpt2 import (check_supported,
                                             stacked_block_params)
from deepspeed_tpu_torch.ops.transformer.fused_ops import (
    fused_bias_gelu, fused_bias_residual_layernorm)
from deepspeed_tpu_torch.utils.device import resolve_device

NEG_INF = -1e30


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
    # a Python scalar, not a tensor made from one: no host-to-device
    # copy (and no stream sync) inside the sync-free dispatch loops
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vc.dtype)
    v_ok = (kpos[None, :] <= kv_limit[:, None])[:, :, None, None]
    vc = torch.where(v_ok, vc, 0.0)
    out = torch.matmul(probs, vc.transpose(1, 2))
    return out.transpose(1, 2)


def _project(cfg, lp, name, x, quant_block):
    """x @ the projection `name`'s kernel (no bias) in the compute
    dtype, or the int8 weight-only epilogue where the layer carries the
    kernel's scales (the JAX engine's `_dense_apply`)."""
    scale = lp.get(f"{name}.{KERNEL_SCALE}")
    if scale is None:
        return torch.matmul(x, lp[f"{name}.kernel"])
    return int8_matmul(x.to(cfg.dtype), lp[f"{name}.kernel"], scale,
                       quant_block, cfg.dtype)


def _block_paged(cfg, lp, hidden, boundary, kl, vl, tables, positions,
                 valid, kv_limit, page_size, quant_block):
    """One pre-LN block in GPT2Block's fused phrasing over the true
    hidden state `hidden + boundary` [B, Tq, C]: writes this chunk's K/V
    into the layer's page pool (kl/vl: [P, page, H, D], updated in
    place) and attends through the page tables ([B, max_pages]). Rows
    with valid=False (inactive decode slots, a verify step's unused
    drafts) write to scratch page 0. Returns (residual_stream, (mlp_y,
    mlp_b)), the next boundary."""
    b, t, c = hidden.shape
    h, d = cfg.n_head, cfg.head_dim
    eps = cfg.layer_norm_epsilon
    sum_dtype = torch.promote_types(hidden.dtype, cfg.dtype)

    x, hidden = fused_bias_residual_layernorm(
        boundary[0], boundary[1], hidden, lp["ln_1.scale"],
        lp["ln_1.bias"], eps=eps, out_dtype=cfg.dtype, sum_dtype=sum_dtype)
    qkv = _project(cfg, lp, "c_attn", x, quant_block) + lp["c_attn.bias_c"]
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
    attn_y = _project(cfg, lp, "c_proj", attn, quant_block)
    y, hidden = fused_bias_residual_layernorm(
        attn_y, lp["c_proj.bias"], hidden, lp["ln_2.scale"],
        lp["ln_2.bias"], eps=eps, out_dtype=cfg.dtype, sum_dtype=sum_dtype)
    fc_y = _project(cfg, lp, "c_fc", y, quant_block)
    y = fused_bias_gelu(fc_y, lp["c_fc.bias"], approximate=True,
                        out_dtype=cfg.dtype)
    mlp_y = _project(cfg, lp, "mlp_c_proj", y, quant_block)
    return hidden, (mlp_y, lp["mlp_c_proj.bias"])


def load_weights(params, model_config, device, weight_bits=32,
                 quant_block=None):
    """The serving form of a flat GPT-2 parameter dict on `device`:
    {"wte", "wpe", "wte_c" (the tied head's operand in the compute
    dtype), "ln_f" (scale, bias), "layers" (one dict per block)}. The
    projection kernels are cast to the compute dtype once, or with
    weight_bits 8 quantized once (values padded to whole blocks of K,
    as the epilogue contracts them) with their scales beside them."""
    mc = model_config

    def on_device(x):
        return torch.as_tensor(x).detach().to(device)

    params = {name: on_device(v) for name, v in params.items()}
    if weight_bits == 8:
        params = quantize_param_tree(params, quant_block)
    wte = params["wte"]
    layers = []
    for lp in stacked_block_params(params, mc.n_layer):
        for mod in QUANT_KERNEL_MODULES:
            name = f"{mod}.kernel"
            scale = lp.get(f"{mod}.{KERNEL_SCALE}")
            if scale is None:
                lp[name] = lp[name].to(mc.dtype)
            else:
                kp = scale.shape[-2] * quant_block
                lp[name] = F.pad(lp[name], (0, 0, 0, kp - lp[name].shape[0]))
        lp["c_attn.bias_c"] = lp["c_attn.bias"].to(mc.dtype)
        layers.append(lp)
    return {"wte": wte, "wpe": params["wpe"], "wte_c": wte.to(mc.dtype),
            "ln_f": (params["ln_f.scale"], params["ln_f.bias"]),
            "layers": layers}


def gumbel_argmax(scores, gen):
    """A categorical draw per row of `scores` [.., V] (logits, -inf
    masked) in the Gumbel-max form (what jax.random.categorical
    computes), from the torch.Generator `gen`."""
    u = torch.rand(scores.shape, generator=gen, device=scores.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(scores + gumbel, dim=-1)


def process_logits(l32, top_k, temperature, top_k_cap):
    """The sampler's per-slot top-k mask and temperature scale: l32
    [S, .., V] fp32, top_k and temperature [S]. top_k 0 keeps every
    logit; masked logits are -inf. Both distributions of speculative
    acceptance go through it, so that the ratio targets what vanilla
    decode samples from."""
    lead = (-1,) + (1,) * (l32.dim() - 1)
    vals = torch.topk(l32, top_k_cap, dim=-1).values
    idx = torch.clamp(top_k - 1, 0, top_k_cap - 1).view(lead)
    kth = torch.gather(vals, -1, idx.expand(vals.shape[:-1] + (1,)))
    masked = l32.masked_fill((top_k > 0).view(lead) & (l32 < kth),
                             float("-inf"))
    return masked / torch.clamp(temperature, min=1e-6).view(lead)


class InferenceEngine:
    """Serving engine for a GPT-2 family model.

    `start_request`/`prefill_chunk`/`activate_slot` manage slots
    (fence-side host work), `decode_block` (or, with speculative
    decoding, `spec_block`) enqueues sync-free steps, and `fetch_state`
    is the ONE host<->device rendezvous. `params` is the flat parameter
    dict of models/gpt2.py (from `GPT2ForCausalLM.init`/`params()` or
    `models.convert.params_from_jax`); `draft_params` and
    `draft_model_config` are the external draft model's, for
    `inference.speculative.draft_model: "external"`."""

    def __init__(self, model_config, params, config=None, device="cuda",
                 draft_params=None, draft_model_config=None):
        check_supported(model_config)
        config = config or {}
        cfg = InferenceConfig(config)
        self.device = resolve_device(device)
        self.model_config = model_config
        self.config = cfg
        self.monitor = Monitor(self, DeepSpeedMonitorConfig(config))
        self._host_steps = 0
        self.micro_steps = 0

        max_seq = model_config.n_positions
        if cfg.max_seq_len is not None:
            max_seq = min(max_seq, cfg.max_seq_len)
        self.max_seq_len = max_seq
        max_pages = -(-max_seq // cfg.kv_page_size)
        self.cache = PagedKVCache(
            n_layer=model_config.n_layer, n_head=model_config.n_head,
            head_dim=model_config.head_dim, num_pages=cfg.kv_num_pages,
            page_size=cfg.kv_page_size, max_slots=cfg.max_slots,
            max_pages_per_slot=max_pages, dtype=model_config.dtype,
            ledger=self.monitor.ledger)
        # int8 weight-only: quantized once here (the JAX engine's load)
        self._weights = load_weights(params, model_config, self.device,
                                     cfg.weight_bits, cfg.weight_quant_block)
        self.monitor.ledger.register_tree(
            memory_mod.CAT_PARAMS, "inference.params", self._weights)
        # request-level serving observability: on by default, but only
        # under an enabled monitor block on the same config
        self.tracker = None
        if self.monitor.enabled and cfg.observability_enabled:
            from deepspeed_tpu_torch.monitor.serving import ServingTracker
            self.tracker = ServingTracker(self.monitor, self.cache, cfg)
            self.monitor.attach_serving(self.tracker)
        self._top_k_cap = min(cfg.top_k_max, model_config.vocab_size)
        self._rows = torch.arange(cfg.max_slots, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._tables_version = self.cache.table_version

        self.speculative_enabled = cfg.spec_enabled
        if cfg.spec_enabled:
            self._init_speculative(draft_params, draft_model_config)
        self._state = self._fresh_state()

    def _init_speculative(self, draft_params, draft_model_config):
        """The draft model, its KV pool and the round state
        (inference/speculative.py)."""
        from deepspeed_tpu_torch.inference import speculative as spec
        cfg, mc = self.config, self.model_config
        if cfg.spec_draft_model == "external":
            if draft_params is None or draft_model_config is None:
                raise ValueError(
                    'inference.speculative.draft_model="external" requires '
                    "draft_params and draft_model_config")
            check_supported(draft_model_config)
            self._draft_config = draft_model_config
            self._draft = load_weights(draft_params, draft_model_config,
                                       self.device, cfg.weight_bits,
                                       cfg.weight_quant_block)
            self.monitor.ledger.register_tree(
                memory_mod.CAT_PARAMS, "inference.draft_params",
                self._draft)
        else:
            # the derived draft's weights are the flagship's own layer
            # dicts: no new bytes to register
            self._draft_config, self._draft = spec.derive_draft(
                mc, self._weights, cfg.spec_draft_model)
        dmc = self._draft_config
        if dmc.n_head != mc.n_head or dmc.head_dim != mc.head_dim:
            raise ValueError(
                "speculative draft model must share the flagship's head "
                "geometry (the draft KV pool reuses the flagship page-table "
                "shapes)")
        self.cache.attach_draft(dmc.n_layer)
        k = cfg.spec_k
        self._steps = torch.arange(k + 1, device=self.device)
        self._wcols = torch.arange(cfg.max_new_tokens, device=self.device)
        self._draft_gen = torch.Generator(device=self.device)
        self._verify_gen = torch.Generator(device=self.device)
        self._reset_speculative()

    def _reset_speculative(self):
        from deepspeed_tpu_torch.inference import speculative as spec
        self._spec_state = spec.fresh_spec_state(self)
        # host mirror of the draft dispatch depth: max(live k_slot) as
        # of the last fence (adaptive back-off without another sync)
        self._spec_next_draft = self.config.spec_k
        self._spec_draft_dispatch_s = 0.0
        self._spec_verify_dispatch_s = 0.0

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
        if self.speculative_enabled:
            self._reset_speculative()
        if self.tracker is not None:
            self.tracker.on_reset()

    # ------------------------------------------------------------------
    # the model over the paged cache
    # ------------------------------------------------------------------
    def _embed(self, weights, tokens, positions):
        """wte[tokens] + wpe[positions] in the compute dtype (positions
        clamped to the table, as the JAX gathers clamp)."""
        mc = self.model_config
        posc = torch.clamp(positions, 0, mc.n_positions - 1)
        return weights["wte"][tokens].to(mc.dtype) + \
            weights["wpe"][posc].to(mc.dtype)

    def _stack(self, weights, mc, hidden, k_pool, v_pool, tables, positions,
               valid, kv_limit):
        """All layers of `weights` over hidden [B, Tq, C], K/V into the
        pools [L, P, page, H, D]; returns the last boundary carry
        (residual_stream, (mlp_y, mlp_b))."""
        prev = (torch.zeros(hidden.shape, dtype=mc.dtype,
                            device=self.device),
                torch.zeros((mc.n_embd,), dtype=weights["wte"].dtype,
                            device=self.device))
        for i, lp in enumerate(weights["layers"]):
            hidden, prev = _block_paged(
                mc, lp, hidden, prev, k_pool[i], v_pool[i], tables,
                positions, valid, kv_limit, self.cache.page_size,
                self.config.weight_quant_block)
        return hidden, prev

    def _logits(self, weights, mc, resid, boundary):
        """ln_f (K3's ln_f form) and the tied head: [B, Tq, V] in the
        compute dtype. The head runs one GEMM per query position, each
        over the [B, C] rows a decode step gives it, so that a verify
        row sees the decode row's GEMM (the module docstring)."""
        mlp_y, mlp_b = boundary
        hidden = fused_bias_residual_layernorm(
            mlp_y, mlp_b, resid, *weights["ln_f"],
            eps=mc.layer_norm_epsilon, out_dtype=torch.float32,
            return_sum=False).to(mc.dtype)
        head = weights["wte_c"].t()
        return torch.stack([torch.matmul(hidden[:, j].contiguous(), head)
                            for j in range(hidden.shape[1])], dim=1)

    def _sample(self, logits):
        """Greedy, or temperature + top-k sampling, per slot on the
        device, from the engine's torch.Generator."""
        st = self._state
        l32 = logits.to(torch.float32)
        greedy = torch.argmax(l32, dim=-1)
        scaled = process_logits(l32, st["top_k"], st["temperature"],
                                self._top_k_cap)
        drawn = gumbel_argmax(scaled, self._gen)
        return torch.where(st["temperature"] > 0.0, drawn, greedy)

    @torch.no_grad()
    def _decode_step(self):
        """One token for every slot; enqueues only (no host sync).
        Returns the pre-sampling logits [max_slots, vocab]."""
        mc, st = self.model_config, self._state
        out_w = self.config.max_new_tokens
        active, pos = st["active"], st["pos"]
        hidden = self._embed(self._weights, st["cur_token"], pos)[:, None]
        resid, boundary = self._stack(
            self._weights, mc, hidden, st["k_pool"], st["v_pool"],
            st["tables"], pos[:, None], active[:, None], pos)
        logits = self._logits(self._weights, mc, resid, boundary)[:, 0]
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
        positions [start, start+len), in the draft's pool too when
        speculation is on (the draft attends over the whole committed
        prefix). Pages must already be ensured."""
        dev = self.device
        n = len(tokens)
        if n > self.config.prefill_chunk:
            raise ValueError(f"{n} tokens exceed inference.prefill_chunk="
                             f"{self.config.prefill_chunk}")
        ids = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        posv = torch.arange(start, start + n, device=dev)
        tables = torch.as_tensor(self.cache.tables[slot][None],
                                 dtype=torch.long, device=dev)
        valid = torch.ones((1, n), dtype=torch.bool, device=dev)
        kv_limit = torch.full((1,), start + n - 1, dtype=torch.long,
                              device=dev)
        st = self._state
        runs = [(self._weights, self.model_config, st["k_pool"],
                 st["v_pool"])]
        if self.speculative_enabled:
            sp = self._spec_state
            runs.append((self._draft, self._draft_config, sp["dk_pool"],
                         sp["dv_pool"]))
        for weights, mc, k_pool, v_pool in runs:
            hidden = self._embed(weights, ids, posv)[None]
            self._stack(weights, mc, hidden, k_pool, v_pool, tables,
                        posv[None], valid, kv_limit)

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
        if self.speculative_enabled:
            # a new request starts optimistic: k at its cap, a clean
            # acceptance EMA
            sp = self._spec_state
            sp["k_slot"][slot] = self.config.spec_k
            sp["acc_ema"][slot] = 1.0

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
    # the hot dispatch loops + the serving fence
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

    def spec_block(self, rounds):
        """Enqueue `rounds` speculative rounds back-to-back, each
        `spec_next_draft()` draft steps and ONE flagship verify, the
        acceptance decided on the device: no host sync, nothing read
        until `fetch_state`. The per-phase perf_counter spans are
        DISPATCH time (the work runs asynchronously and settles at the
        fence), the drafted-vs-verified split."""
        from deepspeed_tpu_torch.inference import speculative as spec
        nd = self._spec_next_draft
        for _ in range(rounds):
            t0 = time.perf_counter()
            for j in range(nd):
                spec.draft_step(self, j)
            t1 = time.perf_counter()
            spec.verify_step(self, nd)
            self._spec_draft_dispatch_s += t1 - t0
            self._spec_verify_dispatch_s += time.perf_counter() - t1

    def spec_next_draft(self):
        """Draft steps the next spec_block will dispatch per round (max
        live k_slot as of the last fence; the worst-case tokens a round
        commits is this + 1)."""
        return self._spec_next_draft

    def spec_dispatch_split(self):
        """Drain the accumulated (draft_s, verify_s) dispatch spans (host
        perf_counter, reset on read: one reader per fence)."""
        split = (self._spec_draft_dispatch_s, self._spec_verify_dispatch_s)
        self._spec_draft_dispatch_s = 0.0
        self._spec_verify_dispatch_s = 0.0
        return split

    def fetch_state(self):
        """THE serving fence: one device->host copy of the per-slot
        progress the scheduler needs (active flags, eos flags,
        positions, generated counts, output rings, and with speculation
        the round counters), packed into one tensor so the copy is one
        sync."""
        st = self._state
        s, w = self.config.max_slots, self.config.max_new_tokens
        parts = [st["active"].to(torch.long),
                 st["finished_eos"].to(torch.long), st["pos"], st["n_gen"],
                 st["out_tokens"].reshape(-1)]
        if self.speculative_enabled:
            sp = self._spec_state
            parts += [sp["k_slot"], sp["drafted_total"],
                      sp["accepted_total"], sp["verified_total"],
                      sp["rollbacks"], sp["rounds"].reshape(1)]
        host = torch.cat(parts).cpu().numpy()
        snap = {"active": host[:s].astype(bool),
                "finished_eos": host[s:2 * s].astype(bool),
                "pos": host[2 * s:3 * s].astype(np.int32),
                "n_gen": host[3 * s:4 * s].astype(np.int32),
                "out_tokens": host[4 * s:4 * s + s * w].reshape(
                    s, w).astype(np.int32)}
        if not self.speculative_enabled:
            return snap
        k_slot, drafted, accepted, verified, rollbacks = (
            host[4 * s + s * w + i * s:4 * s + s * w + (i + 1) * s].astype(
                np.int32) for i in range(5))
        if self.config.spec_adaptive:
            live = k_slot[snap["active"]]
            self._spec_next_draft = int(live.max()) if live.size \
                else self.config.spec_k
        snap["speculative"] = {"k_slot": k_slot, "drafted": drafted,
                               "accepted": accepted, "verified": verified,
                               "rollbacks": rollbacks,
                               "rounds": int(host[-1])}
        return snap
