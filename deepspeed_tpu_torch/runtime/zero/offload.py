"""ZeRO-Offload at data-parallel world size 1 (port of
deepspeed_tpu/runtime/zero/offload.py).

The fp32 master parameters and both Adam moments live in host RAM and
are stepped by the native CPU-Adam (`ops/adam/cpu_adam.py`, built from
`csrc/adam/cpu_adam.cpp`); the device holds only the compute-dtype
parameters and an fp32 gradient accumulator. One optimizer step:

  1. the device tail: unscale, the global norm, clipping, and the wire
     cast (bf16 when computing in bf16 or grad_bits=16), or the int8 /
     1-bit quantizers of the compressed wire;
  2. the norm read, the one host sync of the step: a non-finite norm is
     an overflow, and a skipped step leaves the masters, the param
     shadow and the 1-bit residual as they were;
  3. the chunk loop over 4M-element chunks: D2H of the wire chunk,
     CPU-Adam on it (the bf16 downcast fused into the same native pass),
     H2D of the new parameters.

On the card the loop is a pipeline. Each direction has a ring of pinned
host chunk buffers, allocated once, and a side stream of its own. D2H
copies are queued `non_blocking` on the D2H stream behind an event
recorded after the tail; the host waits on chunk i's copy event only,
steps chunk i while chunk i+1's D2H (queued when chunk i-1 finished)
and chunk i-1's H2D run on the copy engines, and queues chunk i's H2D
on the H2D stream. A pinned buffer is written again only after the
event of the copy that last read it. The training stream waits on the
last H2D's event before the next forward: a stream wait, not a host
sync. `_offload_ring` (default 2) is the ring's depth; 0 runs the serial
baseline the pipeline is measured against (blocking copies, chunk after
chunk, the path a CPU engine takes).

Layouts. The host flat (masters, moments, the wire) is in the JAX
package's `ravel_pytree` leaf order (the model's `params_to_jax` tree,
scanned layers stacked), so a `host_master` written by either package
loads in the other. The device parameters are views of one flat
compute-dtype buffer in the same order, each leaf's offset rounded up
to 64 elements: the kernels read LayerNorm's gamma/beta and GeLU's bias
with 16-byte vector loads, which an arbitrary offset would break. A
chunk's H2D is cut at the leaf edges into copies that land in the
parameters themselves. The gradient accumulator is one compact fp32
flat in host order (no kernel reads it), so a chunk of the wire is one
contiguous D2H.

The compressed wire (`zero_optimization.offload_wire`) is the JAX
package's: int8 gradients with one fp32 scale per 4096-element block,
1-bit signs with a per-block scale and on-device error feedback, int8
parameter deltas against a device fp32 copy with a host shadow (both
apply the same dequantized delta; here both sides are unfused torch
ops, so they stay bit-equal), and an uncompressed fp32 warm-up.
"""

import math
import time

import numpy as np
import torch

from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.fp16.onebit_adam import pack_signs
from deepspeed_tpu_torch.utils.logging import logger


def quantize_int8_blocks(x, block):
    """Symmetric int8 block quantization of a flat fp32 array or tensor:
    (q int8 [n], scales fp32 [ceil(n/block)]), scale = max-abs / 127 per
    block (the JAX package's numpy function, in torch ops on the same
    fp32 values; dequant is q * scales[i // block])."""
    t = torch.as_tensor(x)
    n = t.numel()
    full = n // block * block
    parts = [t[:full].view(-1, block).abs().amax(dim=1)]
    if full < n:
        parts.append(t[full:].abs().amax().reshape(1))
    s = torch.cat(parts) / 127.0
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.empty(n, dtype=torch.int8, device=t.device)
    if full:
        q[:full] = torch.clamp(torch.round(
            t[:full].view(-1, block) / safe[:full // block, None]),
            -127, 127).to(torch.int8).reshape(-1)
    if full < n:
        q[full:] = torch.clamp(torch.round(t[full:] / safe[-1]),
                               -127, 127).to(torch.int8)
    return q, s


def dequantize_int8_blocks(q, s, block):
    """q * scales[i // block] in fp32."""
    return q.to(torch.float32) * torch.repeat_interleave(s, block)[:q.numel()]


def _host(x):
    """A checkpoint value (CPU tensor, numpy array or number) as numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _np(t):
    """numpy view of a CPU tensor (bf16 as its uint16 storage)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        return t.numpy().view(np.uint16)
    return t.numpy()


class ZeroOffloadMixin:
    """The offload half of DeepSpeedEngine (see the module docstring)."""

    # 16 MB of fp32 a chunk: D2H(i+1) / CPU-Adam(i) / H2D(i-1) overlap
    # only if a chunk is small next to the model (the JAX package's cap)
    _OFFLOAD_CHUNK_ELEMS = 4 << 20
    # elements per quantization scale; a multiple of 8, so the 1-bit
    # payload's chunk slices stay byte-aligned
    _OFFLOAD_WIRE_BLOCK = 4096
    # device parameter offsets are multiples of this (256 bytes of fp32)
    _OFFLOAD_DEVICE_ALIGN = 64
    # pinned chunk buffers per direction on the card; 0: the serial
    # baseline (blocking copies, nothing overlapped)
    _offload_ring = 2
    # record the host chunk ranges on the device clock (offload_trace)
    _offload_trace = False

    def _offload_enabled(self):
        return bool(self._config.zero_enabled and
                    self._config.zero_cpu_offload)

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------
    def _offload_host_order(self, names):
        """Parameter names in the JAX tree's ravel order (the model's
        `params_to_jax` tree, dict keys sorted, scanned layers stacked);
        the dict's order for a model without that converter."""
        to_jax = getattr(self.module, "params_to_jax", None)
        if to_jax is None:
            return list(names)
        tree = to_jax({n: n for n in names}, remat=self._remat(),
                      stack=ckpt_io.Stacked)
        order = []
        for _, leaf in ckpt_io.tree_to_entries(tree):
            order += list(leaf) if isinstance(leaf, ckpt_io.Stacked) \
                else [leaf]
        if sorted(order) != sorted(names):
            raise ValueError("params_to_jax does not cover the parameters "
                             "exactly once")
        return order

    def _init_offload(self, initial):
        """Host masters, CPU-Adam, the host loss scaler, the device
        parameter and accumulator flats, the wire state. `initial`:
        {name: tensor} in the engine's order. Returns (params {name:
        device view}, [accumulator view per parameter])."""
        from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
        from deepspeed_tpu_torch.runtime.fp16.loss_scaler import \
            CreateLossScaler
        names = list(initial)
        order = self._offload_host_order(names)
        shapes = {n: tuple(initial[n].shape) for n in names}
        align = self._OFFLOAD_DEVICE_ALIGN
        host_off, dev_off = {}, {}
        h = d = 0
        for name in order:
            k = math.prod(shapes[name])
            host_off[name], dev_off[name] = h, d
            h += k
            d += -(-k // align) * align
        n, n_dev = h, d
        self._offload_order = order
        self._offload_host_off = host_off
        self._offload_shapes = shapes
        self._host_master = np.empty(n, np.float32)
        for name in names:
            k = math.prod(shapes[name])
            src = torch.as_tensor(initial[name]).detach()
            self._host_master[host_off[name]:host_off[name] + k] = \
                src.to("cpu", torch.float32).reshape(-1).numpy()
        dev = self.device
        self._offload_param_flat = torch.zeros(n_dev, dtype=self.compute_dtype,
                                               device=dev)
        self._offload_acc = torch.zeros(n, dtype=torch.float32, device=dev)
        params, acc = {}, []
        for name in names:
            k = math.prod(shapes[name])
            view = self._offload_param_flat[dev_off[name]:dev_off[name] + k]
            params[name] = view.view(shapes[name])
            acc.append(self._offload_acc[host_off[name]:host_off[name] + k]
                       .view(shapes[name]))
        # host leaf runs [(host lo, host hi, device offset)] in host order
        self._offload_runs = [(host_off[m], host_off[m] + math.prod(shapes[m]),
                               dev_off[m]) for m in order]
        self._offload_push_masters()
        for p in params.values():
            p.requires_grad_(True)

        p = dict(self._config.optimizer_params or {})
        betas = p.get("betas", (0.9, 0.999))
        self._host_adam = DeepSpeedCPUAdam(
            n, lr=p.get("lr", 1e-3), betas=betas, eps=p.get("eps", 1e-8),
            weight_decay=p.get("weight_decay", 0.0),
            adamw_mode=p.get("adam_w_mode", True) or
            (self._config.optimizer_name or "").lower() == C.ADAMW_OPTIMIZER)
        self._host_scaler = CreateLossScaler(
            dtype_fp16=self.fp16_mode,
            static_loss_scale=self._config.loss_scale,
            dynamic_scaling=self.dynamic_loss_scale_enabled,
            dynamic_loss_args=self.dynamic_loss_scale_args())
        self._offload_last_norm = None
        self.offload_timing = {}
        self._offload_pinned = None
        self._init_offload_wire(n)
        # memory ledger: offload MOVES the masters and the moments to
        # host RAM — the ledger's host space is where its whole memory
        # argument lives. The device parameters are views of one flat
        # buffer: the engine registers the views (as `params`) and not
        # the buffer, so each byte counts once.
        from deepspeed_tpu_torch.monitor import memory as _mem
        led = self.monitor.ledger
        led.register(_mem.CAT_HOST_MASTER, "offload.host_master",
                     self._host_master.nbytes, space=_mem.SPACE_HOST)
        # CPU-Adam moments: exp_avg + exp_avg_sq, fp32, one per element
        led.register(_mem.CAT_HOST_OPT, "offload.adam_moments",
                     2 * n * 4, space=_mem.SPACE_HOST)
        logger.info(
            f"ZeRO-Offload: {n / 1e6:.1f}M fp32 masters + moments on host "
            f"(native cpu_adam={self._host_adam.native}, wire grad_bits="
            f"{self._wire_grad_bits} param_bits={self._wire_param_bits})")
        return params, acc

    def _offload_bounds(self, n, align=1):
        """[(lo, hi)] chunks of at most ~4M elements over [0, n); with
        `align`, interior edges on multiples of it (the quantized wires
        slice their per-block scales by absolute offset)."""
        k = max(1, -(-n // self._OFFLOAD_CHUNK_ELEMS))
        edges = np.linspace(0, n, k + 1).astype(np.int64)
        if align > 1:
            edges = (edges // align) * align
            edges[-1] = n
        return [(int(edges[i]), int(edges[i + 1])) for i in range(k)
                if edges[i + 1] > edges[i]]

    def _init_offload_wire(self, n):
        zc = self._config.zero_config
        self._wire_grad_bits = zc.offload_wire_grad_bits
        self._wire_param_bits = zc.offload_wire_param_bits
        self._wire_warmup = zc.offload_wire_warmup_steps
        self._offload_wire_steps = 0
        self.wire_stats = {}
        B = self._OFFLOAD_WIRE_BLOCK
        align = B if self._wire_grad_bits in (1, 8) else 1
        self._offload_bounds_cached = self._offload_bounds(n, align)
        self._offload_pieces = [self._pieces(lo, hi) for lo, hi in
                                self._offload_bounds_cached]
        self._offload_grad_residual = None
        self._offload_param_shadow = None
        self._offload_device_flat = None
        from deepspeed_tpu_torch.monitor import memory as _mem
        led = self.monitor.ledger
        if self._wire_grad_bits == 1:
            # the error-feedback residual, padded to whole scale blocks
            self._offload_grad_residual = torch.zeros(
                -(-n // B) * B, dtype=torch.float32, device=self.device)
            led.register_tree(_mem.CAT_WIRE, "offload.grad_residual",
                              self._offload_grad_residual)
        if self._wire_param_bits == 8:
            # the host shadow tracks the device fp32 copy: both apply
            # the same dequantized deltas
            self._offload_param_shadow = self._host_master.copy()
            self._offload_device_flat = torch.from_numpy(
                self._host_master).to(self.device, copy=True)
            led.register(_mem.CAT_WIRE, "offload.param_shadow",
                         self._offload_param_shadow.nbytes,
                         space=_mem.SPACE_HOST)
            # the device fp32 flat copy is the int8 wire's 4 B/param
            # device cost
            led.register_tree(_mem.CAT_WIRE, "offload.device_flat",
                              self._offload_device_flat)

    def _pieces(self, lo, hi):
        """[(a, b, device offset)]: chunk [lo, hi)'s elements [a, b) land
        at the device flat's offset (the leaf runs cut by the chunk)."""
        out = []
        for h0, h1, d in self._offload_runs:
            a, b = max(lo, h0), min(hi, h1)
            if a < b:
                out.append((a - lo, b - lo, d + a - h0))
        return out

    @torch.no_grad()
    def _offload_push_masters(self):
        """Every device parameter from the host masters (set-up and
        checkpoint loads; the step pushes by chunk)."""
        host = torch.from_numpy(self._host_master)
        for h0, h1, d in self._offload_runs:
            self._offload_param_flat[d:d + h1 - h0].copy_(host[h0:h1])

    def _offload_views(self, flat=None):
        """{name: fp32 CPU tensor}: views of a host-order flat (default:
        the host masters)."""
        host = torch.from_numpy(self._host_master if flat is None else flat)
        return {n: host[o:o + math.prod(self._offload_shapes[n])]
                .view(self._offload_shapes[n])
                for n, o in self._offload_host_off.items()}

    # ------------------------------------------------------------------
    # the device tails
    # ------------------------------------------------------------------
    def _offload_unscale_clip(self, loss_scale):
        """The accumulator, unscaled and clipped in place, and the global
        norm (a device scalar)."""
        flat = self._offload_acc
        if self.fp16_mode:
            flat.div_(loss_scale)
        norm = torch.sqrt(torch.dot(flat, flat))
        clip = self.gradient_clipping()
        if clip and clip > 0:
            factor = torch.clamp(clip / (norm + 1e-6), max=1.0)
            factor = torch.where(torch.isfinite(factor), factor,
                                 torch.ones_like(factor))
            flat.mul_(factor)
        return flat, norm

    def _offload_grad_tail(self, loss_scale):
        """Native wire: bf16 on the wire when computing in bf16 or at
        grad_bits=16 (the host widens it), else fp32."""
        flat, norm = self._offload_unscale_clip(loss_scale)
        if self.compute_dtype == torch.bfloat16 or self._wire_grad_bits == 16:
            flat = flat.to(torch.bfloat16)
        return flat, norm

    def _offload_grad_tail_q8(self, loss_scale):
        flat, norm = self._offload_unscale_clip(loss_scale)
        q, scale = quantize_int8_blocks(flat, self._OFFLOAD_WIRE_BLOCK)
        return q, scale, norm

    def _offload_grad_tail_q1(self, loss_scale):
        """Signs and per-block mean-abs scales of grad + residual, and the
        new residual, which the caller commits only on a clean step. The
        pad lanes past n are masked out of the residual and the last
        block's scale: they never cross the wire."""
        B = self._OFFLOAD_WIRE_BLOCK
        flat, norm = self._offload_unscale_clip(loss_scale)
        n = flat.numel()
        corrected = self._offload_grad_residual.clone()
        corrected[:n] += flat
        corrected[n:] = 0.0
        blocks = corrected.view(-1, B)
        count = torch.full((blocks.shape[0],), float(B),
                           dtype=torch.float32, device=flat.device)
        # a slice's fill_ takes the number as a kernel argument; an
        # element assignment would copy it from the host and wait
        count[-1:].fill_(n - (blocks.shape[0] - 1) * B)
        # the block sums accumulate in fp64 and round once: within an
        # ulp of the JAX package's fp32 sums wherever those are
        scale = blocks.abs().sum(dim=1, dtype=torch.float64).to(
            torch.float32) / count
        signs = torch.where(blocks >= 0, 1.0, -1.0)
        new_res = (blocks - scale[:, None] * signs).reshape(-1)
        new_res[n:] = 0.0
        packed = pack_signs(corrected)[:-(-n // 8)]
        return packed, scale, norm, new_res

    # ------------------------------------------------------------------
    # checkpoint state
    # ------------------------------------------------------------------
    def _offload_checkpoint_snapshot(self, isolate=True):
        """Copies (isolate) or live references of what the next host step
        mutates in place: the masters, the moments and step, the wire
        state."""
        master = self._host_master.copy() if isolate else self._host_master
        sd = self._host_adam.state_dict()
        adam = {"exp_avg": sd["exp_avg"].copy() if isolate
                else sd["exp_avg"],
                "exp_avg_sq": sd["exp_avg_sq"].copy() if isolate
                else sd["exp_avg_sq"],
                "step": np.asarray(sd["step"], np.int64)}
        snap = {"host_master": master, "host_adam": adam}
        if self._config.zero_config.offload_wire_compressed():
            snap["offload_wire"] = self._offload_wire_state_dict()
        return snap

    def _offload_wire_state_dict(self):
        """The error-feedback residual and the param shadow (the device
        fp32 copy is the shadow's mirror, rebuilt from it on load)."""
        d = {"wire_steps": np.asarray(self._offload_wire_steps, np.int64)}
        if self._offload_grad_residual is not None:
            d["grad_residual"] = self._offload_grad_residual.cpu().numpy()
        if self._offload_param_shadow is not None:
            d["param_shadow"] = self._offload_param_shadow.copy()
        return d

    def _offload_wire_load_state_dict(self, sd):
        """Restore the wire state; a checkpoint without it (or from
        another wire config) restarts the error feedback from zero and
        resyncs the shadow to the restored masters, as in JAX."""
        if self._offload_grad_residual is not None:
            res = None if not sd else sd.get("grad_residual")
            if res is not None and tuple(np.shape(res)) == \
                    tuple(self._offload_grad_residual.shape):
                self._offload_grad_residual.copy_(torch.as_tensor(
                    np.asarray(res, np.float32)))
            else:
                self._offload_grad_residual.zero_()
        if self._offload_param_shadow is not None:
            shadow = None if not sd else sd.get("param_shadow")
            if shadow is not None and np.shape(shadow) == \
                    self._offload_param_shadow.shape:
                self._offload_param_shadow[:] = shadow
            else:
                self._offload_param_shadow[:] = self._host_master
            self._offload_device_flat.copy_(
                torch.from_numpy(self._offload_param_shadow))
        if sd:
            self._offload_wire_steps = int(np.asarray(sd.get("wire_steps",
                                                             0)))

    def _offload_load_state(self, optim_sd):
        """Restore the masters, the moments and step, the loss scale and
        the wire state from a checkpoint's optimizer half: the entries
        under aux/ (this package's writer) or the JSON metadata (where
        the JAX writer puts host_adam and offload_wire)."""
        aux = optim_sd.get("aux_flat") or {}

        def saved_dict(name):
            prefix = f"aux/{name}['"
            got = {k[len(prefix):-2]: _host(v) for k, v in aux.items()
                   if k.startswith(prefix)}
            return got or optim_sd.get(name)

        if "aux/host_master" not in aux:
            logger.warning(
                "checkpoint has no host-offload optimizer state (saved "
                "without cpu_offload?); masters restored from module "
                "weights, Adam moments reset")
            return
        self._host_master[:] = _host(aux["aux/host_master"])
        self._host_adam.load_state_dict(saved_dict("host_adam"))
        if "aux/scale.loss_scale" in aux:
            self._host_scaler.cur_scale = float(
                _host(aux["aux/scale.loss_scale"]))
            if self.fp16_mode:
                self._offload_set_scale(self._host_scaler.cur_scale)
        if self._config.zero_config.offload_wire_compressed():
            self._offload_wire_load_state_dict(saved_dict("offload_wire"))

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _offload_in_warmup(self):
        return (self._wire_warmup > 0 and
                self._offload_wire_steps < self._wire_warmup)

    @torch.no_grad()
    def _offload_take_step(self, lr):
        """The device tail, the norm read, CPU-Adam over the chunks and
        the new parameters back. Returns True when the step overflowed
        (and was skipped)."""
        t0 = time.perf_counter()
        B = self._OFFLOAD_WIRE_BLOCK
        warm = self._offload_in_warmup() and (
            self._wire_grad_bits in (1, 8, 16) or self._wire_param_bits == 8)
        g_mode = self._wire_grad_bits \
            if self._wire_grad_bits in (1, 8) and not warm else 0
        p_mode = 8 if self._wire_param_bits == 8 else 0
        loss_scale = self.state.scale.loss_scale

        new_res = scales = None
        if g_mode == 1:
            wire, scales, norm, new_res = \
                self._offload_grad_tail_q1(loss_scale)
        elif g_mode == 8:
            wire, scales, norm = self._offload_grad_tail_q8(loss_scale)
        elif warm and self._wire_grad_bits in (1, 8, 16):
            wire, norm = self._offload_unscale_clip(loss_scale)
        else:
            wire, norm = self._offload_grad_tail(loss_scale)
        t1 = time.perf_counter()
        # the one host sync of the step
        norm_host = float(norm)
        t2 = time.perf_counter()
        # the norm is on the host already: it feeds the monitor's
        # grad_norm and the stall diagnosis for free
        self._offload_last_norm = norm_host
        self.monitor.heartbeat("offload")
        overflow = not math.isfinite(norm_host)
        self._host_scaler.update_scale(overflow)
        if self.fp16_mode:
            self._offload_set_scale(self._host_scaler.cur_scale)
        if overflow:
            # masters, shadow and residual untouched; the residual
            # computed above is dropped
            self._offload_acc.zero_()
            self.state.skipped.add_(1)
            self.offload_timing = {"overflow": True,
                                   "tail_ms": (t1 - t0) * 1e3,
                                   "norm_wait_ms": (t2 - t1) * 1e3}
            self.monitor.subsystem_span(
                "offload", "host_step (overflow skip)", t0,
                time.perf_counter() - t0)
            return True
        if new_res is not None:
            self._offload_grad_residual.copy_(new_res)

        bounds = self._offload_bounds_cached
        if g_mode == 1:
            chunks = [wire[lo // 8: -(-hi // 8)] for lo, hi in bounds]
        else:
            chunks = [wire[lo:hi] for lo, hi in bounds]
        d2h_bytes = wire.numel() * wire.element_size() + \
            (scales.numel() * 4 if scales is not None else 0)
        bf16_out = p_mode == 0 and self.compute_dtype == torch.bfloat16
        if self.device.type == "cuda" and self._offload_ring > 0:
            h2d_bytes, split = self._offload_pipeline(
                chunks, scales, p_mode, warm, bf16_out, lr)
        else:
            h2d_bytes, split = self._offload_serial(
                chunks, scales, p_mode, warm, bf16_out, lr)
        self._offload_acc.zero_()
        self.state.global_steps.add_(1)
        self._offload_wire_steps += 1
        n = self._host_master.size
        native_elem = 2 if self.compute_dtype == torch.bfloat16 else 4
        self.wire_stats = {
            "grad_bits": self._wire_grad_bits,
            "param_bits": self._wire_param_bits,
            "warmup": bool(warm),
            "d2h_bytes": int(d2h_bytes),
            "h2d_bytes": int(h2d_bytes),
            "d2h_bytes_native": int(n * native_elem),
            "h2d_bytes_native": int(n * native_elem),
        }
        t3 = time.perf_counter()
        # norm_at / done_at: perf_counter seconds, for a caller's split
        self.offload_timing = dict(
            overflow=False, chunks=len(bounds), ring=self._offload_ring,
            tail_ms=(t1 - t0) * 1e3, norm_wait_ms=(t2 - t1) * 1e3,
            host_step_ms=(t3 - t0) * 1e3, norm_at=t2, done_at=t3, **split)
        # the host step gets its own Perfetto track: D2H + chunked
        # CPU-Adam + H2D as one slice
        self.monitor.subsystem_span(
            "offload", "host_step", t0, t3 - t0,
            args={"d2h_bytes": int(d2h_bytes), "h2d_bytes": int(h2d_bytes)})
        return False

    def _offload_set_scale(self, scale):
        """The fp16 loss scale the next micro batches multiply by (a
        non-blocking copy from pinned memory on the card)."""
        dest = self.state.scale.loss_scale
        if dest.is_cuda:
            if getattr(self, "_offload_scale_pin", None) is None:
                self._offload_scale_pin = torch.empty(
                    (), dtype=torch.float32, pin_memory=True)
            # the last copy from this buffer finished before the norm read
            self._offload_scale_pin.fill_(float(scale))
            dest.copy_(self._offload_scale_pin, non_blocking=True)
        else:
            dest.fill_(float(scale))

    def _offload_host_chunk(self, lo, hi, wire_c, g_scales, p_mode, warm,
                            bf16_out, lr, out):
        """CPU-Adam on the chunk [lo, hi), given its wire chunk (a CPU
        tensor) and the host scales; writes what goes back into the CPU
        tensors of `out` ("bf16", "f32", "q", "s") and returns the H2D
        bytes."""
        B = self._OFFLOAD_WIRE_BLOCK
        m = hi - lo
        mchunk = self._host_master[lo:hi]
        adam = self._host_adam
        b16 = _np(out["bf16"][:m]) if bf16_out else None
        with torch.profiler.record_function("offload.cpu_adam"):
            if wire_c.dtype == torch.uint8:
                adam.step_chunk_q1(lo, hi, mchunk, _np(wire_c),
                                   g_scales[lo // B: -(-hi // B)], B, lr=lr,
                                   params_bf16_out=b16)
            elif wire_c.dtype == torch.int8:
                adam.step_chunk_q8(lo, hi, mchunk, _np(wire_c),
                                   g_scales[lo // B: -(-hi // B)], B, lr=lr,
                                   params_bf16_out=b16)
            else:
                g = wire_c if wire_c.dtype == torch.float32 else \
                    wire_c.to(torch.float32)
                adam.step_chunk(lo, hi, mchunk, _np(g), lr=lr,
                                params_bf16_out=b16)
        if p_mode == 8 and not warm:
            # int8 delta against the shadow; the dequantized delta goes
            # into the shadow, so its error feeds the next delta
            shadow = torch.from_numpy(self._offload_param_shadow[lo:hi])
            q, s = quantize_int8_blocks(torch.from_numpy(mchunk) - shadow, B)
            shadow += dequantize_int8_blocks(q, s, B)
            out["q"][:m].copy_(q)
            out["s"][:s.numel()].copy_(s)
            return m + s.numel() * 4
        if p_mode == 8:
            # warm-up: a full-precision sync keeps shadow == device copy
            self._offload_param_shadow[lo:hi] = mchunk
        if bf16_out:
            return m * 2
        out["f32"][:m].copy_(torch.from_numpy(mchunk))
        return m * 4

    def _offload_device_chunk(self, i, lo, hi, p_mode, warm, bf16_out, src,
                              stage, non_blocking=True):
        """The device half of chunk i's return: `src` holds what the host
        wrote (CPU tensors; pinned on the card's pipeline) and `stage`
        device buffers of the chunk's size for it. The H2D copies go to
        the parameters directly (bf16 native wire) or through `stage`."""
        B = self._OFFLOAD_WIRE_BLOCK
        m = hi - lo
        nb = -(-m // B)
        nbk = dict(non_blocking=non_blocking)
        flat = self._offload_param_flat
        if p_mode == 8 and not warm:
            q = stage["q"][:m]
            s = stage["s"][:nb]
            q.copy_(src["q"][:m], **nbk)
            s.copy_(src["s"][:nb], **nbk)
            dev = self._offload_device_flat[lo:hi]
            dev += dequantize_int8_blocks(q, s, B)
            data = dev
        elif p_mode == 8:
            dev = self._offload_device_flat[lo:hi]
            dev.copy_(src["f32"][:m], **nbk)
            data = dev
        elif bf16_out:
            data = src["bf16"][:m]
        else:
            data = stage["f32"][:m]
            data.copy_(src["f32"][:m], **nbk)
        for a, b, d in self._offload_pieces[i]:
            flat[d:d + b - a].copy_(data[a:b], **nbk)

    def _offload_buffers(self, m, device, pin):
        """A chunk's buffers: "bf16", "f32", "q", "s" (and "in", the raw
        bytes of a wire chunk) for `m` elements."""
        nb = -(-m // self._OFFLOAD_WIRE_BLOCK)
        kw = dict(device=device, pin_memory=pin)
        return {"in": torch.empty(m * 4, dtype=torch.uint8, **kw),
                "bf16": torch.empty(m, dtype=torch.bfloat16, **kw),
                "f32": torch.empty(m, dtype=torch.float32, **kw),
                "q": torch.empty(m, dtype=torch.int8, **kw),
                "s": torch.empty(nb, dtype=torch.float32, **kw)}

    def _offload_serial(self, chunks, scales, p_mode, warm, bf16_out, lr):
        """The chunk loop with nothing overlapped: a CPU engine's, and
        the card's serial baseline (`_offload_ring` 0: each chunk's D2H,
        host step and H2D one after another, blocking copies)."""
        bounds = self._offload_bounds_cached
        g_scales = scales.cpu().numpy() if scales is not None else None
        m_max = max(hi - lo for lo, hi in bounds)
        out = self._offload_buffers(m_max, "cpu", False)
        on_card = self.device.type == "cuda"
        stage = self._offload_buffers(m_max, self.device, False) \
            if on_card else out
        self._host_adam.begin_step()
        h2d = 0
        t0 = time.perf_counter()
        for i, ((lo, hi), c) in enumerate(zip(bounds, chunks)):
            h2d += self._offload_host_chunk(
                lo, hi, c.to("cpu") if on_card else c.contiguous(),
                g_scales, p_mode, warm, bf16_out, lr, out)
            self._offload_device_chunk(i, lo, hi, p_mode, warm, bf16_out,
                                       out, stage, non_blocking=False)
        if on_card:
            torch.cuda.current_stream(self.device).synchronize()
        return h2d, {"host_loop_ms": (time.perf_counter() - t0) * 1e3}

    def _offload_pipeline(self, chunks, scales, p_mode, warm, bf16_out, lr):
        """The chunk loop on the card (module docstring): pinned rings,
        a D2H and an H2D side stream, per-chunk events."""
        dev = self.device
        bounds = self._offload_bounds_cached
        k = len(bounds)
        ring = max(1, int(self._offload_ring))
        m_max = max(hi - lo for lo, hi in bounds)
        pinned = self._offload_pinned
        if pinned is None or len(pinned["in"]) < ring:
            # allocated once: pinning at every step would cost seconds
            # at the flagship's size; a failed pin raises
            pinned = self._offload_pinned = {
                "in": [self._offload_buffers(m_max, "cpu", True)
                       for _ in range(ring)],
                "out": [self._offload_buffers(m_max, "cpu", True)
                        for _ in range(ring)],
                "stage": [self._offload_buffers(m_max, dev, False)
                          for _ in range(ring)],
                "d2h": torch.cuda.Stream(dev), "h2d": torch.cuda.Stream(dev),
                # an idle stream: an event recorded on it is stamped
                # when the host records it (offload_trace's clock)
                "clock": torch.cuda.Stream(dev),
                "scales": torch.empty(
                    -(-self._host_master.size // self._OFFLOAD_WIRE_BLOCK),
                    dtype=torch.float32, pin_memory=True)}
        d2h, h2d = pinned["d2h"], pinned["h2d"]
        cur = torch.cuda.current_stream(dev)
        tail = torch.cuda.Event()
        tail.record(cur)
        d2h.wait_event(tail)
        h2d.wait_event(tail)
        wire = chunks[0]._base if chunks[0]._base is not None else chunks[0]
        wire.record_stream(d2h)
        g_scales = None
        if scales is not None:
            hs = pinned["scales"][:scales.numel()]
            with torch.cuda.stream(d2h):
                hs.copy_(scales, non_blocking=True)
                scales.record_stream(d2h)
            g_scales = hs.numpy()
        timed = []      # (kind, chunk, start event, end event)
        d2h_done = [None] * k
        h2d_done = [None] * k
        host_in = [None] * k

        def issue_d2h(i):
            buf = pinned["in"][i % ring]["in"]
            c = chunks[i]
            dst = buf[:c.numel() * c.element_size()].view(c.dtype)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            with torch.cuda.stream(d2h):
                start.record(d2h)
                dst.copy_(c, non_blocking=True)
                end.record(d2h)
            timed.append(("d2h", i, start, end))
            d2h_done[i], host_in[i] = end, dst

        def mark():
            if not self._offload_trace:
                return None
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(pinned["clock"])
            return ev

        origin = mark()
        for i in range(min(ring, k)):
            issue_d2h(i)
        self._host_adam.begin_step()
        h2d_bytes = 0
        wait_s = adam_s = 0.0
        host_ranges, marks = [], []
        t_loop = time.perf_counter()
        for i, (lo, hi) in enumerate(bounds):
            slot = i % ring
            t = time.perf_counter()
            d2h_done[i].synchronize()
            if i >= ring:
                # the out buffer's last H2D has read it
                h2d_done[i - ring].synchronize()
            t_a = time.perf_counter()
            wait_s += t_a - t
            m_a = mark()
            h2d_bytes += self._offload_host_chunk(
                lo, hi, host_in[i], g_scales, p_mode, warm, bf16_out, lr,
                pinned["out"][slot])
            marks.append((m_a, mark()))
            t_b = time.perf_counter()
            adam_s += t_b - t_a
            host_ranges.append((t_a, t_b))
            host_in[i] = None
            if i + ring < k:
                issue_d2h(i + ring)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            with torch.cuda.stream(h2d):
                start.record(h2d)
                self._offload_device_chunk(i, lo, hi, p_mode, warm,
                                           bf16_out, pinned["out"][slot],
                                           pinned["stage"][slot])
                end.record(h2d)
            timed.append(("h2d", i, start, end))
            h2d_done[i] = end
        loop_s = time.perf_counter() - t_loop
        # the next forward waits for the last H2D: a stream wait
        cur.wait_event(h2d_done[-1])
        self._offload_timed = timed
        self._offload_marks = (origin, marks)
        return h2d_bytes, {"host_loop_ms": loop_s * 1e3,
                           "host_chunks_ms": adam_s * 1e3,
                           "copy_wait_ms": wait_s * 1e3,
                           "host_chunk_ms": [(b - a) * 1e3
                                             for a, b in host_ranges]}

    def offload_copy_ms(self):
        """{"d2h_ms", "h2d_ms"}: the device time of the last pipelined
        step's D2H and H2D copies (CUDA events; waits for them)."""
        out = {"d2h_ms": 0.0, "h2d_ms": 0.0}
        for kind, _, start, end in getattr(self, "_offload_timed", []):
            end.synchronize()
            out[kind + "_ms"] += start.elapsed_time(end)
        return out

    def offload_trace(self):
        """The last pipelined step's timeline on the device clock, in ms
        from the loop's start: {"host": [(start, end)] per chunk's host
        step, "d2h": {chunk: (start, end)}, "h2d": {...}}. Needs
        `_offload_trace` set before the step."""
        origin, marks = self._offload_marks
        if origin is None:
            raise RuntimeError("set _offload_trace before the step")
        torch.cuda.synchronize(self.device)
        out = {"host": [(origin.elapsed_time(a), origin.elapsed_time(b))
                        for a, b in marks], "d2h": {}, "h2d": {}}
        for kind, i, start, end in self._offload_timed:
            out[kind][i] = (origin.elapsed_time(start),
                            origin.elapsed_time(end))
        return out

    @property
    def fp32_params(self):
        """The fp32 parameters {name: tensor}: under offload a copy of the
        host masters (the next step mutates them in place)."""
        if self._offload_enabled():
            return {n: v.clone() for n, v in
                    self._offload_views().items()}
        if self.mixed_precision:
            return {n: m.detach() for n, m in
                    zip(self.state.params, self.state.master)}
        return {n: p.detach() for n, p in self.state.params.items()}
