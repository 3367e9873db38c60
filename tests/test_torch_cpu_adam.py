"""PyTorch port: DeepSpeedCPUAdam (deepspeed_tpu_torch/ops/adam/) against
the JAX package's.

Both packages compile the repository's csrc/adam/cpu_adam.cpp with g++
and the same flags (the port's ops/_build.py `host_library`, the JAX
package's op_builder), so on the same flat fp32 inputs the port's native
step equals the JAX package's bit for bit: parameters, both moments and
the fused bf16 output, over 3 steps of `step`, of `step_chunk` (several
chunks against one whole), of `step_chunk_q8` and of `step_chunk_q1`,
in AdamW and L2 mode with weight decay. Inputs come from numpy seeds.

The port's plain twin (torch ops, `use_native=False`) is held to the
native library within 1e-6 relative of the largest value (the library
may fuse a multiply-add where the twin rounds twice); its bf16 output
is the twin's parameters rounded to nearest even. Also: a state_dict
round trip, and that a failed build raises instead of falling back to
the twin.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JAdam
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam import cpu_adam as tca
from torch_one_thread import one_torch_thread  # noqa: F401

N = 10_000 + 37          # not a multiple of the block or of 8
BLOCK = 4096
TWIN_TOL = 1e-6


def _inputs(seed, steps=3):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(N).astype(np.float32)
    grads = [rng.standard_normal(N).astype(np.float32) * 0.1
             for _ in range(steps)]
    return p, grads


def _pair(adamw, wd, native=True):
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=wd,
              adamw_mode=adamw)
    return DeepSpeedCPUAdam(N, use_native=native, **kw), JAdam(N, **kw)


def _state(opt, p, out):
    return (p, opt.exp_avg, opt.exp_avg_sq, out)


def _assert_bits(a, b):
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("adamw,wd", [(True, 0.0), (True, 0.01),
                                      (False, 0.01)],
                         ids=["adamw", "adamw_wd", "l2"])
def test_native_step_bit_equal_to_jax(adamw, wd):
    mine, ref = _pair(adamw, wd)
    assert mine.native and ref.native
    p0, grads = _inputs(1)
    pm, pr = p0.copy(), p0.copy()
    om, orf = np.empty(N, np.uint16), np.empty(N, np.uint16)
    for g in grads:
        mine.step(pm, g, params_bf16_out=om)
        ref.step(pr, g, params_bf16_out=orf)
    assert mine.step_count == ref.step_count == 3
    _assert_bits(_state(mine, pm, om), _state(ref, pr, orf))


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("adamw,wd", [(True, 0.01), (False, 0.01)],
                         ids=["adamw_wd", "l2"])
def test_chunked_steps_bit_equal_to_jax_and_to_whole(adamw, wd, tensors):
    """Three chunks per step (the offload driver's loop, lr per call)
    against the JAX package's chunks and against one whole chunk; the
    port's buffers as numpy arrays or as CPU tensors."""
    mine, ref = _pair(adamw, wd)
    whole, _ = _pair(adamw, wd)
    p0, grads = _inputs(2)
    pm, pr, pw = p0.copy(), p0.copy(), p0.copy()
    om, orf, ow = (np.empty(N, np.uint16) for _ in range(3))
    edges = [0, 3001, 7777, N]
    for step, g in enumerate(grads):
        lr = 1e-2 / (step + 1)
        for opt in (mine, ref, whole):
            opt.begin_step()
        for lo, hi in zip(edges[:-1], edges[1:]):
            a, b = pm[lo:hi], g[lo:hi]
            out = om[lo:hi]
            if tensors:
                a, b = torch.from_numpy(a), torch.from_numpy(b)
                out = torch.from_numpy(out.view(np.int16)).view(
                    torch.bfloat16)
            mine.step_chunk(lo, hi, a, b, lr=lr, params_bf16_out=out)
            ref.step_chunk(lo, hi, pr[lo:hi], g[lo:hi], lr=lr,
                           params_bf16_out=orf[lo:hi])
        whole.step_chunk(0, N, pw, g, lr=lr, params_bf16_out=ow)
    _assert_bits(_state(mine, pm, om), _state(ref, pr, orf))
    _assert_bits(_state(mine, pm, om), _state(whole, pw, ow))


def _q8(g):
    from deepspeed_tpu.runtime.zero.offload import quantize_int8_blocks
    return quantize_int8_blocks(g, BLOCK)


def _q1(g):
    from deepspeed_tpu_torch.runtime.fp16.onebit_adam import pack_signs
    nb = -(-N // BLOCK)
    pad = np.zeros(nb * BLOCK, np.float32)
    pad[:N] = g
    s = np.abs(pad.reshape(nb, BLOCK)).mean(axis=1).astype(np.float32)
    packed = pack_signs(torch.from_numpy(g)).numpy()
    return packed, s


@pytest.mark.parametrize("wire", ["q8", "q1"])
@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "l2"])
def test_quantized_chunk_steps_bit_equal_to_jax(wire, adamw):
    """step_chunk_q8 / step_chunk_q1 over two block-aligned chunks, the
    bf16 output fused, against the JAX package's."""
    mine, ref = _pair(adamw, 0.01)
    p0, grads = _inputs(3)
    pm, pr = p0.copy(), p0.copy()
    om, orf = np.empty(N, np.uint16), np.empty(N, np.uint16)
    edges = [0, 2 * BLOCK, N]
    for g in grads:
        payload, scales = _q8(g) if wire == "q8" else _q1(g)
        mine.begin_step()
        ref.begin_step()
        for lo, hi in zip(edges[:-1], edges[1:]):
            sl = scales[lo // BLOCK: -(-hi // BLOCK)]
            for opt, p, out in ((mine, pm, om), (ref, pr, orf)):
                if wire == "q8":
                    opt.step_chunk_q8(lo, hi, p[lo:hi], payload[lo:hi], sl,
                                      BLOCK, params_bf16_out=out[lo:hi])
                else:
                    opt.step_chunk_q1(lo, hi, p[lo:hi],
                                      payload[lo // 8: -(-hi // 8)], sl,
                                      BLOCK, params_bf16_out=out[lo:hi])
    _assert_bits(_state(mine, pm, om), _state(ref, pr, orf))


@pytest.mark.parametrize("call", ["step", "chunk", "q8", "q1"])
@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "l2"])
def test_twin_matches_native(call, adamw):
    """The plain twin against the native library, 3 steps: parameters
    and moments within 1e-6 relative, bf16 output the twin's parameters
    rounded to nearest even."""
    twin, _ = _pair(adamw, 0.01, native=False)
    nat, _ = _pair(adamw, 0.01)
    assert not twin.native and nat.native
    p0, grads = _inputs(4)
    pt, pn = p0.copy(), p0.copy()
    ot, on = np.empty(N, np.uint16), np.empty(N, np.uint16)
    for g in grads:
        for opt, p, out in ((twin, pt, ot), (nat, pn, on)):
            if call == "step":
                opt.step(p, g, params_bf16_out=out)
                continue
            opt.begin_step()
            if call == "chunk":
                opt.step_chunk(0, N, p, g, lr=5e-3, params_bf16_out=out)
            elif call == "q8":
                q, s = _q8(g)
                opt.step_chunk_q8(0, N, p, q, s, BLOCK, params_bf16_out=out)
            else:
                packed, s = _q1(g)
                opt.step_chunk_q1(0, N, p, packed, s, BLOCK,
                                  params_bf16_out=out)
    for a, b in ((pt, pn), (twin.exp_avg, nat.exp_avg),
                 (twin.exp_avg_sq, nat.exp_avg_sq)):
        assert np.max(np.abs(a - b)) <= TWIN_TOL * np.max(np.abs(b))
    ref_bf16 = torch.from_numpy(pt).to(torch.bfloat16).view(torch.int16)
    assert np.array_equal(ot.view(np.int16), ref_bf16.numpy())


def test_state_dict_round_trip():
    """A fresh optimizer loaded from another's state_dict takes the next
    step bit for bit as the original does (moments and step restored,
    the native step counter with them)."""
    a, _ = _pair(True, 0.01)
    p0, grads = _inputs(5)
    pa = p0.copy()
    for g in grads[:2]:
        a.step(pa, g)
    sd = {k: (v.copy() if isinstance(v, np.ndarray) else v)
          for k, v in a.state_dict().items()}
    b, _ = _pair(True, 0.01)
    b.load_state_dict(sd)
    assert b.step_count == 2
    pb = pa.copy()
    a.step(pa, grads[2])
    b.step(pb, grads[2])
    assert np.array_equal(pa, pb)
    assert np.array_equal(a.exp_avg_sq, b.exp_avg_sq)


def test_failed_build_raises_without_a_twin(tmp_path, monkeypatch):
    """A source g++ refuses raises at construction (no silent twin); so
    does a missing g++."""
    bad = tmp_path / "cpu_adam.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(_build.HOST_SOURCES, "cpu_adam", str(bad))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        DeepSpeedCPUAdam(N)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        DeepSpeedCPUAdam(N)


def test_ds_build_cpu_adam_0_names_the_twin(monkeypatch, caplog):
    """DS_BUILD_CPU_ADAM=0 (the JAX package's switch) runs the twin, and
    a warning says so."""
    monkeypatch.setenv(tca.BUILD_VAR, "0")
    seen = []
    monkeypatch.setattr(tca.logger, "warning", seen.append)
    opt = DeepSpeedCPUAdam(N)
    assert not opt.native
    assert seen and tca.BUILD_VAR in seen[0]


def test_library_lands_in_the_build_dir():
    """The port's library is built from csrc/adam/cpu_adam.cpp into
    build/torch_kernels/, keyed by source, flags and host."""
    import os
    src, path = _build._host_lib_path("cpu_adam")
    assert src.endswith(os.path.join("csrc", "adam", "cpu_adam.cpp"))
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert _build.BUILD_DIR.endswith(os.path.join("build", "torch_kernels"))
    tca.load_native()
    assert os.path.exists(path)
    assert tca.ds_num_threads() >= 1
