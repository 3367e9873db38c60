"""Worker processes of tests/test_torch_sequence_parallel.py.

Each rank of a gloo group of P processes (a `file://` rendezvous) runs
every case of the module once, on inputs made from numpy seeds that the
test process makes the same way, and writes what it got to
`<out_dir>/rank<r>.npz`: its chunk of each output, its chunk of each
gradient, the messages of the cases that must raise, and GPT-2's loss
and gradients under sequence parallelism. This module imports torch and
the port only (no JAX), so the spawned processes start fast.
"""

import os
import traceback

import numpy as np
import torch

# (name, local chunk length, heads, head dim, causal, use_flash): the
# ring and Ulysses cases, global T = P * local chunk
RING_CASES = (("ring_flash_causal", 128, 2, 64, True, True),
              ("ring_flash_full", 128, 2, 64, False, True),
              ("ring_fallback_causal", 24, 2, 32, True, False),
              ("ring_fallback_full", 24, 2, 32, False, False))
ULYSSES_CASE = ("ulysses_causal", 32, 4, 32, True, False)
GPT2_T = 64          # GPT-2 sequence length (the JAX test's)
GPT2_BATCH = 4


def global_qkv(t, h, d, seed):
    """The global [1, T, H, D] q, k, v of a case (fp32)."""
    r = np.random.RandomState(seed)
    return [r.randn(1, t, h, d).astype(np.float32) for _ in range(3)]


def case_seed(name):
    return sum(map(ord, name))


def gpt2_ids():
    return np.random.RandomState(11).randint(
        0, 256, (GPT2_BATCH, GPT2_T)).astype(np.int64)


def _attention_case(fn, name, t_local, h, d, causal, rank, p, out, **kw):
    """The rank's chunk of out and of the grads of sum(out ** 2)."""
    q, k, v = global_qkv(t_local * p, h, d, case_seed(name))
    chunk = slice(rank * t_local, (rank + 1) * t_local)
    leaves = [torch.from_numpy(x[:, chunk].copy()).requires_grad_(True)
              for x in (q, k, v)]
    o = fn(*leaves, causal=causal, **kw)
    (o.float() ** 2).sum().backward()
    out[f"{name}/out"] = o.detach().numpy()
    for n, x in zip("qkv", leaves):
        out[f"{name}/d{n}"] = x.grad.numpy()


def _raises(out, key, fn):
    try:
        fn()
    except ValueError as e:
        out[key] = np.array(str(e))
    else:
        out[key] = np.array("")


def run_cases(rank, p, out_dir, param_file):
    import torch.distributed as dist
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    from deepspeed_tpu_torch.ops import sequence as sp
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.utils.distributed import init_distributed

    torch.set_num_threads(1)
    init_distributed("gloo", init_method="file://" + os.path.join(
        out_dir, "rendezvous"), rank=rank, world_size=p, verbose=False,
        timeout=120)
    out = {}
    for name, tl, h, d, causal, flash in RING_CASES:
        _attention_case(sp.ring_attention, name, tl, h, d, causal, rank, p,
                        out, use_flash=flash)
    name, tl, h, d, causal, _ = ULYSSES_CASE
    _attention_case(sp.ulysses_attention, name, tl, h, d, causal, rank, p,
                    out)

    # what must raise: heads the group size does not divide, and chunks
    # of unequal length
    odd = torch.zeros((1, 8, p + 1, 16))
    _raises(out, "raise/heads", lambda: sp.ulysses_attention(odd, odd, odd))
    uneven = torch.zeros((1, 8 + (rank == 0), 2, 16))
    _raises(out, "raise/ring_chunks",
            lambda: sp.ring_attention(uneven, uneven, uneven))
    _raises(out, "raise/ulysses_chunks",
            lambda: sp.ulysses_attention(uneven, uneven, uneven))

    # a group of one rank: the ring sends nothing and is flash attention
    singles = [dist.new_group([r]) for r in range(p)]
    q, k, v = (torch.from_numpy(x) for x in global_qkv(128, 2, 64, 5))
    one = sp.ring_attention(q, k, v, group=singles[rank], use_flash=True)
    out["single/out"] = one.numpy()
    out["single/ref"] = fa.flash_attention_with_lse(q, k, v)[0].numpy()

    # GPT-2 under sequence parallelism: the same weights on every rank,
    # the whole batch, loss and every gradient
    flat = np.load(param_file)
    for impl in ("ring", "ulysses"):
        cfg = tgpt2.tiny_gpt2_config(n_layer=2, n_head=8, dropout=0.0,
                                     sequence_parallel=impl)
        model = tgpt2.GPT2ForCausalLM(cfg, device="cpu")
        params = {n: torch.from_numpy(flat[n]).requires_grad_(True)
                  for n in flat.files}
        loss = model.loss_fn(params, {"input_ids": gpt2_ids()})
        grads = torch.autograd.grad(loss, list(params.values()))
        out[f"gpt2_{impl}/loss"] = loss.detach().numpy()
        for n, g in zip(params, grads):
            out[f"gpt2_{impl}/grad/{n}"] = g.numpy()
    dist.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def worker(rank, p, out_dir, param_file):
    """The spawned process: run every case, or leave the traceback in
    `<out_dir>/rank<r>.err` for the test to show."""
    try:
        run_cases(rank, p, out_dir, param_file)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ----------------------------------------------------------------------
# fp16 (tests/test_torch_fp16_ring.py): the same harness on fp16 inputs
# ----------------------------------------------------------------------
# (name, local chunk length, heads, head dim, causal, use_flash): the
# ring's flash body (K5's and K2's given-delta twins) causal and not, and
# Ulysses on the flash twins (K1, K2-fused); global T = P * local chunk
FP16_CASES = (("ring_flash_causal_fp16", 128, 2, 64, True, True),
              ("ring_flash_full_fp16", 128, 2, 64, False, True),
              ("ulysses_flash_causal_fp16", 64, 4, 64, True, True))


def _attention_case_fp16(fn, name, t_local, h, d, causal, rank, p, out,
                         **kw):
    """The rank's chunk of out and of the grads of sum(out.float() ** 2),
    on the fp16 casts of the case's global inputs."""
    q, k, v = global_qkv(t_local * p, h, d, case_seed(name))
    chunk = slice(rank * t_local, (rank + 1) * t_local)
    leaves = [torch.from_numpy(x[:, chunk].copy()).half().requires_grad_(True)
              for x in (q, k, v)]
    o = fn(*leaves, causal=causal, **kw)
    (o.float() ** 2).sum().backward()
    out[f"{name}/out"] = o.detach().float().numpy()
    for n, x in zip("qkv", leaves):
        out[f"{name}/d{n}"] = x.grad.float().numpy()


def run_fp16_cases(rank, p, out_dir, param_file):
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    from deepspeed_tpu_torch.ops import sequence as sp
    from deepspeed_tpu_torch.utils.distributed import init_distributed
    import torch.distributed as dist

    torch.set_num_threads(1)
    init_distributed("gloo", init_method="file://" + os.path.join(
        out_dir, "rendezvous"), rank=rank, world_size=p, verbose=False,
        timeout=120)
    out = {}
    for name, tl, h, d, causal, flash in FP16_CASES:
        fn = sp.ulysses_attention if name.startswith("ulysses") else \
            sp.ring_attention
        _attention_case_fp16(fn, name, tl, h, d, causal, rank, p, out,
                             use_flash=flash)
    # GPT-2 in fp16 under sequence parallelism (fp16 parameters, as the
    # engine holds them): the ring's fallback body, Ulysses' dense one
    flat = np.load(param_file)
    for impl in ("ring", "ulysses"):
        cfg = tgpt2.tiny_gpt2_config(n_layer=2, n_head=8, dropout=0.0,
                                     dtype=torch.float16,
                                     sequence_parallel=impl)
        model = tgpt2.GPT2ForCausalLM(cfg, device="cpu")
        params = {n: torch.from_numpy(flat[n]).half().requires_grad_(True)
                  for n in flat.files}
        loss = model.loss_fn(params, {"input_ids": gpt2_ids()})
        grads = torch.autograd.grad(loss, list(params.values()))
        out[f"gpt2_{impl}/loss"] = loss.detach().float().numpy()
        for n, g in zip(params, grads):
            out[f"gpt2_{impl}/grad/{n}"] = g.float().numpy()
    dist.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def worker_fp16(rank, p, out_dir, param_file):
    """The spawned process of the fp16 cases (as `worker`)."""
    try:
        run_fp16_cases(rank, p, out_dir, param_file)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ----------------------------------------------------------------------
# the ring's overlap schedule (tests/test_torch_overlap.py): the fallback
# body under ops/overlap.py's issue distances and with overlap off
# ----------------------------------------------------------------------
# (label, overlap.configure arguments)
OVERLAP_SCHEDULES = (("d1", dict(issue_distance=1)),
                     ("d2", dict(issue_distance=2)),
                     ("d3", dict(issue_distance=3)),
                     ("off", dict(enabled=False)))
OVERLAP_CASES = (("ring_overlap_causal", 24, 2, 32, True),
                 ("ring_overlap_full", 24, 2, 32, False))


def run_overlap_cases(rank, p, out_dir):
    import torch.distributed as dist
    from deepspeed_tpu_torch.ops import overlap
    from deepspeed_tpu_torch.ops import sequence as sp
    from deepspeed_tpu_torch.utils.distributed import init_distributed

    torch.set_num_threads(1)
    init_distributed("gloo", init_method="file://" + os.path.join(
        out_dir, "rendezvous"), rank=rank, world_size=p, verbose=False,
        timeout=120)
    out = {}
    for name, tl, h, d, causal in OVERLAP_CASES:
        q, k, v = global_qkv(tl * p, h, d, case_seed(name))
        chunk = slice(rank * tl, (rank + 1) * tl)
        for label, sched in OVERLAP_SCHEDULES:
            overlap.reset()
            overlap.configure(**sched)
            leaves = [torch.from_numpy(x[:, chunk].copy()).requires_grad_(
                True) for x in (q, k, v)]
            o = sp.ring_attention(*leaves, causal=causal, use_flash=False)
            (o ** 2).sum().backward()
            out[f"{name}/{label}/out"] = o.detach().numpy()
            for n, x in zip("qkv", leaves):
                out[f"{name}/{label}/d{n}"] = x.grad.numpy()
            out[f"{name}/{label}/inflight"] = np.array(
                overlap.inflight_bytes())
    overlap.reset()
    dist.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def worker_overlap(rank, p, out_dir):
    """The spawned process of the overlap cases (as `worker`)."""
    try:
        run_overlap_cases(rank, p, out_dir)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
