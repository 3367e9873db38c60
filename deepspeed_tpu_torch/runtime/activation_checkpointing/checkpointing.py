"""User-facing activation checkpointing and the named remat policies
(port of deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py).

`checkpoint(fn, *args)` reruns the wrapped computation in the backward
pass instead of keeping its intermediates, and `configure()` applies the
JSON `activation_checkpointing` block to every later `checkpoint()`
call. Underneath is `remat(fn, *args, policy=...)`, which the models'
blocks use too (`ops/transformer/transformer.py` `run_block`): non-
reentrant `torch.utils.checkpoint`, made selective by a policy.

Policies (`resolve_checkpoint_policy`, in the JAX package's order):
registered names first (`register_checkpoint_policy`; the built-in
"save_fused_epilogues"), then "save_only_these_names:a,b", then the
argument-free names of `jax.checkpoint_policies`, which the port maps
itself: everything_saveable (nothing is recomputed), nothing_saveable
(full-block remat, as policy None), dots_saveable / checkpoint_dots and
dots_with_no_batch_dims_saveable / checkpoint_dots_with_no_batch_dims.

How each kind of policy keeps what it names:

* dots: torch's selective checkpoint (`create_selective_checkpoint_
  contexts`) keeps the outputs of the GEMM ops, so the recompute does not
  run them again. A product with no batch dims is `aten.mm` / `addmm`
  (the projections, `x @ kernel` over [B*T, C]); `bmm` / `baddbmm` have
  batch dims (the dense attention's products).
* names: a kernel's autograd Function computes its outputs through
  `named_outputs(names, compute)`. In a remat frame's first forward the
  outputs the policy names are kept (detached) in the frame's stash, in
  call order; in the recompute the same call hands them back, and when
  every output is named `compute` is not called, so the kernel does not
  launch again. The Function saves what it saved the first time, so the
  backward reads the same tensors. The names are the JAX package's:
  "attn_out" / "attn_lse" (flash attention, `flash_attention_
  rematerializable`), "fused_ln_out" / "fused_ln_sum" (K3) and
  "fused_gelu_sum" / "fused_gelu_out" (K4); save_fused_epilogues keeps
  all but "fused_gelu_out" (the 4H-wide output is one transcendental pass
  from the kept sum), so K4-fwd runs again in the recompute, as the
  pallas_call does in the JAX package's rematted backward.
* A GEMM whose only consumer is a kernel the recompute hands back (c_proj
  before ln_2's K3, BERT's attn_ow and output_w) is dead in the
  recompute: inside `dead_gemms(names)` its output is left uninitialized
  (its inputs are still saved, by autograd, before the op runs). The
  JAX package's dead-code elimination drops the same dots. The last GEMM
  of a block (mlp_c_proj) never runs in a recompute either: torch stops
  recomputing once the last saved tensor is packed, before that op runs.

`cpu_checkpointing` keeps the inputs of `checkpoint()` in pinned host
memory (a non-blocking copy on the current stream) until the recompute
copies them back; the forward itself runs on the device tensors, whose
gradients flow as without it. There is no fallback: a failed pinned
allocation raises. `partition_activations` shards over a model-parallel
group, which world size 1 does not have, so it is accepted and changes
nothing, as the JAX package skips it without a `model` axis > 1; an
`mpu` with a model-parallel size > 1 raises (ROADMAP Queue 1 item 6).
`contiguous_memory_optimization`, `number_checkpoints` and
`synchronize_checkpoint_boundary` are accepted no-ops; `profile` wraps
each call in `torch.profiler.record_function("ds_checkpoint")`.

`RNGStatesTracker` keeps named streams as explicit `torch.Generator`s;
a recompute draws what the forward drew because the port's dropout takes
a generator seeded per block, not the global stream.
"""

import contextlib
import dataclasses
import functools
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy,
                                    checkpoint as _torch_checkpoint,
                                    create_selective_checkpoint_contexts)

from deepspeed_tpu_torch.utils.device import resolve_device

ITEM_6 = ("a model-parallel group (partition_activations over an mpu "
          "or mesh of model-parallel size > 1) is not in the port yet: "
          "ROADMAP Queue 1 item 6")

# ----------------------------------------------------------------------
# module state (the reference's globals, checkpointing.py:40-56)
# ----------------------------------------------------------------------
PARTITION_ACTIVATIONS = False
CPU_CHECKPOINTING = False
CONTIGUOUS_CHECKPOINTING = False
SYNCHRONIZE = False
PROFILE_TIME = False
num_layers = None

_policy_name = None
_configured = False


# ----------------------------------------------------------------------
# policies
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """What a remat frame keeps from the first forward: the kernel
    outputs named in `names`, the GEMM outputs of `dots` ("all", or
    "no_batch": products without batch dims), or with `everything` all
    of it (no recompute)."""
    names: frozenset = frozenset()
    dots: str = None
    everything: bool = False

    def saves(self, name):
        return self.everything or name in self.names


def save_only_these_names(*names):
    return RematPolicy(names=frozenset(names))


# the argument-free names of jax.checkpoint_policies, mapped
_JAX_POLICIES = {
    "everything_saveable": RematPolicy(everything=True),
    "nothing_saveable": RematPolicy(),
    "dots_saveable": RematPolicy(dots="all"),
    "checkpoint_dots": RematPolicy(dots="all"),
    "dots_with_no_batch_dims_saveable": RematPolicy(dots="no_batch"),
    "checkpoint_dots_with_no_batch_dims": RematPolicy(dots="no_batch"),
}

_NAMED_POLICIES = {}


def register_checkpoint_policy(name, policy):
    """Publish a RematPolicy under a string name, resolvable from every
    remat_policy / checkpoint_policy config field."""
    if not isinstance(policy, RematPolicy):
        raise TypeError(f"policy {name!r} must be a RematPolicy, got "
                        f"{type(policy).__name__}")
    _NAMED_POLICIES[name] = policy


def _builtin_policies():
    if "save_fused_epilogues" not in _NAMED_POLICIES:
        from deepspeed_tpu_torch.ops.transformer.fused_ops import \
            FUSED_EPILOGUE_SAVE_NAMES
        register_checkpoint_policy(
            "save_fused_epilogues",
            save_only_these_names("attn_out", "attn_lse",
                                  *FUSED_EPILOGUE_SAVE_NAMES))
    return _NAMED_POLICIES


def resolve_checkpoint_policy(name):
    """Policy name -> RematPolicy: registered custom names first (incl.
    the built-in "save_fused_epilogues"), then the literal
    "save_only_these_names:a,b" syntax, then the argument-free
    `jax.checkpoint_policies` names. None (full remat) and a RematPolicy
    pass through."""
    if name is None or isinstance(name, RematPolicy):
        return name
    policies = _builtin_policies()
    if name in policies:
        return policies[name]
    if name.startswith("save_only_these_names:"):
        names = [n for n in name.split(":", 1)[1].split(",") if n]
        return save_only_these_names(*names)
    if name in _JAX_POLICIES:
        return _JAX_POLICIES[name]
    raise ValueError(
        f"unknown checkpoint policy {name!r}: not a registered "
        f"custom policy ({sorted(policies)}), a "
        "save_only_these_names:... spec, or a "
        "jax.checkpoint_policies attribute")


# ----------------------------------------------------------------------
# remat frames
# ----------------------------------------------------------------------
_local = threading.local()


def _frames():
    if not hasattr(_local, "frames"):
        _local.frames = []
    return _local.frames


def _current():
    frames = _frames()
    return frames[-1] if frames else None


class _Frame:
    """One remat call's stash of named kernel outputs."""

    def __init__(self, policy):
        self.policy = policy
        self.stash = []
        self.cursor = 0
        self.recomputing = False

    @contextlib.contextmanager
    def active(self, recomputing):
        self.recomputing = recomputing
        self.cursor = 0
        frames = _frames()
        frames.append(self)
        try:
            yield
        finally:
            frames.pop()

    def take(self):
        t = self.stash[self.cursor]
        self.cursor += 1
        return t


def named_outputs(names, compute):
    """`compute()`'s outputs (a tuple, one tensor per name in `names`),
    kept or handed back by the innermost remat frame as its policy says:
    in the first forward the named ones are stashed; in the recompute
    they are returned from the stash, and `compute` runs only when some
    output is not named. Outside a remat frame, `compute()`."""
    frame = _current()
    if frame is None:
        return compute()
    keep = [frame.policy.saves(n) for n in names]
    if not any(keep):
        return compute()
    if not frame.recomputing:
        outs = compute()
        frame.stash.extend(t.detach() for k, t in zip(keep, outs) if k)
        return outs
    kept = [frame.take() if k else None for k in keep]
    if all(keep):
        return tuple(kept)
    fresh = compute()
    return tuple(s if k else t for k, s, t in zip(keep, kept, fresh))


def replays(names):
    """Whether the current frame is recomputing and hands back every
    output named in `names` (their kernel does not run again)."""
    frame = _current()
    return frame is not None and frame.recomputing and \
        all(frame.policy.saves(n) for n in names)


_GEMMS = {torch.ops.aten.mm, torch.ops.aten.addmm}
_BATCHED_GEMMS = {torch.ops.aten.bmm, torch.ops.aten.baddbmm}


class _DeadGemms(TorchDispatchMode):
    """GEMMs return uninitialized outputs of the right shape and dtype
    (computed on the meta device); every other op runs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in _GEMMS | _BATCHED_GEMMS:
            return func(*args, **kwargs)
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        meta = torch.utils._pytree.tree_map(
            lambda a: a.to("meta") if isinstance(a, torch.Tensor) else a,
            (args, kwargs))
        out = func(*meta[0], **meta[1])
        return torch.empty_like(out, device=device)


def dead_gemms(names):
    """Context for the GEMMs whose only consumer is the kernel that
    outputs `names`: in a recompute that hands all of them back
    (`replays`), the GEMMs' outputs are dead and are not computed.
    Elsewhere a null context."""
    if replays(names):
        return _DeadGemms()
    return contextlib.nullcontext()


def _sac_policy_fn(dots):
    ops = _GEMMS | (_BATCHED_GEMMS if dots == "all" else set())

    def policy_fn(ctx, op, *args, **kwargs):
        if op.overloadpacket in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy_fn


class _Entered:
    """Enters several context managers as one (None entries skipped)."""

    def __init__(self, *cms):
        self.cms = [c for c in cms if c is not None]
        self.stack = None

    def __enter__(self):
        self.stack = contextlib.ExitStack()
        for c in self.cms:
            self.stack.enter_context(c)
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)


def _contexts(policy):
    """(forward context, recompute context) of one remat call."""
    fwd = rec = None
    if policy.dots:
        fwd, rec = create_selective_checkpoint_contexts(
            _sac_policy_fn(policy.dots))
    if not policy.names:
        return fwd, rec
    frame = _Frame(policy)
    return (_Entered(fwd, frame.active(False)),
            _Entered(rec, frame.active(True)))


def remat(function, *args, policy=None, preserve_rng_state=False):
    """`function(*args)` under rematerialisation: non-reentrant
    torch.utils.checkpoint keeps the inputs (and what `policy` keeps)
    and recomputes the rest in the backward. `policy`: None or
    "nothing_saveable" (full remat), a policy name or a RematPolicy;
    everything_saveable runs `function` without remat."""
    policy = resolve_checkpoint_policy(policy)
    if policy is not None and policy.everything:
        return function(*args)
    kwargs = {}
    if policy is not None and (policy.names or policy.dots):
        kwargs["context_fn"] = functools.partial(_contexts, policy)
    return _torch_checkpoint(function, *args, use_reentrant=False,
                             preserve_rng_state=preserve_rng_state,
                             **kwargs)


# ----------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------
def is_configured():
    return _configured


def reset():
    """Reference parity (`checkpointing.py:691`): frees contiguous
    buffers between eval forwards. The caching allocator owns buffer
    lifetime, so this is a no-op."""


def set_num_layers(nlayers):
    global num_layers
    num_layers = nlayers


def partition_activations_in_checkpoint(partition_activation):
    global PARTITION_ACTIVATIONS
    PARTITION_ACTIVATIONS = partition_activation


def _model_parallel_size(mpu):
    for attr in ("get_model_parallel_world_size",
                 "get_tensor_model_parallel_world_size"):
        if hasattr(mpu, attr):
            return int(getattr(mpu, attr)())
    return 1


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              mesh=None, checkpoint_policy=None):
    """Configure activation checkpointing (ref `checkpointing.py:747`).

    `deepspeed_config` may be a parsed `DeepSpeedConfig`, a dict, or a
    JSON path; explicit kwargs override its values. An `mpu` whose
    model-parallel size is above 1, or any `mesh`, raises (ROADMAP Queue
    1 item 6): world size 1 has no model axis to partition over."""
    global PARTITION_ACTIVATIONS, CPU_CHECKPOINTING, \
        CONTIGUOUS_CHECKPOINTING, SYNCHRONIZE, PROFILE_TIME, num_layers, \
        _policy_name, _configured

    if mesh is not None or (mpu_ is not None and
                            _model_parallel_size(mpu_) > 1):
        raise NotImplementedError(ITEM_6)
    if checkpoint_policy is not None:
        resolve_checkpoint_policy(checkpoint_policy)   # ValueError if bad
    PARTITION_ACTIVATIONS = False
    CPU_CHECKPOINTING = False
    CONTIGUOUS_CHECKPOINTING = False
    SYNCHRONIZE = False
    PROFILE_TIME = False
    num_layers = None
    if deepspeed_config is not None:
        cfg = deepspeed_config
        if isinstance(cfg, (str, dict)):
            from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
            cfg = DeepSpeedConfig(cfg)
        ac = cfg.activation_checkpointing_config
        PARTITION_ACTIVATIONS = bool(ac.partition_activations)
        CPU_CHECKPOINTING = bool(ac.cpu_checkpointing)
        CONTIGUOUS_CHECKPOINTING = bool(ac.contiguous_memory_optimization)
        SYNCHRONIZE = bool(ac.synchronize_checkpoint_boundary)
        PROFILE_TIME = bool(ac.profile)
        num_layers = ac.number_checkpoints

    if partition_activations is not None:
        PARTITION_ACTIVATIONS = partition_activations
    if contiguous_checkpointing is not None:
        CONTIGUOUS_CHECKPOINTING = contiguous_checkpointing
    if num_checkpoints is not None:
        num_layers = num_checkpoints
    if checkpoint_in_cpu is not None:
        CPU_CHECKPOINTING = checkpoint_in_cpu
    if synchronize is not None:
        SYNCHRONIZE = synchronize
    if profile is not None:
        PROFILE_TIME = profile
    _policy_name = checkpoint_policy
    _configured = True


# ----------------------------------------------------------------------
# checkpoint()
# ----------------------------------------------------------------------
# the inputs `checkpoint()` keeps on the host (cpu_checkpointing), while
# their frames hold them
_HOST_STAGED = weakref.WeakSet()


def host_staged_inputs():
    """The host copies that cpu_checkpointing keeps alive right now."""
    return list(_HOST_STAGED)


def _to_host(x):
    """A host copy of `x`: pinned, by a non-blocking copy on the current
    stream, for a CUDA tensor; a plain copy for a CPU one (already host
    memory: the copy keeps the path the same)."""
    x = x.detach()
    if x.is_cuda:
        h = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                        pin_memory=True)
        h.copy_(x, non_blocking=True)
    else:
        h = x.clone()
    _HOST_STAGED.add(h)
    return h


def _offloaded(function, args, policy):
    """`function(*args)` under remat with its tensor inputs kept as host
    copies: the forward runs on `args` themselves (and their gradients
    flow to them), the recompute on copies brought back to each input's
    device with its requires_grad."""
    is_t = [isinstance(a, torch.Tensor) for a in args]
    staged = tuple(_to_host(a) if t else a for a, t in zip(args, is_t))
    meta = [(a.device, a.requires_grad) if t else None
            for a, t in zip(args, is_t)]
    live = {"args": args}

    def run(*hosts):
        first = live.pop("args", None)
        if first is not None:     # the forward: the inputs themselves
            return function(*first)
        back = [h.to(m[0], non_blocking=True).requires_grad_(m[1])
                if m is not None else h for h, m in zip(hosts, meta)]
        return function(*back)

    return remat(run, *staged, policy=policy, preserve_rng_state=True)


def checkpoint(function, *args):
    """Checkpoint a function (ref `checkpointing.py:666`): its
    intermediates are recomputed, not kept, in the backward pass, under
    the configured `checkpoint_policy`. Returns `function(*args)`."""
    policy = resolve_checkpoint_policy(_policy_name)
    inner = function
    if PROFILE_TIME:
        def inner(*a):
            with torch.profiler.record_function("ds_checkpoint"):
                return function(*a)
    if CPU_CHECKPOINTING and torch.is_grad_enabled():
        return _offloaded(inner, args, policy)
    return remat(inner, *args, policy=policy, preserve_rng_state=True)


# ----------------------------------------------------------------------
# RNG stream tracker (API parity with CudaRNGStatesTracker,
# ref checkpointing.py:148-263)
# ----------------------------------------------------------------------
class RNGStatesTracker:
    """Named random streams, each a `torch.Generator` on `device` ("cuda"
    unless the caller asks for the CPU). `fork(name)` yields the stream's
    generator; what the block draws from it advances the stream."""

    def __init__(self, device="cuda"):
        self.device = device
        self.states_ = {}

    def reset(self):
        self.states_ = {}

    def get_states(self):
        """{name: generator state} (copies)."""
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states(self, states):
        self.states_ = {}
        for name, state in states.items():
            gen = torch.Generator(device=resolve_device(self.device))
            gen.set_state(state)
            self.states_[name] = gen

    def add(self, name, seed):
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        gen = torch.Generator(device=resolve_device(self.device))
        gen.manual_seed(int(seed))
        self.states_[name] = gen

    @contextlib.contextmanager
    def fork(self, name="model-parallel-rng"):
        """Yields the stream's generator."""
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        yield self.states_[name]


_RNG_TRACKER = RNGStatesTracker()
_MODEL_PARALLEL_RNG = "model-parallel-rng"


def get_rng_tracker():
    return _RNG_TRACKER


def model_parallel_manual_seed(seed, model_parallel_rank=0, device=None):
    """Seed the default and model-parallel streams (ref
    `model_parallel_cuda_manual_seed`, checkpointing.py:224-263): the
    model-parallel stream (seed + 2718 + rank) differs per rank, the
    default stream does not. Returns the default stream's generator."""
    if device is not None:
        _RNG_TRACKER.device = device
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add(_MODEL_PARALLEL_RNG,
                     seed + 2718 + int(model_parallel_rank))
    gen = torch.Generator(device=resolve_device(_RNG_TRACKER.device))
    gen.manual_seed(int(seed))
    return gen


# torch-API aliases (what reference user code imports)
get_cuda_rng_tracker = get_rng_tracker
model_parallel_cuda_manual_seed = model_parallel_manual_seed
CudaRNGStatesTracker = RNGStatesTracker
