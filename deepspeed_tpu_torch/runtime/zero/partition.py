"""ZeRO's per-device memory plan at world size 1 (the part of
deepspeed_tpu/runtime/zero/partition.py that one card runs).

The JAX package phrases ZeRO stages 1-3 as sharding annotations over
the mesh's data axis (`ZeroShardingPolicy`); its `memory_plan` is the
closed form of the bytes each device holds per memory-ledger category,
which the elastic supervisor attaches to its recovery events and the
memory ledger validates against. At world size 1 no leaf shards and
none is padded, so the plan is each category's element count times its
bytes, for every stage. The partitioning itself (specs, padding plans,
shardings over more than one device) comes with data parallelism,
ROADMAP Queue 1 item 6.
"""

import numpy as np


def _later(what):
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet: ROADMAP Queue 1 item 6")


def _numel(shapes):
    """Elements of every leaf of a tree (dicts, lists, tuples) of
    tensors, arrays or shapes."""
    if isinstance(shapes, dict):
        return sum(_numel(v) for v in shapes.values())
    if isinstance(shapes, (list, tuple)) and not all(
            isinstance(d, (int, np.integer)) for d in shapes):
        return sum(_numel(v) for v in shapes)
    shape = shapes if isinstance(shapes, (list, tuple)) else \
        getattr(shapes, "shape", np.shape(shapes))
    return int(np.prod(tuple(shape), dtype=np.int64))


class ZeroShardingPolicy:
    """ZeRO stage -> per-device bytes of each state group, at
    `dp_size` 1 (the one world size the port trains at)."""

    def __init__(self, stage, dp_size=1):
        # ValueError, not assert: a bad stage must fail loudly under
        # `python -O` too, and the message must carry the value
        if not isinstance(stage, (int, np.integer)) or \
                not 0 <= stage <= 3:
            raise ValueError(
                f"zero_optimization.stage must be an integer in "
                f"[0, 3], got {stage!r}")
        if dp_size != 1:
            raise _later(f"a ZeRO plan over {dp_size} data-parallel ranks")
        self.stage = stage
        self.dp_size = dp_size

    def memory_plan(self, shapes, compute_bytes=2, sr_mode=False, gas=1):
        """Planned per-device bytes per memory-ledger category for a
        parameter tree of `shapes`, as the JAX policy's closed form:

          params     compute-dtype params
          master     fp32 masters (absent in SR mode — no fp32 store)
          opt_state  two Adam moments (fp32, or compute-dtype in SR
                     mode)
          grads      the persistent fp32 accumulator (only when the
                     step keeps one, i.e. gas > 1)

        At one device nothing shards and nothing is padded."""
        n = _numel(shapes)
        return {
            "params": n * compute_bytes,
            "master": 0 if sr_mode else n * 4,
            "opt_state": 2 * n * (compute_bytes if sr_mode else 4),
            "grads": n * 4 if gas > 1 else 0,
        }
