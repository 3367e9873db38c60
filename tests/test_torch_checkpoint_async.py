"""PyTorch port: asynchronous checkpoint saves, the single-process cases
of the JAX package's `test_async_checkpoint.py` on the port's engine
(split out of tests/test_torch_checkpoint.py to spread the test clock
over workers): atomic commits, async equal to sync under training,
backpressure (block and drop), ordering, writer errors, draining, gas
changes across a reload, client-state isolation, staging dirs,
rotation, and timeouts with abandon and shutdown.
"""

import os
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.runtime import checkpoint as ckpt_io

from test_torch_checkpoint import SEQ, _engine
from torch_one_thread import one_torch_thread  # noqa: F401


# ----------------------------------------------------------------------
# async saves: the single-process cases of test_async_checkpoint.py
# ----------------------------------------------------------------------
def _train(engine, steps, start=0):
    gas = engine.gradient_accumulation_steps()
    for i in range(steps):
        ids = np.random.RandomState(start + i).randint(0, 256, (gas, 4, SEQ))
        engine.train_batch(batch={"input_ids": ids})


def _case_atomic_commit(tmp_path):
    engine = _engine()
    _train(engine, 2)
    assert engine.save_checkpoint(str(tmp_path), tag="t1") is True
    engine.wait_for_checkpoint()
    assert os.path.isdir(tmp_path / "t1")
    assert not os.path.exists(tmp_path / ("t1" + ckpt_io.STAGING_SUFFIX))
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "t1"
    path, _ = engine.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("t1")


def _case_async_equals_sync_under_training(tmp_path):
    """A sync and an async save of the same state are bit-identical
    although training steps (in place) while the writer serializes."""
    engine = _engine()
    _train(engine, 2)
    engine.save_checkpoint(str(tmp_path), tag="sync_ref", async_save=False,
                           save_latest=False)
    orig = engine._write_checkpoint
    gate = threading.Event()

    def gated(*a, **k):
        assert gate.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = gated
    engine.save_checkpoint(str(tmp_path), tag="async_ref", async_save=True)
    ref_mu = [m.clone() for m in engine.state.opt_state.mu]
    _train(engine, 3, start=100)
    gate.set()
    engine.wait_for_checkpoint()
    assert ckpt_io.checkpoint_dirs_bit_identical(
        str(tmp_path / "sync_ref"), str(tmp_path / "async_ref"))
    engine2 = _engine(seed=7)
    engine2.load_checkpoint(str(tmp_path), tag="async_ref")
    assert all(torch.equal(a, b)
               for a, b in zip(ref_mu, engine2.state.opt_state.mu))


def _case_backpressure_blocks(tmp_path):
    engine = _engine()   # writer_queue_depth defaults to 1
    _train(engine, 1)
    orig = engine._write_checkpoint

    def slow(*a, **k):
        time.sleep(0.5)
        return orig(*a, **k)

    engine._write_checkpoint = slow
    t0 = time.perf_counter()
    engine.save_checkpoint(str(tmp_path), tag="a")
    first = time.perf_counter() - t0
    t1 = time.perf_counter()
    engine.save_checkpoint(str(tmp_path), tag="b")
    second = time.perf_counter() - t1
    engine.wait_for_checkpoint()
    assert first < 0.4 <= second, (first, second)
    assert os.path.isdir(tmp_path / "a") and os.path.isdir(tmp_path / "b")
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "b"


def _case_backpressure_drops(tmp_path):
    engine = _engine({"queue_policy": "drop"})
    _train(engine, 1)
    orig = engine._write_checkpoint
    started, release = threading.Event(), threading.Event()

    def gated(*a, **k):
        started.set()
        assert release.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = gated
    assert engine.save_checkpoint(str(tmp_path), tag="a") is True
    assert started.wait(timeout=10)
    # dropped BEFORE paying for the snapshot
    with mock.patch.object(engine, "_checkpoint_snapshot") as snap:
        assert engine.save_checkpoint(str(tmp_path), tag="b") is False
    assert snap.call_count == 0
    release.set()
    engine.wait_for_checkpoint()
    assert os.path.isdir(tmp_path / "a")
    assert not os.path.exists(tmp_path / "b")
    assert not os.path.exists(tmp_path / ("b" + ckpt_io.STAGING_SUFFIX))


def _case_same_tag_serializes(tmp_path):
    engine = _engine({"writer_queue_depth": 2})
    _train(engine, 1)
    orig = engine._write_checkpoint
    started, release = threading.Event(), threading.Event()

    def gated(*a, **k):
        if not started.is_set():
            started.set()
            assert release.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = gated
    assert engine.save_checkpoint(str(tmp_path), tag="t") is True
    assert started.wait(timeout=10)
    threading.Timer(0.5, release.set).start()
    t0 = time.perf_counter()
    assert engine.save_checkpoint(str(tmp_path), tag="t") is True
    assert time.perf_counter() - t0 >= 0.3
    engine.wait_for_checkpoint()
    assert sorted(os.listdir(tmp_path)) == ["latest", "t"]


def _case_submission_order(tmp_path):
    engine = _engine({"writer_queue_depth": 2, "keep_last": 1})
    _train(engine, 1)
    orig = engine._write_checkpoint
    first = threading.Event()

    def stagger(*a, **k):
        if not first.is_set():
            first.set()
            time.sleep(0.5)   # the first job serializes slowly
        return orig(*a, **k)

    engine._write_checkpoint = stagger
    assert engine.save_checkpoint(str(tmp_path), tag="older") is True
    assert engine.save_checkpoint(str(tmp_path), tag="newer") is True
    engine.wait_for_checkpoint()
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "newer"
    assert os.path.isdir(tmp_path / "newer")
    assert not os.path.isdir(tmp_path / "older")   # rotated out


def _case_later_failure_no_deadlock(tmp_path):
    engine = _engine({"writer_queue_depth": 2})
    _train(engine, 1)
    orig = engine._write_checkpoint

    def hooked(save_dir, tag, snap, save_latest, **k):
        if tag == "a":
            time.sleep(0.5)
            return orig(save_dir, tag, snap, save_latest, **k)
        raise OSError("disk full")   # job b dies before its gate

    engine._write_checkpoint = hooked
    assert engine.save_checkpoint(str(tmp_path), tag="a") is True
    assert engine.save_checkpoint(str(tmp_path), tag="b") is True
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        engine.wait_for_checkpoint()
    assert os.path.isdir(tmp_path / "a")


def _case_writer_error_reraised(tmp_path):
    engine = _engine()
    _train(engine, 1)

    def boom(*a, **k):
        raise OSError("disk full")

    engine._write_checkpoint = boom
    engine.save_checkpoint(str(tmp_path), tag="t")
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        engine.wait_for_checkpoint()
    engine.wait_for_checkpoint()   # consumed; the writer is usable


def _case_sync_drains_async(tmp_path):
    engine = _engine()
    _train(engine, 1)
    orig = engine._write_checkpoint
    release = threading.Event()

    def gated(save_dir, tag, snap, save_latest, **k):
        if tag == "slow":
            assert release.wait(timeout=30)
        return orig(save_dir, tag, snap, save_latest, **k)

    engine._write_checkpoint = gated
    engine.save_checkpoint(str(tmp_path), tag="slow")
    threading.Timer(0.4, release.set).start()
    t0 = time.perf_counter()
    engine.save_checkpoint(str(tmp_path), tag="final", async_save=False)
    assert time.perf_counter() - t0 >= 0.3
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "final"
    assert os.path.isdir(tmp_path / "slow")


def _case_gas_change_across_reload(tmp_path):
    eng_a = _engine(gas=2)
    _train(eng_a, 2)
    assert eng_a.global_steps == 2 and eng_a.micro_steps == 4
    eng_a.save_checkpoint(str(tmp_path), tag="t")
    eng_a.wait_for_checkpoint()
    eng_b = _engine(seed=7)   # gas 1
    eng_b.load_checkpoint(str(tmp_path), tag="t")
    assert eng_b.global_steps == 2   # micro_steps // gas would say 4
    assert int(eng_b.state.global_steps) == 2


def _case_resave_existing_tag(tmp_path):
    engine = _engine()
    _train(engine, 1)
    engine.save_checkpoint(str(tmp_path), tag="t")
    engine.wait_for_checkpoint()
    _train(engine, 1, start=50)
    engine.save_checkpoint(str(tmp_path), tag="t")
    engine.wait_for_checkpoint()
    assert sorted(os.listdir(tmp_path)) == ["latest", "t"]
    assert engine.load_checkpoint(str(tmp_path))[0].endswith("t")


def _case_client_state_isolated(tmp_path):
    engine = _engine()
    _train(engine, 1)
    orig = engine._write_checkpoint
    gate = threading.Event()

    def slow(*a, **k):
        assert gate.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = slow
    state = {"metrics": {"acc": 1}}
    engine.save_checkpoint(str(tmp_path), tag="t", client_state=state)
    state["metrics"]["acc"] = 999   # mutate while the writer waits
    gate.set()
    engine.wait_for_checkpoint()
    sd, _ = ckpt_io.load_checkpoint_files(str(tmp_path), "t")
    assert sd["metrics"] == {"acc": 1}
    assert engine.load_checkpoint(str(tmp_path))[1] == {
        "metrics": {"acc": 1}}


def _case_interrupted_save_raises(tmp_path):
    os.makedirs(tmp_path / ("t" + ckpt_io.STAGING_SUFFIX))
    with pytest.raises(ckpt_io.CheckpointStagingOnlyError,
                       match="interrupted save"):
        ckpt_io.load_checkpoint_flat(str(tmp_path), "t")
    with pytest.raises(ckpt_io.CheckpointNotFoundError):
        _engine().load_checkpoint(str(tmp_path), tag="never")


def _case_latest_skips_staging(tmp_path):
    (tmp_path / "latest").write_text("t" + ckpt_io.STAGING_SUFFIX)
    assert ckpt_io.read_latest_tag(str(tmp_path)) is None
    assert _engine().load_checkpoint(str(tmp_path)) == (None, {})
    ckpt_io.write_latest_tag(str(tmp_path), "real")
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "real"
    assert sorted(os.listdir(tmp_path)) == ["latest"]


def _case_keep_last_rotation(tmp_path):
    engine = _engine({"keep_last": 2})
    _train(engine, 1)
    for i in range(3):
        engine.save_checkpoint(str(tmp_path), tag=f"t{i}")
        engine.wait_for_checkpoint()
        time.sleep(0.05)   # distinct mtimes on coarse filesystems
    dirs = sorted(d for d in os.listdir(tmp_path)
                  if os.path.isdir(tmp_path / d))
    assert dirs == ["t1", "t2"], dirs
    assert engine.load_checkpoint(str(tmp_path))[0].endswith("t2")


def _case_timeout_abandon_and_shutdown(tmp_path):
    """A wedged writer: the bounded wait raises, abandonment frees the
    engine, the abandoned job still commits its tag but not `latest`,
    and a save to the tag it holds is skipped."""
    engine = _engine()
    _train(engine, 1)
    engine.save_checkpoint(str(tmp_path), tag="good", async_save=False)
    orig = engine._write_checkpoint
    release = threading.Event()

    def wedged(*a, **k):
        assert release.wait(timeout=30)
        return orig(*a, **k)

    engine._write_checkpoint = wedged
    engine.save_checkpoint(str(tmp_path), tag="stuck")
    with pytest.raises(ckpt_io.CheckpointWaitTimeout) as err:
        engine.wait_for_checkpoint(timeout=0.1)
    assert err.value.pending == 1
    assert engine.abandon_checkpoint_writers() == 1
    engine._write_checkpoint = orig
    assert engine.save_checkpoint(str(tmp_path), tag="stuck") is False
    engine.shutdown()   # nothing tracked: returns at once
    release.set()
    for w in engine._abandoned_ckpt_writers:
        w.wait(timeout=30)
    assert os.path.isdir(tmp_path / "stuck")
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "good"
    engine.save_checkpoint(str(tmp_path), tag="next")
    engine.shutdown()   # drains the new writer
    assert ckpt_io.read_latest_tag(str(tmp_path)) == "next"


ASYNC_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
               if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(ASYNC_CASES))
def test_async_checkpoint(case, tmp_path):
    ASYNC_CASES[case](tmp_path)
