"""PyTorch port: the launch-plan autotuner against the JAX package's
autotuner (ops/autotune.py in both).

Held here, exactly (these are strings, dicts and integers):
  * `pow2_bucket`, the shape classes, `entry_key` and the collective
    schedule candidates equal the JAX package's outputs for the same
    inputs. The kernel families' candidates differ by design: the JAX
    package tunes Pallas block shapes, the port its kernels' run-time
    launch plans (K3's row groups, grid and fold, K4's CTAs per group)
    and the tile pairs its CUDA sources instantiate; those are checked
    against the plans' own constraints;
  * the table round-trips; a wrong version, a corrupt file or a stale
    source hash gives the default plan and one warning; an edit to a
    family's `.cu` source changes its hash;
  * the never-slower floor with a fake `measure`;
  * a tuned plan reaches `ln_fwd_plan`, `ln_bwd_plan` and `gelu_plan`
    at a given SM count and the C entry's arguments (the launch is a
    fake entry here: the CPU has no kernel), and the plans' cache does
    not hide a later winner;
  * `overlap` `sites: "auto"` reads the `collective_schedule` entries;
  * the monitor events' keys equal the JAX package's.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops import autotune as jat
from deepspeed_tpu.ops import overlap as joverlap
from deepspeed_tpu_torch.ops import autotune as tat
from deepspeed_tpu_torch.ops import overlap as toverlap
from deepspeed_tpu_torch.ops.transformer import fused_ops as fo
from torch_one_thread import one_torch_thread  # noqa: F401

BACKEND = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _isolated_table(tmp_path):
    for mod in (tat, jat):
        mod.reset()
        mod.configure(table_path=str(tmp_path / f"{mod.__name__}.json"))
    yield tmp_path
    for mod in (tat, jat):
        mod.reset()
    toverlap.reset()
    joverlap.reset()


class _StubMonitor:
    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, fields))


class _Warnings(logging.Handler):
    """The port's logger does not propagate (caplog misses it)."""

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        from deepspeed_tpu_torch.utils.logging import logger
        logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.utils.logging import logger
        logger.removeHandler(self)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 64, 100, 1023, 1024, 11264])
def test_pow2_bucket_equals_jax(n):
    assert tat.pow2_bucket(n) == jat.pow2_bucket(n)


@pytest.mark.parametrize("args", [(1024, 64, True, False),
                                  (4096, 128, False, True),
                                  (128, 64, True, True)])
def test_flash_shape_class_equals_jax(args):
    assert tat.flash_shape_class(*args) == jat.flash_shape_class(*args)


@pytest.mark.parametrize("n,h", [(4, 1600), (11264, 1600), (11264, 6400),
                                 (2048, 1024), (7, 64)])
def test_row_and_qmm_shape_classes_equal_jax(n, h):
    assert tat.row_kernel_shape_class(n, h) == \
        jat.row_kernel_shape_class(n, h)
    assert tat.row_plan_shape_class(n, h, "fwd") == \
        jat.row_kernel_shape_class(n, h) + "_fwd"
    assert tat.qmm_shape_class(n, h, 3 * h) == \
        jat.qmm_shape_class(n, h, 3 * h)


@pytest.mark.parametrize("dtype", [(torch.float32, jnp.float32),
                                   (torch.bfloat16, jnp.bfloat16),
                                   (torch.float16, jnp.float16),
                                   ("schedule", "schedule")])
def test_entry_key_equals_jax(dtype):
    tdt, jdt = dtype
    assert tat.entry_key("fused_ln", "rows16384_h1600_fwd", tdt,
                         backend=BACKEND) == \
        jat.entry_key("fused_ln", "rows16384_h1600_fwd", jdt,
                      backend=BACKEND)
    assert tat._backend() == "cpu"


@pytest.mark.parametrize("site", ["moe_dispatch", "ring", "zero3_leaf"])
@pytest.mark.parametrize("mesh", [None, {"data": 8, "expert": 2},
                                  {"pipe": 1, "data": 4, "model": 2}])
@pytest.mark.parametrize("payload", [0, 1000, 4096, 3 * 2 ** 20])
def test_collective_family_equals_jax(site, mesh, payload):
    assert tat.collective_candidates(site) == \
        jat.collective_candidates(site)
    assert tat.collective_shape_class(site, mesh, payload) == \
        jat.collective_shape_class(site, mesh, payload)
    assert tat.mesh_shape_class(mesh) == jat.mesh_shape_class(mesh)
    assert tat.COLLECTIVE_DEFAULT == jat.COLLECTIVE_DEFAULT
    assert tat.TABLE_VERSION == jat.TABLE_VERSION == 2
    assert tat.TABLE_BASENAME == jat.TABLE_BASENAME
    assert set(tat.KERNEL_MODULES) == set(jat.KERNEL_MODULES)


# ----------------------------------------------------------------------
# the port's candidates: launch plans the kernels can take
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,h,sms", [(11264, 1600, 132), (4, 1600, 132),
                                     (2048, 1024, 132), (64, 64, 8),
                                     (100, 5120, 132)])
def test_row_candidates_are_plans_the_kernels_take(n, h, sms):
    for direction in ("fwd", "bwd"):
        default, cands = tat.row_search_space("fused_ln", direction, n, h,
                                              sms)
        plan = (fo.ln_fwd_plan if direction == "fwd" else fo.ln_bwd_plan)
        assert plan(n, h, sms, True, fo._tuned(default)) == \
            plan(n, h, sms)
        assert cands and len({json.dumps(c, sort_keys=True)
                              for c in cands}) == len(cands)
        for c in cands:
            p = plan(n, h, sms, True, fo._tuned(c))
            assert p.grid >= 1 and p.groups >= 1
            assert p.threads <= 32 * 20
            if direction == "bwd":
                assert 1 <= p.fold <= p.grid
                assert p.fold_groups == -(-p.grid // p.fold)
    for w in (h, 4 * h):
        default, cands = tat.row_search_space("fused_gelu", "bwd", n, w,
                                              sms)
        assert fo.gelu_plan(n, w, 1, sms, True, fo._tuned(default)) == \
            fo.gelu_plan(n, w, 1, sms)
        for c in cands:
            p = fo.gelu_plan(n, w, 1, sms, True, fo._tuned(c))
            assert p.work_rows == p.ctas_per_group >= 1


def test_plans_raise_on_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="positive int"):
        fo.ln_fwd_plan(64, 1600, 132, True, fo._tuned({"grid": 0}))
    with pytest.raises(ValueError, match="unknown keys"):
        fo.ln_bwd_plan(64, 1600, 132, True, fo._tuned({"row_block": 64}))
    with pytest.raises(ValueError, match="warps"):
        fo.ln_bwd_plan(64, 1600, 132, True, fo._tuned({"groups": 3}))
    with pytest.raises(ValueError, match="warps"):
        fo.ln_fwd_plan(64, 5120, 132, True, fo._tuned({"groups": 2}))
    with pytest.raises(ValueError, match="positive int"):
        fo.gelu_plan(64, 256, 1, 132, True,
                     fo._tuned({"ctas_per_group": 1.5}))


def test_flash_and_qmm_candidates_are_the_instantiated_tiles():
    from deepspeed_tpu_torch.ops.transformer.flash_attention import \
        _kernel_tiles
    for dt, d in ((torch.bfloat16, 64), (torch.float16, 128),
                  (torch.float32, 64)):
        bq, bk = _kernel_tiles(dt, d)
        assert tat.flash_tile_candidates(dt, d) == \
            [{"block_q": bq, "block_k": bk}]
    assert tat.qmm_tile_candidates() == [{"block_m": 128, "block_n": 128}]
    # one candidate: the search measures the default alone, speedup 1.0
    res = tat.search("flash_fwd", "t1024_d64_causal", torch.bfloat16,
                     tat.flash_tile_candidates(torch.bfloat16, 64),
                     tat.flash_tile_candidates(torch.bfloat16, 64)[0],
                     measure=lambda p: 1e-3)
    assert res["speedup_vs_default"] == 1.0
    assert res["candidates_tried"] == 1


# ----------------------------------------------------------------------
# search semantics and the table
# ----------------------------------------------------------------------
def _fake_search(mod, dtype, times, default=10, persist=True):
    return mod.search("fused_gelu", "rows256_h128_fwd", dtype,
                      [{"ctas_per_group": c} for c in times if c != default],
                      {"ctas_per_group": default},
                      measure=lambda p: times[p["ctas_per_group"]],
                      persist=persist)


@pytest.mark.parametrize("times,winner,speedup", [
    ({10: 3e-3, 5: 1e-3, 20: 2e-3}, 5, 3.0),
    ({10: 1e-3, 5: 5e-3, 20: 9e-3}, 10, 1.0),
    ({10: 2e-3, 5: 2e-3}, 10, 1.0),
])
def test_never_slower_floor_equals_jax(times, winner, speedup):
    got = _fake_search(tat, torch.float32, times)
    ref = _fake_search(jat, jnp.float32, times)
    assert got["params"] == ref["params"] == {"ctas_per_group": winner}
    assert got["speedup_vs_default"] == ref["speedup_vs_default"] == speedup
    assert set(got) == set(ref)


def test_search_needs_a_measurement_source():
    with pytest.raises(ValueError):
        tat.search("fused_ln", "s", torch.float32, [], {})


def test_search_with_build_interleaves_and_times_each_candidate():
    calls = []

    def build(p):
        return lambda: calls.append(p["ctas_per_group"])
    res = tat.search("fused_gelu", "rows8_h64_bwd", torch.float32,
                     [{"ctas_per_group": 2}], {"ctas_per_group": 1},
                     build=build, warmup=2, reps=3, inner=4)
    assert res["candidates_tried"] == 2
    # warm-up 2 each, then 3 rounds of 4 calls each, round robin
    assert calls[:4] == [1, 1, 2, 2]
    assert calls[4:] == [1] * 4 + [2] * 4 + [1] * 4 + [2] * 4 + \
        [1] * 4 + [2] * 4
    t = tat.measure_callable(lambda: None, warmup=1, reps=2, inner=3)
    assert t >= 0.0


def test_table_roundtrip(tmp_path):
    _fake_search(tat, torch.bfloat16, {10: 2e-3, 5: 1e-3})
    path = tat.table_path()
    tat.reset()
    tat.configure(table_path=path)
    assert tat.lookup("fused_gelu", "rows256_h128_fwd", torch.bfloat16) == \
        {"ctas_per_group": 5}
    doc = json.load(open(path))
    assert doc["version"] == tat.TABLE_VERSION
    (key, entry), = doc["entries"].items()
    assert key == "fused_gelu|cpu|bfloat16|rows256_h128_fwd"
    assert entry["source_hash"] == tat.kernel_source_hash("fused_gelu")
    _fake_search(jat, jnp.bfloat16, {10: 2e-3, 5: 1e-3})
    (_, jentry), = json.load(open(jat.table_path()))["entries"].items()
    assert set(entry) == set(jentry)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_default_path_env_override_and_build_cache(monkeypatch, tmp_path):
    from deepspeed_tpu_torch.ops import _build
    tat.reset()
    assert tat.table_path() == os.path.join(_build.BUILD_DIR,
                                            tat.TABLE_BASENAME)
    assert "build" in tat.table_path().split(os.sep)
    monkeypatch.setenv("DS_TPU_AUTOTUNE_TABLE", str(tmp_path / "env.json"))
    assert tat.table_path() == str(tmp_path / "env.json")
    tat.configure(table_path=str(tmp_path / "cfg.json"))
    assert tat.table_path() == str(tmp_path / "cfg.json")


@pytest.mark.parametrize("damage", ["version", "corrupt", "hash"])
def test_bad_tables_give_defaults_and_one_warning(damage):
    _fake_search(tat, torch.float32, {10: 2e-3, 5: 1e-3})
    path = tat.table_path()
    doc = json.load(open(path))
    if damage == "version":
        doc["version"] = 1
        json.dump(doc, open(path, "w"))
        needle = "version"
    elif damage == "corrupt":
        open(path, "w").write("{not json")
        needle = "unreadable"
    else:
        for e in doc["entries"].values():
            e["source_hash"] = "deadbeef"
        json.dump(doc, open(path, "w"))
        needle = "different kernel source"
    tat.reset()
    tat.configure(table_path=path)
    with _Warnings() as w:
        for _ in range(3):
            assert tat.lookup("fused_gelu", "rows256_h128_fwd",
                              torch.float32) is None
            assert tat.row_plan("fused_gelu", 256, 128, "fwd",
                                torch.float32) is None
    assert len([m for m in w.messages if needle in m]) == 1, w.messages


def test_source_hash_covers_the_cuda_sources(monkeypatch, tmp_path):
    """An edit to fused_ln_bwd.cu changes the fused_ln family's hash and
    no other family's."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(tat._CSRC, csrc)
    monkeypatch.setattr(tat, "_CSRC", str(csrc))
    before = {k: tat.kernel_source_hash(k) for k in tat.KERNEL_SOURCES}
    with open(csrc / "fused_ln_bwd.cu", "a") as f:
        f.write("\n// edited\n")
    tat.reset()
    after = {k: tat.kernel_source_hash(k) for k in tat.KERNEL_SOURCES}
    assert [k for k in before if before[k] != after[k]] == ["fused_ln"]


def test_disabled_lookups_return_none():
    _fake_search(tat, torch.float32, {10: 2e-3, 5: 1e-3})
    tat.configure(enabled=False)
    assert tat.lookup("fused_gelu", "rows256_h128_fwd", torch.float32) \
        is None
    tat.configure(enabled=True)
    assert tat.lookup("fused_gelu", "rows256_h128_fwd", torch.float32) == \
        {"ctas_per_group": 5}


# ----------------------------------------------------------------------
# a tuned plan reaches the launch
# ----------------------------------------------------------------------
class _FakeEntry:
    """Stands in for a kernel's C entry: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    from deepspeed_tpu_torch.ops import _build
    entries = {}

    def function(lib, fn, argtypes):
        return entries.setdefault(fn, _FakeEntry())
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(fo, "_sm_count", lambda dev: 132)
    return entries


def _record(kernel, n, h, direction, params, dtype=torch.float32):
    tat.record(kernel, tat.row_plan_shape_class(n, h, direction), dtype,
               params, 1.0, 2.0, 2)


def test_tuned_plans_reach_the_c_entries(fake_launch):
    n, h, w = 64, 1600, 256
    g = torch.Generator().manual_seed(0)
    y, res = torch.randn(n, h, generator=g), torch.randn(n, h, generator=g)
    vec = torch.ones(h)
    x = torch.randn(n, w, generator=g)

    def launch_all():
        fo._ln_fwd_launch(y, vec, res, vec, vec, 1e-5, torch.float32,
                          torch.float32, True)
        fo._ln_bwd_launch(y, vec, res, res, 1e-5, torch.float32)
        fo._gelu_fwd_launch(x, torch.zeros(w), True, torch.float32,
                            torch.float32)
        fo._gelu_bwd_launch(x, x, True, torch.float32)

    def args():
        fwd = fake_launch["ds_fused_ln_fwd"].calls[-1]
        bwd = fake_launch["ds_fused_ln_bwd"].calls[-1]
        gf = fake_launch["ds_fused_gelu_fwd"].calls[-1]
        gb = fake_launch["ds_fused_gelu_bwd"].calls[-1]
        # (groups, grid); (groups, grid, fold); ctas_per_group twice
        return fwd[-4:-2], bwd[-5:-2], gf[7], gb[9]

    launch_all()
    d_fwd, d_bwd = fo.ln_fwd_plan(n, h, 132), fo.ln_bwd_plan(n, h, 132)
    assert args() == ((d_fwd.groups, d_fwd.grid),
                      (d_bwd.groups, d_bwd.grid, d_bwd.fold),
                      fo.gelu_plan(n, w, 1, 132).ctas_per_group,
                      fo.gelu_plan(n, w, 1, 132).ctas_per_group)
    mon = _StubMonitor()
    tat.configure(monitor=mon)
    for tuned in ({"groups": 2, "grid": 5}, {"groups": 1, "grid": 3}):
        # a later winner is not hidden by the plans' cache
        _record("fused_ln", n, h, "fwd", tuned)
        _record("fused_ln", n, h, "bwd", {"groups": 1, "grid": 7,
                                          "fold": tuned["grid"]})
        _record("fused_gelu", n, w, "fwd", {"ctas_per_group": tuned["grid"]})
        _record("fused_gelu", n, w, "bwd",
                {"ctas_per_group": tuned["grid"] + 1})
        launch_all()
        assert args() == ((tuned["groups"], tuned["grid"]),
                          (1, 7, tuned["grid"]), tuned["grid"],
                          tuned["grid"] + 1)
    # the workspace follows the plan: K3-bwd's counters one per fold
    # group and one for the groups
    plan = fo.ln_bwd_plan(n, h, 132, True,
                          fo._tuned({"groups": 1, "grid": 7, "fold": 3}))
    assert (plan.fold_groups, plan.counters) == (3, 4)
    # one autotune_hit per key, the JAX package's keys
    hits = [f for k, f in mon.events if k == "autotune_hit"]
    assert len(hits) == 4
    assert set(hits[0]) == {"kernel", "shape_class", "dtype", "backend",
                            "params"}
    # the caller's plan wins over the table
    fo._ln_fwd_launch(y, vec, res, vec, vec, 1e-5, torch.float32,
                      torch.float32, True, tuned={"groups": 2, "grid": 9})
    assert fake_launch["ds_fused_ln_fwd"].calls[-1][-4:-2] == (2, 9)


def test_events_keys_equal_jax():
    tmon, jmon = _StubMonitor(), _StubMonitor()
    tat.configure(monitor=tmon)
    jat.configure(monitor=jmon)
    _fake_search(tat, torch.float32, {10: 2e-3, 5: 1e-3})
    _fake_search(jat, jnp.float32, {10: 2e-3, 5: 1e-3})
    tat.lookup("fused_gelu", "rows256_h128_fwd", torch.float32)
    jat.lookup("fused_gelu", "rows256_h128_fwd", jnp.float32)
    assert [k for k, _ in tmon.events] == [k for k, _ in jmon.events] == \
        ["autotune_search", "autotune_hit"]
    for (_, t), (_, j) in zip(tmon.events, jmon.events):
        assert set(t) == set(j)
        assert {k: v for k, v in t.items() if k != "backend"} == \
            {k: v for k, v in j.items() if k != "backend"}


# ----------------------------------------------------------------------
# overlap: "auto" reads the collective schedule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("site", ["moe_dispatch", "ring"])
def test_overlap_auto_reads_collective_schedule_as_jax(site):
    mesh, payload = {"data": 1}, 64 * 1024
    times = {json.dumps(c, sort_keys=True): 1.0 + i
             for i, c in enumerate(tat.collective_candidates(site))}
    best = tat.collective_candidates(site)[-1]
    times[json.dumps(best, sort_keys=True)] = 0.1
    for mod in (tat, jat):
        mod.search_collective_schedule(
            site, mesh, payload,
            measure=lambda p: times[json.dumps(p, sort_keys=True)])
    for ov in (toverlap, joverlap):
        ov.configure(enabled=True, sites="auto")
    got = toverlap.schedule(site, payload, mesh)
    assert got == joverlap.schedule(site, payload, mesh)
    assert got == {"overlap": best["overlap"],
                   "issue_distance": best["issue_distance"],
                   "granularity": best["granularity"]}
    # an explicit site list wins over the table
    toverlap.configure(sites=[site])
    assert toverlap.schedule(site, payload, mesh)["overlap"] is True
    assert toverlap.schedule(site, payload, mesh)["granularity"] == 1
    # no entry for another payload class: the untuned schedule
    toverlap.configure(sites="auto")
    assert toverlap.schedule(site, 2 ** 30, mesh) == \
        {"overlap": True, "issue_distance": 1, "granularity": 1}


def test_engine_wires_the_block(tmp_path):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    model = tgpt2.GPT2ForCausalLM(tgpt2.tiny_gpt2_config(), device="cpu")
    path = str(tmp_path / "engine_table.json")
    engine, *_ = dst.initialize(
        model=model, model_parameters=model.init(seed=0),
        config={"train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "autotune": {"enabled": False, "table_path": path}})
    assert tat.table_path() == path and not tat._state["enabled"]
    assert np.isfinite(float(engine.train_batch(batch={
        "input_ids": np.zeros((1, 2, 16), np.int32)})))
