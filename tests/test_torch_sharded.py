"""Blocks and pipelined host I/O of the port's sweep, against the port's own
one-device synchronous run and the reference's one-device ``SweepRunner``.

The port runs N blocks on the CPU as ``devices=[cpu] * N`` (the reference's
simulated host devices). The standing bar, ported from
``tests/test_sharded.py``:

- N blocks and the pipelined loop reproduce the one-device synchronous
  sweep bit for bit (states, shard arrays, manifest, records, the journal's
  event sequence), with injected failures, across a checkpoint resumed on
  another device count and across ``remesh``; against the reference's
  one-device sweep, counters and bitmaps are equal and floats within the
  tolerances of ``tests/test_torch_sweep.py`` (rtol 1e-5; atol 1e-3 on
  positions, 1e-4 on speeds);
- ``--workers`` composes with devices: the worker grid is devices x workers;
- ``plan_chunk_blocks`` equals the reference's on the same draws;
- overlapping ``begin_drain`` handles never drain an instance twice;
- ``sweep_devices`` and the launcher refuse more cards than exist.
"""

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from hypcompat import given, settings, st

from repro.core.record import RecordConfig as JRecordConfig
from repro.core.scenario import SimConfig as JSimConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import SweepRunner as JSweepRunner
from repro.core.sweep import plan_chunk_blocks as j_plan_chunk_blocks
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.io import flatten_with_paths
from repro_torch.convert import to_numpy
from repro_torch.core.fault import FailureInjector, FaultModel, run_with_failures
from repro_torch.core.fleet import RetryPolicy, RunJournal, run_supervised
from repro_torch.core.record import RecordConfig
from repro_torch.core.scenario import SimConfig
from repro_torch.core.sweep import (
    BlockPlan,
    SweepConfig,
    SweepRunner,
    completion_rate,
    plan_chunk_blocks,
)
from repro_torch.data.shards import DatasetWriter, ShardedDataset
from repro_torch.kernels import build
from repro_torch.launch import mesh
from repro_torch.launch import sweep as launcher

sys.path.insert(0, str(Path(__file__).parent))
from conftest import state_tree_np  # noqa: E402

MIX2 = ("highway_merge", "lane_drop")
COUNTERS = ("throughput", "spawned", "speed_count", "collisions", "merges_ok",
            "ramp_blocked_steps", "lane_changes", "steps")
KW = dict(n_instances=10, steps_per_instance=80, chunk_steps=40, seed=3,
          scenario_mix=MIX2, vary_horizon=True, min_horizon_frac=0.3)
_REF: dict = {}


def _cfg(**kw):
    return SweepConfig(sim=SimConfig(n_slots=16),
                       record=RecordConfig(record_every=10, k_slots=4),
                       **dict(KW, **kw))


def blocks(k):
    return ["cpu"] * k


def port_ref():
    """The port's one-device synchronous sweep, run once."""
    if "torch" not in _REF:
        _REF["torch"] = SweepRunner(_cfg(), device="cpu").run()
    return _REF["torch"]


def jax_ref():
    """The reference's one-device sweep of the same config, run once."""
    if "jax" not in _REF:
        jcfg = JSweepConfig(sim=JSimConfig(n_slots=16),
                            record=JRecordConfig(record_every=10, k_slots=4),
                            **KW)
        _REF["jax"] = state_tree_np(JSweepRunner(jcfg).run())
    return _REF["jax"]


def assert_states_equal(a, b):
    for (pa, x), (pb, y) in zip(flatten_with_paths(a), flatten_with_paths(b)):
        assert pa == pb
        assert torch.equal(x, y), pa


def assert_matches_reference(got):
    want, got = jax_ref(), to_numpy(got)
    for field in ("done", "chunk", "horizon", "scenario_id"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    for field in COUNTERS:
        np.testing.assert_array_equal(getattr(got.metrics, field),
                                      getattr(want.metrics, field),
                                      err_msg=field)
    for field in ("speed_sum", "min_ttc"):
        np.testing.assert_allclose(getattr(got.metrics, field),
                                   getattr(want.metrics, field), rtol=1e-5)
    for field in ("lane", "active", "t"):
        np.testing.assert_array_equal(getattr(got.sim, field),
                                      getattr(want.sim, field), err_msg=field)
    np.testing.assert_allclose(got.sim.pos, want.sim.pos, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.sim.vel, want.sim.vel, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got.trace.lane, want.trace.lane)
    np.testing.assert_array_equal(got.trace.active, want.trace.active)


# --------------------------------------------------------------------------
# blocks against one device
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch,wpd", [
    ("grouped", 1), ("grouped", 2), ("switch", 1), ("auto", 2),
])
def test_blocks_match_single_device_bitwise(dispatch, wpd):
    """Four blocks, the trace included, equal the port's one-device run bit
    for bit and the reference's within tolerance."""
    runner = SweepRunner(_cfg(dispatch=dispatch), devices=blocks(4),
                         workers_per_device=wpd)
    got = runner.run()
    assert completion_rate(got) == 1.0
    assert_states_equal(port_ref(), got)
    assert_matches_reference(got)


@pytest.mark.parametrize("k", [2, 3])
def test_block_count_invariance(k):
    """Two and three blocks (three does not divide ten) agree too."""
    got = SweepRunner(_cfg(), devices=blocks(k)).run()
    assert_states_equal(port_ref(), got)


def test_blocks_failure_parity():
    """The same plan kills the same logical instances on blocks: failure
    masks key on the worker grid, never on the block placement."""
    plan = {0: [0], 1: [2, 3]}
    for devices, wpd in ((None, 4), (blocks(4), 1)):
        runner = SweepRunner(_cfg(), device="cpu" if devices is None else None,
                             devices=devices, workers_per_device=wpd)
        final, info = run_with_failures(runner,
                                        FailureInjector(4, dict(plan)))
        assert info["completion_rate"] == 1.0
        assert len(info["failure_events"]) == 2
        assert_states_equal(port_ref(), final._replace(chunk=port_ref().chunk))
    assert_matches_reference(final._replace(chunk=port_ref().chunk))


@pytest.mark.parametrize("first,then", [(4, 1), (1, 4)])
def test_resume_across_device_count_change(tmp_path, first, then):
    """A checkpoint taken on one device count resumes on another, bit for
    bit: blocks never leak into the state."""
    ckpt = CheckpointManager(str(tmp_path / "sw"))
    runner = SweepRunner(_cfg(), devices=blocks(first))
    state = runner.run_chunk(runner.init())
    ckpt.save(int(state.chunk), state)
    ckpt.wait()
    final, info = run_with_failures(SweepRunner(_cfg(), devices=blocks(then)),
                                    FailureInjector(4, {}), ckpt=ckpt)
    assert info["completion_rate"] == 1.0
    assert info["chunks_run"] == int(final.chunk) - 1
    assert_states_equal(port_ref(), final)


def test_remesh_mid_sweep():
    """``remesh`` moves a live sweep between device counts mid-run."""
    runner = SweepRunner(_cfg(), devices=blocks(4))
    state = runner.run_chunk(runner.init())
    state = runner.remesh(state, blocks(2))
    assert runner.n_devices == 2 and runner._n_workers() == 2
    final = runner.run(state)
    assert completion_rate(final) == 1.0
    assert_states_equal(port_ref(), final)
    with pytest.raises(ValueError, match="at least one"):
        runner.remesh(final, [])


# --------------------------------------------------------------------------
# pipelined against synchronous
# --------------------------------------------------------------------------


def _supervised(tmp_path, name, *, pipeline, devices=None, faults=None,
                max_chunks=10_000):
    cfg = _cfg()
    root = tmp_path / name
    writer = DatasetWriter(str(root / "ds"), cfg, shard_size=3)
    journal = RunJournal(str(root / "journal.jsonl"))
    runner = SweepRunner(cfg, device="cpu" if devices is None else None,
                         devices=devices, workers_per_device=2)
    timings = []
    state, info = run_supervised(
        runner, faults, RetryPolicy(max_retries=1),
        ckpt=CheckpointManager(str(root / "ck")), writer=writer,
        journal=journal, pipeline=pipeline, max_chunks=max_chunks,
        on_timing=lambda c, t: timings.append((c, t)))
    writer.finalize(fault_info=info)
    return state, info, root, timings


def _events(root):
    return [{k: v for k, v in e.items() if k != "time"}
            for e in RunJournal.read(str(root / "journal.jsonl"))]


def _assert_same_dataset(a, b):
    da, db = ShardedDataset.load(str(a / "ds")), ShardedDataset.load(str(b / "ds"))
    assert da.manifest["shards"] == db.manifest["shards"]
    assert da.manifest["fault_events"] == db.manifest["fault_events"]
    for x, y in zip(da.iter_shards(), db.iter_shards()):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert da.records() == db.records()


@pytest.mark.parametrize("faulted", [False, True])
def test_pipelined_matches_synchronous(tmp_path, faulted):
    """Pipelining moves when files are written, never what: the final
    state, every shard array, the manifest, the records and the journal's
    events equal the synchronous loop's, with and without faults (a crash,
    a hang, a straggler, a poison instance that gets quarantined, a
    corrupted checkpoint and a corrupted shard); the pipelined run uses
    four blocks."""
    faults = None
    if faulted:
        faults = FaultModel(8, {0: [1]}, hangs={1: [4]}, stragglers={0: [2]},
                            poison_instances=(7,), corrupt_ckpt=frozenset({0}),
                            corrupt_shard=frozenset({1}))
    s_sync, i_sync, r_sync, t_sync = _supervised(tmp_path, "sync",
                                                 pipeline=False, faults=faults)
    s_pipe, i_pipe, r_pipe, t_pipe = _supervised(
        tmp_path, "pipe", pipeline=True, devices=blocks(4), faults=faults)
    assert i_sync["eligible_completion_rate"] == 1.0
    assert_states_equal(s_sync, s_pipe)
    for k in ("chunks_run", "failure_events", "quarantined", "report"):
        assert i_sync[k] == i_pipe[k], k
    _assert_same_dataset(r_sync, r_pipe)
    assert _events(r_sync) == _events(r_pipe)
    kinds = {e["kind"] for e in _events(r_sync)}
    if faulted:
        assert i_sync["quarantined"] == [7]
        assert {"failure", "straggler", "quarantine", "corrupt_ckpt",
                "corrupt_shard", "shard_repair"} <= kinds
    else:
        assert_states_equal(port_ref(), s_pipe)
    for timings in (t_sync, t_pipe):
        assert [c for c, _ in timings] == list(range(i_sync["chunks_run"]))
        for _, t in timings:
            assert sorted(t) == ["chunk_s", "ckpt_s", "commit_s", "drain_s",
                                 "wait_s"]
    assert all(t["wait_s"] == t["commit_s"] for _, t in t_sync)


def test_pipelined_kill_resume(tmp_path):
    """A pipelined run stopped after two chunks (its commit joined, so the
    last chunk's checkpoint is on disk) resumes, pipelined, to the
    one-device state bit for bit; the writer re-scans its shards."""
    _, info, root, _ = _supervised(tmp_path, "run", pipeline=True,
                                   devices=blocks(2), max_chunks=2)
    assert info["chunks_run"] == 2
    assert CheckpointManager(str(root / "ck")).has_checkpoint()
    final, info, root, _ = _supervised(tmp_path, "run", pipeline=True)
    assert info["completion_rate"] == 1.0
    assert_states_equal(port_ref(), final)
    ids = [i for s in ShardedDataset.load(str(root / "ds")).manifest["shards"]
           for i in s["instances"]]
    assert sorted(ids) == list(range(10))


def test_overlapping_begin_drain_never_duplicates(tmp_path):
    """Two outstanding ``begin_drain`` handles never drain an instance
    twice: a handle's ids are reserved until it is finished."""
    cfg = SweepConfig(n_instances=4, steps_per_instance=40, chunk_steps=40,
                      sim=SimConfig(n_slots=16), seed=0,
                      record=RecordConfig(record_every=10, k_slots=4))
    state = SweepRunner(cfg, device="cpu").run()
    w = DatasetWriter(str(tmp_path / "ds"), cfg, shard_size=2)
    h1 = w.begin_drain(state)
    h2 = w.begin_drain(state)  # overlapping: everything is already in flight
    assert h2 is None
    assert w.finish_drain(h1) == 4
    assert w.finish_drain(h2) == 0
    assert w.begin_drain(state) is None  # and persisted ids stay excluded
    w.finalize()
    ds = ShardedDataset.load(str(tmp_path / "ds"))
    assert ds.n_instances == 4
    assert sorted(r["instance"] for r in ds.records()) == [0, 1, 2, 3]


# --------------------------------------------------------------------------
# workers x devices, device lists, launcher
# --------------------------------------------------------------------------


def test_workers_compose_with_devices():
    """``--workers`` is instances per device: the worker grid the injector
    and the planner see is devices x workers, blocks are padded to a
    workers multiple, and a (4 x 2) and a (1 x 8) grid kill the same
    instances."""
    runner = SweepRunner(_cfg(), devices=blocks(4), workers_per_device=2)
    assert runner._n_workers() == 8
    bp = runner.plan_chunk_sharded(runner.init())
    assert isinstance(bp, BlockPlan) and bp.cap % 2 == 0
    assert bp.take.size == 4 * bp.cap and bp.n_devices == 4
    plan = {0: [5], 1: [1, 6]}
    finals = []
    for devices, wpd in ((blocks(4), 2), (None, 8)):
        r = SweepRunner(_cfg(), device="cpu" if devices is None else None,
                        devices=devices, workers_per_device=wpd)
        st_, info = run_with_failures(
            r, FailureInjector(r._n_workers(), dict(plan)))
        assert info["completion_rate"] == 1.0
        finals.append(st_)
    assert_states_equal(finals[0], finals[1])
    with pytest.raises(ValueError):
        SweepRunner(_cfg(), devices=blocks(2), workers_per_device=0)
    with pytest.raises(ValueError, match="devices\\[0\\]"):
        SweepRunner(_cfg(), device="cpu", devices=["meta", "meta"])


def test_sweep_devices_refuses_more_cards_than_exist(monkeypatch):
    assert mesh.sweep_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match=">= 1"):
        mesh.sweep_devices(0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert mesh.sweep_devices(1, "cuda") == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        mesh.sweep_devices(2, "cuda")
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        launcher.main(["--instances", "2", "--steps", "10", "--devices", "2"])


def test_launcher_blocks_pipelined_out_equals_synchronous(tmp_path, capsys):
    """``--devices 4 --pipeline`` and ``--devices 1 --no-pipeline`` write
    the same ``--out`` file; the status line names devices x workers and
    the I/O mode."""
    base = ["--device", "cpu", "--instances", "10", "--steps", "80",
            "--chunk-steps", "40", "--slots", "16", "--scenario-mix", "all",
            "--vary-horizon", "--seed", "3", "--dataset-dir"]
    outs = []
    for name, extra in (("a", ["--devices", "4", "--pipeline"]),
                        ("b", ["--devices", "1", "--no-pipeline"])):
        out = tmp_path / f"{name}.json"
        launcher.main(base + [str(tmp_path / name), "--out", str(out)] + extra)
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert json.loads(outs[0])["fault_info"]["completion_rate"] == 1.0
    text = capsys.readouterr().out
    assert "4 device(s) x 1 worker(s)" in text and "pipelined I/O" in text
    assert "1 device(s) x 1 worker(s)" in text and "synchronous I/O" in text


def test_launch_counts_are_exact_under_threads():
    """``build.launched`` and ``SweepRunner.group_calls`` count every call
    from many threads, with the interpreter switching threads often."""
    counts = {"k": 0}
    # a rollout of no steps: a bare count
    runner = SweepRunner(_cfg(chunk_steps=0), device="cpu")
    st0 = runner.init()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                build.launched("k", 0, counts)
            for _ in range(50):
                runner._rollout(runner._sims[0], st0.sim, st0.metrics,
                                st0.params, st0.horizon, st0.trace)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 16 * 2000
    assert runner.group_calls == 16 * 50


# --------------------------------------------------------------------------
# the planner, bit for bit
# --------------------------------------------------------------------------


def _plans_equal(done, sids, n_devices, wpd, grouped, compaction, hold):
    kw = dict(grouped=grouped, compaction=compaction, hold=hold)
    want = j_plan_chunk_blocks(done, sids, n_devices, wpd, **kw)
    got = plan_chunk_blocks(done, sids, n_devices, wpd, **kw)
    if want is None:
        assert got is None
        return
    assert (got.cap, got.identity) == (want.cap, want.identity)
    for field in ("take", "keep", "block_sid"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
        assert getattr(got, field).dtype == getattr(want, field).dtype


@settings(max_examples=80, deadline=None)
@given(
    n=st.integers(1, 40),
    n_devices=st.integers(1, 8),
    wpd=st.integers(1, 4),
    n_scenarios=st.integers(1, 5),
    grouped=st.booleans(),
    compaction=st.booleans(),
    held=st.booleans(),
    seed=st.integers(0, 2**32 - 1),
)
def test_property_plan_chunk_blocks_matches_reference(
        n, n_devices, wpd, n_scenarios, grouped, compaction, held, seed):
    rng = np.random.default_rng(seed)
    done = rng.random(n) < rng.uniform(0.0, 1.0)
    sids = rng.integers(0, n_scenarios, size=n).astype(np.int32)
    hold = rng.random(n) < 0.2 if held else None
    _plans_equal(done, sids, n_devices, wpd, grouped, compaction, hold)


def test_plan_chunk_blocks_matches_reference_seedwise():
    """The same comparison without hypothesis: 200 seeded bitmaps."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 40))
        done = rng.random(n) < rng.uniform(0.0, 1.0)
        sids = rng.integers(0, int(rng.integers(1, 6)), size=n)
        hold = rng.random(n) < 0.2 if rng.integers(2) else None
        _plans_equal(done, sids, int(rng.integers(1, 9)),
                     int(rng.integers(1, 4)), bool(rng.integers(2)),
                     bool(rng.integers(2)), hold)
