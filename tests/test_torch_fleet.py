"""Faults and fleet supervision of the port (``repro_torch.core.fault`` and
``repro_torch.core.fleet``), mirroring ``tests/test_fault.py`` and
``tests/test_fleet.py``.

Levels:
- against the reference, exactly: the same ``random_model`` seed gives the
  same fault schedule, and a supervised run gives the same journal event
  sequence (every field but the wall-clock ``time``) and the same fleet
  table;
- within the port, bit for bit: a faulted run ends in the fault-free
  run's state, a killed and resumed run in the uninterrupted run's (state
  and shards), and a corrupt checkpoint or shard costs nothing but time.
"""

import json

import numpy as np
import pytest
import torch

from repro.core.fault import FailureInjector as JFailureInjector
from repro.core.fault import FaultModel as JFaultModel
from repro.core.fleet import RetryPolicy as JRetryPolicy
from repro.core.fleet import RunJournal as JRunJournal
from repro.core.fleet import format_completion_table as j_table
from repro.core.fleet import run_supervised as j_run_supervised
from repro.core.scenario import SimConfig as JSimConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import SweepRunner as JSweepRunner
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.io import flatten_with_paths
from repro_torch.core.fault import (
    FailureInjector,
    FaultModel,
    revert_instances,
    run_with_failures,
)
from repro_torch.core.fleet import (
    FleetState,
    RetryPolicy,
    RunJournal,
    completion_report,
    format_completion_table,
    run_supervised,
)
from repro_torch.core.record import RecordConfig
from repro_torch.core.scenario import SimConfig
from repro_torch.core.sweep import SweepConfig, SweepRunner
from repro_torch.data.shards import DatasetWriter, ShardedDataset

MIX = ("highway_merge", "lane_drop")
_CLEAN: dict = {}


def _cfg(**kw):
    base = dict(n_instances=8, steps_per_instance=80, chunk_steps=20,
                sim=SimConfig(n_slots=16), seed=11)
    base.update(kw)
    return SweepConfig(**base)


def _rec_cfg(**kw):
    return _cfg(scenario_mix=MIX, vary_horizon=True, min_horizon_frac=0.4,
                record=RecordConfig(record_every=10, k_slots=4), **kw)


def runner(cfg, workers=1):
    return SweepRunner(cfg, device="cpu", workers_per_device=workers)


def clean(kind="plain"):
    if kind not in _CLEAN:
        cfg = _cfg() if kind == "plain" else _rec_cfg()
        _CLEAN[kind] = runner(cfg).run()
    return _CLEAN[kind]


def assert_states_equal(a, b, skip=()):
    for (pa, x), (pb, y) in zip(flatten_with_paths(a), flatten_with_paths(b)):
        assert pa == pb
        if pa not in skip:
            assert torch.equal(x, y), pa


def shard_rows(root):
    out = {}
    for z in ShardedDataset.load(root).iter_shards():
        for j, i in enumerate(z["instance"]):
            out[int(i)] = {k: v[j] for k, v in z.items()}
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_schedules_match_reference(seed):
    kw = dict(n_workers=6, n_chunks=9, fail_prob=0.2, hang_prob=0.1,
              straggler_prob=0.15, poison_instances=(3,),
              corrupt_ckpt_prob=0.2, corrupt_shard_prob=0.3, seed=seed)
    a, b = JFaultModel.random_model(**kw), FaultModel.random_model(**kw)
    for field in ("n_workers", "plan", "hangs", "stragglers",
                  "poison_instances", "corrupt_ckpt", "corrupt_shard"):
        assert getattr(a, field) == getattr(b, field), field
    for c in range(9):
        assert a.lost_workers(c) == b.lost_workers(c)
        np.testing.assert_array_equal(a.instance_mask(c, 20),
                                      b.instance_mask(c, 20))
    assert (JFailureInjector.random(5, 7, 0.3, seed).plan
            == FailureInjector.random(5, 7, 0.3, seed).plan)
    assert b.worker_of(13, 20) == a.worker_of(13, 20)


def test_supervised_journal_matches_reference(tmp_path):
    """Crashes, hangs, stragglers and a poison instance over a 4-worker
    grid: the same events, in the same order, with the same fields, and
    the same completion table."""
    kw = dict(n_workers=4, n_chunks=12, fail_prob=0.15, hang_prob=0.1,
              straggler_prob=0.1, poison_instances=(5,), seed=2)
    jcfg = JSweepConfig(n_instances=8, steps_per_instance=80, chunk_steps=20,
                        sim=JSimConfig(n_slots=16), seed=11)
    cfg = _cfg()
    jj, pj = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    _, jinfo = j_run_supervised(
        JSweepRunner(jcfg, workers_per_device=4), JFaultModel.random_model(**kw),
        JRetryPolicy(max_retries=2), journal=JRunJournal(jj))
    _, info = run_supervised(
        runner(cfg, 4), FaultModel.random_model(**kw), RetryPolicy(max_retries=2),
        journal=RunJournal(pj))
    strip = lambda evs: [{k: v for k, v in e.items() if k != "time"}  # noqa: E731
                         for e in evs]
    want, got = strip(JRunJournal.read(jj)), strip(RunJournal.read(pj))
    assert got == want
    kinds = {e["kind"] for e in got}
    assert {"failure", "straggler", "quarantine", "chunk", "complete"} <= kinds
    assert info["quarantined"] == jinfo["quarantined"] == [5]
    assert format_completion_table(info["report"]) == j_table(jinfo["report"])


def test_retry_policy_journal_and_replay(tmp_path):
    p = RetryPolicy(backoff_base=1, backoff_factor=2.0, backoff_cap=5)
    assert [p.backoff_chunks(k) for k in range(1, 6)] == [1, 2, 4, 5, 5]
    jr = RunJournal(str(tmp_path / "sub" / "j.jsonl"))
    assert not jr.exists()
    jr.append({"kind": "failure", "retries": {"2": 1}, "hold_until": {"2": 3}})
    jr.append({"kind": "quarantine", "instances": [4]})
    with open(jr.path, "a") as f:
        f.write('{"kind": "failure", "retr')  # torn by a kill
    events = RunJournal.read(jr.path)
    assert [e["kind"] for e in events] == ["failure", "quarantine"]
    assert all("time" in e for e in events)
    fs = FleetState.replay(events, 6)
    assert fs.retries.tolist() == [0, 0, 1, 0, 0, 0]
    assert fs.hold_until[2] == 3 and fs.quarantined.tolist()[4]
    assert fs.held(2).tolist() == [False, False, True, False, True, False]
    assert fs.held(3).tolist() == [False, False, False, False, True, False]


def test_revert_instances_restores_masked_rows_only():
    r = runner(_rec_cfg())
    s0 = r.init()
    s1 = r.run_chunk(s0)
    mask = np.zeros(8, bool)
    mask[[1, 6]] = True
    out = revert_instances(s1, s0, mask)
    assert int(out.chunk) == 1
    for (path, a), (_, b), (_, c) in zip(flatten_with_paths(out),
                                         flatten_with_paths(s0),
                                         flatten_with_paths(s1)):
        if a.dim() == 0:
            continue
        assert torch.equal(a[[1, 6]], b[[1, 6]]), path
        keep = [0, 2, 3, 4, 5, 7]
        assert torch.equal(a[keep], c[keep]), path


def test_failed_runs_equal_the_clean_run(tmp_path):
    """Crashes and hangs with backoff, and the legacy loop's reverts, only
    change when instances run: the final state is the fault-free one."""
    fm = FaultModel(4, {0: [1], 1: [0, 3]}, hangs={3: [2]})
    state, info = run_supervised(runner(_cfg()), fm, RetryPolicy(max_retries=10),
                                 journal=RunJournal(str(tmp_path / "j.jsonl")))
    assert info["completion_rate"] == 1.0 and info["retries_total"] > 0
    assert_states_equal(clean(), state, skip=(".chunk",))
    state, info = run_with_failures(runner(_cfg()),
                                    FailureInjector(4, {0: [1], 2: [0, 3]}))
    assert info["completion_rate"] == 1.0 and len(info["failure_events"]) == 2
    assert_states_equal(clean(), state, skip=(".chunk",))


def test_kill_resume_parity_under_faults(tmp_path):
    """A faulted, recording, checkpointed run killed after two chunks and
    resumed (the fault plan by the absolute chunk counter, the fleet state
    from the journal) ends in the uninterrupted run's state and shards."""
    plan = {0: [1], 2: [0, 2], 3: [3]}
    pol = RetryPolicy(max_retries=8)
    full_wr = DatasetWriter(str(tmp_path / "full"), _rec_cfg(), shard_size=3)
    full, _ = run_supervised(runner(_rec_cfg()), FaultModel(4, dict(plan)),
                             pol, writer=full_wr)
    full_wr.finalize()
    ck = CheckpointManager(str(tmp_path / "ck"))
    jr = RunJournal(str(tmp_path / "j.jsonl"))
    wr = DatasetWriter(str(tmp_path / "ds"), _rec_cfg(), shard_size=3)
    _, info_a = run_supervised(runner(_rec_cfg()), FaultModel(4, dict(plan)),
                               pol, ckpt=ck, writer=wr, journal=jr,
                               max_chunks=2)
    assert info_a["completion_rate"] < 1.0
    del wr
    wr = DatasetWriter(str(tmp_path / "ds"), _rec_cfg(), shard_size=3)
    resumed, info_b = run_supervised(
        runner(_rec_cfg()), FaultModel(4, dict(plan)), pol, ckpt=ck,
        writer=wr, journal=jr)
    wr.finalize()
    assert info_b["completion_rate"] == 1.0
    assert_states_equal(full, resumed)
    assert "resume" in [e["kind"] for e in RunJournal.read(jr.path)]
    a, b = shard_rows(str(tmp_path / "ds")), shard_rows(str(tmp_path / "full"))
    assert a.keys() == b.keys() == set(range(8))
    for i in a:
        for k in a[i]:
            np.testing.assert_array_equal(a[i][k], b[i][k], err_msg=f"{i}/{k}")


def test_run_with_failures_resume_uses_absolute_chunk(tmp_path):
    plan = {0: [1], 2: [0, 3], 3: [2]}
    full, _ = run_with_failures(runner(_cfg()), FailureInjector(4, dict(plan)))
    ck = CheckpointManager(str(tmp_path / "ck"))
    run_with_failures(runner(_cfg()), FailureInjector(4, dict(plan)),
                      ckpt=ck, max_chunks=2)
    resumed, info = run_with_failures(runner(_cfg()),
                                      FailureInjector(4, dict(plan)), ckpt=ck)
    assert info["completion_rate"] == 1.0
    assert_states_equal(full, resumed)   # the chunk counter included


def test_pipeline_is_refused():
    """``pipeline=True`` is no longer refused: both loops accept it and
    reach the synchronous loop's final state bit for bit."""
    state, info = run_supervised(runner(_cfg()), pipeline=True)
    assert info["completion_rate"] == 1.0
    assert_states_equal(clean(), state)
    state, info = run_with_failures(runner(_cfg()), FailureInjector(1, {}),
                                    pipeline=True)
    assert info["completion_rate"] == 1.0 and info["failure_events"] == []
    assert_states_equal(clean(), state)


def test_poison_quarantine_and_backoff(tmp_path):
    """The poison instance is quarantined after its budget; instances that
    failed sit out their backoff; the rest completes; journal replay
    gives the final fleet state."""
    jr = RunJournal(str(tmp_path / "j.jsonl"))
    fm = FaultModel(4, {0: [0]}, poison_instances=(6,))
    state, info = run_supervised(
        runner(_cfg()), fm, RetryPolicy(max_retries=2, backoff_base=2),
        journal=jr, max_chunks=60)
    assert info["quarantined"] == [6]
    assert info["eligible_completion_rate"] == 1.0
    assert info["completion_rate"] == 7 / 8
    events = RunJournal.read(jr.path)
    fail0 = next(e for e in events if e["kind"] == "failure" and
                 e["fault"] == "crash")
    assert fail0["instances"] == [0, 1] and fail0["hold_until"]["0"] == 3
    # held through chunks 1-2: instances 0 and 1 are a chunk behind at 2
    assert int(state.sim.t[0]) == int(state.horizon[0])
    fs = FleetState.replay(events, 8)
    assert np.flatnonzero(fs.quarantined).tolist() == [6]
    assert int(fs.retries.sum()) == info["retries_total"]
    clean_state = clean()
    for i in (0, 1, 2, 7):
        assert torch.equal(state.sim.pos[i], clean_state.sim.pos[i])


def test_chunk_deadline_is_journaled(tmp_path):
    jr = RunJournal(str(tmp_path / "j.jsonl"))
    _, info = run_supervised(runner(_cfg()), journal=jr, chunk_deadline=0.0)
    assert info["completion_rate"] == 1.0
    dl = [e for e in RunJournal.read(jr.path) if e["kind"] == "deadline"]
    assert len(dl) == info["chunks_run"] and dl[0]["deadline"] == 0.0


def test_corrupt_checkpoint_and_shard_hooks(tmp_path):
    """A truncated newest checkpoint is skipped on resume; a truncated
    shard is found by the audit and drained again; the results equal the
    undamaged run's."""
    fm = FaultModel(4, {}, corrupt_ckpt=frozenset({1}),
                    corrupt_shard=frozenset({2}))
    ck = CheckpointManager(str(tmp_path / "ck"))
    jr = RunJournal(str(tmp_path / "j.jsonl"))
    wr = DatasetWriter(str(tmp_path / "ds"), _rec_cfg(), shard_size=2)
    run_supervised(runner(_rec_cfg()), fm, ckpt=ck, writer=wr, journal=jr,
                   max_chunks=3)
    wr = DatasetWriter(str(tmp_path / "ds"), _rec_cfg(), shard_size=2)
    resumed, info = run_supervised(runner(_rec_cfg()), fm, ckpt=ck,
                                   writer=wr, journal=jr)
    wr.finalize()
    assert info["completion_rate"] == 1.0
    events = RunJournal.read(jr.path)
    kinds = [e["kind"] for e in events]
    assert "corrupt_ckpt" in kinds and "corrupt_shard" in kinds
    assert "shard_repair" in kinds
    assert any(e["kind"] == "resume" and e["skipped_ckpts"] == []
               for e in events)
    assert_states_equal(clean("rec"), resumed, skip=(".chunk",))
    rows = shard_rows(str(tmp_path / "ds"))
    assert sorted(rows) == list(range(8))
    tr = clean("rec").trace
    for i, row in rows.items():
        np.testing.assert_array_equal(row["series"], tr.series[i].numpy())


def test_completion_report_and_table():
    state = clean()
    fs = FleetState.zeros(8)
    fs.quarantined[3] = True
    state = state._replace(done=state.done.clone())
    state.done[3] = False
    rep = completion_report(state, fs, ("highway_merge",))
    assert rep["total"]["completion_rate"] == 7 / 8
    assert rep["total"]["eligible_completion_rate"] == 1.0
    table = format_completion_table(rep)
    assert table.splitlines()[-1].startswith("| total | 8 | 7 | 87.5% | 1 |")
    assert json.loads(json.dumps(rep)) == rep
