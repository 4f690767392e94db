"""Sweep parity: the chunk planner is bit-exact with the reference, sweep
init draws the same parameters and horizons bit for bit, a small mixed
sweep matches the reference (completion bitmap and integer counters
exactly; float metrics within rtol = 1e-5, since the reference's compiler
fuses multiply-adds the port rounds twice and sums speeds in another
order), and within the port ``switch`` and ``grouped`` dispatch give
bit-identical state."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.aggregate import aggregate_metrics as j_aggregate
from repro.core.scenario import SimConfig as JSimConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import SweepRunner as JSweepRunner
from repro.core.sweep import plan_chunk as j_plan_chunk
from repro_torch.convert import sweep_state_from_numpy, to_numpy
from repro_torch.core.aggregate import aggregate_metrics, metrics_to_records
from repro_torch.core.scenario import SimConfig
from repro_torch.core.sweep import (
    SweepConfig,
    SweepRunner,
    completion_rate,
    plan_chunk,
)

sys.path.insert(0, str(Path(__file__).parent))
from conftest import state_tree_np  # noqa: E402

MIX = ("highway_merge", "lane_drop", "stop_and_go", "speed_limit_zone")
COUNTERS = ("throughput", "spawned", "speed_count", "collisions", "merges_ok",
            "ramp_blocked_steps", "lane_changes", "steps")
_SWEEPS: dict = {}
_JINIT: dict = {}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_workers", [1, 3, 4])
def test_plan_chunk_bitwise(seed, n_workers):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    sids = rng.integers(0, 4, n).astype(np.int32)
    for p_done in (0.0, 0.5, 1.0):
        done = rng.uniform(size=n) < p_done
        for hold in (None, rng.uniform(size=n) < 0.2):
            for grouped in (False, True):
                for compaction in (False, True):
                    kw = dict(grouped=grouped, compaction=compaction, hold=hold)
                    want = j_plan_chunk(done, sids, n_workers, **kw)
                    got = plan_chunk(done, sids, n_workers, **kw)
                    assert len(got) == len(want)
                    for a, b in zip(want, got):
                        assert (a.roster, a.keep, a.identity) == (
                            b.roster, b.keep, b.identity)
                        np.testing.assert_array_equal(a.take, b.take)


def sweep_cfgs(dispatch="grouped", vary=False):
    kw = dict(n_instances=8, steps_per_instance=120, chunk_steps=40, seed=0,
              scenario_mix=MIX, dispatch=dispatch, vary_horizon=vary)
    return (JSweepConfig(sim=JSimConfig(n_slots=16), **kw),
            SweepConfig(sim=SimConfig(n_slots=16), **kw))


def sweeps():
    """The mixed sweep with drawn horizons (stragglers exercise compaction),
    run once by the reference and once by the port (grouped dispatch)."""
    if not _SWEEPS:
        jcfg, cfg = sweep_cfgs(vary=True)
        _SWEEPS["jax"] = JSweepRunner(jcfg).run(j_init(True))
        runner = SweepRunner(cfg, device="cpu")
        _SWEEPS["torch"] = runner.run()
        _SWEEPS["group_calls"] = runner.group_calls
    return _SWEEPS


def j_init(vary):
    """The reference's initial sweep state, computed once per ``vary``."""
    if vary not in _JINIT:
        _JINIT[vary] = JSweepRunner(sweep_cfgs(vary=vary)[0]).init()
    return _JINIT[vary]


@pytest.mark.parametrize("vary", [False, True])
def test_init_matches_reference_bitwise(vary):
    _, cfg = sweep_cfgs(vary=vary)
    want = state_tree_np(j_init(vary))
    got = to_numpy(SweepRunner(cfg, device="cpu").init())
    for part in ("params", "sim", "metrics"):
        for field, a, b in zip(getattr(got, part)._fields,
                               getattr(want, part), getattr(got, part)):
            np.testing.assert_array_equal(b, a, err_msg=f"{part}.{field}")
    for field in ("horizon", "done", "chunk", "scenario_id"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_mixed_sweep_matches_reference():
    s = sweeps()
    want, got = state_tree_np(s["jax"]), to_numpy(s["torch"])
    np.testing.assert_array_equal(got.done, want.done)
    assert got.done.all()
    np.testing.assert_array_equal(got.chunk, want.chunk)
    for field in COUNTERS:
        np.testing.assert_array_equal(getattr(got.metrics, field),
                                      getattr(want.metrics, field),
                                      err_msg=field)
    for field in ("speed_sum", "min_ttc"):
        np.testing.assert_allclose(getattr(got.metrics, field),
                                   getattr(want.metrics, field), rtol=1e-5)
    for field in ("lane", "active", "is_cav", "cooldown", "key", "t"):
        np.testing.assert_array_equal(getattr(got.sim, field),
                                      getattr(want.sim, field), err_msg=field)
    np.testing.assert_allclose(got.sim.pos, want.sim.pos, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.sim.vel, want.sim.vel, rtol=1e-5, atol=1e-4)


def test_aggregate_matches_reference():
    s = sweeps()
    jw = s["jax"]
    want = j_aggregate(jw.metrics, scenario_ids=jw.scenario_id,
                       scenario_names=MIX)
    got = aggregate_metrics(s["torch"].metrics,
                            scenario_ids=s["torch"].scenario_id,
                            scenario_names=MIX)

    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = v
        return out

    fw, fg = flat(want), flat(got)
    assert list(fg) == list(fw)
    for k in fw:
        if isinstance(fw[k], int):
            assert fg[k] == fw[k], k
        else:
            np.testing.assert_allclose(fg[k], fw[k], rtol=1e-5, err_msg=k)
    records = metrics_to_records(s["torch"].metrics, s["torch"].params,
                                 scenario_ids=s["torch"].scenario_id,
                                 scenario_names=MIX)
    assert len(records) == 8 and records[1]["scenario"] == "lane_drop"
    assert "forced_merges" in records[1]


def test_switch_equals_grouped_bitwise():
    _, cfg_s = sweep_cfgs("switch", vary=True)
    a = sweeps()["torch"]
    b = SweepRunner(cfg_s, device="cpu").run()
    assert completion_rate(a) == completion_rate(b) == 1.0
    for x, y in zip(to_numpy(a.sim) + to_numpy(a.metrics),
                    to_numpy(b.sim) + to_numpy(b.metrics)):
        np.testing.assert_array_equal(x, y)


def test_launch_count_rule_and_state_round_trip():
    """Grouped dispatch makes one batched chunk call per chunk and scenario
    with a pending instance; converted reference state resumes in the
    port."""
    s = sweeps()
    horizon = s["torch"].horizon.numpy()
    sids = s["torch"].scenario_id.numpy()
    want = sum(np.unique(sids[horizon > 40 * c]).size
               for c in range(int(s["torch"].chunk)))
    assert s["group_calls"] == want
    _, cfg = sweep_cfgs(vary=True)
    state = sweep_state_from_numpy(state_tree_np(j_init(True)), "cpu")
    runner = SweepRunner(dataclasses.replace(cfg, chunk_steps=10), device="cpu")
    state = runner.run_chunk(state)
    assert int(state.chunk) == 1 and state.sim.t.tolist() == [10] * 8


def test_runner_refuses_state_on_another_device():
    """A state built on one device is never stepped on another."""
    _, cfg = sweep_cfgs(vary=True)
    state = sweep_state_from_numpy(state_tree_np(j_init(True)), "cpu")
    runner = SweepRunner(cfg, device="meta")
    with pytest.raises(ValueError, match="device"):
        runner.run_chunk(state)
    with pytest.raises(ValueError, match="device"):
        runner.run(state)


def test_record_is_refused_until_ported():
    with pytest.raises(ValueError, match="record"):
        SweepRunner(SweepConfig(record=object()), device="cpu")
    with pytest.raises(ValueError, match="dispatch"):
        SweepRunner(SweepConfig(dispatch="nope"), device="cpu")
