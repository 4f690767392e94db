"""Recording parity: ``repro_torch.core.record`` and the recording rollout.

Levels:
- against the reference (``repro.core.sweep`` with the same
  ``RecordConfig``): which steps fill which rows, the counter channels and
  the lane/active slabs exactly; the float channels (``mean_speed``,
  ``min_ttc``) and the speed slab within the sweep tests' tolerances
  (rtol 1e-5, and atol 1e-4 on speeds), since the reference's compiler
  fuses multiply-adds the port rounds twice and sums speeds in another
  order;
- within the port, bit for bit: the stride-window path ≡ the per-step
  fallback, chunk-size invariance, ``switch`` ≡ ``grouped`` ≡ no
  compaction, and recording on ≡ off for the final simulator state.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.record import FIELD_CHANNELS as J_FIELD_CHANNELS
from repro.core.record import RecordConfig as JRecordConfig
from repro.core.scenario import SimConfig as JSimConfig
from repro.core.simulator import rollout_chunk_rec as j_rollout_chunk_rec
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import SweepRunner as JSweepRunner
from repro_torch.convert import sweep_state_from_numpy, to_numpy
from repro_torch.core.record import (
    DEFAULT_FIELDS,
    FIELD_CHANNELS,
    RecordConfig,
    TraceBuffer,
    batch_zeros,
    valid_rows,
)
from repro_torch.core.scenario import SimConfig
from repro_torch.core.simulator import rollout_chunk_rec
from repro_torch.core.sweep import SweepConfig, SweepRunner

sys.path.insert(0, str(Path(__file__).parent))
from conftest import state_tree_np  # noqa: E402

MIX = ("highway_merge", "lane_drop")
EXACT_FIELDS = ("active_count", "throughput", "lane_changes", "collisions")
_RUNS: dict = {}


def cfgs(**kw):
    base = dict(n_instances=6, steps_per_instance=60, chunk_steps=30, seed=5,
                scenario_mix=MIX, dispatch="grouped", vary_horizon=True,
                min_horizon_frac=0.4)
    base.update(kw)
    return (JSweepConfig(sim=JSimConfig(n_slots=16),
                         record=JRecordConfig(record_every=10, k_slots=4),
                         **base),
            SweepConfig(sim=SimConfig(n_slots=16),
                        record=RecordConfig(record_every=10, k_slots=4),
                        **base))


def port_run(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _RUNS:
        _RUNS[key] = SweepRunner(cfgs(**kw)[1], device="cpu").run()
    return _RUNS[key]


def ref_run():
    if "jax" not in _RUNS:
        jcfg = cfgs()[0]
        _RUNS["jax"] = state_tree_np(JSweepRunner(jcfg).run())
    return _RUNS["jax"]


def assert_traces_match(got: TraceBuffer, want):
    fields = list(DEFAULT_FIELDS)
    for f in EXACT_FIELDS:
        j = fields.index(f)
        np.testing.assert_array_equal(got.series[..., j], want.series[..., j],
                                      err_msg=f)
    for f in ("mean_speed", "min_ttc"):
        j = fields.index(f)
        np.testing.assert_allclose(got.series[..., j], want.series[..., j],
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.lane, want.lane)
    np.testing.assert_array_equal(got.active, want.active)
    np.testing.assert_allclose(got.speed, want.speed, rtol=1e-5, atol=1e-4)


def assert_bitwise(a, b):
    for x, y in zip(to_numpy(a.sim) + to_numpy(a.metrics),
                    to_numpy(b.sim) + to_numpy(b.metrics)):
        np.testing.assert_array_equal(x, y)
    if a.trace is None or b.trace is None:
        assert a.trace is None and b.trace is None
        return
    for x, y in zip(to_numpy(a.trace), to_numpy(b.trace)):
        np.testing.assert_array_equal(x, y)


def test_config_and_buffer_shapes():
    rec = RecordConfig(record_every=10, k_slots=3)
    assert rec.n_rows(95) == 9
    tr = batch_zeros(rec, 95, 4, "cpu")
    assert tuple(tr.series.shape) == (4, 9, len(DEFAULT_FIELDS))
    assert tr.lane.dtype == torch.int32 and tr.active.dtype == torch.bool
    assert tuple(tr.speed.shape) == (4, 9, 3)
    assert set(FIELD_CHANNELS) == set(J_FIELD_CHANNELS)
    for bad in (dict(record_every=0), dict(k_slots=-1), dict(fields=("x",)),
                dict(fields=(), k_slots=0)):
        with pytest.raises(ValueError):
            RecordConfig(**bad)
    np.testing.assert_array_equal(valid_rows(np.array([95, 30]), 10), [9, 3])


def test_sweep_rows_match_reference():
    """Bit-exact rows filled, counters and lane/active exact, floats
    within tolerance: the whole recorded sweep against the reference."""
    want, got = ref_run(), to_numpy(port_run())
    np.testing.assert_array_equal(got.horizon, want.horizon)
    assert_traces_match(got.trace, want.trace)
    # rows past an instance's horizon keep their zero fill; rows before it
    # are all written (active_count > 0 once traffic has spawned)
    valid = valid_rows(got.horizon, 10)
    rows = np.arange(got.trace.series.shape[1])
    filled = np.abs(got.trace.series).sum(-1) > 0
    assert not filled[rows[None, :] >= valid[:, None]].any()
    assert filled[:, 1:][rows[None, 1:] < valid[:, None]].all()


def test_chunk_from_converted_state_matches_reference():
    """One chunk of the recording rollout from an identical converted
    state: a highway_merge instance on the stride-window path, a lane_drop
    instance on the per-step fallback."""
    import jax

    jcfg, cfg = cfgs(n_instances=2)
    jr = JSweepRunner(jcfg)
    jstate = jr.init()
    state = sweep_state_from_numpy(state_tree_np(jstate), "cpu")
    for i, sim in enumerate(jr._sims):
        n_steps = (20, 15)[i]   # the stride-window and per-step paths
        one = jax.tree.map(lambda x: x[i], (jstate.sim, jstate.metrics,
                                            jstate.params, jstate.horizon,
                                            jstate.trace))
        _, _, jtr = j_rollout_chunk_rec(*one, sim, n_steps, jcfg.record)
        rows = torch.tensor([i])
        pick = lambda t: type(t)(*(x.index_select(0, rows) for x in t))  # noqa: E731
        _, _, tr = rollout_chunk_rec(
            pick(state.sim), pick(state.metrics), pick(state.params),
            state.horizon[rows], pick(state.trace),
            dataclasses.replace(cfg.sim, scenario=sim.scenario), n_steps,
            cfg.record)
        want = jax.tree.map(lambda x: np.asarray(x)[None], jtr)
        assert_traces_match(to_numpy(tr), want)


def test_fast_path_equals_fallback_and_chunk_sizes():
    """The stride-window path (chunks of 30 and 60) and the per-step
    fallback (chunks of 15 and 25) give the same rows and state, bit for
    bit."""
    base = port_run()
    for chunk in (60, 15, 25):
        assert_bitwise(base, port_run(chunk_steps=chunk))


@pytest.mark.parametrize("kw", [dict(dispatch="switch"),
                                dict(dispatch="switch", compaction=False)])
def test_dispatch_and_compaction_are_bitwise_equal(kw):
    assert_bitwise(port_run(), port_run(**kw))


def test_recording_does_not_change_the_physics():
    cfg = dataclasses.replace(cfgs()[1], record=None)
    plain = SweepRunner(cfg, device="cpu").run()
    rec = port_run()
    assert plain.trace is None
    assert_bitwise(plain, rec._replace(trace=None))
