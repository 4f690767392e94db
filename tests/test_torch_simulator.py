"""Simulator parity: one ``sim_step`` from identical converted states in all
four scenarios, and 100-step rollouts from a fresh world, against the
reference.

Tolerances: integer and boolean state and counters exactly; floats within
rtol = atol = 1e-6 per step. The reference's compiler contracts
multiply-adds (``vel + accel * dt`` and the IDM terms) into fused
multiply-adds that round once, where the port rounds each operation, so
floats may differ in the last bit; the summed ``speed_sum`` also adds in
another order. Over the 100-step rollouts those last-bit differences have
not flipped a discrete decision (MOBIL threshold, spawn check, collision),
so every counter is compared exactly.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.scenario import SimConfig as JSimConfig
from repro.core.scenarios import get_scenario as j_get_scenario
from repro.core.simulator import rollout as j_rollout
from repro_torch.convert import scenario_params_from_numpy
from repro_torch.core import prng
from repro_torch.core.scenario import SimConfig
from repro_torch.core.scenarios import get_scenario
from repro_torch.core.simulator import (
    SimMetrics,
    init_state,
    rollout,
    rollout_chunk,
    sim_step,
)

sys.path.insert(0, str(Path(__file__).parent))
from conftest import state_tree_np  # noqa: E402
from test_torch_scenarios import world  # noqa: E402

SCENARIOS = ["highway_merge", "lane_drop", "stop_and_go", "speed_limit_zone"]
TOL = dict(rtol=1e-6, atol=1e-6)
COUNTERS = ("throughput", "spawned", "speed_count", "collisions", "merges_ok",
            "ramp_blocked_steps", "lane_changes", "steps")


def compare(want_tree, got_tree, tol=TOL):
    for field, a, b in zip(got_tree._fields, want_tree, got_tree):
        a, b = np.asarray(a), b.numpy()[0]
        if field == "key":
            a = a.astype(np.int64)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, err_msg=field, **tol)
        else:
            np.testing.assert_array_equal(b, a, err_msg=field)


@pytest.mark.parametrize("name", SCENARIOS)
def test_one_step_from_converted_state(name):
    """One step from the scenario tests' evolved world (300 reference
    steps: spawns, lane changes, vehicles in the scenario zone)."""
    _, _, jst, _, sp, st, step = world(name)
    assert int(np.asarray(jst.active).sum()) > 0
    for impl in ("sort", "cuda"):
        cfg_i = SimConfig(n_slots=16, scenario=name, neighbor_impl=impl)
        jst2, jd = step(jst)
        st2, d = sim_step(st, cfg_i, sp)
        compare(state_tree_np(jst2), st2)
        compare(state_tree_np(jd), d)


@pytest.mark.parametrize("name", SCENARIOS)
def test_rollout_counters_match(name):
    jcfg = JSimConfig(n_slots=16, scenario=name)
    jsp = j_get_scenario(name).sample_params(jax.random.key(1), jcfg)
    want = state_tree_np(j_rollout(jax.random.key(0), jcfg, jsp, 100))
    cfg = SimConfig(n_slots=16, scenario=name)
    sp = scenario_params_from_numpy(state_tree_np(jsp), "cpu")
    got = rollout(prng.key(0, "cpu")[None], cfg, sp, 100)
    for field in COUNTERS:
        np.testing.assert_array_equal(
            getattr(got, field).numpy()[0], getattr(want, field), err_msg=field)
    # speed_sum sums 100 steps of per-step sums: last-bit differences of
    # each step's velocities and the summation order accumulate
    np.testing.assert_allclose(got.speed_sum.numpy()[0], want.speed_sum,
                               rtol=1e-5)
    np.testing.assert_allclose(got.min_ttc.numpy()[0], want.min_ttc, rtol=1e-5)
    assert int(want.spawned) > 0


def test_horizon_masks_steps_exactly():
    """Instances past their horizon keep state and metrics bit for bit;
    the others advance, in one batch."""
    cfg = SimConfig(n_slots=16)
    keys = prng.split(prng.key(2, "cpu"), 3)
    sp = get_scenario(cfg.scenario).sample_params(prng.fold_in(keys, 1), cfg)
    st = init_state(cfg, keys)
    m = SimMetrics.zeros(3, "cpu")
    st, m = rollout_chunk(st, m, sp, torch.tensor([5, 5, 5], dtype=torch.int32),
                          cfg, 5)
    horizon = torch.tensor([5, 8, 12], dtype=torch.int32)
    st2, m2 = rollout_chunk(st, m, sp, horizon, cfg, 10)
    assert st2.t.tolist() == [5, 8, 12]
    for a, b in zip(st, st2):
        assert torch.equal(a[0], b[0])
    for a, b in zip(m, m2):
        assert torch.equal(a[0], b[0])
    assert m2.steps.tolist() == [5, 8, 12]


def test_sim_step_keeps_dtypes():
    cfg = SimConfig(n_slots=8)
    keys = prng.split(prng.key(0, "cpu"), 2)
    sp = get_scenario(cfg.scenario).sample_params(keys, cfg)
    st = init_state(cfg, keys)
    st2, d = sim_step(st, cfg, sp)
    for a, b in zip(st, st2):
        assert a.dtype == b.dtype and a.shape == b.shape
    for f, x in zip(d._fields, d):
        want = torch.float32 if f in ("speed_sum", "speed_count", "min_ttc") \
            else torch.int32
        assert x.dtype == want and x.shape == (2,), f
