"""Scenario parity: ``sample_params`` is bit-exact for all four scenarios, and
every hook, fed one converted state, agrees with the reference (ints and
bools exactly, floats within rtol = atol = 1e-6: the reference's compiler
may fuse a multiply-add that the port rounds twice)."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.neighbors import build_tables as j_build_tables
from repro.core.scenario import SimConfig as JSimConfig
from repro.core.scenarios import get_scenario as j_get_scenario
from repro.core.scenarios.base import idm_accel as j_idm_accel
from repro.core.simulator import init_state as j_init_state
from repro.core.simulator import sim_step as j_sim_step
from repro_torch.convert import scenario_params_from_numpy, sim_state_from_numpy
from repro_torch.core.neighbors import build_tables
from repro_torch.core.scenario import SimConfig
from repro_torch.core.scenarios import get_scenario, list_scenarios
from repro_torch.core.scenarios.base import idm_accel

sys.path.insert(0, str(Path(__file__).parent))
from conftest import state_tree_np  # noqa: E402

SCENARIOS = ["highway_merge", "lane_drop", "stop_and_go", "speed_limit_zone"]
TOL = dict(rtol=1e-6, atol=1e-6)
_WORLDS: dict = {}
_SAMPLERS: dict = {}


def test_registry_and_configs_match_reference():
    from repro.core.scenarios import list_scenarios as j_list

    assert list_scenarios() == j_list() == SCENARIOS
    j_fields = {f.name: f.default for f in dataclasses.fields(JSimConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    assert j_fields == t_fields
    for name in SCENARIOS:
        cfg = SimConfig(n_slots=16, scenario=name)
        jcfg = JSimConfig(n_slots=16, scenario=name)
        assert (dataclasses.asdict(get_scenario(name).geometry(cfg))
                == dataclasses.asdict(j_get_scenario(name).geometry(jcfg)))
        assert (get_scenario(name).metric_aliases
                == j_get_scenario(name).metric_aliases)


def j_sampler(name):
    """The reference's batched ``sample_params``, compiled once per scenario."""
    if name not in _SAMPLERS:
        jcfg = JSimConfig(n_slots=16, scenario=name)
        _SAMPLERS[name] = jax.jit(jax.vmap(
            lambda k: j_get_scenario(name).sample_params(k, jcfg)))
    return _SAMPLERS[name]


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_params_bitwise(name, seed):
    keys = jax.random.split(jax.random.key(seed), 5)
    want = state_tree_np(j_sampler(name)(keys))
    got = get_scenario(name).sample_params(
        torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(np.int64)),
        SimConfig(n_slots=16, scenario=name))
    for field, a, b in zip(got._fields, want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=field)
        assert b.dtype == (torch.int64 if field == "seed" else torch.float32)


def world(name):
    """An organically evolved reference world (300 steps: spawns, lane
    changes, vehicles in the scenario zone), its port conversion, and the
    reference's jitted ``sim_step`` for it (``test_torch_simulator.py``
    steps the same world)."""
    if name not in _WORLDS:
        jcfg = JSimConfig(n_slots=16, scenario=name)
        sp = j_get_scenario(name).sample_params(jax.random.key(3), jcfg)
        st = j_init_state(jcfg, jax.random.key(4))
        step = jax.jit(lambda s: j_sim_step(s, jcfg, sp))
        for _ in range(300):
            st = step(st)[0]
        _WORLDS[name] = (
            jcfg, sp, st, SimConfig(n_slots=16, scenario=name),
            scenario_params_from_numpy(state_tree_np(sp), "cpu"),
            sim_state_from_numpy(state_tree_np(st), "cpu"),
            step,
        )
    return _WORLDS[name]


def check(want, got, exact=None):
    """Reference output (unbatched) vs port output (batch of one)."""
    want = np.asarray(want)
    got = got.numpy()[0]
    if exact is None:
        exact = want.dtype.kind != "f"
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", SCENARIOS)
def test_hooks_match_reference(name):
    jcfg, jsp, jst, cfg, sp, st, _ = world(name)
    jscn, scn = j_get_scenario(name), get_scenario(name)
    jgeom, geom = jscn.geometry(jcfg), scn.geometry(cfg)
    L = geom.n_lanes_total
    assert int(np.asarray(jst.active).sum()) > 0

    jtabs = j_build_tables(jst.pos, jst.lane, jst.active, 4.5, L, "sort")
    tabs = build_tables(st.pos, st.lane, st.active, 4.5, L, "sort")

    # snapshot context
    jctx, ctx = jscn.snapshot_ctx(jst, jcfg, jgeom), scn.snapshot_ctx(st, cfg, geom)
    assert (jctx is None) == (ctx is None)
    if ctx is not None:
        for a, b in zip(jctx, ctx):
            check(a, b)

    # base IDM accel on the own-lane answer, then longitudinal_mods on the
    # own lane and on the left-candidate lane
    for jq, q in ((jst.lane, st.lane),
                  (jnp.minimum(jst.lane + 1, jgeom.n_lanes - 1),
                   (st.lane + 1).clamp_max(geom.n_lanes - 1))):
        jnb, nb = jtabs.query(jq), tabs.query(q)
        jgap = jnp.where(jnb.has_lead, jnb.lead_gap, 1e9)
        ja = j_idm_accel(jst.vel, jst.vel * 0.1, jgap, jst.v0, jst.T,
                         jst.a_max, jst.b_comf, jst.s0)
        a = idm_accel(st.vel, st.vel * 0.1,
                      torch.where(nb.has_lead, nb.lead_gap, 1e9),
                      st.v0, st.T, st.a_max, st.b_comf, st.s0)
        check(ja, a)
        a = torch.from_numpy(np.array(ja))[None]   # identical input
        check(jscn.longitudinal_mods(jst, jcfg, jgeom, jsp, jq, jnb, ja, jctx),
              scn.longitudinal_mods(st, cfg, geom, sp, q, nb, a, ctx))

    # lateral rules
    check(jscn.mobil_eligible(jst, jcfg, jgeom), scn.mobil_eligible(st, cfg, geom))
    for jcand, cand in ((jnp.zeros_like(jst.lane), torch.zeros_like(st.lane)),
                        (jst.lane + 1, st.lane + 1)):
        check(jscn.mobil_candidate_ok(jst, jcfg, jgeom, jcand),
              scn.mobil_candidate_ok(st, cfg, geom, cand))
    jlane, jn = jscn.lateral_rules(jst, jcfg, jgeom, jsp, jtabs, jst.lane)
    lane, n = scn.lateral_rules(st, cfg, geom, sp, tabs, st.lane)
    check(jlane, lane)
    check(jn, n)

    # boundary hooks
    for a, b in zip(jscn.boundary_spawn(jcfg, jgeom, jsp),
                    scn.boundary_spawn(cfg, geom, sp)):
        if b.dim() == 1:
            b = b[None]
        check(a, b)
    jpos, jvel = jscn.boundary_clamp(jst, jcfg, jgeom, jst.pos + 160.0,
                                     jst.vel)
    pos, vel = scn.boundary_clamp(st, cfg, geom, st.pos + 160.0, st.vel)
    check(jpos, pos)
    check(jvel, vel)
    check(jscn.boundary_exit(jst, jcfg, jgeom), scn.boundary_exit(st, cfg, geom))
    check(jscn.boundary_gauge(jst, jcfg, jgeom), scn.boundary_gauge(st, cfg, geom))
