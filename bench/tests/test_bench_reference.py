"""The comparison that decides ``correct``: the frozen reference agrees
with the program bit for bit, the control (the reference in bfloat16 in
the program's place) fails against it, and a run with the timed path
broken underneath reads ``correct`` false, for each fault a sweep cell can
have. The cuda-marked case runs the control on a card at a size a test
run holds."""

import numpy as np
import pytest
import torch

from bench import harness
from bench_common import ROOT, SEED, TINY, run_module, spec

CELLS = [w["name"] for w in spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_program_bit_for_bit(cell):
    """Every instance of a small sweep, after a warm-up and three chunks
    (every scenario of the roster, and the trace where the cell records)."""
    from repro_torch.core.sweep import SweepRunner

    c = harness.find_cell(ROOT, cell)
    drv = c.driver()
    n = 12
    cfg = drv.program_config(c.config, c.traffic, n, SEED)
    runner = SweepRunner(cfg, device="cpu")
    state = runner.init()
    for _ in range(3):
        state = runner.run_chunk(state)
    ids = np.arange(n)
    idx = torch.as_tensor(ids)
    got = {"state": drv._rows(state.sim, idx),
           "metrics": drv._rows(state.metrics, idx),
           "params": drv._rows(state.params, idx),
           "trace": drv._rows(state.trace, idx)}
    from bench.reference.replay import replay

    want = replay(drv.reference_sweep(c.config, c.traffic), SEED, ids,
                  3 * cfg.chunk_steps, "cpu", block_rows=5)
    checks, failed = drv.compare(got, want)
    assert failed == 0
    assert all(ch.value == 0 for ch in checks), checks
    assert int(state.sim.active.sum()) > 0  # vehicles did enter


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails(cell):
    from bench.control import control_checks

    c = harness.find_cell(ROOT, cell)
    checks, failed = control_checks(c, SEED, 60, "cpu", instances=TINY,
                                    block_rows=3)
    assert failed > 0
    assert not all(ch.ok for ch in checks)


def _unchanged(monkeypatch):
    from repro_torch.core.sweep import SweepRunner

    step = SweepRunner.run_chunk

    def unchanged(self, state, hold=None):
        new = step(self, state, hold)  # the work is done, then dropped
        return state._replace(chunk=new.chunk)

    monkeypatch.setattr(SweepRunner, "run_chunk", unchanged)


def _half_left_out(monkeypatch):
    from repro_torch.core import sweep

    plan = sweep.SweepRunner.plan_chunk

    def half(self, state, hold=None):
        out = []
        for p in plan(self, state, hold):
            keep = max(p.keep // 2, 1)
            out.append(sweep.GroupPlan(roster=p.roster, take=p.take[:keep],
                                       keep=keep, identity=False))
        return out

    monkeypatch.setattr(sweep.SweepRunner, "plan_chunk", half)


def _answer_altered(monkeypatch):
    from repro_torch.core import simulator

    step = simulator.sim_step

    def altered(st, cfg, sp):
        st, d = step(st, cfg, sp)
        vel = torch.where(st.active, torch.nextafter(st.vel, st.vel + 1), st.vel)
        return st._replace(vel=vel), d

    monkeypatch.setattr(simulator, "sim_step", altered)


# the faults a sweep cell can have (it runs on one chip, so there is no
# exchange between chips to leave out)
FAULTS = {"state_unchanged": _unchanged, "half_the_batch_left_out":
          _half_left_out, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_reads_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = run_module().execute(cell, SEED, 0.2, False, "cpu", instances=TINY)
    assert line["correct"] is False
    assert line["failed"] > 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_program_agrees_and_the_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench.control import control_checks

    c = harness.find_cell(ROOT, cell)
    n = 4096
    run = c.driver().run(c.config, c.traffic, SEED, 0.0, False, "cuda:0", 0.0,
                         instances=n)
    assert all(ch.value == 0 for ch in run.checks), run.checks
    checks, failed = control_checks(c, SEED, run.steps + 10, "cuda:0",
                                    instances=n)
    assert failed > 0 and not all(ch.ok for ch in checks)
