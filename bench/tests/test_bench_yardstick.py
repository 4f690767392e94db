"""The frozen yardstick, tied to the shapes it counts: the neighbour
search's bound as the program's costing gave it, and the step's byte
counts equal to the sizes of real simulator tensors of a cell's shape."""

import json

import pytest
import torch

from bench import yardstick
from bench_common import BENCH

CONFIG = json.loads((BENCH / "configs" / "sweep-merge-n128.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "dataset-b131k.json").read_text())


def nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree)


def test_neighbor_cost_is_the_costing_it_was_copied_from():
    assert yardstick.neighbor_ms(256, 128, 4, False) == pytest.approx(
        0.00079, abs=5e-6)
    ops, b = yardstick.neighbor_cost(256, 128, 4, False)
    assert (ops, b) == (256 * 128 * 7 * 5, 256 * 128 * 9 + 256 * 4 * 128 * 18)


def test_state_bytes_are_those_of_a_real_state_of_the_cells_shape():
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.simulator import SimMetrics, init_state

    b, n = 131072, CONFIG["sim"]["n_slots"]
    key = torch.zeros((b, 2), dtype=torch.int64, device="meta")
    st = init_state(SimConfig(n_slots=n), key)
    assert nbytes(st) == yardstick.state_bytes(b, n)
    assert nbytes(SimMetrics.zeros(b, "meta")) == b * yardstick.METRICS_BYTES


def test_draws_and_trace_rows_are_those_of_the_programs_tensors():
    from repro_torch.core import prng
    from repro_torch.core.record import RecordConfig, batch_zeros
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.scenarios import get_scenario

    sim = SimConfig(n_slots=CONFIG["sim"]["n_slots"])
    keys = prng.fold_in(prng.key(7, "cpu"), torch.arange(5))
    sp = get_scenario("highway_merge").sample_params(keys, sim)
    assert nbytes(sp) == yardstick.params_bytes(5, sim.n_lanes)
    rec = TRAFFIC["record"]
    tr = batch_zeros(RecordConfig(record_every=rec["every"],
                                  fields=tuple(rec["fields"]),
                                  k_slots=rec["k_slots"]),
                     rec["every"] * 3, 4, "cpu")
    assert nbytes(tr) == 4 * 3 * yardstick.trace_row_bytes(
        len(rec["fields"]), rec["k_slots"])


def test_step_work_is_bytes_bound_at_the_cells_shape():
    ops, b = yardstick.step_work(131072, 128, 3, 4)
    assert b == 2 * yardstick.state_bytes(131072, 128) + 131072 * (
        2 * 40 + yardstick.params_bytes(1, 3) + 4)
    assert b / yardstick.MEM_BYTES_PER_S > ops / yardstick.F32_OPS_PER_S


def test_device_time_readers_take_the_union_of_the_trace_over_the_steps():
    """Overlapping operations count once, time outside the window not at
    all; the step's roofline share over device time is the least time
    over that."""
    from bench import readers
    from bench.harness import Run

    ms = 1_000_000
    events = [("a", -2 * ms, 3 * ms), ("b", 2 * ms, 5 * ms),
              ("neighbor_mq", 10 * ms, 11 * ms), ("c", 19 * ms, 25 * ms)]
    run = Run(config={}, traffic={"record": TRAFFIC["record"]}, setup_s=1.0,
              window_start_ns=0, window_end_ns=20 * ms, steps=2, chunks=1,
              instance_steps=2 * 4, attempted=4, failed=0, checks=[],
              memory_peak_bytes=0,
              groups=[{"rows": 4, "n_slots": 128, "n_lanes": 3,
                       "n_lanes_total": 4}],
              device_events=events)
    assert readers.device_ms_per_step(run) == pytest.approx(7 / 2)
    least = yardstick.least_time_s(*reversed(yardstick.step_work(
        4, 128, 3, 4, TRAFFIC["record"])))
    assert readers.roofline_mfu_device(run) == pytest.approx(
        100 * least / 3.5e-3)
    run.device_events = None
    assert readers.device_ms_per_step(run) is None
    assert readers.roofline_mfu_device(run) is None
