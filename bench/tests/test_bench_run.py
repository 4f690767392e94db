"""A run of each cell on the CPU at a tiny instance count, past the look
for a card: the result line has the contract's keys, the metrics its
mode asks for and nothing a CPU cannot measure, and the numbers compared
come last. Without a card the command exits non-zero and prints nothing."""

import json
import subprocess
import sys

import pytest
import torch

from bench_common import DEVICE_KEYS, LINE_KEYS, ROOT, SEED, TINY, run_module, spec

CELLS = [w["name"] for w in spec()["workloads"]]


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_on_the_cpu_and_prints_a_contract_line(cell, traced):
    line = run_module().execute(cell, SEED, 0.2, traced, "cpu",
                                instances=TINY)
    json.dumps(line)  # the line is plain JSON
    assert list(line)[:5] == list(LINE_KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == TINY
    assert set(DEVICE_KEYS) <= set(line["device"])
    assert line["device"]["platform"] == "cpu"
    b = spec()
    wanted = {m["name"]: m["source"]
              for m in b["per_layer" if traced else "end_to_end"]
              if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= set(wanted)
    # spans and the host clock are read on any device; the device trace
    # needs a card
    assert all(wanted[m] != "device_trace" for m in line["metrics"])
    if traced:
        assert {m.split(".")[0] for m in line["metrics"]} in (
            {"supervisor_ms_per_chunk"}, {"instance_steps_per_s"})
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {m for m, source in wanted.items()
                                        if source != "device_trace"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_command_without_a_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr
