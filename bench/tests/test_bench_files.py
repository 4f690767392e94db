"""The benchmark's files: BENCHMARK.json keeps to the contract's form, every
configuration, traffic, driver and metric is found by its name, and a cell
or a metric added as new files runs without an edit to any file that is
already there."""

import json
import re
import shutil

import pytest

from bench import harness
from bench_common import BENCH, ROOT, SEED, TINY, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_to_the_contract():
    b = spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in b["configs"]}) == len(b["configs"])
    assert len({x["name"] for x in b["workloads"]}) == len(b["workloads"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        assert m["source"] in SOURCES
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])

    def reports(key, cell):
        return {m["name"] for m in b[key]
                if cell in m.get("workloads", [cell])}

    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        e2e_here = reports("end_to_end", w["name"])
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        assert reports("per_layer", w["name"])
    for m in b["per_layer"]:  # each cell of a metric reports what it moves
        for cell in m.get("workloads", [w["name"] for w in b["workloads"]]):
            assert m["moves"] in reports("end_to_end", cell), (m, cell)
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    c = harness.find_cell(ROOT, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.driver().run is not None
    entry = next(x for x in c.spec["configs"] if x["name"] == c.entry["config"])
    assert (ROOT / entry["file"]).is_file()
    assert (ROOT / entry["file"]).is_relative_to(BENCH)
    for traced in (False, True):
        for m in c.metrics(traced):
            mod = harness.load_module(BENCH / "metrics" / f"{m['name']}.py",
                                      "probe_" + m["name"].replace(".", "_"))
            assert callable(mod.read)


def test_config_files_list_what_they_change():
    for entry in spec()["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
        assert cfg["source"] == entry["source"]
        for key in entry["reduced"]:
            assert cfg["sweep"][key] == cfg["reduced"][key]["here"]


def test_a_cell_and_a_metric_added_as_files_run_unedited(tmp_path):
    """In a copy: a new traffic file, a new metric reader, and their
    entries in BENCHMARK.json; no file under bench/ that was there
    changes, and the new cell reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    traffic = json.loads((BENCH / "traffic" / "study-b262k.json").read_text())
    traffic["instances"] = 4096
    (root / "bench" / "traffic" / "study-b4k.json").write_text(
        json.dumps(traffic))
    (root / "bench" / "metrics" / "chunks_in_window.sweep.py").write_text(
        "def read(run):\n    return run.chunks\n")
    b = spec()
    b["workloads"].append({"name": "merge-study-b4k",
                           "config": "sweep-merge-n128",
                           "traffic": "study-b4k", "chips": 1,
                           "why": "a test cell"})
    next(m for m in b["end_to_end"]
         if m["name"] == "instance_steps_per_s")["workloads"].append(
             "merge-study-b4k")
    b["per_layer"].append({"name": "chunks_in_window.sweep", "unit": "chunks",
                           "better": "higher", "source": "program_span",
                           "layer": "fleet supervisor",
                           "moves": "instance_steps_per_s",
                           "workloads": ["merge-study-b4k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.find_cell(root, "merge-study-b4k", bench=root / "bench")
    assert cell.traffic["instances"] == 4096
    run = cell.driver().run(cell.config, cell.traffic, SEED, 0.2, True, "cpu",
                            0.0, instances=TINY)
    metrics = harness.read_metrics(cell, run, traced=True)
    assert metrics["chunks_in_window.sweep"]["value"] >= 1
    assert set(harness.read_metrics(cell, run, traced=False)) == {
        "instance_steps_per_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
