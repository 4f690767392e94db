"""The benchmark's harness: finds a cell's files by name, hands them to the
traffic's driver, reads each metric with its own reader, and builds the
result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives:

- ``bench/configs/<config>.json``: the configuration as it is run;
- ``bench/traffic/<traffic>.json``: the traffic's parameters; its
  ``driver`` key names ``bench/drivers/<driver>.py``, whose ``run`` sets up
  the program, measures the window and checks the outputs, returning a
  :class:`Run`;
- ``bench/metrics/<metric>.py``: a reader, ``read(run) -> float | None``.
  A reader that finds nothing to read returns None, and the metric is left
  out of the line.

So a later cell, configuration or metric is added as files, and no file
that is here needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
# whole top-level module names that no run may load: JAX, and the JAX
# package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit (a run is
    correct when every value is at most its limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver measured in one run, for the metric readers.

    Times are ``time.perf_counter_ns`` readings; ``spans`` are the
    benchmark's own spans around its calls into the program, ``(name,
    start_ns, end_ns)``; ``device_events`` (traced runs on a card) are the
    profiler's device operations ``(name, start_ns, end_ns)`` on the same
    clock; ``groups`` lists, for one simulated step, each batched call's
    shape as the cell defines it."""

    config: dict
    traffic: dict
    setup_s: float
    window_start_ns: int
    window_end_ns: int
    steps: int                 # simulated steps in the window, per instance
    chunks: int
    instance_steps: int
    attempted: int
    failed: int
    checks: list[Check]
    memory_peak_bytes: int
    groups: list[dict]
    spans: list[tuple[str, int, int]] = dataclasses.field(default_factory=list)
    device_events: list[tuple[str, int, int]] | None = None

    @property
    def window_s(self) -> float:
        return (self.window_end_ns - self.window_start_ns) / 1e9


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import ``path`` as a module of its own (metric files carry dots in
    their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files loaded."""

    spec: dict
    entry: dict
    config: dict
    traffic: dict
    bench: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self) -> ModuleType:
        name = self.traffic["driver"]
        return load_module(self.bench / "drivers" / f"{name}.py",
                           f"bench_driver_{name}")

    def metrics(self, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``traced`` its per-layer
        ones: those whose ``workloads`` name it, or that name none."""
        key = "per_layer" if traced else "end_to_end"
        name = self.entry["name"]
        return [m for m in self.spec[key]
                if "workloads" not in m or name in m["workloads"]]

    def profiled(self, traced: bool) -> bool:
        """Does this run need the profiler: it is traced, or one of the
        metrics it reads comes from the device trace."""
        return traced or any(m["source"] == "device_trace"
                             for m in self.metrics(traced))


def find_cell(root: Path, workload: str, bench: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and its files."""
    spec = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(entries)}")
    entry = entries[workload]
    return Cell(spec=spec, entry=entry,
                config=load_json(bench / "configs" / f"{entry['config']}.json"),
                traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
                bench=bench)


def read_metrics(cell: Cell, run: Run, traced: bool) -> dict:
    """Each of the cell's metrics from its reader; a metric whose reader
    finds nothing is left out."""
    out = {}
    for m in cell.metrics(traced):
        reader = load_module(cell.bench / "metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def result_line(cell: Cell, run: Run, traced: bool, device: dict,
                breakdown: dict | None = None) -> dict:
    """The run's result: the contract's keys, then the numbers compared,
    each beside its limit, under a key of their own that comes last."""
    line = {
        "correct": all(c.ok for c in run.checks),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": read_metrics(cell, run, traced),
        "device": device,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in run.checks}
    return line
