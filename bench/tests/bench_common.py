"""Helpers the benchmark's tests share."""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SEED = 2**31 + 4099   # past 32 signed bits, as the driver's seeds are
TINY = 8              # instances in a CPU run

# the contract's keys of a result line, and of its device entry
LINE_KEYS = ("correct", "attempted", "failed", "metrics", "device")
DEVICE_KEYS = ("platform", "kind", "count", "memory_peak_bytes")


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def run_module():
    """``bench/run.py`` as a module (it is a script, not a package member)."""
    path = BENCH / "run.py"
    mod_spec = importlib.util.spec_from_file_location("bench_run_cli", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
