"""Run one cell of the benchmark and print its result as one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs a CUDA card (as many as the cell
asks for): without one it exits with code 2 and prints no result. It
loads the cell's files by name (:mod:`bench.harness`), lets the traffic's
driver set up the program, measure the window and check the outputs
against the plain reference, reads the cell's metrics (``--trace 0``: the
end-to-end ones; ``--trace 1``: the per-layer ones; the window runs under
the profiler in a traced run, and in any run that reads a metric from the
device trace),
prints each number compared beside its limit as the last lines of
standard error, and the result as the last line of standard output. It
exits with code 3, and prints no result, if JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the program builds its kernels under ``build/`` by itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def device_info(torch, device: str, chips: int, run, profiled: bool) -> dict:
    from bench.trace import busy_ns

    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": chips, "memory_peak_bytes": run.memory_peak_bytes}
    if profiled:
        events = run.device_events or []
        info["busy_s"] = busy_ns(events, run.window_start_ns,
                                 run.window_end_ns) / 1e9
        info["window_s"] = run.window_s
    return info


def breakdown(run) -> dict | None:
    from bench.trace import idle_gaps, top_ops

    if not run.device_events:
        return None
    return {"device_ops": top_ops(run.device_events),
            "idle_gaps": idle_gaps(run.device_events, run.window_start_ns,
                                   run.window_end_ns, run.spans)}


def execute(workload: str, seed: int, seconds: float, traced: bool,
            device: str, t_start: float = T_START,
            instances: int | None = None) -> dict:
    """The result line of one run of ``workload`` on ``device`` (the CPU
    tests call this directly, past the look for a card)."""
    import torch

    from bench import harness

    cell = harness.find_cell(ROOT, workload)
    profiled = cell.profiled(traced)
    run = cell.driver().run(cell.config, cell.traffic, seed, seconds,
                            profiled, device, t_start, instances=instances)
    return harness.result_line(
        cell, run, traced,
        device_info(torch, device, cell.chips, run, profiled),
        breakdown(run) if traced else None)


def main(argv=None) -> int:
    args = parse(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    cache_dirs(ROOT)
    from bench import harness

    cell = harness.find_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    line = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda:0")
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"bench: forbidden modules loaded: {leaked}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
