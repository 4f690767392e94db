"""The readings the limits of ``correct`` are set from, for one cell.

    python3 bench/control.py --workload <cell> --program-seeds 1,2,... \\
        --control-seeds 7,8,9 [--out FILE]

For each program seed: one run of the cell's program at its own size, with
a window of one chunk (after the warm-up), compared with the
reference as every run is: the lower readings. For each control seed: the
control in the program's place, the plain reference with its floating
state in bfloat16, the nearest precision below the float32 that the
configurations state, run over every instance of the cell in blocks for
as many steps, and its rows at the run's sample compared with the float32
reference's: the upper readings. Prints one JSON object of both; needs a
card. The tests call :func:`control_checks` on the CPU at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEVICE = "cuda:0"


def control_checks(cell, seed: int, n_steps: int, device,
                   instances: int | None = None, block_rows: int = 8192):
    """The control's checks for ``seed``: the bfloat16 reference over all
    instances, compared at the sample with the float32 reference."""
    import numpy as np
    import torch

    from bench.reference.replay import replay

    drv = cell.driver()
    n = int(instances or cell.traffic["instances"])
    ids = drv.sample_ids(seed, n, int(cell.traffic["check_rows"]))
    low = drv.reference_sweep(cell.config, cell.traffic, torch.bfloat16)
    parts = []
    for s in range(0, n, block_rows):
        block = np.arange(s, min(s + block_rows, n))
        keep = np.intersect1d(block, ids)
        out = replay(low, seed, block, n_steps, device, block_rows)
        pick = torch.as_tensor(np.searchsorted(block, keep))
        parts.append({k: None if v is None else type(v)(
            *(x.index_select(0, pick) for x in v)) for k, v in out.items()})
    got = {k: None if parts[0][k] is None else type(parts[0][k])(
        *(torch.cat(f, 0) for f in zip(*(p[k] for p in parts))))
        for k in parts[0]}
    want = replay(drv.reference_sweep(cell.config, cell.traffic), seed, ids,
                  n_steps, device)
    checks, failed = drv.compare(got, want)
    return checks, failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from bench import harness

    cell = harness.find_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    drv = cell.driver()
    steps = int(cell.traffic["warmup_steps"]) + int(
        cell.config["sweep"]["chunk_steps"])
    out = {"workload": args.workload, "steps": steps,
           "program": {}, "control": {}}
    for seed in filter(None, args.program_seeds.split(",")):
        t0 = time.perf_counter()
        # a window of zero seconds closes at the first chunk boundary
        run = drv.run(cell.config, cell.traffic, int(seed), 0.0, False,
                      DEVICE, t0)
        out["program"][seed] = {c.name: c.value for c in run.checks}
        out["program"][seed]["seconds"] = time.perf_counter() - t0
        print(f"program {seed}: {out['program'][seed]}", file=sys.stderr,
              flush=True)
        torch.cuda.empty_cache()
    for seed in filter(None, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        checks, failed = control_checks(cell, int(seed), steps, DEVICE)
        out["control"][seed] = {c.name: c.value for c in checks}
        out["control"][seed].update(failed=failed,
                                    seconds=time.perf_counter() - t0)
        print(f"control {seed}: {out['control'][seed]}", file=sys.stderr,
              flush=True)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
