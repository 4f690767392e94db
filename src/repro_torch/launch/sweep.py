"""Sweep launcher — the paper's Phase II sweep as one command, on a GPU.

``python -m repro_torch.launch.sweep --instances 1024 --slots 128
--scenario-mix all --neighbor-impl cuda`` runs the sweep on the card;
``--device cpu`` runs it on the CPU. Flags:

``--instances --steps --chunk-steps --slots``
    sweep size, horizon and walltime slice (defaults as the reference);
``--scenario`` / ``--scenario-mix`` (names, or ``all``)
    the workload roster, assigned to instances round-robin;
``--dispatch {auto,switch,grouped}``
    how a mixed roster maps onto batched calls (bit-identical results);
``--neighbor-impl {reference,dense,sort,cuda}``
    the neighborhood engine; ``cuda`` is the hand-written kernel;
``--seed --vary-horizon --out --device``.

It prints what the reference launcher prints (roster line, per-chunk
completion, the final line and the summary JSON) apart from the fleet
table. The fault, retry, checkpoint, heartbeat, dataset and ``--devices``
flags come with the slices that port them.
"""

from __future__ import annotations

import argparse
import json
import time


def _parser(scenarios: list[str]) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sweep",
                                 allow_abbrev=False)
    ap.add_argument("--instances", type=int, default=48)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--chunk-steps", type=int, default=400)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--scenario", default="highway_merge", choices=scenarios,
                    help="workload every instance runs (registry name)")
    ap.add_argument("--scenario-mix", default=None,
                    help="comma-separated scenario names assigned to "
                         "instances round-robin, or 'all' for the whole "
                         "registry (overrides --scenario)")
    ap.add_argument("--dispatch", default="auto",
                    choices=["auto", "switch", "grouped"],
                    help="mixed-sweep chunk dispatch: grouped = per-scenario "
                         "dense batches, switch = every branch on every row "
                         "then a per-row select, auto = grouped iff mixed")
    ap.add_argument("--neighbor-impl", default="sort",
                    choices=["reference", "dense", "sort", "cuda"],
                    help="neighborhood engine implementation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vary-horizon", action="store_true")
    ap.add_argument("--out", default=None, help="write records JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns ``{"state", "summary", "seconds",
    "group_calls"}`` for in-process callers."""
    from repro_torch.core.aggregate import aggregate_metrics, metrics_to_records
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.scenarios import list_scenarios
    from repro_torch.core.sweep import SweepConfig, SweepRunner, completion_rate

    args = _parser(list_scenarios()).parse_args(argv)
    if args.scenario_mix:
        mix = (
            tuple(list_scenarios())
            if args.scenario_mix.strip() == "all"
            else tuple(s.strip() for s in args.scenario_mix.split(",") if s.strip())
        )
    else:
        mix = ()
    cfg = SweepConfig(
        n_instances=args.instances,
        steps_per_instance=args.steps,
        chunk_steps=args.chunk_steps,
        sim=SimConfig(n_slots=args.slots, neighbor_impl=args.neighbor_impl,
                      scenario=args.scenario),
        seed=args.seed,
        vary_horizon=args.vary_horizon,
        scenario_mix=mix,
        dispatch=args.dispatch,
    )
    runner = SweepRunner(cfg, device=args.device)
    print(f"[sweep] scenarios: {', '.join(cfg.scenarios)} "
          f"({'mixed round-robin' if len(cfg.scenarios) > 1 else 'uniform'}) "
          f"| dispatch {cfg.effective_dispatch} "
          f"| neighbor impl {cfg.sim.neighbor_impl} | device {runner.device}")

    def on_chunk(c: int, state):
        print(f"[sweep] chunk {c}: {completion_rate(state)*100:.1f}% complete")
        return state

    t0 = time.perf_counter()
    state = runner.run(on_chunk=on_chunk)
    if runner.device.type == "cuda":
        import torch

        torch.cuda.synchronize(runner.device)
    dt = time.perf_counter() - t0
    summary = aggregate_metrics(
        state.metrics, scenario_ids=state.scenario_id,
        scenario_names=cfg.scenarios,
    )
    chunks = int(state.chunk)
    print(f"[sweep] done in {dt:.1f}s — completion "
          f"{completion_rate(state)*100:.0f}%, {chunks} chunks, "
          f"{runner.group_calls} batched chunk calls")
    print(f"[sweep] {json.dumps(summary, indent=1)}")
    if args.out:
        records = metrics_to_records(
            state.metrics, state.params,
            scenario_ids=state.scenario_id, scenario_names=cfg.scenarios,
        )
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "records": records}, f, indent=1)
        print(f"[sweep] wrote dataset to {args.out}")
    return {"state": state, "summary": summary, "seconds": dt,
            "group_calls": runner.group_calls}


if __name__ == "__main__":
    main()
