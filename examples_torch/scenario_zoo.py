"""Scenario zoo: one small sweep per registered scenario, side by side (the
PyTorch port of ``examples/scenario_zoo.py``).

The Scenario API (``repro_torch.core.scenarios``) separates the vectorized
physics core from pluggable workload definitions, so "run every workload
we have" is a loop over the registry — no per-scenario simulator forks.
This example sweeps each registered scenario with a handful of randomized
instances and prints the per-scenario dataset digest (with each scenario's
own metric names), then runs all of them again as ONE mixed sweep.

Run:  PYTHONPATH=src python examples_torch/scenario_zoo.py
      (on the card; ``--device cpu`` runs it on the CPU)
"""

import argparse

from repro_torch.core.aggregate import aggregate_metrics
from repro_torch.core.scenario import SimConfig
from repro_torch.core.scenarios import get_scenario, list_scenarios
from repro_torch.core.sweep import SweepConfig, SweepRunner, completion_rate
from repro_torch.device import resolve_device

INSTANCES = 6
STEPS = 600


def sweep_one(name: str, device: str = "cuda") -> dict:
    cfg = SweepConfig(
        n_instances=INSTANCES, steps_per_instance=STEPS, chunk_steps=200,
        sim=SimConfig(n_slots=32, scenario=name), seed=17,
    )
    state = SweepRunner(cfg, device=device).run()
    assert completion_rate(state) == 1.0
    summary = aggregate_metrics(
        state.metrics, scenario_ids=state.scenario_id,
        scenario_names=cfg.scenarios,
    )
    return summary["per_scenario"][name]


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns ``{"zoo": {name: digest}, "mixed":
    per-scenario digests of the mixed sweep, "completion"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    device = resolve_device(ap.parse_args(argv).device)

    print(f"== scenario zoo: {INSTANCES} instances x {STEPS} steps each ==")
    zoo = {}
    for name in list_scenarios():
        scn = get_scenario(name)
        geom = scn.geometry(SimConfig(n_slots=32))
        s = zoo[name] = sweep_one(name, device)
        shape = (
            f"{geom.n_lanes} lanes"
            + (f" + {geom.special_lane}" if geom.special_lane != "none" else "")
            + (" (ring)" if geom.ring else "")
        )
        print(f"\n-- {name} [{shape}] --")
        for k, v in s.items():
            print(f"   {k}: {v:.3f}" if isinstance(v, float) else f"   {k}: {v}")

    print("\n== the same zoo as ONE mixed sweep (one batched run) ==")
    cfg = SweepConfig(
        n_instances=2 * len(list_scenarios()), steps_per_instance=STEPS,
        chunk_steps=200, sim=SimConfig(n_slots=32), seed=23,
        scenario_mix=tuple(list_scenarios()),
    )
    state = SweepRunner(cfg, device=device).run()
    summary = aggregate_metrics(
        state.metrics, scenario_ids=state.scenario_id,
        scenario_names=cfg.scenarios,
    )
    completion = completion_rate(state)
    print(f"completion: {completion*100:.0f}%")
    for name, s in summary["per_scenario"].items():
        print(f"  {name}: throughput={s.get('total_throughput', s.get('total_exited'))} "
              f"mean_speed={s['mean_speed']:.1f} collisions={s['total_collisions']}")
    return dict(zoo=zoo, mixed=summary["per_scenario"], completion=completion)


if __name__ == "__main__":
    main()
