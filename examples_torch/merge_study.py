"""Merge study: the paper's Phase-II experiment in miniature (the PyTorch
port of ``examples/merge_study.py``).

Sweeps CAV penetration (the randomized parameter the paper's dataset was
built to explore) and reports how merge throughput / safety respond — the
kind of insight the paper's Phase III extracts with ML, read here directly
from the aggregated sweep dataset.

The port's ``rollout`` is batched (one world a key row), so the seeds of a
point, and in ``main`` all (point, seed) pairs, run as the rows of one
call; row (p_cav, s) has the key ``fold_in(key(7), s)`` and the instance
seed ``s``, as the reference's per-call loop does, and its numbers are the
reference's.

Run:  PYTHONPATH=src python examples_torch/merge_study.py
      (on the card; ``--device cpu`` runs it on the CPU)
"""

import argparse

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.scenario import ScenarioParams, SimConfig
from repro_torch.core.simulator import rollout
from repro_torch.device import resolve_device

P_CAVS = [0.0, 0.25, 0.5, 0.75, 1.0]


def run_points(p_cavs, n_seeds: int = 4, steps: int = 900,
               device: str = "cuda") -> list[tuple]:
    """:func:`run_point` of every ``p_cavs`` entry, all (point, seed)
    pairs as the rows of one batched rollout."""
    cfg = SimConfig(n_slots=48)
    dev = resolve_device(device)
    p = torch.tensor(p_cavs, dtype=torch.float32,
                     device=dev).repeat_interleave(n_seeds)
    seeds = list(range(n_seeds)) * len(p_cavs)
    b = len(seeds)
    keys = torch.stack([prng.fold_in(prng.key(7, dev), s) for s in seeds])

    def full(x):
        return torch.full((b,), x, dtype=torch.float32, device=dev)

    sp = ScenarioParams(
        lambda_main=torch.full((b, 3), 0.35, dtype=torch.float32, device=dev),
        lambda_ramp=full(0.25),
        p_cav=p,
        v0_mean=full(30.0),
        v0_ramp=full(21.0),
        seed=torch.tensor(seeds, dtype=torch.int64, device=dev),
        aux0=full(0.0),
        aux1=full(0.0),
    )
    m = rollout(keys, cfg, sp, steps)

    def per_point(x):  # [points, seeds], as the reference's float64 means
        return x.cpu().numpy().astype(np.float64).reshape(len(p_cavs),
                                                         n_seeds)

    tp, merges, blocked = (per_point(x).mean(1) for x in (
        m.throughput, m.merges_ok, m.ramp_blocked_steps))
    speed = (per_point(m.speed_sum)
             / np.maximum(per_point(m.speed_count), 1)).mean(1)
    return list(zip(tp, merges, blocked, speed))


def run_point(p_cav: float, n_seeds: int = 4, steps: int = 900,
              device: str = "cuda"):
    return run_points([p_cav], n_seeds, steps, device)[0]


def main(argv: list[str] | None = None) -> list[tuple]:
    """Run the example; returns one ``(p_cav, throughput, merges,
    ramp_blocked, mean_speed)`` row a point."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"{'p_cav':>6} {'throughput':>11} {'merges':>7} "
          f"{'ramp_blocked':>13} {'mean_speed':>11}")
    rows = []
    for p_cav, (tp, merges, blocked, speed) in zip(
            P_CAVS, run_points(P_CAVS, device=device)):
        print(f"{p_cav:>6.2f} {tp:>11.1f} {merges:>7.1f} "
              f"{blocked:>13.1f} {speed:>11.2f}")
        rows.append((p_cav, tp, merges, blocked, speed))
    print("\nHigher CAV share → tighter accepted gaps → more completed "
          "merges per ramp demand (the Phase-II/III hypothesis).")
    return rows


if __name__ == "__main__":
    main()
