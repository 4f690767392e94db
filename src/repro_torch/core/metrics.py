"""Throughput & distribution accounting — the paper's §5 evaluation harness
(port of ``repro/core/metrics.py``, numpy only).

Reproduces the bookkeeping behind:
- Table 5.1 / Fig 5.1: completed runs over time, cluster vs personal computer
  (48·t per 15-minute slice; 2,304 vs 74 after 12 h → ~31×).
- §5.2: distribution evenness (exactly ``per_node`` instances per node per
  slice, 100 % of the time).
- Tables 5.2/5.3 / Fig 5.2: parallel (6×8) vs serial (6×1) configurations.

Plus the scheduling pieces the paper delegates to PBS: block assignment of
array elements to nodes, and an LPT (longest-processing-time) balancer used
when instance costs vary (straggler-aware assignment, DESIGN.md §7).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """The paper's experimental setup: 6 DICE-lab nodes × 8 instances."""

    n_nodes: int = 6
    instances_per_node: int = 8
    walltime_min: float = 15.0  # per job slice

    @property
    def batch_per_slice(self) -> int:
        return self.n_nodes * self.instances_per_node


def cluster_timeline(
    spec: ClusterSpec, timestamps_min: list[float]
) -> list[int]:
    """Completed runs at each timestamp — paper Table 5.1 cluster column."""
    return [
        int(t // spec.walltime_min) * spec.batch_per_slice
        for t in timestamps_min
    ]


def personal_timeline(
    run_minutes: float, timestamps_min: list[float]
) -> list[int]:
    """Completed runs on a single sequential machine (paper PC column).

    The paper's PC completes 74 runs in 720 min → ~9.73 min/run.
    (1e-9 guard: t an exact multiple of run_minutes counts the finished run.)
    """
    return [int(t / run_minutes + 1e-9) for t in timestamps_min]


PAPER_TIMESTAMPS = [30, 60, 90, 120, 240, 360, 720]
PAPER_PC = [4, 7, 11, 15, 26, 40, 74]
PAPER_CLUSTER = [96, 192, 288, 384, 768, 1152, 2304]


def block_assignment(n_instances: int, n_workers: int) -> np.ndarray:
    """PBS-style contiguous block assignment: instance → worker id."""
    per = -(-n_instances // n_workers)
    return np.minimum(np.arange(n_instances) // per, n_workers - 1)


def lpt_assignment(costs: np.ndarray, n_workers: int) -> np.ndarray:
    """Longest-processing-time greedy: balances variable-cost instances."""
    order = np.argsort(-np.asarray(costs))
    loads = np.zeros(n_workers)
    assign = np.zeros(len(costs), dtype=np.int64)
    for i in order:
        w = int(np.argmin(loads))
        assign[i] = w
        loads[w] += costs[i]
    return assign


def makespan(costs: np.ndarray, assign: np.ndarray, n_workers: int) -> float:
    loads = np.zeros(n_workers)
    np.add.at(loads, assign, costs)
    return float(loads.max())


def distribution_evenness(assign: np.ndarray, n_workers: int) -> dict:
    """§5.2 metric: how evenly instances land on workers."""
    counts = np.bincount(assign, minlength=n_workers)
    return {
        "min": int(counts.min()),
        "max": int(counts.max()),
        "perfectly_even": bool(counts.max() - counts.min() <= 1),
        "counts": counts.tolist(),
    }


def speedup_at(
    spec: ClusterSpec, pc_run_minutes: float, at_min: float
) -> float:
    """Cluster-vs-PC completed-run ratio at time ``at_min`` (paper: ~31×)."""
    cluster = cluster_timeline(spec, [at_min])[0]
    pc = personal_timeline(pc_run_minutes, [at_min])[0]
    return cluster / max(pc, 1)
