"""Re-derive a sweep's instances from its seed and replay them, plainly.

The program draws every instance from ``fold_in(key(seed), i)`` and steps
each one on its own: no instance reads another's row. So the reference can
draw any sample of instance ids by itself and replay just those rows, for
as many steps as the program's window ran, and the program's rows at the
same ids must equal what it gives. :func:`replay` does that per scenario
group, in blocks of rows, and returns the final states, metrics, draws and
trace rows in the order of the ids asked for.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from . import prng
from .sim import (
    SCENARIOS,
    RecordConfig,
    ScenarioParams,
    SimConfig,
    SimMetrics,
    init_state,
    rollout,
    trace_zeros,
)


@dataclass(frozen=True)
class Sweep:
    """What the reference needs to know of a sweep: the scenario roster
    (instance ``i`` runs ``roster[i % len(roster)]``), the simulator's
    settings, the horizon and the recording."""

    roster: tuple[str, ...]
    sim: SimConfig
    steps_per_instance: int
    record: RecordConfig | None = None
    vary_horizon: bool = False
    min_horizon_frac: float = 0.5


def draw(sweep: Sweep, seed: int, ids: np.ndarray, roster_id: int, device):
    """Initial state, metrics, draws, horizon and trace of the instances
    ``ids`` (all of roster entry ``roster_id``)."""
    sim = dataclasses.replace(sweep.sim, scenario=sweep.roster[roster_id])
    idx = torch.as_tensor(ids, dtype=torch.int64, device=device)
    k = prng.fold_in(prng.key(seed, device), idx)
    params = SCENARIOS[sim.scenario].sample_params(prng.fold_in(k, 1), sim)
    params = ScenarioParams(*(x.to(sim.dtype) if x.is_floating_point() else x
                              for x in params))
    state = init_state(sim, prng.fold_in(k, 2))
    n = len(ids)
    if sweep.vary_horizon:
        frac = prng.uniform(prng.fold_in(k, 3), (), sweep.min_horizon_frac, 1.0)
        horizon = (frac * sweep.steps_per_instance).to(torch.int32)
    else:
        horizon = torch.full((n,), sweep.steps_per_instance,
                             dtype=torch.int32, device=device)
    trace = (trace_zeros(sweep.record, sweep.steps_per_instance, n, device)
             if sweep.record is not None else None)
    return sim, state, SimMetrics.zeros(n, device), params, horizon, trace


def _to_host(tree):
    return None if tree is None else type(tree)(*(x.cpu() for x in tree))


def replay(sweep: Sweep, seed: int, ids, n_steps: int, device,
           block_rows: int = 4096) -> dict:
    """Replay instances ``ids`` for ``n_steps`` steps from their draws.

    Returns ``{"state", "metrics", "params", "trace"}``, each a NamedTuple
    of host tensors whose rows follow ``ids``; ``trace`` is None when the
    sweep records nothing."""
    ids = np.asarray(ids, dtype=np.int64)
    roster = ids % len(sweep.roster)
    parts = []
    for r in range(len(sweep.roster)):
        rows = np.flatnonzero(roster == r)
        for s in range(0, rows.size, block_rows):
            sel = rows[s:s + block_rows]
            sim, st, m, sp, h, tr = draw(sweep, seed, ids[sel], r, device)
            with torch.no_grad():
                st, m, tr = rollout(st, m, sp, h, tr, sim, sweep.record,
                                    n_steps)
            parts.append((sel, _to_host(st), _to_host(m), _to_host(sp),
                          _to_host(tr)))
    order = np.argsort(np.concatenate([p[0] for p in parts]), kind="stable")
    perm = torch.as_tensor(order)

    def join(i):
        trees = [p[i] for p in parts]
        if trees[0] is None:
            return None
        return type(trees[0])(*(torch.cat(f, 0).index_select(0, perm)
                                for f in zip(*trees)))

    return {"state": join(1), "metrics": join(2), "params": join(3),
            "trace": join(4)}
