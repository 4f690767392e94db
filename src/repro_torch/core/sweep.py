"""The PBS-job-array analogue on one GPU: a chunked simulation sweep.

Port of the single-device part of ``repro/core/sweep.py``. ``n_instances``
independent simulations run in ``chunk_steps``-step walltime slices until
the per-instance ``done`` bitmap is all true (the paper's §5.2 completion
metric). Between chunks the host-side **chunk execution planner**
(:func:`plan_chunk`, host numpy copied from the reference) decides which
instances run and how they are batched:

- compaction: only pending instances are stepped, so finished slots stop
  burning lockstep compute;
- dispatch (``SweepConfig.dispatch``) on a mixed-scenario roster:
  ``"switch"`` runs every roster branch on the whole batch and selects
  per row (the reference's vmapped ``lax.switch``: a k-scenario mix pays
  k× the step work; the parity oracle); ``"grouped"`` gathers each
  scenario's rows into one dense batch, steps it with that scenario's
  physics only, and scatters results back to logical slots; ``"auto"``
  is grouped exactly when the roster is mixed.

Both modes give bit-identical state. Every :class:`SweepState` stays in
logical instance order: gather/scatter is confined to ``run_chunk``.

A recording sweep (``SweepConfig.record``, a
:class:`~repro_torch.core.record.RecordConfig`) also fills
``SweepState.trace``; the trace rides the same gather/scatter and, under
``switch`` dispatch, the same per-row select as the simulator state, so its
rows do not depend on dispatch or compaction. Multi-device blocks
(``plan_chunk_blocks``) arrive with a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.record import RecordConfig, TraceBuffer, batch_zeros
from repro_torch.core.scenario import ScenarioParams, SimConfig
from repro_torch.core.scenarios import get_scenario
from repro_torch.core.simulator import (
    SimMetrics,
    SimState,
    init_state,
    rollout_chunk_rec,
    select_rows,
)
from repro_torch.device import resolve_device

DISPATCH_MODES = ("auto", "switch", "grouped")


@dataclass(frozen=True)
class SweepConfig:
    """Static description of one sweep — the paper's batch-job submission.

    ``n_instances`` simulations of ``steps_per_instance`` steps each (or a
    drawn horizon when ``vary_horizon``), in ``chunk_steps``-step slices.
    ``dispatch`` picks how a mixed roster runs: ``"switch"`` (every branch
    on every row, then a per-row select), ``"grouped"`` (per-scenario dense
    batches) or ``"auto"`` (grouped iff the roster is mixed); all are
    bit-for-bit equivalent. ``record`` (a :class:`RecordConfig`) turns on
    the trajectory channel; ``None`` records terminal metrics only.
    """

    n_instances: int = 48          # the paper's experiment: 6 nodes x 8 = 48
    steps_per_instance: int = 9000 # 15 sim-minutes at dt=0.1
    chunk_steps: int = 1500        # one "walltime slice"
    sim: SimConfig = SimConfig()
    seed: int = 0
    vary_horizon: bool = False     # straggler population: horizons in
    min_horizon_frac: float = 0.5  # [frac*steps, steps]
    compaction: bool = True        # step pending instances only
    scenario_mix: tuple[str, ...] = ()  # round-robin roster; empty = sim.scenario
    dispatch: str = "auto"         # "switch" | "grouped" | "auto"
    record: RecordConfig | None = None  # trajectory recording

    @property
    def scenarios(self) -> tuple[str, ...]:
        """The effective scenario roster (mix, or the single sim scenario)."""
        return tuple(self.scenario_mix) or (self.sim.scenario,)

    @property
    def effective_dispatch(self) -> str:
        """Resolve "auto": grouped pays off exactly when the roster is mixed."""
        if self.dispatch == "auto":
            return "grouped" if len(self.scenarios) > 1 else "switch"
        return self.dispatch


class SweepState(NamedTuple):
    """Sweep state; every tensor has a leading ``[N]`` instance axis in
    logical instance order (``chunk`` is a 0-d counter)."""

    sim: SimState           # per-instance simulator states
    metrics: SimMetrics     # per-instance accumulators
    params: ScenarioParams  # per-instance scenario draws
    horizon: torch.Tensor   # [N] i32
    done: torch.Tensor      # [N] bool — the completion bitmap
    chunk: torch.Tensor     # [] i32 — walltime slices executed
    scenario_id: torch.Tensor  # [N] i32 — index into SweepConfig.scenarios
    trace: TraceBuffer | None = None  # recorded time series, when recording


@dataclass(frozen=True)
class GroupPlan:
    """One dense batch of a chunk execution plan.

    ``take[:keep]`` are the logical ids whose results are kept; rows past
    ``keep`` are padding (already-done instances when any exist — their
    rollout is a horizon-masked no-op and the results are discarded).
    """

    roster: int        # index into SweepConfig.scenarios; -1 = mixed (switch)
    take: np.ndarray   # [P] logical ids to gather, padded to worker multiple
    keep: int          # number of real (non-padding) rows
    identity: bool     # take == arange(N): gather/scatter can be skipped


def _partition_live(done, scenario_ids, *, grouped, compaction, hold=None):
    """Live set, done-pool padding source and per-roster ``(roster, ids)``
    groups (one ``-1`` group when not grouped); ``hold`` excludes
    instances in every mode."""
    n = done.size
    mask_live = ~done if compaction else np.ones(n, bool)
    if hold is not None:
        mask_live = mask_live & ~hold
    live = np.flatnonzero(mask_live)
    pad_pool = np.flatnonzero(done)
    if grouped:
        rosters = np.unique(scenario_ids[live])
        groups = [(int(r), live[scenario_ids[live] == r]) for r in rosters]
    else:
        groups = [(-1, live)]
    return live, pad_pool, groups


def _pad_group(idx: np.ndarray, pad_pool: np.ndarray, n_workers: int):
    """Pad ``idx`` to a multiple of the worker count with finished
    instances when any exist, else with the group's first live row."""
    pad = (-idx.size) % max(n_workers, 1)
    if pad == 0:
        return idx, idx.size
    fill = np.resize(pad_pool if pad_pool.size else idx[:1], pad)
    return np.concatenate([idx, fill]), idx.size


def plan_chunk(
    done: np.ndarray,
    scenario_ids: np.ndarray,
    n_workers: int,
    *,
    grouped: bool,
    compaction: bool,
    hold: np.ndarray | None = None,
) -> list[GroupPlan]:
    """Build the host-side execution plan for one chunk.

    ``compaction`` selects the live set (pending instances only vs.
    everyone), ``grouped`` splits it into one dense batch per roster entry,
    ``hold`` masks instances out entirely. Empty when nothing is pending.
    """
    n = done.size
    live, pad_pool, groups = _partition_live(
        done, scenario_ids, grouped=grouped, compaction=compaction, hold=hold,
    )
    if live.size == 0:
        return []
    plans = []
    for roster, idx in groups:
        take, keep = _pad_group(idx, pad_pool, n_workers)
        identity = take.size == n and keep == n and np.array_equal(
            take, np.arange(n)
        )
        plans.append(GroupPlan(roster=roster, take=take, keep=keep,
                               identity=identity))
    return plans


def _gather(tree, idx: torch.Tensor):
    if tree is None:
        return None
    return type(tree)(*(x.index_select(0, idx) for x in tree))


def _scatter(full, part, upd: torch.Tensor, keep: int):
    if full is None:
        return None
    return type(full)(*(f.index_copy(0, upd, p[:keep])
                        for f, p in zip(full, part)))


def _select(rows: torch.Tensor, new, old):
    return None if old is None else select_rows(rows, new, old)


class SweepRunner:
    """Drives a sweep to 100 % completion in walltime-slice chunks on one
    device (``cuda`` unless ``device="cpu"``).

    ``workers_per_device`` is the launcher's ``--workers``: the fault
    injector's worker grid (:meth:`_n_workers`, the paper's instances per
    node). On one device the planner pads nothing: padding to the grid
    would only step already-done instances.
    """

    def __init__(self, cfg: SweepConfig, device: str | torch.device | None = None,
                 workers_per_device: int = 1):
        if cfg.dispatch not in DISPATCH_MODES:
            raise ValueError(
                f"dispatch must be one of {DISPATCH_MODES}, got {cfg.dispatch!r}"
            )
        if cfg.record is not None and not isinstance(cfg.record, RecordConfig):
            raise ValueError(
                f"SweepConfig.record must be a RecordConfig or None, got "
                f"{type(cfg.record).__name__}"
            )
        if workers_per_device < 1:
            raise ValueError(
                f"workers_per_device must be >= 1, got {workers_per_device}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.workers_per_device = workers_per_device
        self.dispatch = cfg.effective_dispatch
        self._sims = tuple(
            dataclasses.replace(cfg.sim, scenario=s) for s in cfg.scenarios
        )
        #: number of batched rollout calls made so far (one per group, and
        #: one per distinct roster config in a switch chunk)
        self.group_calls = 0

    # ---------------- init ----------------

    def init(self) -> SweepState:
        """Draw every instance's parameters and an empty world from the
        sweep seed (``fold_in(key(seed), i)``, as the reference does)."""
        cfg, sims, dev = self.cfg, self._sims, self.device
        n = cfg.n_instances
        ids = torch.arange(n, device=dev)
        k = prng.fold_in(prng.key(cfg.seed, dev), ids)            # [N, 2]
        sids = (ids % len(sims)).to(torch.int32)
        k_sp = prng.fold_in(k, 1)
        params = None
        for r, s in enumerate(sims):
            sp = get_scenario(s.scenario).sample_params(k_sp, s)
            params = sp if params is None else select_rows(sids == r, sp, params)
        sim = init_state(cfg.sim, prng.fold_in(k, 2))
        if cfg.vary_horizon:
            frac = prng.uniform(prng.fold_in(k, 3), (),
                                cfg.min_horizon_frac, 1.0)
            horizon = (frac * cfg.steps_per_instance).to(torch.int32)
        else:
            horizon = torch.full((n,), cfg.steps_per_instance,
                                 dtype=torch.int32, device=dev)
        trace = (batch_zeros(cfg.record, cfg.steps_per_instance, n, dev)
                 if cfg.record is not None else None)
        return SweepState(
            sim=sim,
            metrics=SimMetrics.zeros(n, dev),
            params=params,
            horizon=horizon,
            done=torch.zeros(n, dtype=torch.bool, device=dev),
            chunk=torch.zeros((), dtype=torch.int32, device=dev),
            scenario_id=sids,
            trace=trace,
        )

    def _n_workers(self) -> int:
        """Total worker slots: one device × its instances per device (the
        fault injector's grid)."""
        return self.workers_per_device

    # ---------------- one walltime slice ----------------

    def _host_bitmap(self, state: SweepState) -> tuple[np.ndarray, np.ndarray]:
        done = state.done.cpu().numpy()
        sids = state.scenario_id.cpu().numpy()
        if sids.size and (sids.min() < 0 or sids.max() >= len(self._sims)):
            raise ValueError(
                f"state.scenario_id out of range for a {len(self._sims)}-"
                f"entry roster {self.cfg.scenarios}"
            )
        return done, sids

    def plan_chunk(self, state: SweepState,
                   hold: np.ndarray | None = None) -> list[GroupPlan]:
        """The chunk execution plan for the current bitmap; ``hold``
        (boolean ``[N]``) keeps instances off the schedule."""
        cfg = self.cfg
        grouped = self.dispatch == "grouped"
        no_hold = hold is None or not hold.any()
        if not cfg.compaction and not grouped and no_hold:
            n = cfg.n_instances
            return [GroupPlan(roster=-1, take=np.arange(n), keep=n,
                              identity=True)]
        done, sids = self._host_bitmap(state)
        return plan_chunk(done, sids, 1, grouped=grouped,
                          compaction=cfg.compaction, hold=hold)

    def _rollout(self, sim_cfg: SimConfig, st, m, sp, h, tr):
        self.group_calls += 1
        return rollout_chunk_rec(st, m, sp, h, tr, sim_cfg,
                                 self.cfg.chunk_steps, self.cfg.record)

    def _switch(self, st, m, sp, h, tr, sid):
        """Every distinct roster config on the whole batch, then a per-row
        select by ``sid`` of state, metrics and trace — the reference's
        vmapped ``lax.switch``."""
        out = None
        for s in dict.fromkeys(self._sims):
            rows = torch.zeros_like(sid, dtype=torch.bool)
            for r, sr in enumerate(self._sims):
                if sr == s:
                    rows |= sid == r
            st2, m2, tr2 = self._rollout(s, st, m, sp, h, tr)
            out = (st2, m2, tr2) if out is None else (
                select_rows(rows, st2, out[0]), select_rows(rows, m2, out[1]),
                _select(rows, tr2, out[2]))
        return out

    def _run_group(self, state: SweepState, plan: GroupPlan) -> SweepState:
        """Gather one plan group, step it, scatter results (the trace
        too) to logical slots."""
        def run(st, m, sp, h, tr, sid):
            if plan.roster < 0:
                return self._switch(st, m, sp, h, tr, sid)
            return self._rollout(self._sims[plan.roster], st, m, sp, h, tr)

        if plan.identity:
            sim, metrics, trace = run(state.sim, state.metrics, state.params,
                                      state.horizon, state.trace,
                                      state.scenario_id)
            return state._replace(sim=sim, metrics=metrics, trace=trace)
        take = torch.as_tensor(plan.take, device=self.device)
        sim, metrics, trace = run(
            _gather(state.sim, take), _gather(state.metrics, take),
            _gather(state.params, take), state.horizon.index_select(0, take),
            _gather(state.trace, take),
            state.scenario_id.index_select(0, take),
        )
        upd = take[:plan.keep]
        return state._replace(
            sim=_scatter(state.sim, sim, upd, plan.keep),
            metrics=_scatter(state.metrics, metrics, upd, plan.keep),
            trace=_scatter(state.trace, trace, upd, plan.keep),
        )

    def _check_device(self, state: SweepState) -> None:
        """Raise unless every tensor of ``state`` is on the runner's device:
        a state built elsewhere is never stepped there silently."""
        stack = [state]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                if x.device != self.device:
                    raise ValueError(
                        f"SweepState holds a tensor on {x.device}, but this "
                        f"runner runs on {self.device}; build the state on "
                        f"device={str(self.device)!r}"
                    )
            elif x is not None:
                stack.extend(x)

    def run_chunk(self, state: SweepState,
                  hold: np.ndarray | None = None) -> SweepState:
        """Advance every pending instance by one walltime slice; raises if
        ``state`` is not on the runner's device.

        ``hold`` (boolean ``[N]``) keeps the masked instances off this
        chunk: their state is untouched and the chunk counter still
        advances (the fleet supervisor's retry backoff and quarantine).
        """
        self._check_device(state)
        for plan in self.plan_chunk(state, hold):
            state = self._run_group(state, plan)
        done = state.sim.t >= state.horizon
        return state._replace(done=done, chunk=state.chunk + 1)

    def run(
        self,
        state: SweepState | None = None,
        max_chunks: int = 10_000,
        on_chunk: Callable[[int, SweepState], SweepState] | None = None,
    ) -> SweepState:
        """Run until the completion bitmap is all-true. ``on_chunk(c,
        state) -> state`` runs after every chunk (progress, checkpoints).
        A given ``state`` must lie on the runner's device."""
        if state is None:
            state = self.init()
        self._check_device(state)
        for c in range(max_chunks):
            if bool(state.done.all()):
                break
            state = self.run_chunk(state)
            if on_chunk is not None:
                state = on_chunk(c, state)
        return state


def completion_rate(state: SweepState) -> float:
    """Fraction of instances whose ``done`` bit is set."""
    return float(state.done.float().mean())
