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
rows do not depend on dispatch or compaction.

Blocks (``SweepRunner(devices=[...])`` with more than one entry, the
paper's "across an arbitrary number of computing nodes"): the planner
packs the live instances into one block per device by LPT
(:func:`plan_chunk_blocks`, host numpy copied from the reference); each
block is enqueued on its own CUDA stream of its card, one after another
from the calling thread, so the streams compute while the host enqueues.
The block's rows are gathered on the home device (``devices[0]``), handed
to its device, stepped there and scattered back in block order, so every
:class:`SweepState` stays in logical order on the home device and N blocks
give the same bits as one device. A list that names one card k times runs
k blocks on k streams of that card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
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


def _pad_fill(pad_pool: np.ndarray, fallback: np.ndarray) -> np.ndarray:
    """The padding source both planners share: finished instances when any
    exist, else the given live fallback row."""
    return pad_pool if pad_pool.size else fallback


def _pad_group(idx: np.ndarray, pad_pool: np.ndarray, n_workers: int):
    """Pad ``idx`` to a multiple of the worker count with finished
    instances when any exist, else with the group's first live row."""
    pad = (-idx.size) % max(n_workers, 1)
    if pad == 0:
        return idx, idx.size
    fill = np.resize(_pad_fill(pad_pool, idx[:1]), pad)
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


@dataclass(frozen=True)
class BlockPlan:
    """A chunk execution plan in per-device blocks.

    Device ``d`` owns rows ``take[d*cap : (d+1)*cap]``; ``keep`` marks the
    rows whose results go back to their logical slots (the rest pad the
    block). ``block_sid[d]`` is the roster index every kept row of block
    ``d`` runs, or ``-1`` for a block that mixes scenarios (or runs the
    switch).
    """

    take: np.ndarray       # [D*cap] logical ids (gather order)
    keep: np.ndarray       # [D*cap] bool — True where results are kept
    block_sid: np.ndarray  # [D] i32 — roster id per block; -1 = mixed
    cap: int               # rows per block (multiple of workers_per_device)
    identity: bool         # take == arange(N), all kept

    @property
    def n_devices(self) -> int:
        return self.block_sid.size


def plan_chunk_blocks(
    done: np.ndarray,
    scenario_ids: np.ndarray,
    n_devices: int,
    workers_per_device: int = 1,
    *,
    grouped: bool,
    compaction: bool,
    hold: np.ndarray | None = None,
) -> BlockPlan | None:
    """Pack one chunk's live instances into per-device blocks by LPT.

    1. partition the live set by scenario (when ``grouped``; otherwise one
       roster ``-1`` group);
    2. split any group larger than the fair share ``ceil(live / D)`` into
       fair-share pieces, so a group spans devices only when it must;
    3. place pieces largest first on the least-loaded device (ties: the
       lowest device index, then the lowest roster id);
    4. ``cap`` = the largest load rounded up to a ``workers_per_device``
       multiple; each block is padded to ``cap`` with finished instances,
       or with the first live row before anything has finished.

    Returns None when nothing is pending. The same bitmap always gives the
    same plan, bit for bit the reference's.
    """
    n = done.size
    live, pad_pool, groups = _partition_live(
        done, scenario_ids, grouped=grouped, compaction=compaction, hold=hold,
    )
    if live.size == 0:
        return None
    d_count = max(n_devices, 1)
    wpd = max(workers_per_device, 1)
    fair = -(-live.size // d_count)
    pieces: list[tuple[int, np.ndarray]] = []
    for roster, idx in groups:
        for s in range(0, idx.size, fair):
            pieces.append((roster, idx[s : s + fair]))
    pieces.sort(key=lambda p: (-p[1].size, p[0]))
    loads = np.zeros(d_count, np.int64)
    bins: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(d_count)]
    for roster, idx in pieces:
        d = int(np.argmin(loads))
        bins[d].append((roster, idx))
        loads[d] += idx.size
    cap = max(int(loads.max()), 1)
    cap = -(-cap // wpd) * wpd
    take = np.empty(d_count * cap, np.int64)
    keep = np.zeros(d_count * cap, bool)
    block_sid = np.zeros(d_count, np.int32)
    fill_src = _pad_fill(pad_pool, live[:1])
    for d in range(d_count):
        ids = (np.concatenate([idx for _, idx in bins[d]]) if bins[d]
               else np.empty(0, np.int64))
        rosters_d = {roster for roster, _ in bins[d]}
        if len(rosters_d) == 1:
            block_sid[d] = rosters_d.pop()
        elif len(rosters_d) > 1:
            block_sid[d] = -1
        pad = cap - ids.size
        row = np.concatenate([ids, np.resize(fill_src, pad)]) if pad else ids
        take[d * cap : (d + 1) * cap] = row
        keep[d * cap : d * cap + ids.size] = True
    identity = bool(
        take.size == n and keep.all() and np.array_equal(take, np.arange(n))
    )
    return BlockPlan(take=take, keep=keep, block_sid=block_sid, cap=cap,
                     identity=identity)


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


def _map(fn, tree):
    """``fn`` on every tensor of a nest of tuples and NamedTuples (None
    stays None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    vals = [_map(fn, x) for x in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def _record_stream(tree, stream) -> None:
    """Mark every tensor of ``tree`` as used on ``stream``, so the caching
    allocator keeps its memory until that stream's work on it is done."""
    _map(lambda x: x.record_stream(stream), tree)


class SweepRunner:
    """Drives a sweep to 100 % completion in walltime-slice chunks, on one
    device (``cuda`` unless ``device="cpu"``) or in blocks over
    ``devices``.

    ``devices`` (a list, see :func:`repro_torch.launch.mesh.sweep_devices`)
    with more than one entry runs every chunk as per-device LPT blocks
    (:func:`plan_chunk_blocks`), each on its own CUDA stream of its card;
    ``devices[0]`` is the home device that holds the state. A list that
    names one device k times runs k blocks on it (k streams of one card,
    or k blocks in turn on the CPU).

    ``workers_per_device`` is the launcher's ``--workers``: the fault
    injector's worker grid is ``len(devices) x workers_per_device``
    (:meth:`_n_workers`, the paper's nodes x instances per node), and each
    block is padded to a multiple of it. On one device the planner pads
    nothing: padding would only step already-done instances.
    """

    def __init__(self, cfg: SweepConfig, device: str | torch.device | None = None,
                 workers_per_device: int = 1, devices=None):
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
        if devices is None:
            devices = [device]
        elif device is not None and (
                not len(devices)
                or resolve_device(device) != resolve_device(devices[0])):
            raise ValueError(f"device {device!r} must be devices[0] "
                             f"(devices {list(devices)!r})")
        self._set_devices(devices)
        self.workers_per_device = workers_per_device
        self.dispatch = cfg.effective_dispatch
        self._sims = tuple(
            dataclasses.replace(cfg.sim, scenario=s) for s in cfg.scenarios
        )
        #: number of batched rollout calls made so far (one per group, and
        #: one per distinct roster config in a switch chunk); exact under
        #: threads
        self.group_calls = 0
        self._count_lock = threading.Lock()

    def _set_devices(self, devices) -> None:
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("devices must name at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"devices must be of one type, got "
                             f"{[str(d) for d in devs]}")
        self.devices = devs
        self.device = devs[0]
        self.n_devices = len(devs)
        self._streams = (tuple(torch.cuda.Stream(device=d) for d in devs)
                         if devs[0].type == "cuda" and len(devs) > 1 else None)

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
        """Total worker slots: devices x instances per device (the fault
        injector's grid)."""
        return self.n_devices * self.workers_per_device

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

    def plan_chunk_sharded(self, state: SweepState,
                           hold: np.ndarray | None = None) -> BlockPlan | None:
        """The blocked plan (:func:`plan_chunk_blocks`) for the current
        bitmap over this runner's devices."""
        return self._plan_blocks(*self._host_bitmap(state), hold)

    def _plan_blocks(self, done, sids, hold) -> BlockPlan | None:
        return plan_chunk_blocks(
            done, sids, self.n_devices, self.workers_per_device,
            grouped=self.dispatch == "grouped",
            compaction=self.cfg.compaction, hold=hold,
        )

    def _rollout(self, sim_cfg: SimConfig, st, m, sp, h, tr):
        with self._count_lock:
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

    def _step_rows(self, ops, sids: np.ndarray):
        """Step one block's rows (``ops`` = sim, metrics, params, horizon,
        trace; ``sids`` their roster ids on the host): the switch under
        ``switch`` dispatch, else one batch per roster in the block."""
        st, m, sp, h, tr = ops
        if self.dispatch != "grouped":
            sid = torch.as_tensor(sids, device=h.device)
            return self._switch(st, m, sp, h, tr, sid)
        rosters = np.unique(sids)
        if rosters.size == 1:
            return self._rollout(self._sims[int(rosters[0])], *ops)
        out = (st, m, tr)
        for r in rosters:
            rows = np.flatnonzero(sids == r)
            idx = torch.as_tensor(rows, device=h.device)
            part = self._rollout(self._sims[int(r)], _gather(st, idx),
                                 _gather(m, idx), _gather(sp, idx),
                                 h.index_select(0, idx), _gather(tr, idx))
            out = tuple(_scatter(full, p, idx, rows.size)
                        for full, p in zip(out, part))
        return out

    def _run_block(self, d: int, ops, sids: np.ndarray, home_stream, ready):
        """Enqueue one block on ``devices[d]``. On a card it runs on the
        block's stream: it waits for the gathers (``ready``), copies the
        rows over when the card is not the home one, steps them and hands
        the results back on the home stream. Returns the results and the
        event that marks them done (None on the CPU). Safe to call from
        any thread."""
        dev, home = self.devices[d], self.device
        if dev.type != "cuda":
            return self._step_rows(ops, sids), None
        stream = self._streams[d]
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(torch.cuda.device(dev))
            if dev != home:  # the home card's stream for the copies back
                ctx.enter_context(torch.cuda.stream(home_stream))
            ctx.enter_context(torch.cuda.stream(stream))
            stream.wait_event(ready)
            if dev == home:
                _record_stream(ops, stream)
            else:
                ops = _map(lambda x: x.to(dev, non_blocking=True), ops)
            out = self._step_rows(ops, sids)
            if dev == home:
                _record_stream(out, home_stream)
            else:
                out = _map(lambda x: x.to(home, non_blocking=True), out)
            return out, stream.record_event()

    @staticmethod
    def _dispatch(calls: list) -> list:
        """Run the blocks' enqueue calls one after another on this thread.
        Nothing in a block waits on its device, so the streams (or cards)
        compute while the host enqueues the next block. A host thread per
        block made the sweep slower, not faster: the threads contend for
        the interpreter lock, which each small op gives up and takes back
        (PERF.md, phase 6a of ``chip_smoke.py`` times both)."""
        return [call() for call in calls]

    def _run_blocks(self, state: SweepState, bp: BlockPlan,
                    sids: np.ndarray) -> SweepState:
        """Gather each block's kept rows on the home device, enqueue the
        blocks, then scatter their results back in block order. Padding
        rows are not stepped: their results would be dropped."""
        home = self.device
        jobs = []
        for d in range(self.n_devices):
            rows = slice(d * bp.cap, (d + 1) * bp.cap)
            ids = bp.take[rows][bp.keep[rows]]
            if ids.size:
                idx = torch.as_tensor(ids, device=home)
                ops = (_gather(state.sim, idx), _gather(state.metrics, idx),
                       _gather(state.params, idx),
                       state.horizon.index_select(0, idx),
                       _gather(state.trace, idx))
                jobs.append((d, ids, idx, ops))
        home_stream = ready = None
        if home.type == "cuda":
            home_stream = torch.cuda.current_stream(home)
            ready = home_stream.record_event()
        outs = self._dispatch([
            functools.partial(self._run_block, d, ops, sids[ids],
                              home_stream, ready)
            for d, ids, _, ops in jobs])
        for (_, ids, idx, _), ((sim, metrics, trace), finished) in zip(jobs, outs):
            if finished is not None:
                home_stream.wait_event(finished)
            state = state._replace(
                sim=_scatter(state.sim, sim, idx, ids.size),
                metrics=_scatter(state.metrics, metrics, idx, ids.size),
                trace=_scatter(state.trace, trace, idx, ids.size),
            )
        return state

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
        if self.n_devices > 1:
            done, sids = self._host_bitmap(state)
            bp = self._plan_blocks(done, sids, hold)
            if bp is not None:
                state = self._run_blocks(state, bp, sids)
        else:
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


    def remesh(self, state: SweepState, devices) -> SweepState:
        """Move a live sweep onto another device list (elastic scale up or
        down). The state is moved to the new home device; its logical
        order, and so every later bit, does not change."""
        self._set_devices(devices)
        return _map(lambda x: x.to(self.device), state)


def completion_rate(state: SweepState) -> float:
    """Fraction of instances whose ``done`` bit is set."""
    return float(state.done.float().mean())
