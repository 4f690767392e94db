"""Unattended-run fleet supervision: retry budgets, quarantine, journaling.

Port of ``repro/core/fleet.py``: the in-process half of the paper's §5.2
contract (100 % completion over unattended runs); the process half is
:mod:`repro_torch.launch.controller`. :func:`run_supervised` survives every
fault of :class:`~repro_torch.core.fault.FaultModel` without a human:

- **Retry budgets.** Every reverted instance is charged a retry and held
  out of scheduling with exponential backoff (:class:`RetryPolicy`, in
  chunks, through the planner's ``hold`` mask).
- **Quarantine.** An instance past its budget is held for good and left
  out of the *eligible* completion denominator: one poison instance
  degrades only itself.
- **Run journal.** Every event is appended to a crash-safe jsonl log whose
  failure events carry the post-update retry counters and hold horizons,
  so a resumed supervisor rebuilds its fleet state by replay
  (:meth:`FleetState.replay`).
- **Durable-state audit.** After each chunk's checkpoint save and shard
  drain, injected corruption truncates the newest artifact on disk, and
  recovery runs live: restore falls back past digest-mismatched steps, and
  :meth:`~repro_torch.data.shards.DatasetWriter.verify_shards` rewrites a
  damaged shard.

:func:`completion_report` is the paper's §5.2 completion accounting per
scenario; :func:`format_completion_table` renders it. ``pipeline=True``
commits each chunk (checkpoint save, shard drain, audits, journal,
heartbeat) on an I/O thread while the next chunk runs, in the same order
and with the same bits as the synchronous loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.io import PAYLOAD, list_steps
from repro_torch.core.fault import FailureInjector, FaultModel, revert_instances
from repro_torch.core.sweep import SweepRunner, SweepState, _map


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-instance retry budget and exponential re-queue backoff.

    ``max_retries`` is the budget: an instance whose failure count
    *exceeds* it is quarantined (so the default 3 allows three reverts
    and quarantines on the fourth). After failure number ``k`` the
    instance is held out of scheduling for ``backoff_chunks(k)`` chunks —
    ``backoff_base * backoff_factor**(k-1)``, capped at ``backoff_cap``
    so a long sweep never idles an instance indefinitely.
    """

    max_retries: int = 3
    backoff_base: int = 1
    backoff_factor: float = 2.0
    backoff_cap: int = 8

    def backoff_chunks(self, n_failures: int) -> int:
        """Hold duration (in chunks) after the ``n_failures``-th failure."""
        raw = self.backoff_base * self.backoff_factor ** max(n_failures - 1, 0)
        return int(min(self.backoff_cap, raw))


class RunJournal:
    """Append-only jsonl event log — the run's crash-safe flight recorder.

    Each :meth:`append` writes one JSON line and fsyncs, so the journal
    survives a SIGKILL mid-run with at most a torn final line (which
    :meth:`read` skips). Events that mutate fleet state ("failure",
    "quarantine") carry the post-update values, making replay plain
    assignment — see :meth:`FleetState.replay`.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def exists(self) -> bool:
        """True iff the journal file is present on disk."""
        return os.path.exists(self.path)

    def append(self, event: dict) -> None:
        """Durably append one event (adds a wall-clock ``time`` field)."""
        event = dict(event, time=time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")
            f.flush()
            os.fsync(f.fileno())

    @staticmethod
    def read(path: str) -> list[dict]:
        """All parseable events, in append order. A torn line (kill
        mid-append) is skipped rather than poisoning the replay."""
        if not os.path.exists(path):
            return []
        events = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return events


@dataclasses.dataclass
class FleetState:
    """Mutable per-instance supervision state (host-side, numpy).

    ``retries[i]`` counts charged failures, ``quarantined[i]`` marks a
    poison instance permanently removed from scheduling, and
    ``hold_until[i]`` is the first chunk index at which instance ``i``
    may run again (exponential backoff). Everything here is rebuilt from
    the journal on resume — it is deliberately NOT part of the sweep
    checkpoint, so fleet bookkeeping never perturbs trajectory parity
    with an unsupervised run.
    """

    retries: np.ndarray      # [N] int64 — failures charged so far
    quarantined: np.ndarray  # [N] bool
    hold_until: np.ndarray   # [N] int64 — held while chunk < hold_until

    @staticmethod
    def zeros(n: int) -> "FleetState":
        """Fresh fleet state for ``n`` instances (no failures yet)."""
        return FleetState(
            retries=np.zeros(n, np.int64),
            quarantined=np.zeros(n, bool),
            hold_until=np.zeros(n, np.int64),
        )

    @staticmethod
    def replay(events: list[dict], n: int) -> "FleetState":
        """Rebuild fleet state from journal events by assignment.

        "failure" events carry post-update ``retries`` / ``hold_until``
        maps and "quarantine" events carry instance lists, so replay in
        append order converges to the exact state at the last fsync —
        the crash-safety contract of :class:`RunJournal`.
        """
        fs = FleetState.zeros(n)
        for e in events:
            kind = e.get("kind")
            if kind == "failure":
                for k, v in (e.get("retries") or {}).items():
                    fs.retries[int(k)] = int(v)
                for k, v in (e.get("hold_until") or {}).items():
                    fs.hold_until[int(k)] = int(v)
            elif kind == "quarantine":
                for i in e.get("instances", []):
                    fs.quarantined[int(i)] = True
        return fs

    def held(self, chunk: int) -> np.ndarray:
        """Boolean [N]: instances excluded from scheduling at ``chunk``
        (quarantined, or still inside their backoff window)."""
        return self.quarantined | (self.hold_until > chunk)


def _damage_checkpoint(root: str) -> int | None:
    """Truncate the newest checkpoint's payload in place (chaos hook).

    Returns the damaged step, or None when there is nothing to damage.
    The manifest's SHA-256 no longer matches, so restore must detect it
    and fall back — this is how ``FaultModel.corrupt_ckpt`` turns into a
    real on-disk fault.
    """
    steps = list_steps(root)
    if not steps:
        return None
    payload = os.path.join(root, f"step_{steps[-1]:09d}", PAYLOAD)
    try:
        size = os.path.getsize(payload)
        with open(payload, "r+b") as f:
            f.truncate(max(size // 2, 1))
    except OSError:
        return None
    return steps[-1]


def _damage_shard(root: str) -> int | None:
    """Truncate the newest committed shard npz in place (chaos hook).

    Returns the damaged shard index, or None. The writer's
    :meth:`~repro_torch.data.shards.DatasetWriter.verify_shards` must detect
    the torn npz, drop the shard, and re-drain its instances.
    """
    import glob

    shards = sorted(glob.glob(os.path.join(root, "shard_*.npz")))
    if not shards:
        return None
    path = shards[-1]
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    except OSError:
        return None
    return int(os.path.basename(path)[len("shard_"):-len(".npz")])


def _as_model(faults: FailureInjector | None, n_workers: int) -> FaultModel:
    """Normalize any injector (or None) to a full FaultModel."""
    if faults is None:
        return FaultModel(n_workers, {})
    if isinstance(faults, FaultModel):
        return faults
    return FaultModel(faults.n_workers, faults.plan)


def run_supervised(
    runner: SweepRunner,
    faults: FailureInjector | None = None,
    policy: RetryPolicy | None = None,
    ckpt: CheckpointManager | None = None,
    writer=None,
    journal: RunJournal | None = None,
    state: SweepState | None = None,
    max_chunks: int = 10_000,
    on_progress: Callable[[int, float], None] | None = None,
    chunk_deadline: float | None = None,
    pipeline: bool = False,
    on_timing: Callable[[int, dict], None] | None = None,
) -> tuple[SweepState, dict]:
    """The supervised fault-tolerant run loop — §5.2 without a human.

    Per chunk (``c`` = the absolute chunk counter, so a resumed run replays
    the same schedule):

    1. Stop when every instance is done or quarantined.
    2. ``runner.run_chunk(state, hold=...)``: quarantined and backing-off
       instances are held (untouched, never padding).
    3. Inject faults: crashed or hung workers lose their live instances'
       progress (revert to the snapshot); a poison instance loses only its
       own. Each reverted instance is charged a retry, then quarantined
       (budget exceeded) or held for ``backoff_chunks``. Stragglers keep
       their results and are journaled. ``done`` is recomputed after the
       revert, before the drain.
    4. Durable writes: checkpoint save, shard drain, the corruption hooks
       and a :meth:`verify_shards` audit.
    5. Journal the chunk's events (failures first, the chunk commit last)
       and report ``on_progress(c, done_frac)`` after the durable writes,
       so a kill right after a heartbeat leaves a checkpoint at least as
       new as the heartbeat.

    ``chunk_deadline`` (wall-clock seconds per chunk) journals a
    "deadline" event on overrun: a chunk in flight cannot be preempted, so
    real hangs are the process controller's job (heartbeat-loss SIGKILL);
    the hang fault simulates the timeout and revert in-process.

    ``pipeline=True`` runs steps 4 and 5 of chunk ``c`` (its commit) on one
    I/O thread while the loop runs chunk ``c+1``: ``run_chunk`` returns
    only once the host has dispatched the whole chunk, so the overlap has
    to come from a thread. The commit works on a host copy of the state,
    started without waiting on the device right after the chunk's
    completion bitmap is read, so the I/O thread never touches the device.
    At most one commit is in flight: it is joined before the next one is
    submitted and before the loop ends, so the writes, the journal's
    events and the heartbeat-after-checkpoint rule keep the synchronous
    loop's order, and the files hold the same bits.

    ``on_timing(c, {"chunk_s", "ckpt_s", "drain_s", "commit_s",
    "wait_s"})`` receives the host seconds of each chunk's compute (to its
    completion bitmap), checkpoint save, shard drain and whole commit, and
    the seconds the loop waited for that commit (all of it when
    synchronous); pipelined, it comes once the commit has been joined.

    Returns ``(state, info)``: ``chunks_run``, ``failure_events``,
    ``completion_rate``, ``eligible_completion_rate``, ``quarantined``,
    ``retries_total`` and the :func:`completion_report`.
    """
    n = runner.cfg.n_instances
    faults = _as_model(faults, runner._n_workers())
    policy = policy or RetryPolicy()
    if state is None:
        state = runner.init()
    fleet = FleetState.zeros(n)
    resumed_events: list[dict] = []
    if journal is not None and journal.exists():
        resumed_events = RunJournal.read(journal.path)
        fleet = FleetState.replay(resumed_events, n)
    if ckpt is not None and ckpt.has_checkpoint():
        state, _meta = ckpt.restore(like=state)
        if journal is not None:
            journal.append({
                "kind": "resume",
                "chunk": int(state.chunk),
                "skipped_ckpts": list(ckpt.last_skipped),
                "replayed_events": len(resumed_events),
            })

    def _emit(event: dict) -> None:
        if journal is not None:
            journal.append(event)

    def _commit(c, st, ready, done_after, events, done_frac,
                n_quarantined) -> dict:
        """The chunk's durable writes, audits, journal and progress."""
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()  # the host copy of ``st`` has landed
        if ckpt is not None:
            ckpt.save(c + 1, st)
            if c in faults.corrupt_ckpt:
                ckpt.wait()
                step = _damage_checkpoint(ckpt.root)
                events = events + [
                    {"kind": "corrupt_ckpt", "chunk": c, "step": step}
                ]
        t1 = time.perf_counter()
        if writer is not None:
            writer.drain(st, done_after)
            if c in faults.corrupt_shard:
                idx = _damage_shard(writer.root)
                events = events + [
                    {"kind": "corrupt_shard", "chunk": c, "shard": idx}
                ]
            repaired = writer.verify_shards()
            if repaired:
                events = events + [
                    {"kind": "shard_repair", "chunk": c, "shards": repaired}
                ]
        t2 = time.perf_counter()
        for e in events:
            _emit(e)
        _emit({
            "kind": "chunk", "chunk": c, "done": done_frac,
            "quarantined": n_quarantined,
        })
        if on_progress is not None:
            on_progress(c, done_frac)
        return {"ckpt_s": t1 - t0, "drain_s": t2 - t1,
                "commit_s": time.perf_counter() - t0}

    inflight = None  # pipelined: (chunk, chunk seconds, the commit's future)

    def _join() -> None:
        nonlocal inflight
        if inflight is None:
            return
        c, chunk_s, future = inflight
        inflight = None
        t0 = time.perf_counter()
        io = future.result()
        wait_s = time.perf_counter() - t0
        if on_timing is not None:
            on_timing(c, dict(chunk_s=chunk_s, **io, wait_s=wait_s))

    chunks_run = 0
    failure_events: list[dict] = []
    with contextlib.ExitStack() as stack:
        pool = (stack.enter_context(ThreadPoolExecutor(1))
                if pipeline else None)
        for _ in range(max_chunks):
            done_host = state.done.cpu().numpy()
            if np.all(done_host | fleet.quarantined):
                break
            c = int(state.chunk)
            held = fleet.held(c)
            alive = ~done_host & ~held
            snapshot = state
            t0 = time.monotonic()
            state = runner.run_chunk(state, hold=held if held.any() else None)
            chunks_run += 1
            events, mask = _inject(faults, c, n, alive)
            if mask.any():
                state = revert_instances(state, snapshot, mask)
                state = state._replace(done=state.sim.t >= state.horizon)
                events += _charge(fleet, policy, c, mask, events)
                failure_events.extend(
                    {k: e[k] for k in ("chunk", "fault", "workers",
                                       "instances")}
                    for e in events if e["kind"] == "failure"
                )

            done_after = state.done.cpu().numpy()  # sync point
            elapsed = time.monotonic() - t0
            if chunk_deadline is not None and elapsed > chunk_deadline:
                events.append({
                    "kind": "deadline", "chunk": c,
                    "elapsed": elapsed, "deadline": chunk_deadline,
                })
            packet = (c, state, None, done_after, events,
                      float(done_after.mean()), int(fleet.quarantined.sum()))
            if pool is None:
                io = _commit(*packet)
                if on_timing is not None:
                    on_timing(c, dict(chunk_s=elapsed, **io,
                                      wait_s=io["commit_s"]))
                continue
            if ckpt is not None or writer is not None:
                packet = (c, *_host_copy(state), *packet[3:])
            _join()
            inflight = (c, elapsed, pool.submit(_commit, *packet))
        _join()

    if writer is not None:
        # idempotent close-out: anything a kill window or a shard repair
        # left unpersisted is drained here
        writer.drain(state)

    report = completion_report(state, fleet, runner.cfg.scenarios)
    info = {
        "chunks_run": chunks_run,
        "failure_events": failure_events,
        "completion_rate": report["total"]["completion_rate"],
        "eligible_completion_rate":
            report["total"]["eligible_completion_rate"],
        "quarantined": np.flatnonzero(fleet.quarantined).tolist(),
        "retries_total": int(fleet.retries.sum()),
        "report": report,
    }
    _emit({
        "kind": "complete",
        "chunks_run": chunks_run,
        "completion_rate": info["completion_rate"],
        "eligible_completion_rate": info["eligible_completion_rate"],
        "quarantined": info["quarantined"],
    })
    return state, info


def _inject(faults: FaultModel, c: int, n: int, alive: np.ndarray):
    """Chunk ``c``'s faults: worker-granular crashes and hangs, then
    instance-granular poison, on live instances only. Returns the events
    and the boolean ``[N]`` mask of instances to revert."""
    events: list[dict] = []
    mask = np.zeros(n, bool)
    for kind, w in faults.lost_workers(c):
        wm = faults.worker_mask(w, n) & alive
        if wm.any():
            events.append({
                "kind": "failure", "fault": kind, "chunk": c,
                "workers": [w],
                "instances": np.flatnonzero(wm).tolist(),
            })
            mask |= wm
    poison = np.zeros(n, bool)
    for i in faults.poison_instances:
        if 0 <= i < n and alive[i] and not mask[i]:
            poison[i] = True
    if poison.any():
        events.append({
            "kind": "failure", "fault": "poison", "chunk": c,
            "workers": None,
            "instances": np.flatnonzero(poison).tolist(),
        })
        mask |= poison
    slow = faults.straggler_workers(c)
    if slow:
        events.append({
            "kind": "straggler", "chunk": c, "workers": list(slow),
        })
    return events, mask


def _charge(fleet: FleetState, policy: RetryPolicy, c: int, mask: np.ndarray,
            events: list[dict]) -> list[dict]:
    """Charge each reverted instance a retry: quarantine it past its budget,
    else hold it for its backoff. Writes the post-update counters into the
    failure events (so journal replay is plain assignment) and returns the
    quarantine event, if any."""
    ids = np.flatnonzero(mask)
    fleet.retries[ids] += 1
    over = ids[fleet.retries[ids] > policy.max_retries]
    back = ids[fleet.retries[ids] <= policy.max_retries]
    fleet.quarantined[over] = True
    for i in back:
        fleet.hold_until[i] = c + 1 + policy.backoff_chunks(
            int(fleet.retries[i])
        )
    for e in events:
        if e["kind"] != "failure":
            continue
        e["retries"] = {str(i): int(fleet.retries[i]) for i in e["instances"]}
        e["hold_until"] = {
            str(i): int(fleet.hold_until[i]) for i in e["instances"]
        }
    if over.size:
        return [{"kind": "quarantine", "chunk": c, "instances": over.tolist()}]
    return []


def _host_copy(state: SweepState):
    """A copy of ``state`` on the host, and the event that marks it landed
    (None when the state already lies on the host). The copies go into
    pinned memory without waiting on the device, so the loop can go on
    dispatching while they run."""
    if state.done.device.type != "cuda":
        return state, None

    def copy(x):
        return torch.empty_like(x, device="cpu", pin_memory=True).copy_(
            x, non_blocking=True)

    host = _map(copy, state)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(state.done.device))
    return host, ready


def completion_report(
    state: SweepState,
    fleet: FleetState | None,
    scenarios: tuple[str, ...],
) -> dict:
    """The paper's §5.2 completion-rate accounting, per scenario.

    ``completion_rate`` counts ALL instances (a quarantined instance failed
    to complete); ``eligible_completion_rate`` leaves quarantined instances
    out (did everything the fleet kept scheduling finish?). The
    supervisor's gate is eligible == 1.0, with every quarantined instance
    listed.
    """
    done = state.done.cpu().numpy()
    sids = state.scenario_id.cpu().numpy()
    n = done.size
    if fleet is None:
        fleet = FleetState.zeros(n)

    def _row(sel: np.ndarray, name: str) -> dict:
        total = int(sel.sum())
        completed = int((done & sel).sum())
        quar = int((fleet.quarantined & sel).sum())
        eligible = total - quar
        edone = int((done & sel & ~fleet.quarantined).sum())
        return {
            "scenario": name,
            "instances": total,
            "completed": completed,
            "completion_rate": completed / total if total else 1.0,
            "quarantined": quar,
            "eligible": eligible,
            "eligible_completion_rate":
                edone / eligible if eligible else 1.0,
            "retries": int(fleet.retries[sel].sum()),
        }

    rows = [
        _row(sids == i, name)
        for i, name in enumerate(scenarios)
        if bool((sids == i).any())
    ]
    return {"total": _row(np.ones(n, bool), "total"), "scenarios": rows}


def format_completion_table(report: dict) -> str:
    """Render :func:`completion_report` as the §5.2-style markdown table."""
    header = (
        "| Scenario | Instances | Completed | Completion | "
        "Quarantined | Eligible completion | Retries |\n"
        "|---|---|---|---|---|---|---|"
    )
    lines = [header]
    for row in report["scenarios"] + [report["total"]]:
        lines.append(
            "| {scenario} | {instances} | {completed} | {cr:.1%} | "
            "{quarantined} | {ecr:.1%} | {retries} |".format(
                cr=row["completion_rate"],
                ecr=row["eligible_completion_rate"],
                **{k: row[k] for k in (
                    "scenario", "instances", "completed", "quarantined",
                    "retries",
                )},
            )
        )
    return "\n".join(lines)
