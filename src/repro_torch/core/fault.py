"""Fault tolerance for sweeps: failure injection, revert, checkpoint hooks.

Port of ``repro/core/fault.py``. Failures are *injected*: a worker's chunk
results are discarded, as if its node died mid-slice, and the sweep loop
re-schedules the affected instances from their last durable state. The
paper reports a 100 % completion rate over 12 hours (§5.2); the tests hold
the completion bitmap to 100 % under injected faults.

Failure masks and reverts address LOGICAL instance ids through the static
``n_workers`` grid (the launcher's ``--workers``), never the planner's
per-chunk packing, so the same schedule kills the same instances under any
dispatch mode and with or without compaction. The schedules are drawn with
``np.random.default_rng(seed)`` exactly as the reference draws them, so one
seed gives both packages the same faults.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.sweep import SweepRunner, SweepState


@dataclasses.dataclass
class FailureInjector:
    """Deterministically kills workers at configured chunk indices.

    ``plan`` maps chunk index → worker ids that fail during that chunk. A
    failed worker loses the chunk's progress for every instance it carries
    (its ceil-block of the logical instance axis).
    """

    n_workers: int
    plan: dict[int, list[int]]

    def failed_workers(self, chunk: int) -> list[int]:
        return self.plan.get(chunk, [])

    def instance_mask(self, chunk: int, n_instances: int) -> np.ndarray:
        """Boolean ``[N]`` over logical ids: True where the carrying worker
        failed this chunk."""
        mask = np.zeros((n_instances,), bool)
        per = -(-n_instances // self.n_workers)  # ceil block size
        for w in self.failed_workers(chunk):
            mask[w * per : (w + 1) * per] = True
        return mask

    @staticmethod
    def random(n_workers: int, n_chunks: int, fail_prob: float,
               seed: int = 0) -> "FailureInjector":
        rng = np.random.default_rng(seed)
        plan: dict[int, list[int]] = {}
        for c in range(n_chunks):
            dead = [w for w in range(n_workers) if rng.random() < fail_prob]
            if dead:
                plan[c] = dead
        return FailureInjector(n_workers, plan)


# the simulator fault taxonomy: crashes, hangs and stragglers, and corrupted
# durable writes
FAULT_KINDS = ("crash", "hang", "straggler", "corrupt_ckpt", "corrupt_shard")


@dataclasses.dataclass
class FaultModel(FailureInjector):
    """Every fault the fleet supervisor (:mod:`repro_torch.core.fleet`)
    must survive unattended; ``plan`` stays the crash schedule.

    - ``hangs``: chunk → workers that exceed the chunk deadline (reverted
      like a crash, journaled as a hang);
    - ``stragglers``: chunk → workers that run slow but finish (results
      kept, journaled);
    - ``poison_instances``: logical ids that kill their worker every chunk
      they run (only they are reverted and charged, until quarantined);
    - ``corrupt_ckpt`` / ``corrupt_shard``: chunks after whose checkpoint
      save / shard drain the newest artifact is truncated on disk.
    """

    hangs: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    stragglers: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    poison_instances: tuple[int, ...] = ()
    corrupt_ckpt: frozenset = frozenset()
    corrupt_shard: frozenset = frozenset()

    def lost_workers(self, chunk: int) -> list[tuple[str, int]]:
        """Workers whose chunk results are lost, with the fault kind."""
        return [("crash", w) for w in self.plan.get(chunk, [])] + [
            ("hang", w) for w in self.hangs.get(chunk, [])
        ]

    def failed_workers(self, chunk: int) -> list[int]:
        """Every worker whose slice is lost this chunk (crashes and hangs)."""
        return [w for _, w in self.lost_workers(chunk)]

    def straggler_workers(self, chunk: int) -> list[int]:
        return self.stragglers.get(chunk, [])

    def worker_mask(self, worker: int, n_instances: int) -> np.ndarray:
        """Boolean ``[N]`` over the logical ids ``worker`` carries."""
        mask = np.zeros((n_instances,), bool)
        per = -(-n_instances // self.n_workers)
        mask[worker * per : (worker + 1) * per] = True
        return mask

    def worker_of(self, instance: int, n_instances: int) -> int:
        per = -(-n_instances // self.n_workers)
        return instance // per

    @staticmethod
    def random_model(
        n_workers: int,
        n_chunks: int,
        fail_prob: float,
        hang_prob: float = 0.0,
        straggler_prob: float = 0.0,
        poison_instances: tuple[int, ...] = (),
        corrupt_ckpt_prob: float = 0.0,
        corrupt_shard_prob: float = 0.0,
        seed: int = 0,
    ) -> "FaultModel":
        """A seeded random schedule over every fault channel (the
        reference's draws, in the reference's order)."""
        rng = np.random.default_rng(seed)
        crashes: dict[int, list[int]] = {}
        hangs: dict[int, list[int]] = {}
        slows: dict[int, list[int]] = {}
        bad_ckpt, bad_shard = set(), set()
        for c in range(n_chunks):
            for table, p in ((crashes, fail_prob), (hangs, hang_prob),
                             (slows, straggler_prob)):
                hit = [w for w in range(n_workers) if rng.random() < p]
                if hit:
                    table[c] = hit
            if rng.random() < corrupt_ckpt_prob:
                bad_ckpt.add(c)
            if rng.random() < corrupt_shard_prob:
                bad_shard.add(c)
        return FaultModel(
            n_workers, crashes, hangs=hangs, stragglers=slows,
            poison_instances=tuple(poison_instances),
            corrupt_ckpt=frozenset(bad_ckpt),
            corrupt_shard=frozenset(bad_shard),
        )


def revert_instances(state: SweepState, snapshot: SweepState,
                     mask: np.ndarray) -> SweepState:
    """Discard the masked instances' progress, restoring them from
    ``snapshot``: a per-row select over every ``[N]`` tensor of the state,
    the trace included. The chunk counter keeps its current value."""
    n = mask.shape[0]
    m = torch.as_tensor(mask, device=state.done.device)

    def pick(cur, old):
        if cur is None:
            return None
        if isinstance(cur, torch.Tensor):
            if cur.dim() >= 1 and cur.shape[0] == n:
                return torch.where(m.reshape((-1,) + (1,) * (cur.dim() - 1)),
                                   old, cur)
            return cur
        return type(cur)(*(pick(a, b) for a, b in zip(cur, old)))

    return pick(state, snapshot)._replace(chunk=state.chunk)


def run_with_failures(
    runner: SweepRunner,
    injector: FailureInjector,
    ckpt=None,
    state: SweepState | None = None,
    max_chunks: int = 10_000,
    on_progress: Callable[[int, float], None] | None = None,
    writer=None,
    pipeline: bool = False,
) -> tuple[SweepState, dict]:
    """The fault-tolerant run loop without supervision: a thin call of
    :func:`repro_torch.core.fleet.run_supervised` with no backoff and a
    retry budget that never quarantines.

    Per chunk: snapshot → run chunk → inject failures (revert the killed
    workers' live instances to the snapshot, then recompute ``done``) →
    checkpoint (``ckpt``, a :class:`~repro_torch.ckpt.CheckpointManager`) →
    drain finished instances to ``writer`` (a
    :class:`~repro_torch.data.shards.DatasetWriter`); ``pipeline=True``
    commits each chunk on an I/O thread while the next one runs. Returns
    the final state and ``{chunks_run, failure_events, completion_rate}``,
    one failure event ``{chunk, workers, instances}`` per chunk in which a
    worker failed (``instances`` counts the instances it carries), as the
    reference reports them.
    """
    from repro_torch.core.fleet import RetryPolicy, run_supervised  # cycle

    unlimited = RetryPolicy(max_retries=2**62, backoff_base=0)
    state, info = run_supervised(runner, injector, unlimited, ckpt=ckpt,
                                 writer=writer, state=state,
                                 max_chunks=max_chunks,
                                 on_progress=on_progress, pipeline=pipeline)
    n = runner.cfg.n_instances
    last = int(state.chunk)
    events = [
        {"chunk": c, "workers": dead,
         "instances": int(injector.instance_mask(c, n).sum())}
        for c in range(last - info["chunks_run"], last)
        if (dead := injector.failed_workers(c))
    ]
    return state, {
        "chunks_run": info["chunks_run"],
        "failure_events": events,
        "completion_rate": float(state.done.float().mean()),
    }
