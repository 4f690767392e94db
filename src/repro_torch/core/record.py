"""Streaming trajectory recording — the Phase-III dataset channel.

Port of ``repro/core/record.py``. A recording sweep fills, besides its
terminal :class:`~repro_torch.core.simulator.SimMetrics`, a per-instance
time series:

- :class:`RecordConfig` — what to record: named scalar channels
  (:data:`FIELD_CHANNELS`), a ``record_every`` step stride, and the first
  ``k_slots`` vehicle slots' (lane, speed, active) for the token streams;
- :class:`TraceBuffer` — ``[N, R, F]`` f32 series and ``[N, R, K]`` lane
  (i32), speed (f32) and active (bool) slabs. Row ``r`` holds the snapshot
  after step ``(r+1)·record_every``: a write is a pure function of the
  instance's simulation state, so chunk boundaries, dispatch mode,
  compaction, a fault revert or a checkpoint resume never change a row.

Where the reference writes a non-emitting row to an out-of-range index that
``mode="drop"`` discards, torch would raise on that index, and a clamped
index would overwrite a real row. :func:`record_step` therefore selects the
one emitting row of each instance by a mask: rows that are not written keep
their bits, and no step waits on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

F32 = torch.float32


def _mean_speed(st, m):
    # the speed sum in float64, rounded once: exact, so it does not depend
    # on how a batch splits the reduction (the reference sums in f32)
    total = torch.where(st.active, st.vel, 0.0).sum(-1, dtype=torch.float64)
    count = st.active.sum(-1, dtype=F32)
    return total.to(F32) / count.clamp_min(1.0)


# Scalar channels recordable per sampled step: each maps the post-step
# (state, accumulated metrics) of a batch to one ``[B]`` f32 value. Counter
# channels record the CUMULATIVE value at the sampled step.
FIELD_CHANNELS = {
    "mean_speed": _mean_speed,
    "active_count": lambda st, m: st.active.sum(-1, dtype=F32),
    "throughput": lambda st, m: m.throughput.to(F32),
    "spawned": lambda st, m: m.spawned.to(F32),
    "lane_changes": lambda st, m: m.lane_changes.to(F32),
    "merges_ok": lambda st, m: m.merges_ok.to(F32),
    "collisions": lambda st, m: m.collisions.to(F32),
    "ramp_blocked_steps": lambda st, m: m.ramp_blocked_steps.to(F32),
    "min_ttc": lambda st, m: m.min_ttc,
}

DEFAULT_FIELDS = (
    "mean_speed",
    "active_count",
    "throughput",
    "lane_changes",
    "collisions",
    "min_ttc",
)


@dataclass(frozen=True)
class RecordConfig:
    """What a recording sweep records: ``fields`` from
    :data:`FIELD_CHANNELS`, ``k_slots`` vehicle slots' (lane, speed,
    active), every ``record_every`` physics steps (row ``r`` is the
    snapshot after step ``(r+1)*record_every``)."""

    record_every: int = 10
    fields: tuple[str, ...] = DEFAULT_FIELDS
    k_slots: int = 0

    def __post_init__(self) -> None:
        if self.record_every < 1:
            raise ValueError(f"record_every must be >= 1, got {self.record_every}")
        if self.k_slots < 0:
            raise ValueError(f"k_slots must be >= 0, got {self.k_slots}")
        unknown = [f for f in self.fields if f not in FIELD_CHANNELS]
        if unknown:
            raise ValueError(
                f"unknown record fields {unknown}; known: "
                f"{sorted(FIELD_CHANNELS)}"
            )
        if not self.fields and not self.k_slots:
            raise ValueError("RecordConfig records nothing: empty fields "
                             "and k_slots=0")

    def n_rows(self, steps: int) -> int:
        """Rows a horizon of ``steps`` fills (only complete strides)."""
        return steps // self.record_every


class TraceBuffer(NamedTuple):
    """Per-instance recorded time series, ``[N]``-stacked.

    ``series[i, r, f]`` is channel ``fields[f]`` of instance ``i`` after
    step ``(r+1)*record_every``; ``lane/speed/active[i, r, k]`` are its
    first ``k_slots`` vehicle slots at the same instant. Rows past the
    instance's ``horizon // record_every`` keep their zero fill.
    """

    series: torch.Tensor  # [N, R, F] f32
    lane: torch.Tensor    # [N, R, K] i32
    speed: torch.Tensor   # [N, R, K] f32
    active: torch.Tensor  # [N, R, K] bool


def batch_zeros(rec: RecordConfig, steps: int, n_instances: int,
                device: str | torch.device) -> TraceBuffer:
    """Empty buffers for ``n_instances`` (the sweep's initial trace)."""
    r, k = rec.n_rows(steps), rec.k_slots
    return TraceBuffer(
        series=torch.zeros((n_instances, r, len(rec.fields)), dtype=F32,
                           device=device),
        lane=torch.zeros((n_instances, r, k), dtype=torch.int32, device=device),
        speed=torch.zeros((n_instances, r, k), dtype=F32, device=device),
        active=torch.zeros((n_instances, r, k), dtype=torch.bool,
                           device=device),
    )


def record_step(tr: TraceBuffer, st, m, rec: RecordConfig,
                emit: torch.Tensor) -> TraceBuffer:
    """Write each instance's row where ``emit`` ``[B]`` holds and the state
    sits on the stride.

    ``st``/``m`` are the post-step state and accumulated metrics (``st.t``
    already advanced). An instance writes row ``t // record_every - 1``;
    every other row, and every row of an instance that does not emit, keeps
    its bits.
    """
    n_rows = tr.series.shape[1]
    t1 = st.t
    idx = torch.div(t1, rec.record_every, rounding_mode="floor") - 1
    emit = emit & (t1 % rec.record_every == 0) & (idx >= 0) & (idx < n_rows)
    hit = (torch.arange(n_rows, device=t1.device)[None, :] == idx[:, None]) \
        & emit[:, None]                                             # [B, R]
    hit = hit[:, :, None]
    if rec.fields:
        vals = torch.stack([FIELD_CHANNELS[f](st, m) for f in rec.fields], -1)
        tr = tr._replace(series=torch.where(hit, vals[:, None, :], tr.series))
    if rec.k_slots:
        k = rec.k_slots
        tr = tr._replace(
            lane=torch.where(hit, st.lane[:, None, :k], tr.lane),
            speed=torch.where(hit, st.vel[:, None, :k], tr.speed),
            active=torch.where(hit, st.active[:, None, :k], tr.active),
        )
    return tr


def valid_rows(horizon, record_every: int):
    """Per-instance count of filled rows (numpy arrays or tensors)."""
    return horizon // record_every
