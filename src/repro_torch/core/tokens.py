"""Trajectory → token streams: the Phase-III bridge, port of
``repro/core/tokens.py``.

A recorded instance is serialized as

    [BOS] (step frame) [SEP] (step frame) ... [EOS] [PAD]*

where a step frame holds one token per tracked vehicle slot,
``token = 4 + lane_code * n_buckets + speed_bucket`` (an inactive slot has
lane code ``n_lanes + 1``). The vocabulary is ``4 + (n_lanes + 2) *
n_buckets``. The frame code is host-side numpy, as in the reference: this
is dataset preparation at chunk boundaries. :func:`record_rollout` records
a batch of fresh episodes through the port's own rollout
(``rollout_chunk_rec`` with a :class:`~repro_torch.core.record.RecordConfig`),
so its rows are the ones a recording sweep writes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PAD, BOS, EOS, SEP = 0, 1, 2, 3
SPECIAL = 4


class Trajectory(NamedTuple):
    """Recorded vehicle slots, ``[..., T, K]``: row ``r`` is the snapshot
    after step ``(r+1)*record_every``."""

    lane: torch.Tensor    # i32 (an inactive slot keeps its last lane)
    speed: torch.Tensor   # f32
    active: torch.Tensor  # bool


def vocab_size(cfg, n_buckets: int = 16) -> int:
    """Lanes 0..n_lanes (the ramp) plus one inactive code, times the speed
    buckets, after the four special tokens."""
    return SPECIAL + (cfg.n_lanes + 2) * n_buckets


def _frame_tokens(lane, speed, active, cfg, n_buckets: int,
                  v_max: float) -> np.ndarray:
    """Per-vehicle token code of the (lane, speed, active) channels."""
    speed = np.asarray(speed, np.float32)
    scaled = speed / np.float32(v_max) * np.float32(n_buckets)
    bucket = np.clip(scaled.astype(np.int32), 0, n_buckets - 1)
    lane_code = np.where(active, lane, cfg.n_lanes + 1)
    return SPECIAL + lane_code * n_buckets + bucket


def trace_token_streams(
    lane,
    speed,
    active,
    valid_rows,
    cfg,
    n_buckets: int = 16,
    v_max: float = 40.0,
) -> tuple[np.ndarray, np.ndarray]:
    """``[N, R, K]`` (lane, speed, active) slabs and ``[N]`` filled-row
    counts → ``([N, L] i32 streams, [N] stream lengths incl. BOS/EOS)``,
    ``L = R*(K+1) + 2``, trailing ``PAD``."""
    lane = np.asarray(lane)
    active = np.asarray(active)
    valid = np.asarray(valid_rows).astype(np.int64)
    n, r, k = lane.shape
    tok = _frame_tokens(lane, speed, active, cfg, n_buckets,
                        v_max).astype(np.int32)
    fw = k + 1  # frame width: k vehicle tokens + SEP
    frames = np.concatenate(
        [tok, np.full((n, r, 1), SEP, np.int32)], axis=2
    ).reshape(n, r * fw)
    mask = np.arange(r * fw)[None, :] < (valid * fw)[:, None]
    out = np.full((n, r * fw + 2), PAD, np.int32)
    out[:, 0] = BOS
    out[:, 1 : 1 + r * fw] = np.where(mask, frames, PAD)
    out[np.arange(n), 1 + valid * fw] = EOS
    return out, 2 + valid * fw


def record_rollout(keys: torch.Tensor, sp, cfg, n_steps: int,
                   record_every: int = 10, k_slots: int = 16):
    """Roll one fresh episode per key row (``[B, 2]`` keys, ``[B]``-stacked
    :class:`~repro_torch.core.scenario.ScenarioParams`), recording the
    first ``k_slots`` vehicle slots every ``record_every`` steps: the
    reference's ``record_rollout`` over a batch. Returns the ``[B]``
    :class:`~repro_torch.core.simulator.SimMetrics` and a ``[B, T, K]``
    :class:`Trajectory`, ``T = n_steps // record_every``."""
    from repro_torch.core.record import RecordConfig, batch_zeros
    from repro_torch.core.simulator import (SimMetrics, init_state,
                                            rollout_chunk_rec)

    b, dev = keys.shape[0], keys.device
    rec = RecordConfig(record_every=record_every, fields=(),
                       k_slots=min(k_slots, cfg.n_slots))
    horizon = torch.full((b,), n_steps, dtype=torch.int32, device=dev)
    _, metrics, trace = rollout_chunk_rec(
        init_state(cfg, keys), SimMetrics.zeros(b, dev), sp, horizon,
        batch_zeros(rec, n_steps, b, dev), cfg, n_steps, rec)
    return metrics, Trajectory(trace.lane, trace.speed, trace.active)


def _full_streams(traj: Trajectory, cfg, n_buckets: int,
                  v_max: float) -> np.ndarray:
    """``[B, T, K]`` trajectories → ``[B, T*(K+1)+2]`` streams, every row
    filled (so no PAD)."""
    lane, speed, active = (x.cpu().numpy() for x in traj)
    valid = np.full(lane.shape[0], lane.shape[1])
    return trace_token_streams(lane, speed, active, valid, cfg,
                               n_buckets=n_buckets, v_max=v_max)[0]


def trajectory_to_tokens(traj: Trajectory, cfg, n_buckets: int = 16,
                         v_max: float = 40.0) -> torch.Tensor:
    """One ``[T, K]`` trajectory → its 1-D stream ``[BOS] frames [EOS]``
    (i32, length ``T*(K+1)+2``, on the trajectory's device)."""
    one = Trajectory(*(x[None] for x in traj))
    return torch.from_numpy(_full_streams(one, cfg, n_buckets, v_max)[0]).to(
        traj.lane.device)


def sweep_token_dataset(keys: torch.Tensor, params, cfg, n_steps: int = 600,
                        record_every: int = 10, k_slots: int = 16,
                        n_buckets: int = 16) -> torch.Tensor:
    """``[n, 2]`` keys + ``[n]``-stacked params → ``[n, stream_len]`` i32
    token streams of fresh recorded episodes, on the keys' device."""
    _, traj = record_rollout(keys, params, cfg, n_steps, record_every,
                             k_slots)
    return torch.from_numpy(_full_streams(traj, cfg, n_buckets, 40.0)).to(
        keys.device)
