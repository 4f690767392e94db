"""Trajectory → token streams: the part of ``repro/core/tokens.py`` that the
shard writer needs.

A recorded instance is serialized as

    [BOS] (step frame) [SEP] (step frame) ... [EOS] [PAD]*

where a step frame holds one token per tracked vehicle slot,
``token = 4 + lane_code * n_buckets + speed_bucket`` (an inactive slot has
lane code ``n_lanes + 1``). The vocabulary is ``4 + (n_lanes + 2) *
n_buckets``. Host-side numpy, as in the reference: this is dataset
preparation at chunk boundaries. The single-episode recorder
(``record_rollout``) and ``sweep_token_dataset`` come with the token-dataset
slice of the port.
"""

from __future__ import annotations

import numpy as np

PAD, BOS, EOS, SEP = 0, 1, 2, 3
SPECIAL = 4


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
