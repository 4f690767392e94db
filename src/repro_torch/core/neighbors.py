"""Neighborhood engine — the simulator's O(N²) hot spot, batched over instances.

Port of ``repro/core/neighbors.py``. Every tensor carries a leading
instance axis ``B``: a world is ``pos``/``lane``/``active`` of shape
``[B, N]``, per-lane tables are ``[B, L, N]``. Four interchangeable
implementations (``SimConfig.neighbor_impl``), all bit-for-bit equal:

``reference``
    The masked all-pairs scan (``neighbor_info``), one pass per lane.
``dense``
    One ``[B, N, N]`` pairwise materialization, every lane in one
    ``[B, L, N, N]`` reduction.
``sort``
    One stable per-lane argsort of positions, queries answered by
    ``searchsorted`` adjacency lookups.
``cuda``
    The hand-written multi-query CUDA kernel
    (:func:`repro_torch.kernels.idm.neighbor_kernel`, the counterpart of
    the reference's ``pallas``): one launch per table build (Q = lane
    count) and one per single query (Q = 1). On CPU tensors it runs the
    kernel's plain version.

The shared contract: lead = argmin over vehicles strictly ahead in the
query lane, follower = argmin over vehicles strictly behind; exact
position ties are neither; index ties resolve to the lowest slot; absent
neighbours report ``idx = 0``, ``gap = INF - veh_len`` (in f32),
``has = False``; inactive queriers have no neighbours.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.idm import neighbor_kernel
from repro_torch.kernels.ref import INF, neighbor_info

IMPLS = ("reference", "dense", "sort", "cuda")

__all__ = [
    "IMPLS", "INF", "Neighbors", "NeighborTables", "build_tables",
    "neighbor_info", "query_lanes",
]


class Neighbors(NamedTuple):
    """Lead/follower answer for one query-lane vector. All fields [B, N]."""

    lead_idx: torch.Tensor   # i32, 0 when has_lead is False
    lead_gap: torch.Tensor   # f32 bumper-to-bumper, INF - veh_len when absent
    has_lead: torch.Tensor   # bool
    foll_idx: torch.Tensor   # i32
    foll_gap: torch.Tensor   # f32
    has_foll: torch.Tensor   # bool


class NeighborTables(NamedTuple):
    """Per-lane neighbor tables. All fields [B, L, N] (lane-major)."""

    lead_idx: torch.Tensor
    lead_gap: torch.Tensor
    has_lead: torch.Tensor
    foll_idx: torch.Tensor
    foll_gap: torch.Tensor
    has_foll: torch.Tensor

    def query(self, query_lane: torch.Tensor) -> Neighbors:
        """Answer a per-vehicle query-lane vector ``[B, N]`` by gathering
        along the lane axis. Out-of-range lanes clamp, as the reference's
        gathers do (a switch-dispatched branch also runs on rows of other
        scenarios, whose lanes may exceed its table; those rows are
        discarded)."""
        idx = query_lane.long().clamp(0, self.lead_idx.shape[1] - 1).unsqueeze(1)
        return Neighbors(*(t.gather(1, idx).squeeze(1) for t in self))


def _reference_tables(pos, lane, active, veh_len, n_lanes_total):
    per_lane = [
        neighbor_info(pos, lane, active, veh_len, torch.full_like(lane, l))
        for l in range(n_lanes_total)
    ]
    return NeighborTables(*(torch.stack(f, dim=1) for f in zip(*per_lane)))


def _dense_tables(pos, lane, active, veh_len, n_lanes_total):
    n = pos.shape[-1]
    dpos = pos[:, None, :] - pos[:, :, None]                   # [B,N,N]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    pair_act = active[:, None, :] & active[:, :, None] & ~eye
    ahead_act = pair_act & (dpos > 0.0)
    behind_act = pair_act & (dpos < 0.0)
    lanes = torch.arange(n_lanes_total, dtype=lane.dtype, device=lane.device)
    in_lane = lane[:, None, :] == lanes[None, :, None]         # [B,L,N] over j

    ahead = ahead_act[:, None] & in_lane[:, :, None, :]        # [B,L,N,N]
    behind = behind_act[:, None] & in_lane[:, :, None, :]
    inf = torch.tensor(INF, dtype=pos.dtype, device=pos.device)

    lead_d = torch.where(ahead, dpos[:, None], inf)
    foll_d = torch.where(behind, -dpos[:, None], inf)
    return NeighborTables(
        lead_d.argmin(dim=-1).to(torch.int32),
        lead_d.amin(dim=-1) - veh_len,
        ahead.any(dim=-1),
        foll_d.argmin(dim=-1).to(torch.int32),
        foll_d.amin(dim=-1) - veh_len,
        behind.any(dim=-1),
    )


def _sort_tables(pos, lane, active, veh_len, n_lanes_total):
    b, n = pos.shape
    dev = pos.device
    inf = torch.tensor(INF, dtype=pos.dtype, device=dev)
    no_gap = inf - veh_len
    lanes = torch.arange(n_lanes_total, dtype=lane.dtype, device=dev)
    in_l = active[:, None, :] & (lane[:, None, :] == lanes[None, :, None])
    key = torch.where(in_l, pos[:, None, :], inf)              # [B,L,N]
    order = torch.argsort(key, dim=-1, stable=True)  # in-lane ascending
    spos = key.gather(-1, order)
    p = pos[:, None, :].expand(b, n_lanes_total, n).contiguous()
    act = active[:, None, :]

    # lead: first entry strictly greater than pos_i ('right' skips ties,
    # which also excludes self and exact-tie vehicles, as the oracle does)
    j = torch.searchsorted(spos, p, right=True)
    jc = j.clamp(max=n - 1)
    cand = spos.gather(-1, jc)
    has_lead = (j < n) & (cand < INF * 0.5) & act
    lead_idx = torch.where(has_lead, order.gather(-1, jc), 0).to(torch.int32)
    lead_gap = torch.where(has_lead, cand - p - veh_len, no_gap)

    # follower: last entry strictly less than pos_i, then back to the
    # start of its tie group (the oracle's lowest slot index)
    j2 = torch.searchsorted(spos, p) - 1
    cand2 = spos.gather(-1, j2.clamp(min=0))
    jf = torch.searchsorted(spos, cand2)
    has_foll = (j2 >= 0) & (cand2 < INF * 0.5) & act
    foll_idx = torch.where(has_foll, order.gather(-1, jf), 0).to(torch.int32)
    foll_gap = torch.where(has_foll, p - cand2 - veh_len, no_gap)
    return NeighborTables(lead_idx, lead_gap, has_lead, foll_idx, foll_gap,
                          has_foll)


def _cuda_tables(pos, lane, active, veh_len, n_lanes_total):
    b, n = pos.shape
    q = torch.arange(n_lanes_total, dtype=torch.int32, device=pos.device)
    q = q[None, :, None].expand(b, n_lanes_total, n).contiguous()
    return NeighborTables(*neighbor_kernel(
        pos.contiguous(), lane.contiguous(), active.contiguous(), q,
        veh_len=veh_len,
    ))


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"neighbor_impl must be one of {IMPLS}, got {impl!r}")


def build_tables(pos, lane, active, veh_len: float, n_lanes_total: int,
                 impl: str = "dense") -> NeighborTables:
    """Per-lane lead/follower tables ``[B, L, N]`` for one state snapshot.

    One call serves any number of per-vehicle query-lane vectors via
    ``tables.query(q)``.
    """
    _check_impl(impl)
    if impl == "reference":
        return _reference_tables(pos, lane, active, veh_len, n_lanes_total)
    if impl == "dense":
        return _dense_tables(pos, lane, active, veh_len, n_lanes_total)
    if impl == "sort":
        return _sort_tables(pos, lane, active, veh_len, n_lanes_total)
    return _cuda_tables(pos, lane, active, veh_len, n_lanes_total)


def query_lanes(pos, lane, active, veh_len: float, query_lane,
                impl: str = "dense", *,
                n_lanes_total: int | None = None) -> Neighbors:
    """Answer one per-vehicle query-lane vector ``[B, N]`` (one construction)."""
    _check_impl(impl)
    if impl in ("reference", "dense"):
        return Neighbors(*neighbor_info(pos, lane, active, veh_len, query_lane))
    if impl == "sort":
        if n_lanes_total is None:
            raise ValueError(
                "query_lanes(impl='sort') needs n_lanes_total (the lane "
                "count is a static table dimension)"
            )
        tabs = _sort_tables(pos, lane, active, veh_len, n_lanes_total)
        return tabs.query(query_lane)
    res = neighbor_kernel(
        pos.contiguous(), lane.contiguous(), active.contiguous(),
        query_lane.contiguous()[:, None, :], veh_len=veh_len,
    )
    return Neighbors(*(t[:, 0] for t in res))
