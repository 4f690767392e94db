"""Vectorized mixed-traffic simulator core, batched over instances.

Port of ``repro/core/simulator.py``: IDM car following, MOBIL lane
changing and the scenario hooks, for a whole batch of instances at once.
The reference steps one instance and ``vmap``s it; here every
:class:`SimState` field carries a written-out instance axis (``[B, N]``,
``[B]`` for the step counter, ``[B, 2]`` for the PRNG key) and
:func:`sim_step` advances the whole batch. The reference's ``lax.scan``
over steps is a Python loop (:func:`rollout_chunk_rec`, which also fills
a recording sweep's trace), with the same horizon no-op masking: a step
past an instance's horizon leaves its state and metrics untouched.

``sim_step`` performs exactly two neighborhood constructions per step, as
the reference does: one table build on the pre-move snapshot (own-lane,
MOBIL and scenario lateral-rule queries) and one single query on the
post-lane-change snapshot (the integration accel, reused by the
collision/TTC stage). With ``neighbor_impl="cuda"`` each is one launch of
the hand-written neighbor kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core.neighbors import (  # noqa: F401  (re-exported)
    Neighbors,
    NeighborTables,
    build_tables,
    neighbor_info,
    query_lanes,
)
from repro_torch.core.scenario import ScenarioParams, SimConfig, driver_params
from repro_torch.core.scenarios import get_scenario
from repro_torch.core.scenarios.base import (  # noqa: F401  (idm_accel re-exported)
    RoadGeometry,
    Scenario,
    col,
    count,
    idm_accel,
    jmod,
    take,
)

INF = 1e9
F32 = torch.float32
I32 = torch.int32


class SimState(NamedTuple):
    """Batched simulator state: one row per instance."""

    pos: torch.Tensor        # [B, N] f32, meters from segment start
    vel: torch.Tensor        # [B, N] f32, m/s
    lane: torch.Tensor       # [B, N] i32; n_lanes == ramp lane
    active: torch.Tensor     # [B, N] bool
    is_cav: torch.Tensor     # [B, N] bool
    v0: torch.Tensor         # [B, N] f32 desired speed
    T: torch.Tensor          # [B, N] f32 headway
    a_max: torch.Tensor      # [B, N] f32
    b_comf: torch.Tensor     # [B, N] f32
    s0: torch.Tensor         # [B, N] f32
    politeness: torch.Tensor # [B, N] f32
    cooldown: torch.Tensor   # [B, N] i32 lane-change cooldown
    key: torch.Tensor        # [B, 2] int64 PRNG key words
    t: torch.Tensor          # [B] i32 step counter


class SimMetrics(NamedTuple):
    """Per-instance metric accumulators, each ``[B]`` (field names keep
    their merge-era spelling; scenarios rename them via
    ``Scenario.metric_aliases``)."""

    throughput: torch.Tensor      # i32 vehicles exited
    spawned: torch.Tensor         # i32
    speed_sum: torch.Tensor       # f32
    speed_count: torch.Tensor     # f32
    collisions: torch.Tensor      # i32
    merges_ok: torch.Tensor       # i32 scenario-forced lane moves
    ramp_blocked_steps: torch.Tensor  # i32 scenario congestion gauge
    lane_changes: torch.Tensor    # i32
    min_ttc: torch.Tensor         # f32
    steps: torch.Tensor           # i32

    @staticmethod
    def zeros(b: int, device: str | torch.device) -> "SimMetrics":
        """Fresh accumulators for ``b`` instances on ``device`` (``min_ttc``
        at INF)."""
        z_i = torch.zeros(b, dtype=I32, device=device)
        z_f = torch.zeros(b, dtype=F32, device=device)
        return SimMetrics(z_i, z_i, z_f, z_f, z_i, z_i, z_i, z_i,
                          torch.full((b,), INF, dtype=F32, device=device), z_i)


def init_state(cfg: SimConfig, key: torch.Tensor) -> SimState:
    """Empty worlds, one per key row (``key`` is ``[B, 2]``): every slot
    inactive, parked at ``-INF`` m, drivers at population means, ``t = 0``."""
    b, n = key.shape[0], cfg.n_slots
    dev = key.device
    zf = torch.zeros((b, n), dtype=F32, device=dev)
    zi = torch.zeros((b, n), dtype=I32, device=dev)
    zb = torch.zeros((b, n), dtype=torch.bool, device=dev)
    return SimState(
        pos=zf - INF, vel=zf, lane=zi, active=zb, is_cav=zb,
        v0=zf + 30.0, T=zf + 1.5, a_max=zf + 1.4, b_comf=zf + 2.0,
        s0=zf + 2.0, politeness=zf + 0.3, cooldown=zi,
        key=key, t=torch.zeros(b, dtype=I32, device=dev),
    )


# --------------------------------------------------------------------------
# physics primitives
# --------------------------------------------------------------------------

def _own_accel(st: SimState, cfg: SimConfig, geom: RoadGeometry,
               scn: Scenario, sp: ScenarioParams, query_lane, nb: Neighbors,
               ctx=None):
    """IDM accel against the lead in ``query_lane`` plus the scenario's
    longitudinal constraints, clamped to ``[-b_max, a_max]``."""
    v_lead = torch.where(nb.has_lead, take(st.vel, nb.lead_idx), 0.0)
    gap = torch.where(nb.has_lead, nb.lead_gap, INF)
    dv = torch.where(nb.has_lead, st.vel - v_lead, 0.0)
    a = idm_accel(st.vel, dv, gap, st.v0, st.T, st.a_max, st.b_comf, st.s0)
    a = scn.longitudinal_mods(st, cfg, geom, sp, query_lane, nb, a, ctx)
    return torch.minimum(a.clamp_min(-cfg.b_max), st.a_max)


def _mobil_candidate(st: SimState, cfg: SimConfig, geom: RoadGeometry,
                     scn: Scenario, sp: ScenarioParams, a_now,
                     own: Neighbors, tabs: NeighborTables, cand_lane,
                     ctx=None):
    """MOBIL incentive + safety for moving every vehicle to ``cand_lane``."""
    nb = tabs.query(cand_lane)
    li, lg, hl, fi, fg, hf = nb
    a_new = _own_accel(st, cfg, geom, scn, sp, cand_lane, nb, ctx)

    # new follower j: before = its current accel; after = following self
    a_j_before = torch.where(hf, take(a_now, fi), 0.0)
    gap_j_after = torch.where(hf, fg, INF)
    v_j = take(st.vel, fi)
    a_j_after = idm_accel(
        v_j, v_j - st.vel, gap_j_after,
        take(st.v0, fi), take(st.T, fi), take(st.a_max, fi),
        take(st.b_comf, fi), take(st.s0, fi),
    )
    a_j_after = torch.where(hf, a_j_after, 0.0)

    # old follower k: before = following self; after = following self's lead
    ki, hk = own.foll_idx, own.has_foll
    lead_pos = torch.where(own.has_lead, take(st.pos, own.lead_idx), INF)
    lead_vel = torch.where(own.has_lead, take(st.vel, own.lead_idx), 0.0)
    gap_k_after = lead_pos - take(st.pos, ki) - cfg.vehicle_len
    a_k_before = torch.where(hk, take(a_now, ki), 0.0)
    v_k = take(st.vel, ki)
    a_k_after = idm_accel(
        v_k, v_k - lead_vel, gap_k_after,
        take(st.v0, ki), take(st.T, ki), take(st.a_max, ki),
        take(st.b_comf, ki), take(st.s0, ki),
    )
    a_k_after = torch.where(hk, a_k_after, 0.0)

    incentive = (a_new - a_now) + st.politeness * (
        (a_j_after - a_j_before) + (a_k_after - a_k_before)
    )
    safe = (a_j_after >= -cfg.b_safe) & (
        torch.where(hf, fg, INF) > 0.0
    ) & (torch.where(hl, lg, INF) > 0.0)
    return incentive, safe


def _apply_lane_changes(st: SimState, cfg: SimConfig, geom: RoadGeometry,
                        scn: Scenario, sp: ScenarioParams, a_now,
                        own: Neighbors, tabs: NeighborTables, ctx=None):
    """Simultaneous MOBIL decisions for scenario-eligible vehicles."""
    eligible = scn.mobil_eligible(st, cfg, geom) & st.active
    can_change = eligible & (st.cooldown == 0)

    left = (st.lane + 1).clamp_max(geom.n_lanes - 1)
    right = (st.lane - 1).clamp_min(0)
    inc_l, safe_l = _mobil_candidate(st, cfg, geom, scn, sp, a_now, own,
                                     tabs, left, ctx)
    inc_r, safe_r = _mobil_candidate(st, cfg, geom, scn, sp, a_now, own,
                                     tabs, right, ctx)
    ok_l = (safe_l & (inc_l > cfg.mobil_athr) & (left != st.lane)
            & can_change & scn.mobil_candidate_ok(st, cfg, geom, left))
    ok_r = (safe_r & (inc_r > cfg.mobil_athr) & (right != st.lane)
            & can_change & scn.mobil_candidate_ok(st, cfg, geom, right))

    go_left = ok_l & (~ok_r | (inc_l >= inc_r))
    go_right = ok_r & ~go_left
    new_lane = torch.where(go_left, left, torch.where(go_right, right, st.lane))
    changed = go_left | go_right
    cooldown = torch.where(
        changed, cfg.lane_change_cooldown, (st.cooldown - 1).clamp_min(0)
    )
    return new_lane, cooldown, count(changed)


def _put(arr: torch.Tensor, slot: torch.Tensor, val: torch.Tensor):
    """``arr.at[slot].set(val, mode="drop")`` per row, where ``slot == N``
    means drop: scatter into an ``N+1``-wide buffer and cut the last column."""
    b, n = arr.shape
    buf = torch.cat([arr, arr.new_zeros((b, 1))], dim=1)
    buf.scatter_(1, slot, val.to(arr.dtype).expand(b, -1))
    return buf[:, :n]


def _spawn(st: SimState, cfg: SimConfig, geom: RoadGeometry, scn: Scenario,
           sp: ScenarioParams, key: torch.Tensor):
    """Bernoulli(λ·dt) arrivals per spawn lane; each arriving lane claims
    the next-lowest free slot in lane order, with a fresh driver."""
    n = st.pos.shape[1]
    lam, base_v0, lanes = scn.boundary_spawn(cfg, geom, sp)
    n_spawn_lanes = lanes.shape[0]
    ku, kj = prng.split(key, 2).unbind(-2)
    u = prng.uniform(ku, (3, n_spawn_lanes))     # arrival, cav, v0 jitter

    arrive = u[:, 0] < lam * cfg.dt                                # [B, L]
    in_lane = st.active[:, None, :] & (st.lane[:, None, :] == lanes[None, :, None])
    nearest = torch.where(in_lane, st.pos[:, None, :], INF).amin(dim=-1)
    clear = nearest > cfg.spawn_gap
    if geom.ring:
        # traffic also approaches the spawn point from behind the seam
        rear = torch.where(in_lane, st.pos[:, None, :], -INF).amax(dim=-1)
        clear = clear & ((geom.road_len - rear) > 3.0 * cfg.spawn_gap)

    # rank-based slot claim: the r-th lane that wants to spawn takes the
    # r-th-lowest free slot; lanes beyond the free-slot count miss out
    free = ~st.active
    n_free = count(free)[:, None]
    want = arrive & clear
    want_i = want.to(I32)
    rank = torch.cumsum(want_i, dim=1, dtype=I32) - want_i
    ok = want & (rank < n_free)
    free_slots = torch.argsort((~free).to(I32), dim=1, stable=True)
    claim = free_slots.gather(1, rank.clamp_max(n - 1).long())
    slot = torch.where(ok, claim, n)                               # n = drop

    cav = u[:, 1] < col(sp.p_cav)
    new_v0 = base_v0 * (0.9 + 0.2 * u[:, 2])
    dp = driver_params(cav, kj, n_spawn_lanes)
    # entry speed from the NEW driver's just-drawn headway
    init_v = torch.minimum(new_v0, nearest / dp["T"].clamp_min(0.5))

    st = st._replace(
        pos=_put(st.pos, slot, torch.zeros_like(new_v0)),
        vel=_put(st.vel, slot, (init_v * 0.8).clamp_min(5.0)),
        lane=_put(st.lane, slot, lanes[None, :]),
        active=_put(st.active, slot, torch.ones_like(cav)),
        is_cav=_put(st.is_cav, slot, cav),
        v0=_put(st.v0, slot, new_v0),
        T=_put(st.T, slot, dp["T"]),
        a_max=_put(st.a_max, slot, dp["a_max"]),
        b_comf=_put(st.b_comf, slot, dp["b_comf"]),
        s0=_put(st.s0, slot, dp["s0"]),
        politeness=_put(st.politeness, slot, dp["politeness"]),
    )
    return st, count(ok)


# --------------------------------------------------------------------------
# one physics step
# --------------------------------------------------------------------------

def sim_step(
    st: SimState, cfg: SimConfig, sp: ScenarioParams
) -> tuple[SimState, SimMetrics]:
    """One dt step of ``cfg.scenario`` for every instance in the batch.
    Returns the new state and this step's ``[B]`` metric deltas."""
    scn = get_scenario(cfg.scenario)
    geom = scn.geometry(cfg)
    key, k_spawn = prng.split(st.key, 2).unbind(-2)
    st = st._replace(key=key)
    impl = cfg.neighbor_impl
    n_lanes_total = geom.n_lanes_total

    # 1. pre-move snapshot: ONE neighborhood construction serves the
    #    own-lane accel, both MOBIL candidates and the lateral rules
    tabs = build_tables(
        st.pos, st.lane, st.active, cfg.vehicle_len, n_lanes_total, impl
    )
    ctx = scn.snapshot_ctx(st, cfg, geom)
    own = tabs.query(st.lane)
    a_now = _own_accel(st, cfg, geom, scn, sp, st.lane, own, ctx)

    # 2. lane changes: discretionary MOBIL, then the scenario's mandatory moves
    new_lane, cooldown, n_lc = _apply_lane_changes(
        st, cfg, geom, scn, sp, a_now, own, tabs, ctx
    )
    new_lane, n_forced = scn.lateral_rules(st, cfg, geom, sp, tabs, new_lane)
    st = st._replace(lane=new_lane, cooldown=cooldown)

    # 3. post-change snapshot (second and last construction)
    nb = query_lanes(
        st.pos, st.lane, st.active, cfg.vehicle_len, st.lane, impl,
        n_lanes_total=n_lanes_total,
    )
    ctx2 = scn.snapshot_ctx(st, cfg, geom)
    accel = _own_accel(st, cfg, geom, scn, sp, st.lane, nb, ctx2)
    accel = torch.where(st.active, accel, 0.0)
    vel = (st.vel + accel * cfg.dt).clamp_min(0.0)
    pos = st.pos + vel * cfg.dt
    pos, vel = scn.boundary_clamp(st, cfg, geom, pos, vel)
    st = st._replace(pos=pos, vel=vel)

    # 4. collisions: follower overlapping the lead it followed this dt
    li2, hl2 = nb.lead_idx, nb.has_lead
    dgap = take(st.pos, li2) - st.pos
    if geom.ring:
        half = 0.5 * geom.road_len
        dgap = jmod(dgap + half, geom.road_len) - half
    lg2 = torch.where(hl2, dgap - cfg.vehicle_len, INF - cfg.vehicle_len)
    crashed = st.active & hl2 & (lg2 < 0.0)
    n_crash = count(crashed)

    # 5. exits (scenario predicate; a ring has none)
    exited = scn.boundary_exit(st, cfg, geom)
    n_out = count(exited)
    active = st.active & ~exited & ~crashed
    st = st._replace(active=active, pos=torch.where(active, st.pos, -INF))

    # 6. TTC (closing pairs only)
    dv = torch.where(hl2, st.vel - take(st.vel, li2), 0.0)
    ttc = torch.where(
        st.active & hl2 & (dv > 0.1), lg2.clamp_min(0.0) / dv, INF
    )
    min_ttc = ttc.amin(dim=-1)

    # 7. scenario congestion gauge
    n_blocked = scn.boundary_gauge(st, cfg, geom)

    # 8. demand
    st, n_spawn = _spawn(st, cfg, geom, scn, sp, k_spawn)
    st = st._replace(t=st.t + 1)

    # speed_sum accumulates in float64 and rounds once: the sum is then
    # exact, so it does not depend on how a backend splits the reduction
    # (which differs with the batch size, e.g. grouped vs switch dispatch)
    speed_sum = torch.where(st.active, st.vel, 0.0).sum(
        dim=-1, dtype=torch.float64).to(F32)
    delta = SimMetrics(
        throughput=n_out,
        spawned=n_spawn,
        speed_sum=speed_sum,
        speed_count=st.active.sum(dim=-1, dtype=F32),
        collisions=n_crash,
        merges_ok=n_forced,
        ramp_blocked_steps=n_blocked,
        lane_changes=n_lc,
        min_ttc=min_ttc,
        steps=torch.ones_like(n_out),
    )
    return st, delta


def _acc(m: SimMetrics, d: SimMetrics) -> SimMetrics:
    return SimMetrics(
        throughput=m.throughput + d.throughput,
        spawned=m.spawned + d.spawned,
        speed_sum=m.speed_sum + d.speed_sum,
        speed_count=m.speed_count + d.speed_count,
        collisions=m.collisions + d.collisions,
        merges_ok=m.merges_ok + d.merges_ok,
        ramp_blocked_steps=m.ramp_blocked_steps + d.ramp_blocked_steps,
        lane_changes=m.lane_changes + d.lane_changes,
        min_ttc=torch.minimum(m.min_ttc, d.min_ttc),
        steps=m.steps + d.steps,
    )


def select_rows(rows: torch.Tensor, new: NamedTuple, old: NamedTuple):
    """Per-instance ``where(rows, new, old)`` over every field of a state."""
    def pick(a, b):
        return torch.where(rows.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return type(old)(*(pick(a, b) for a, b in zip(new, old)))


# --------------------------------------------------------------------------
# rollouts
# --------------------------------------------------------------------------

def _step_live(st, metrics, sp, horizon, cfg):
    """One masked step: instances at or past their horizon keep their state
    and metrics. Also returns the unmasked post-step pair and ``live``."""
    live = st.t < horizon
    st2, d = sim_step(st, cfg, sp)
    m2 = _acc(metrics, d)
    return (select_rows(live, st2, st), select_rows(live, m2, metrics),
            st2, m2, live)


def rollout_chunk_rec(
    st: SimState,
    metrics: SimMetrics,
    sp: ScenarioParams,
    horizon: torch.Tensor,
    trace,
    cfg: SimConfig,
    n_steps: int,
    rec=None,
):
    """Advance the batch ``n_steps`` steps (one walltime slice); steps past
    an instance's ``horizon`` ``[B]`` are no-ops for it (state and metrics
    unchanged), exactly as the reference's masked scan.

    With a :class:`~repro_torch.core.record.RecordConfig` ``rec`` the
    rollout also fills ``trace`` (a ``TraceBuffer``); with ``rec=None``,
    ``trace`` rides through untouched. Returns ``(st, metrics, trace)``.

    When ``n_steps`` is a multiple of the stride, recording runs once per
    stride window (channels and writes after the window's last step, for
    the instances whose step counter moved in the window). This relies on
    live instances entering a chunk at a stride-aligned step, which every
    sweep path gives. Otherwise a per-step fallback records at the same
    rows, bit for bit. Recording never changes the physics.
    """
    from repro_torch.core.record import record_step  # no import cycle

    if rec is None:
        for _ in range(n_steps):
            st, metrics, *_ = _step_live(st, metrics, sp, horizon, cfg)
        return st, metrics, trace

    stride = rec.record_every
    if n_steps % stride == 0:
        for _ in range(n_steps // stride):
            t0 = st.t
            for _ in range(stride):
                st, metrics, *_ = _step_live(st, metrics, sp, horizon, cfg)
            # an instance frozen at its horizon for the whole window must
            # not re-emit its final row
            trace = record_step(trace, st, metrics, rec, st.t > t0)
        return st, metrics, trace

    for _ in range(n_steps):
        st, metrics, st2, m2, live = _step_live(st, metrics, sp, horizon, cfg)
        trace = record_step(trace, st2, m2, rec, live)
    return st, metrics, trace


def rollout_chunk(
    st: SimState,
    metrics: SimMetrics,
    sp: ScenarioParams,
    horizon: torch.Tensor,
    cfg: SimConfig,
    n_steps: int,
) -> tuple[SimState, SimMetrics]:
    """Recording-free chunk rollout (see :func:`rollout_chunk_rec`)."""
    st, metrics, _ = rollout_chunk_rec(st, metrics, sp, horizon, None, cfg,
                                       n_steps, None)
    return st, metrics


def rollout(key: torch.Tensor, cfg: SimConfig, sp: ScenarioParams,
            n_steps: int) -> SimMetrics:
    """Full episodes from fresh worlds, one per key row ``[B, 2]``."""
    st = init_state(cfg, key)
    b = key.shape[0]
    horizon = torch.full((b,), n_steps, dtype=I32, device=key.device)
    _, metrics = rollout_chunk(
        st, SimMetrics.zeros(b, key.device), sp, horizon, cfg, n_steps
    )
    return metrics
