"""The sweep simulator, plain: a frozen copy kept as the benchmark's reference.

IDM car following, MOBIL lane changing, the four scenarios' hooks, the
demand process and the trajectory recording, batched over instances: every
:class:`SimState` field carries a leading instance axis (``[B, N]``, ``[B]``
for the step counter, ``[B, 2]`` for the PRNG key). It is the program's
arithmetic written out once, in the same order, so that the program's
final states, metrics and trace rows can be held to it bit for bit.

Two things differ from the program on purpose:

- the neighbour search is the masked all-pairs scan (:func:`neighbor_info`),
  the definition the program's sort-and-search kernel must meet: lead =
  the lowest slot at the least positive gap ahead in the query lane,
  follower likewise behind, absent = ``(0, INF - veh_len, False)``;
- ``SimConfig.dtype`` sets the type of the state's floating fields. The
  default, float32, is what the configurations state; the benchmark's
  control runs the same code in bfloat16.

Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import prng

INF = 1e9
F32 = torch.float32
I32 = torch.int32


# --------------------------------------------------------------------------
# configuration and parameter draws
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SimConfig:
    """Static simulator configuration, one per roster entry."""

    n_slots: int = 64
    n_lanes: int = 3
    road_len: float = 1000.0
    merge_start: float = 600.0
    merge_end: float = 750.0
    scenario: str = "highway_merge"
    dt: float = 0.1
    vehicle_len: float = 4.5
    spawn_gap: float = 15.0
    b_safe: float = 4.0
    b_max: float = 8.0
    mobil_athr: float = 0.1
    lane_change_cooldown: int = 20
    merge_gap_front: float = 8.0
    merge_gap_rear: float = 10.0
    dtype: torch.dtype = F32


class ScenarioParams(NamedTuple):
    """Per-instance demand and driver-population draws (``[B]`` rows;
    ``lambda_main`` is ``[B, n_lanes]``)."""

    lambda_main: torch.Tensor
    lambda_ramp: torch.Tensor
    p_cav: torch.Tensor
    v0_mean: torch.Tensor
    v0_ramp: torch.Tensor
    seed: torch.Tensor
    aux0: torch.Tensor
    aux1: torch.Tensor


HUMAN = dict(T=1.5, a_max=1.4, b_comf=2.0, s0=2.0, politeness=0.3)
CAV = dict(T=0.9, a_max=2.0, b_comf=2.5, s0=1.5, politeness=0.5)


def driver_params(is_cav, jitter_key, n: int, dtype):
    """Per-vehicle IDM/MOBIL parameters ``[B, n]``: humans jittered by a
    uniform in [0.85, 1.15], CAVs standard."""
    jt = prng.uniform(jitter_key, (n,), 0.85, 1.15).to(dtype)

    def const(x: float) -> torch.Tensor:
        return torch.full_like(jt, x)

    def mix(h: float, c: float) -> torch.Tensor:
        base = torch.where(is_cav, const(c), const(h))
        return torch.where(is_cav, base, base * jt)

    return dict(
        T=mix(HUMAN["T"], CAV["T"]),
        a_max=mix(HUMAN["a_max"], CAV["a_max"]),
        b_comf=mix(HUMAN["b_comf"], CAV["b_comf"]),
        s0=mix(HUMAN["s0"], CAV["s0"]),
        politeness=torch.where(is_cav, const(CAV["politeness"]),
                               const(HUMAN["politeness"])),
    )


# --------------------------------------------------------------------------
# road geometry and shared physics
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class RoadGeometry:
    n_lanes: int
    road_len: float
    special_lane: str = "none"  # "none" | "ramp" | "drop"
    zone_start: float = 0.0
    zone_end: float = 0.0
    ring: bool = False

    @property
    def n_lanes_total(self) -> int:
        return self.n_lanes + (1 if self.special_lane == "ramp" else 0)


def col(x):
    return x[:, None]


def take(x, idx):
    return x.gather(1, idx.long())


def jmod(x, y):
    """Floored remainder (``jnp.mod``)."""
    r = torch.fmod(x, y)
    y_neg = (y < 0) if isinstance(y, torch.Tensor) else y < 0
    do_plus = (r != 0) & ((r < 0) != y_neg)
    return torch.where(do_plus, r + y, r)


def count(mask):
    return mask.sum(dim=-1, dtype=I32)


def idm_accel(v, dv, gap, v0, T, a_max, b_comf, s0):
    """IDM acceleration; ``dv`` is the closing speed."""
    gap = gap.clamp_min(0.1)
    s_star = s0 + (v * T + v * dv / (2.0 * torch.sqrt(a_max * b_comf))
                   ).clamp_min(0.0)
    r = v / v0.clamp_min(0.1)
    r2 = r * r
    g = s_star / gap
    return a_max * (1.0 - r2 * r2 - g * g)


def gap_acceptance(st, cfg, tabs, target_lane):
    _, lg, hl, _, fg, hf = tabs.query(target_lane)
    scale = torch.where(st.is_cav, torch.full_like(lg, 0.7),
                        torch.full_like(lg, 1.0))
    front_need = scale * cfg.merge_gap_front
    rear_need = scale * cfg.merge_gap_rear
    return ((torch.where(hl, lg, INF) > front_need)
            & (torch.where(hf, fg, INF) > rear_need))


def end_wall_mods(st, wall_pos, on_wall_lane, a):
    wall_gap = wall_pos - st.pos
    a_wall = idm_accel(st.vel, st.vel, wall_gap, st.v0, st.T, st.a_max,
                       st.b_comf, st.s0)
    return torch.where(on_wall_lane, torch.minimum(a, a_wall), a)


def end_wall_clamp(wall_pos, on_wall_lane, pos, vel):
    pos = torch.where(on_wall_lane, pos.clamp_max(wall_pos), pos)
    vel = torch.where(on_wall_lane & (pos >= wall_pos), 0.0, vel)
    return pos, vel


def end_wall_gauge(st, wall_pos, on_wall_lane):
    blocked = (st.active & on_wall_lane & (st.pos > wall_pos - 10.0)
               & (st.vel < 0.5))
    return count(blocked)


# --------------------------------------------------------------------------
# the four scenarios
# --------------------------------------------------------------------------

class Scenario:
    """A plain multi-lane pipe; the scenarios below override its hooks."""

    def geometry(self, cfg):
        return RoadGeometry(n_lanes=cfg.n_lanes, road_len=cfg.road_len)

    def snapshot_ctx(self, st, cfg, geom):
        return None

    def longitudinal_mods(self, st, cfg, geom, sp, query_lane, nb, a,
                          ctx=None):
        return a

    def mobil_eligible(self, st, cfg, geom):
        return st.lane < geom.n_lanes

    def mobil_candidate_ok(self, st, cfg, geom, cand_lane):
        return torch.ones_like(st.active)

    def lateral_rules(self, st, cfg, geom, sp, tabs, mobil_lane):
        return mobil_lane, torch.zeros(mobil_lane.shape[0], dtype=I32,
                                       device=mobil_lane.device)

    def boundary_spawn(self, cfg, geom, sp):
        lanes = torch.arange(geom.n_lanes, dtype=I32,
                             device=sp.v0_mean.device)
        base_v0 = col(sp.v0_mean).expand(-1, geom.n_lanes) * 1.0
        return sp.lambda_main, base_v0, lanes

    def boundary_clamp(self, st, cfg, geom, pos, vel):
        return pos, vel

    def boundary_exit(self, st, cfg, geom):
        return st.active & (st.pos > geom.road_len)

    def boundary_gauge(self, st, cfg, geom):
        return torch.zeros(st.pos.shape[0], dtype=I32, device=st.pos.device)


def _seed_draw(k):
    return prng.randint(k, (), 0, 2**31 - 1).to(torch.int64)


class HighwayMerge(Scenario):
    """3 lanes and an on-ramp (lane 3) that ends at the merge zone's end."""

    def geometry(self, cfg):
        return RoadGeometry(n_lanes=cfg.n_lanes, road_len=cfg.road_len,
                            special_lane="ramp", zone_start=cfg.merge_start,
                            zone_end=cfg.merge_end)

    def sample_params(self, key, cfg):
        k1, k2, k3, k4, k5 = prng.split(key, 5).unbind(-2)
        lambda_main = prng.uniform(k1, (cfg.n_lanes,), 0.15, 0.55)
        lambda_ramp = prng.uniform(k2, (), 0.05, 0.30)
        p_cav = prng.uniform(k3, (), 0.0, 1.0)
        v0_mean = prng.uniform(k4, (), 26.0, 33.0)
        v0_ramp = v0_mean * 0.7
        seed = _seed_draw(k5)
        z = torch.zeros_like(p_cav)
        return ScenarioParams(lambda_main, lambda_ramp, p_cav, v0_mean,
                              v0_ramp, seed, z, z)

    def longitudinal_mods(self, st, cfg, geom, sp, query_lane, nb, a,
                          ctx=None):
        return end_wall_mods(st, geom.zone_end, query_lane == geom.n_lanes, a)

    def lateral_rules(self, st, cfg, geom, sp, tabs, mobil_lane):
        on_ramp = (st.lane == geom.n_lanes) & st.active
        in_zone = (st.pos >= geom.zone_start) & (st.pos <= geom.zone_end)
        gap_ok = gap_acceptance(st, cfg, tabs, torch.zeros_like(st.lane))
        merge = on_ramp & in_zone & gap_ok
        return torch.where(merge, 0, mobil_lane), count(merge)

    def boundary_spawn(self, cfg, geom, sp):
        lanes = torch.arange(geom.n_lanes + 1, dtype=I32,
                             device=sp.v0_mean.device)
        lam = torch.cat([sp.lambda_main, col(sp.lambda_ramp)], dim=1)
        base_v0 = torch.where(lanes == geom.n_lanes, col(sp.v0_ramp),
                              col(sp.v0_mean))
        return lam, base_v0, lanes

    def boundary_clamp(self, st, cfg, geom, pos, vel):
        return end_wall_clamp(geom.zone_end, st.lane == geom.n_lanes, pos, vel)

    def boundary_gauge(self, st, cfg, geom):
        return end_wall_gauge(st, geom.zone_end, st.lane == geom.n_lanes)


DROP_LANE = 0
TARGET_LANE = 1


class LaneDrop(Scenario):
    """3 lanes; lane 0 ends at the zone's end and must merge into lane 1."""

    def geometry(self, cfg):
        if cfg.n_lanes < 2:
            raise ValueError("lane_drop needs n_lanes >= 2")
        return RoadGeometry(n_lanes=cfg.n_lanes, road_len=cfg.road_len,
                            special_lane="drop", zone_start=cfg.merge_start,
                            zone_end=cfg.merge_end)

    def sample_params(self, key, cfg):
        k1, k2, k3, k4 = prng.split(key, 4).unbind(-2)
        lambda_main = prng.uniform(k1, (cfg.n_lanes,), 0.25, 0.65)
        p_cav = prng.uniform(k2, (), 0.0, 1.0)
        v0_mean = prng.uniform(k3, (), 26.0, 33.0)
        seed = _seed_draw(k4)
        z = torch.zeros_like(p_cav)
        return ScenarioParams(lambda_main, z, p_cav, v0_mean, v0_mean, seed,
                              z, z)

    def longitudinal_mods(self, st, cfg, geom, sp, query_lane, nb, a,
                          ctx=None):
        return end_wall_mods(st, geom.zone_end, query_lane == DROP_LANE, a)

    def mobil_candidate_ok(self, st, cfg, geom, cand_lane):
        into_closing = ((cand_lane == DROP_LANE) & (st.lane != DROP_LANE)
                        & (st.pos >= geom.zone_start))
        return ~into_closing

    def lateral_rules(self, st, cfg, geom, sp, tabs, mobil_lane):
        must_merge = (st.lane == DROP_LANE) & st.active
        in_zone = (st.pos >= geom.zone_start) & (st.pos <= geom.zone_end)
        target = torch.full_like(st.lane, TARGET_LANE)
        merge = must_merge & in_zone & gap_acceptance(st, cfg, tabs, target)
        return torch.where(merge, TARGET_LANE, mobil_lane), count(merge)

    def boundary_clamp(self, st, cfg, geom, pos, vel):
        return end_wall_clamp(geom.zone_end, st.lane == DROP_LANE, pos, vel)

    def boundary_gauge(self, st, cfg, geom):
        return end_wall_gauge(st, geom.zone_end, st.lane == DROP_LANE)


PERTURB_SECONDS = 5.0
BAND = (0.45, 0.55)
SEAM_FRAC = 0.10


class StopAndGo(Scenario):
    """A ring road with a periodic braking pulse in a band."""

    def geometry(self, cfg):
        ring_len = min(cfg.road_len, max(cfg.n_slots, 8) * 30.0 / cfg.n_lanes)
        return RoadGeometry(n_lanes=cfg.n_lanes, road_len=ring_len, ring=True)

    def sample_params(self, key, cfg):
        k1, k2, k3, k4, k5, k6 = prng.split(key, 6).unbind(-2)
        lambda_main = prng.uniform(k1, (cfg.n_lanes,), 0.25, 0.70)
        p_cav = prng.uniform(k2, (), 0.0, 1.0)
        v0_mean = prng.uniform(k3, (), 26.0, 33.0)
        seed = _seed_draw(k4)
        brake = prng.uniform(k5, (), 2.0, 5.0)
        period = prng.uniform(k6, (), 20.0, 45.0)
        z = torch.zeros_like(p_cav)
        return ScenarioParams(lambda_main, z, p_cav, v0_mean, v0_mean, seed,
                              brake, period)

    def mobil_eligible(self, st, cfg, geom):
        away_from_seam = ((st.pos > SEAM_FRAC * geom.road_len)
                          & (st.pos < (1.0 - SEAM_FRAC) * geom.road_len))
        return (st.lane < geom.n_lanes) & away_from_seam

    def snapshot_ctx(self, st, cfg, geom):
        lanes = torch.arange(geom.n_lanes, dtype=st.lane.dtype,
                             device=st.lane.device)
        in_lane = (st.active[:, None, :]
                   & (st.lane[:, None, :] == lanes[None, :, None]))
        keyed = torch.where(in_lane, st.pos[:, None, :], INF)
        rear_slot = keyed.argmin(dim=-1)
        rear_pos = keyed.amin(dim=-1)
        return rear_pos, st.vel.gather(1, rear_slot)

    def longitudinal_mods(self, st, cfg, geom, sp, query_lane, nb, a,
                          ctx=None):
        rear_pos, rear_vel = (ctx if ctx is not None
                              else self.snapshot_ctx(st, cfg, geom))
        q = query_lane.clamp(0, geom.n_lanes - 1).long()
        rp = rear_pos.gather(1, q)
        wrap_gap = rp + geom.road_len - st.pos - cfg.vehicle_len
        wrap_dv = st.vel - rear_vel.gather(1, q)
        a_wrap = idm_accel(st.vel, wrap_dv, wrap_gap, st.v0, st.T, st.a_max,
                           st.b_comf, st.s0)
        use_wrap = ~nb.has_lead & (rp < INF * 0.5)
        a = torch.where(use_wrap, torch.minimum(a, a_wrap), a)
        period = col(sp.aux1.clamp_min(1.0))
        phase = jmod(col(st.t.to(st.pos.dtype)) * cfg.dt, period)
        pulsing = phase < PERTURB_SECONDS
        in_band = ((st.pos >= BAND[0] * geom.road_len)
                   & (st.pos <= BAND[1] * geom.road_len))
        return torch.where(pulsing & in_band, torch.minimum(a, col(-sp.aux0)),
                           a)

    def boundary_clamp(self, st, cfg, geom, pos, vel):
        return torch.where(st.active, jmod(pos, geom.road_len), pos), vel

    def boundary_exit(self, st, cfg, geom):
        return torch.zeros_like(st.active)

    def boundary_gauge(self, st, cfg, geom):
        return count(st.active & (st.vel < 2.0))


class SpeedLimitZone(Scenario):
    """3 lanes with a drawn speed limit inside the zone."""

    def geometry(self, cfg):
        return RoadGeometry(n_lanes=cfg.n_lanes, road_len=cfg.road_len,
                            zone_start=cfg.merge_start, zone_end=cfg.merge_end)

    def sample_params(self, key, cfg):
        k1, k2, k3, k4, k5 = prng.split(key, 5).unbind(-2)
        lambda_main = prng.uniform(k1, (cfg.n_lanes,), 0.15, 0.55)
        p_cav = prng.uniform(k2, (), 0.0, 1.0)
        v0_mean = prng.uniform(k3, (), 26.0, 33.0)
        seed = _seed_draw(k4)
        limit = prng.uniform(k5, (), 10.0, 18.0)
        z = torch.zeros_like(p_cav)
        return ScenarioParams(lambda_main, z, p_cav, v0_mean, v0_mean, seed,
                              limit, z)

    def longitudinal_mods(self, st, cfg, geom, sp, query_lane, nb, a,
                          ctx=None):
        limit = col(sp.aux0.clamp_min(0.1))
        in_zone = (st.pos >= geom.zone_start) & (st.pos <= geom.zone_end)
        r = st.vel / limit
        r2 = r * r
        a_limit = st.a_max * (1.0 - r2 * r2)
        a = torch.where(in_zone, torch.minimum(a, a_limit), a)
        before = st.pos < geom.zone_start
        ent_gap = geom.zone_start - st.pos
        a_approach = idm_accel(st.vel, st.vel - limit, ent_gap, st.v0, st.T,
                               st.a_max, st.b_comf, st.s0)
        return torch.where(before & (st.vel > limit),
                           torch.minimum(a, a_approach), a)

    def boundary_gauge(self, st, cfg, geom):
        in_zone = (st.active & (st.pos >= geom.zone_start)
                   & (st.pos <= geom.zone_end))
        return count(in_zone)


SCENARIOS = {
    "highway_merge": HighwayMerge(),
    "lane_drop": LaneDrop(),
    "stop_and_go": StopAndGo(),
    "speed_limit_zone": SpeedLimitZone(),
}


# --------------------------------------------------------------------------
# state, neighbours
# --------------------------------------------------------------------------

class SimState(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    lane: torch.Tensor
    active: torch.Tensor
    is_cav: torch.Tensor
    v0: torch.Tensor
    T: torch.Tensor
    a_max: torch.Tensor
    b_comf: torch.Tensor
    s0: torch.Tensor
    politeness: torch.Tensor
    cooldown: torch.Tensor
    key: torch.Tensor
    t: torch.Tensor


class SimMetrics(NamedTuple):
    throughput: torch.Tensor
    spawned: torch.Tensor
    speed_sum: torch.Tensor
    speed_count: torch.Tensor
    collisions: torch.Tensor
    merges_ok: torch.Tensor
    ramp_blocked_steps: torch.Tensor
    lane_changes: torch.Tensor
    min_ttc: torch.Tensor
    steps: torch.Tensor

    @staticmethod
    def zeros(b: int, device) -> "SimMetrics":
        z_i = torch.zeros(b, dtype=I32, device=device)
        z_f = torch.zeros(b, dtype=F32, device=device)
        return SimMetrics(z_i, z_i, z_f, z_f, z_i, z_i, z_i, z_i,
                          torch.full((b,), INF, dtype=F32, device=device), z_i)


def init_state(cfg: SimConfig, key) -> SimState:
    """Empty worlds, one per key row: every slot inactive at ``-INF`` m,
    drivers at the population means, ``t = 0``."""
    b, n = key.shape[0], cfg.n_slots
    dev = key.device
    zf = torch.zeros((b, n), dtype=cfg.dtype, device=dev)
    zi = torch.zeros((b, n), dtype=I32, device=dev)
    zb = torch.zeros((b, n), dtype=torch.bool, device=dev)
    return SimState(
        pos=zf - INF, vel=zf, lane=zi, active=zb, is_cav=zb,
        v0=zf + 30.0, T=zf + 1.5, a_max=zf + 1.4, b_comf=zf + 2.0,
        s0=zf + 2.0, politeness=zf + 0.3, cooldown=zi,
        key=key, t=torch.zeros(b, dtype=I32, device=dev),
    )


class Neighbors(NamedTuple):
    lead_idx: torch.Tensor
    lead_gap: torch.Tensor
    has_lead: torch.Tensor
    foll_idx: torch.Tensor
    foll_gap: torch.Tensor
    has_foll: torch.Tensor


def neighbor_info(pos, lane, active, veh_len, query_lane) -> Neighbors:
    """Lead and follower of every vehicle in ``query_lane[b, i]``, by the
    masked all-pairs scan: strictly ahead / behind, lowest slot on ties."""
    n = pos.shape[-1]
    dpos = pos[:, None, :] - pos[:, :, None]          # [b, i, j] = pos_j - pos_i
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    pair_ok = ((lane[:, None, :] == query_lane[:, :, None])
               & active[:, None, :] & active[:, :, None] & ~eye)
    ahead = pair_ok & (dpos > 0.0)
    behind = pair_ok & (dpos < 0.0)
    inf = torch.tensor(INF, dtype=pos.dtype, device=pos.device)
    lead_d = torch.where(ahead, dpos, inf)
    foll_d = torch.where(behind, -dpos, inf)
    return Neighbors(
        lead_d.argmin(dim=-1).to(I32), lead_d.amin(dim=-1) - veh_len,
        ahead.any(dim=-1),
        foll_d.argmin(dim=-1).to(I32), foll_d.amin(dim=-1) - veh_len,
        behind.any(dim=-1),
    )


class NeighborTables(NamedTuple):
    """Per-lane tables ``[B, L, N]``, lane-major."""

    lead_idx: torch.Tensor
    lead_gap: torch.Tensor
    has_lead: torch.Tensor
    foll_idx: torch.Tensor
    foll_gap: torch.Tensor
    has_foll: torch.Tensor

    def query(self, query_lane) -> Neighbors:
        idx = query_lane.long().clamp(0, self.lead_idx.shape[1] - 1).unsqueeze(1)
        return Neighbors(*(t.gather(1, idx).squeeze(1) for t in self))


def build_tables(pos, lane, active, veh_len, n_lanes_total) -> NeighborTables:
    per_lane = [neighbor_info(pos, lane, active, veh_len,
                              torch.full_like(lane, l))
                for l in range(n_lanes_total)]
    return NeighborTables(*(torch.stack(f, dim=1) for f in zip(*per_lane)))


# --------------------------------------------------------------------------
# one step
# --------------------------------------------------------------------------

def _own_accel(st, cfg, geom, scn, sp, query_lane, nb, ctx=None):
    v_lead = torch.where(nb.has_lead, take(st.vel, nb.lead_idx), 0.0)
    gap = torch.where(nb.has_lead, nb.lead_gap, INF)
    dv = torch.where(nb.has_lead, st.vel - v_lead, 0.0)
    a = idm_accel(st.vel, dv, gap, st.v0, st.T, st.a_max, st.b_comf, st.s0)
    a = scn.longitudinal_mods(st, cfg, geom, sp, query_lane, nb, a, ctx)
    return torch.minimum(a.clamp_min(-cfg.b_max), st.a_max)


def _mobil_candidate(st, cfg, geom, scn, sp, a_now, own, tabs, cand_lane,
                     ctx=None):
    nb = tabs.query(cand_lane)
    li, lg, hl, fi, fg, hf = nb
    a_new = _own_accel(st, cfg, geom, scn, sp, cand_lane, nb, ctx)

    a_j_before = torch.where(hf, take(a_now, fi), 0.0)
    gap_j_after = torch.where(hf, fg, INF)
    v_j = take(st.vel, fi)
    a_j_after = idm_accel(v_j, v_j - st.vel, gap_j_after, take(st.v0, fi),
                          take(st.T, fi), take(st.a_max, fi),
                          take(st.b_comf, fi), take(st.s0, fi))
    a_j_after = torch.where(hf, a_j_after, 0.0)

    ki, hk = own.foll_idx, own.has_foll
    lead_pos = torch.where(own.has_lead, take(st.pos, own.lead_idx), INF)
    lead_vel = torch.where(own.has_lead, take(st.vel, own.lead_idx), 0.0)
    gap_k_after = lead_pos - take(st.pos, ki) - cfg.vehicle_len
    a_k_before = torch.where(hk, take(a_now, ki), 0.0)
    v_k = take(st.vel, ki)
    a_k_after = idm_accel(v_k, v_k - lead_vel, gap_k_after, take(st.v0, ki),
                          take(st.T, ki), take(st.a_max, ki),
                          take(st.b_comf, ki), take(st.s0, ki))
    a_k_after = torch.where(hk, a_k_after, 0.0)

    incentive = (a_new - a_now) + st.politeness * (
        (a_j_after - a_j_before) + (a_k_after - a_k_before))
    safe = ((a_j_after >= -cfg.b_safe) & (torch.where(hf, fg, INF) > 0.0)
            & (torch.where(hl, lg, INF) > 0.0))
    return incentive, safe


def _apply_lane_changes(st, cfg, geom, scn, sp, a_now, own, tabs, ctx=None):
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
    cooldown = torch.where(changed, cfg.lane_change_cooldown,
                           (st.cooldown - 1).clamp_min(0))
    return new_lane, cooldown, count(changed)


def _put(arr, slot, val):
    """Row-wise ``arr[b, slot[b, l]] = val[b, l]``; ``slot == N`` drops."""
    b, n = arr.shape
    buf = torch.cat([arr, arr.new_zeros((b, 1))], dim=1)
    buf.scatter_(1, slot, val.to(arr.dtype).expand(b, -1))
    return buf[:, :n]


def _spawn(st, cfg, geom, scn, sp, key):
    n = st.pos.shape[1]
    lam, base_v0, lanes = scn.boundary_spawn(cfg, geom, sp)
    n_spawn_lanes = lanes.shape[0]
    ku, kj = prng.split(key, 2).unbind(-2)
    u = prng.uniform(ku, (3, n_spawn_lanes)).to(cfg.dtype)

    arrive = u[:, 0] < lam * cfg.dt
    in_lane = st.active[:, None, :] & (st.lane[:, None, :] == lanes[None, :, None])
    nearest = torch.where(in_lane, st.pos[:, None, :], INF).amin(dim=-1)
    clear = nearest > cfg.spawn_gap
    if geom.ring:
        rear = torch.where(in_lane, st.pos[:, None, :], -INF).amax(dim=-1)
        clear = clear & ((geom.road_len - rear) > 3.0 * cfg.spawn_gap)

    free = ~st.active
    n_free = count(free)[:, None]
    want = arrive & clear
    want_i = want.to(I32)
    rank = torch.cumsum(want_i, dim=1, dtype=I32) - want_i
    ok = want & (rank < n_free)
    free_slots = torch.argsort((~free).to(I32), dim=1, stable=True)
    claim = free_slots.gather(1, rank.clamp_max(n - 1).long())
    slot = torch.where(ok, claim, n)

    cav = u[:, 1] < col(sp.p_cav)
    new_v0 = base_v0 * (0.9 + 0.2 * u[:, 2])
    dp = driver_params(cav, kj, n_spawn_lanes, cfg.dtype)
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


def sim_step(st: SimState, cfg: SimConfig, sp: ScenarioParams):
    """One ``dt`` step of ``cfg.scenario`` for every instance; returns the
    new state and this step's ``[B]`` metric deltas."""
    scn = SCENARIOS[cfg.scenario]
    geom = scn.geometry(cfg)
    key, k_spawn = prng.split(st.key, 2).unbind(-2)
    st = st._replace(key=key)

    # 1. tables on the pre-move snapshot
    tabs = build_tables(st.pos, st.lane, st.active, cfg.vehicle_len,
                        geom.n_lanes_total)
    ctx = scn.snapshot_ctx(st, cfg, geom)
    own = tabs.query(st.lane)
    a_now = _own_accel(st, cfg, geom, scn, sp, st.lane, own, ctx)

    # 2. MOBIL, then the scenario's mandatory moves
    new_lane, cooldown, n_lc = _apply_lane_changes(st, cfg, geom, scn, sp,
                                                   a_now, own, tabs, ctx)
    new_lane, n_forced = scn.lateral_rules(st, cfg, geom, sp, tabs, new_lane)
    st = st._replace(lane=new_lane, cooldown=cooldown)

    # 3. the post-change snapshot; integrate
    nb = neighbor_info(st.pos, st.lane, st.active, cfg.vehicle_len, st.lane)
    ctx2 = scn.snapshot_ctx(st, cfg, geom)
    accel = _own_accel(st, cfg, geom, scn, sp, st.lane, nb, ctx2)
    accel = torch.where(st.active, accel, 0.0)
    vel = (st.vel + accel * cfg.dt).clamp_min(0.0)
    pos = st.pos + vel * cfg.dt
    pos, vel = scn.boundary_clamp(st, cfg, geom, pos, vel)
    st = st._replace(pos=pos, vel=vel)

    # 4. collisions with the lead followed this dt
    li2, hl2 = nb.lead_idx, nb.has_lead
    dgap = take(st.pos, li2) - st.pos
    if geom.ring:
        half = 0.5 * geom.road_len
        dgap = jmod(dgap + half, geom.road_len) - half
    lg2 = torch.where(hl2, dgap - cfg.vehicle_len, INF - cfg.vehicle_len)
    crashed = st.active & hl2 & (lg2 < 0.0)
    n_crash = count(crashed)

    # 5. exits
    exited = scn.boundary_exit(st, cfg, geom)
    n_out = count(exited)
    active = st.active & ~exited & ~crashed
    st = st._replace(active=active, pos=torch.where(active, st.pos, -INF))

    # 6. time to collision of closing pairs
    dv = torch.where(hl2, st.vel - take(st.vel, li2), 0.0)
    ttc = torch.where(st.active & hl2 & (dv > 0.1), lg2.clamp_min(0.0) / dv,
                      INF)
    min_ttc = ttc.amin(dim=-1)

    # 7. congestion gauge, 8. demand
    n_blocked = scn.boundary_gauge(st, cfg, geom)
    st, n_spawn = _spawn(st, cfg, geom, scn, sp, k_spawn)
    st = st._replace(t=st.t + 1)

    speed_sum = torch.where(st.active, st.vel, 0.0).sum(
        dim=-1, dtype=torch.float64).to(F32)
    delta = SimMetrics(
        throughput=n_out, spawned=n_spawn, speed_sum=speed_sum,
        speed_count=st.active.sum(dim=-1, dtype=F32), collisions=n_crash,
        merges_ok=n_forced, ramp_blocked_steps=n_blocked, lane_changes=n_lc,
        min_ttc=min_ttc, steps=torch.ones_like(n_out),
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


def select_rows(rows, new, old):
    """Per-instance ``where(rows, new, old)`` over every field."""
    def pick(a, b):
        return torch.where(rows.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return type(old)(*(pick(a, b) for a, b in zip(new, old)))


# --------------------------------------------------------------------------
# recording
# --------------------------------------------------------------------------

def _mean_speed(st, m):
    total = torch.where(st.active, st.vel, 0.0).sum(-1, dtype=torch.float64)
    return total.to(F32) / st.active.sum(-1, dtype=F32).clamp_min(1.0)


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


@dataclass(frozen=True)
class RecordConfig:
    """Channels ``fields`` and the first ``k_slots`` slots' (lane, speed,
    active), every ``record_every`` steps: row ``r`` is the snapshot after
    step ``(r + 1) * record_every``."""

    record_every: int
    fields: tuple[str, ...]
    k_slots: int


class TraceBuffer(NamedTuple):
    series: torch.Tensor  # [B, R, F] f32
    lane: torch.Tensor    # [B, R, K] i32
    speed: torch.Tensor   # [B, R, K] f32
    active: torch.Tensor  # [B, R, K] bool


def trace_zeros(rec: RecordConfig, steps: int, b: int, device) -> TraceBuffer:
    r, k = steps // rec.record_every, rec.k_slots
    return TraceBuffer(
        series=torch.zeros((b, r, len(rec.fields)), dtype=F32, device=device),
        lane=torch.zeros((b, r, k), dtype=I32, device=device),
        speed=torch.zeros((b, r, k), dtype=F32, device=device),
        active=torch.zeros((b, r, k), dtype=torch.bool, device=device),
    )


def record_step(tr: TraceBuffer, st, m, rec: RecordConfig, emit):
    """Write each emitting instance's row ``t // record_every - 1`` when its
    step counter sits on the stride; every other row keeps its bits."""
    n_rows = tr.series.shape[1]
    t1 = st.t
    idx = torch.div(t1, rec.record_every, rounding_mode="floor") - 1
    emit = emit & (t1 % rec.record_every == 0) & (idx >= 0) & (idx < n_rows)
    hit = ((torch.arange(n_rows, device=t1.device)[None, :] == idx[:, None])
           & emit[:, None])[:, :, None]
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


def rollout(st, metrics, sp, horizon, trace, cfg, rec, n_steps: int):
    """``n_steps`` masked steps (a step at or past an instance's horizon
    leaves it untouched), recording after every step that moved it."""
    for _ in range(n_steps):
        live = st.t < horizon
        st2, d = sim_step(st, cfg, sp)
        m2 = _acc(metrics, d)
        if rec is not None:
            trace = record_step(trace, st2, m2, rec, live)
        st = select_rows(live, st2, st)
        metrics = select_rows(live, m2, metrics)
    return st, metrics, trace
