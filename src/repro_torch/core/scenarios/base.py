"""The Scenario API (batched): geometry, parameter sampling and three hook groups.

Port of ``repro/core/scenarios/base.py``. The hooks take a batched
``SimState`` (fields ``[B, N]``) and batched ``ScenarioParams`` (``[B]``
rows); geometry stays a static, hashable description.

``longitudinal_mods(st, cfg, geom, sp, query_lane, nb, a, ctx) -> a``
    Extra acceleration constraints before the ``[-b_max, a_max]`` clamp.
``mobil_eligible`` / ``mobil_candidate_ok`` / ``lateral_rules``
    Which vehicles may change lanes, vetoes of illegal targets, and the
    scenario's mandatory moves after MOBIL.
``boundary_spawn`` / ``boundary_clamp`` / ``boundary_exit`` / ``boundary_gauge``
    The demand process, post-integration position rules, the exit
    predicate and the per-step congestion gauge.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import prng
from repro_torch.core.scenario import ScenarioParams, SimConfig

INF = 1e9


@dataclass(frozen=True)
class RoadGeometry:
    """Static road description a scenario derives from ``SimConfig``."""

    n_lanes: int               # main lanes, indices [0, n_lanes)
    road_len: float
    special_lane: str = "none"  # "none" | "ramp" (extra lane n_lanes) |
    #                             "drop" (main lane 0 terminates at zone_end)
    zone_start: float = 0.0    # scenario zone extent
    zone_end: float = 0.0
    ring: bool = False         # closed road: positions wrap mod road_len

    @property
    def n_lanes_total(self) -> int:
        """Lane-table size: main lanes plus the ramp lane if present."""
        return self.n_lanes + (1 if self.special_lane == "ramp" else 0)


def col(x: torch.Tensor) -> torch.Tensor:
    """A per-instance ``[B]`` value as a ``[B, 1]`` column for ``[B, N]`` math."""
    return x[:, None]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row gather ``x[b, idx[b, i]]`` (the reference's ``x[idx]``)."""
    return x.gather(1, idx.long())


def jmod(x: torch.Tensor, y) -> torch.Tensor:
    """``jnp.mod``: truncated remainder, plus the divisor where the signs
    differ (``jax.numpy.remainder``)."""
    r = torch.fmod(x, y)
    y_neg = (y < 0) if isinstance(y, torch.Tensor) else y < 0
    do_plus = (r != 0) & ((r < 0) != y_neg)
    return torch.where(do_plus, r + y, r)


def gap_acceptance(st, cfg: SimConfig, tabs, target_lane):
    """Per-vehicle mask: are the lead AND follower gaps in ``target_lane``
    acceptable for a mandatory merge? CAVs accept 0.7× gaps."""
    _, lg, hl, _, fg, hf = tabs.query(target_lane)
    scale = torch.where(st.is_cav, torch.full_like(lg, 0.7),
                        torch.full_like(lg, 1.0))
    front_need = scale * cfg.merge_gap_front
    rear_need = scale * cfg.merge_gap_rear
    return (
        (torch.where(hl, lg, INF) > front_need)
        & (torch.where(hf, fg, INF) > rear_need)
    )


def idm_accel(v, dv, gap, v0, T, a_max, b_comf, s0):
    """IDM acceleration. ``dv`` is the closing speed (v_self - v_lead).

    The reference's ``x ** 4`` and ``x ** 2`` are XLA ``integer_pow``
    (repeated squaring), written out here as products.
    """
    gap = gap.clamp_min(0.1)
    s_star = s0 + (v * T + v * dv / (2.0 * torch.sqrt(a_max * b_comf))
                   ).clamp_min(0.0)
    r = v / v0.clamp_min(0.1)
    r2 = r * r
    g = s_star / gap
    return a_max * (1.0 - r2 * r2 - g * g)


def end_wall_mods(st, wall_pos, on_wall_lane, a):
    """Brake ``on_wall_lane`` vehicles against a standing wall at
    ``wall_pos`` (layered onto the base accel via min)."""
    wall_gap = wall_pos - st.pos
    a_wall = idm_accel(
        st.vel, st.vel, wall_gap, st.v0, st.T, st.a_max, st.b_comf, st.s0
    )
    return torch.where(on_wall_lane, torch.minimum(a, a_wall), a)


def end_wall_clamp(wall_pos, on_wall_lane, pos, vel):
    """Hard dead end: cannot drive past the wall; speed zeroes there."""
    pos = torch.where(on_wall_lane, pos.clamp_max(wall_pos), pos)
    vel = torch.where(on_wall_lane & (pos >= wall_pos), 0.0, vel)
    return pos, vel


def count(mask: torch.Tensor) -> torch.Tensor:
    """Per-instance count of a ``[B, N]`` mask as ``[B]`` int32."""
    return mask.sum(dim=-1, dtype=torch.int32)


def end_wall_gauge(st, wall_pos, on_wall_lane):
    """Vehicle-steps stopped within 10 m of the wall (starvation gauge)."""
    blocked = (
        st.active & on_wall_lane
        & (st.pos > wall_pos - 10.0) & (st.vel < 0.5)
    )
    return count(blocked)


class Scenario:
    """Base scenario: a plain multi-lane pipe with default everything."""

    #: registry name (subclasses must set)
    name: str = "base"
    #: generic-metric-field → scenario-meaning renames for records/summaries
    metric_aliases: dict[str, str] = {}

    # ---------------- geometry + parameters ----------------

    def geometry(self, cfg: SimConfig) -> RoadGeometry:
        return RoadGeometry(n_lanes=cfg.n_lanes, road_len=cfg.road_len)

    def sample_params(self, key: torch.Tensor, cfg: SimConfig) -> ScenarioParams:
        """Draw a batch of instances' parameters (``key`` is ``[B, 2]``)."""
        k1, k2, k3, k4 = prng.split(key, 4).unbind(-2)
        z = torch.zeros(key.shape[:-1], dtype=torch.float32, device=key.device)
        lambda_main = prng.uniform(k1, (cfg.n_lanes,), 0.15, 0.55)
        p_cav = prng.uniform(k2, (), 0.0, 1.0)
        v0_mean = prng.uniform(k3, (), 26.0, 33.0)
        seed = prng.randint(k4, (), 0, 2**31 - 1).to(torch.int64)
        return ScenarioParams(
            lambda_main=lambda_main, lambda_ramp=z, p_cav=p_cav,
            v0_mean=v0_mean, v0_ramp=v0_mean, seed=seed, aux0=z, aux1=z,
        )

    # ---------------- hook 1: longitudinal_mods ----------------

    def snapshot_ctx(self, st, cfg: SimConfig, geom: RoadGeometry):
        """Optional scenario state computed once per neighborhood snapshot
        and passed to every ``longitudinal_mods`` call on it."""
        return None

    def longitudinal_mods(self, st, cfg: SimConfig, geom: RoadGeometry,
                          sp: ScenarioParams, query_lane, nb, a, ctx=None):
        """Extra accel constraints (pre-clamp)."""
        return a

    # ---------------- hook 2: lateral_rules ----------------

    def mobil_eligible(self, st, cfg: SimConfig, geom: RoadGeometry):
        """Vehicles allowed discretionary MOBIL changes."""
        return st.lane < geom.n_lanes

    def mobil_candidate_ok(self, st, cfg: SimConfig, geom: RoadGeometry,
                           cand_lane):
        """May MOBIL move vehicle i into ``cand_lane[b, i]``?"""
        return torch.ones_like(st.active)

    def lateral_rules(self, st, cfg: SimConfig, geom: RoadGeometry,
                      sp: ScenarioParams, tabs, mobil_lane):
        """Mandatory scenario moves after MOBIL → (lane, ``[B]`` move count)."""
        return mobil_lane, torch.zeros(
            mobil_lane.shape[0], dtype=torch.int32, device=mobil_lane.device)

    # ---------------- hook 3: boundary ----------------

    def boundary_spawn(self, cfg: SimConfig, geom: RoadGeometry,
                       sp: ScenarioParams):
        """Demand process: (rate ``[B, L]``, base desired speed ``[B, L]``,
        lane ids ``[L]`` i32) per spawn lane."""
        lanes = torch.arange(geom.n_lanes, dtype=torch.int32,
                             device=sp.v0_mean.device)
        base_v0 = col(sp.v0_mean).expand(-1, geom.n_lanes) * 1.0
        return sp.lambda_main, base_v0, lanes

    def boundary_clamp(self, st, cfg: SimConfig, geom: RoadGeometry,
                       pos, vel):
        """Post-integration position/velocity rules (walls, ring wrap)."""
        return pos, vel

    def boundary_exit(self, st, cfg: SimConfig, geom: RoadGeometry):
        """Exit predicate on the post-integration state."""
        return st.active & (st.pos > geom.road_len)

    def boundary_gauge(self, st, cfg: SimConfig, geom: RoadGeometry):
        """Scenario congestion gauge ``[B]`` i32 (vehicle-steps this step)."""
        return torch.zeros(st.pos.shape[0], dtype=torch.int32,
                           device=st.pos.device)
