"""Work-zone speed limit on a straight pipe — throughput under a slow zone.

Port of ``repro/core/scenarios/speed_limit_zone.py``. Inside the zone,
acceleration is capped by IDM's free-road term toward the limit ``aux0``;
upstream, vehicles follow a virtual leader at the zone entrance moving at
the limit. The gauge counts vehicles inside the zone (→ ``zone_veh_steps``).
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.scenario import ScenarioParams, SimConfig
from repro_torch.core.scenarios.base import (
    RoadGeometry,
    Scenario,
    col,
    count,
    idm_accel,
)


class SpeedLimitZone(Scenario):
    name = "speed_limit_zone"
    metric_aliases = {"ramp_blocked_steps": "zone_veh_steps"}

    def geometry(self, cfg: SimConfig) -> RoadGeometry:
        return RoadGeometry(
            n_lanes=cfg.n_lanes,
            road_len=cfg.road_len,
            zone_start=cfg.merge_start,
            zone_end=cfg.merge_end,
        )

    def sample_params(self, key: torch.Tensor, cfg: SimConfig) -> ScenarioParams:
        k1, k2, k3, k4, k5 = prng.split(key, 5).unbind(-2)
        lambda_main = prng.uniform(k1, (cfg.n_lanes,), 0.15, 0.55)
        p_cav = prng.uniform(k2, (), 0.0, 1.0)
        v0_mean = prng.uniform(k3, (), 26.0, 33.0)
        seed = prng.randint(k4, (), 0, 2**31 - 1).to(torch.int64)
        limit = prng.uniform(k5, (), 10.0, 18.0)  # aux0
        z = torch.zeros_like(p_cav)
        return ScenarioParams(
            lambda_main=lambda_main, lambda_ramp=z, p_cav=p_cav,
            v0_mean=v0_mean, v0_ramp=v0_mean, seed=seed, aux0=limit, aux1=z,
        )

    def longitudinal_mods(self, st, cfg, geom, sp, query_lane, nb, a,
                          ctx=None):
        limit = col(sp.aux0.clamp_min(0.1))

        # inside the zone: free-road IDM toward the limit speed caps accel
        in_zone = (st.pos >= geom.zone_start) & (st.pos <= geom.zone_end)
        r = st.vel / limit
        r2 = r * r
        a_limit = st.a_max * (1.0 - r2 * r2)
        a = torch.where(in_zone, torch.minimum(a, a_limit), a)

        # upstream anticipation: a virtual leader at the zone entrance
        before = st.pos < geom.zone_start
        ent_gap = geom.zone_start - st.pos
        a_approach = idm_accel(
            st.vel, st.vel - limit, ent_gap,
            st.v0, st.T, st.a_max, st.b_comf, st.s0,
        )
        return torch.where(
            before & (st.vel > limit), torch.minimum(a, a_approach), a
        )

    def boundary_gauge(self, st, cfg, geom):
        in_zone = (
            st.active & (st.pos >= geom.zone_start)
            & (st.pos <= geom.zone_end)
        )
        return count(in_zone)
