"""The paper's Phase-II workload: a mixed-traffic highway on-ramp merge.

Port of ``repro/core/scenarios/highway_merge.py``::

      lane 2  ──────────────────────────────────────────▶
      lane 1  ──────────────────────────────────────────▶
      lane 0  ──────────────────────────────────────────▶
      ramp(3) ════════════╗ merge zone ╔═══ (ends; must merge or stop)
                      merge_start   merge_end

Ramp vehicles brake against a virtual wall at the ramp end, are excluded
from MOBIL, take a gap-acceptance merge into lane 0 inside the zone (CAVs
accept 0.7× gaps) and are clamped at the ramp's hard end.
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
    end_wall_clamp,
    end_wall_gauge,
    end_wall_mods,
    gap_acceptance,
)


class HighwayMerge(Scenario):
    name = "highway_merge"
    metric_aliases: dict[str, str] = {}

    def geometry(self, cfg: SimConfig) -> RoadGeometry:
        return RoadGeometry(
            n_lanes=cfg.n_lanes,
            road_len=cfg.road_len,
            special_lane="ramp",
            zone_start=cfg.merge_start,
            zone_end=cfg.merge_end,
        )

    def sample_params(self, key: torch.Tensor, cfg: SimConfig) -> ScenarioParams:
        """Same draw order as the reference (the stream is part of the
        parity contract)."""
        k1, k2, k3, k4, k5 = prng.split(key, 5).unbind(-2)
        lambda_main = prng.uniform(k1, (cfg.n_lanes,), 0.15, 0.55)
        lambda_ramp = prng.uniform(k2, (), 0.05, 0.30)
        p_cav = prng.uniform(k3, (), 0.0, 1.0)
        v0_mean = prng.uniform(k4, (), 26.0, 33.0)
        v0_ramp = v0_mean * 0.7
        seed = prng.randint(k5, (), 0, 2**31 - 1).to(torch.int64)
        z = torch.zeros_like(p_cav)
        return ScenarioParams(
            lambda_main, lambda_ramp, p_cav, v0_mean, v0_ramp, seed, z, z
        )

    def longitudinal_mods(self, st, cfg, geom, sp, query_lane, nb, a,
                          ctx=None):
        return end_wall_mods(st, geom.zone_end, query_lane == geom.n_lanes, a)

    def lateral_rules(self, st, cfg, geom, sp, tabs, mobil_lane):
        """Merge from the ramp into lane 0 inside the merge zone."""
        on_ramp = (st.lane == geom.n_lanes) & st.active
        in_zone = (st.pos >= geom.zone_start) & (st.pos <= geom.zone_end)
        gap_ok = gap_acceptance(st, cfg, tabs, torch.zeros_like(st.lane))
        merge = on_ramp & in_zone & gap_ok
        merged_lane = torch.where(merge, 0, mobil_lane)
        return merged_lane, count(merge)

    def boundary_spawn(self, cfg, geom, sp):
        lanes = torch.arange(geom.n_lanes + 1, dtype=torch.int32,
                             device=sp.v0_mean.device)
        lam = torch.cat([sp.lambda_main, col(sp.lambda_ramp)], dim=1)
        base_v0 = torch.where(lanes == geom.n_lanes, col(sp.v0_ramp),
                              col(sp.v0_mean))
        return lam, base_v0, lanes

    def boundary_clamp(self, st, cfg, geom, pos, vel):
        return end_wall_clamp(geom.zone_end, st.lane == geom.n_lanes, pos, vel)

    def boundary_gauge(self, st, cfg, geom):
        return end_wall_gauge(st, geom.zone_end, st.lane == geom.n_lanes)
