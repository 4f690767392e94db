"""Lane-drop bottleneck: the rightmost lane ends; everyone in it must merge.

Port of ``repro/core/scenarios/lane_drop.py``::

      lane 2  ──────────────────────────────────────────▶
      lane 1  ──────────────────────────────────────────▶
      lane 0  ───────────────────────╗ taper ╔ (lane ends — merge or stop)
                                zone_start  zone_end

Lane-0 vehicles brake against a wall at the taper end, take a mandatory
gap-acceptance merge into lane 1 inside the taper, and MOBIL moves into
lane 0 are vetoed past ``zone_start``. Forced merges land in the
``merges_ok`` slot (→ ``forced_merges``), blockage in
``ramp_blocked_steps`` (→ ``drop_blocked_steps``).
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.scenario import ScenarioParams, SimConfig
from repro_torch.core.scenarios.base import (
    RoadGeometry,
    Scenario,
    count,
    end_wall_clamp,
    end_wall_gauge,
    end_wall_mods,
    gap_acceptance,
)

DROP_LANE = 0          # the terminating lane
TARGET_LANE = 1        # where its traffic must go


class LaneDrop(Scenario):
    name = "lane_drop"
    metric_aliases = {
        "merges_ok": "forced_merges",
        "ramp_blocked_steps": "drop_blocked_steps",
    }

    def geometry(self, cfg: SimConfig) -> RoadGeometry:
        if cfg.n_lanes < 2:
            raise ValueError(
                "lane_drop needs n_lanes >= 2: lane 0 terminates and its "
                f"traffic merges into lane {TARGET_LANE}"
            )
        return RoadGeometry(
            n_lanes=cfg.n_lanes,
            road_len=cfg.road_len,
            special_lane="drop",
            zone_start=cfg.merge_start,
            zone_end=cfg.merge_end,
        )

    def sample_params(self, key: torch.Tensor, cfg: SimConfig) -> ScenarioParams:
        k1, k2, k3, k4 = prng.split(key, 4).unbind(-2)
        # heavier demand than the merge — the bottleneck is the point
        lambda_main = prng.uniform(k1, (cfg.n_lanes,), 0.25, 0.65)
        p_cav = prng.uniform(k2, (), 0.0, 1.0)
        v0_mean = prng.uniform(k3, (), 26.0, 33.0)
        seed = prng.randint(k4, (), 0, 2**31 - 1).to(torch.int64)
        z = torch.zeros_like(p_cav)
        return ScenarioParams(
            lambda_main=lambda_main, lambda_ramp=z, p_cav=p_cav,
            v0_mean=v0_mean, v0_ramp=v0_mean, seed=seed, aux0=z, aux1=z,
        )

    def longitudinal_mods(self, st, cfg, geom, sp, query_lane, nb, a,
                          ctx=None):
        return end_wall_mods(st, geom.zone_end, query_lane == DROP_LANE, a)

    def mobil_candidate_ok(self, st, cfg, geom, cand_lane):
        # no discretionary moves INTO the drop lane once it is closing
        into_closing = (
            (cand_lane == DROP_LANE) & (st.lane != DROP_LANE)
            & (st.pos >= geom.zone_start)
        )
        return ~into_closing

    def lateral_rules(self, st, cfg, geom, sp, tabs, mobil_lane):
        # mandatory gap-acceptance merge out of lane 0 inside the taper
        must_merge = (st.lane == DROP_LANE) & st.active
        in_zone = (st.pos >= geom.zone_start) & (st.pos <= geom.zone_end)
        target = torch.full_like(st.lane, TARGET_LANE)
        gap_ok = gap_acceptance(st, cfg, tabs, target)
        merge = must_merge & in_zone & gap_ok
        lane = torch.where(merge, TARGET_LANE, mobil_lane)
        return lane, count(merge)

    def boundary_clamp(self, st, cfg, geom, pos, vel):
        return end_wall_clamp(geom.zone_end, st.lane == DROP_LANE, pos, vel)

    def boundary_gauge(self, st, cfg, geom):
        return end_wall_gauge(st, geom.zone_end, st.lane == DROP_LANE)
