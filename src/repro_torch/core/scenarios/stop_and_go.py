"""Stop-and-go waves: a closed ring road with a periodic braking perturbation.

Port of ``repro/core/scenarios/stop_and_go.py``. Positions wrap mod the
ring length; the frontmost vehicle of each lane follows that lane's
rearmost vehicle across the seam; every ``aux1`` seconds vehicles inside
the perturbation band brake at ``aux0`` m/s² for a few seconds; there are
no exits, and the gauge counts stopped vehicles (→ ``stopped_steps``).
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.scenario import ScenarioParams, SimConfig
from repro_torch.core.scenarios.base import (
    INF,
    RoadGeometry,
    Scenario,
    col,
    count,
    idm_accel,
    jmod,
)

PERTURB_SECONDS = 5.0       # how long each braking pulse lasts
BAND = (0.45, 0.55)         # perturbation band, as fractions of road_len
SEAM_FRAC = 0.10            # no discretionary lane changes this close to
#                             the seam (linear tables can't see across it)


class StopAndGo(Scenario):
    name = "stop_and_go"
    metric_aliases = {
        "ramp_blocked_steps": "stopped_steps",
        "throughput": "exited",  # structurally present, always 0 on a ring
    }

    def geometry(self, cfg: SimConfig) -> RoadGeometry:
        ring_len = min(cfg.road_len, max(cfg.n_slots, 8) * 30.0 / cfg.n_lanes)
        return RoadGeometry(n_lanes=cfg.n_lanes, road_len=ring_len, ring=True)

    def sample_params(self, key: torch.Tensor, cfg: SimConfig) -> ScenarioParams:
        k1, k2, k3, k4, k5, k6 = prng.split(key, 6).unbind(-2)
        lambda_main = prng.uniform(k1, (cfg.n_lanes,), 0.25, 0.70)
        p_cav = prng.uniform(k2, (), 0.0, 1.0)
        v0_mean = prng.uniform(k3, (), 26.0, 33.0)
        seed = prng.randint(k4, (), 0, 2**31 - 1).to(torch.int64)
        brake = prng.uniform(k5, (), 2.0, 5.0)     # aux0
        period = prng.uniform(k6, (), 20.0, 45.0)  # aux1
        z = torch.zeros_like(p_cav)
        return ScenarioParams(
            lambda_main=lambda_main, lambda_ramp=z, p_cav=p_cav,
            v0_mean=v0_mean, v0_ramp=v0_mean, seed=seed,
            aux0=brake, aux1=period,
        )

    def mobil_eligible(self, st, cfg, geom):
        away_from_seam = (
            (st.pos > SEAM_FRAC * geom.road_len)
            & (st.pos < (1.0 - SEAM_FRAC) * geom.road_len)
        )
        return (st.lane < geom.n_lanes) & away_from_seam

    def snapshot_ctx(self, st, cfg, geom):
        # per-lane rearmost vehicle [B, L] — the wrap leader across the seam
        lanes = torch.arange(geom.n_lanes, dtype=st.lane.dtype,
                             device=st.lane.device)
        in_lane = st.active[:, None, :] & (st.lane[:, None, :] == lanes[None, :, None])
        keyed = torch.where(in_lane, st.pos[:, None, :], INF)    # [B, L, N]
        rear_slot = keyed.argmin(dim=-1)
        rear_pos = keyed.amin(dim=-1)
        rear_vel = st.vel.gather(1, rear_slot)
        return rear_pos, rear_vel

    def longitudinal_mods(self, st, cfg, geom, sp, query_lane, nb, a,
                          ctx=None):
        rear_pos, rear_vel = (
            ctx if ctx is not None else self.snapshot_ctx(st, cfg, geom)
        )
        q = query_lane.clamp(0, geom.n_lanes - 1).long()
        rp = rear_pos.gather(1, q)
        wrap_gap = rp + geom.road_len - st.pos - cfg.vehicle_len
        wrap_dv = st.vel - rear_vel.gather(1, q)
        a_wrap = idm_accel(
            st.vel, wrap_dv, wrap_gap,
            st.v0, st.T, st.a_max, st.b_comf, st.s0,
        )
        lane_occupied = rp < INF * 0.5
        use_wrap = ~nb.has_lead & lane_occupied
        a = torch.where(use_wrap, torch.minimum(a, a_wrap), a)

        # periodic braking pulse inside the band — the wave seed
        period = col(sp.aux1.clamp_min(1.0))
        phase = jmod(col(st.t.to(torch.float32)) * cfg.dt, period)
        pulsing = phase < PERTURB_SECONDS
        in_band = (
            (st.pos >= BAND[0] * geom.road_len)
            & (st.pos <= BAND[1] * geom.road_len)
        )
        return torch.where(
            pulsing & in_band, torch.minimum(a, col(-sp.aux0)), a
        )

    def boundary_clamp(self, st, cfg, geom, pos, vel):
        # ring wrap; inactive slots stay parked at -INF
        pos = torch.where(st.active, jmod(pos, geom.road_len), pos)
        return pos, vel

    def boundary_exit(self, st, cfg, geom):
        return torch.zeros_like(st.active)

    def boundary_gauge(self, st, cfg, geom):
        return count(st.active & (st.vel < 2.0))
