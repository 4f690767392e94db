"""Scenario configuration + randomized parameter sampling (batched).

Port of ``repro/core/scenario.py``. ``SimConfig`` is field for field the
reference's static configuration with the same defaults (``neighbor_impl``
adds ``"cuda"``, the counterpart of ``"pallas"``). ``ScenarioParams`` holds
one row per instance: scalar fields are ``[B]``, ``lambda_main`` is
``[B, n_lanes]``. Every draw comes from :mod:`repro_torch.core.prng`, bit
for bit the reference's ``jax.random`` stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core import prng


@dataclass(frozen=True)
class SimConfig:
    """Static simulator configuration (hashable; one per roster entry)."""

    n_slots: int = 64          # fixed vehicle capacity per instance
    n_lanes: int = 3           # main highway lanes (ramp is lane index n_lanes)
    road_len: float = 1000.0
    # generic scenario-zone extents (merge zone, taper, work zone)
    merge_start: float = 600.0
    merge_end: float = 750.0
    scenario: str = "highway_merge"  # registry name (repro_torch.core.scenarios)
    dt: float = 0.1            # SUMO default step length
    vehicle_len: float = 4.5
    spawn_gap: float = 15.0    # min headway at the spawn point
    # IDM bounds
    b_safe: float = 4.0        # MOBIL safety decel limit
    b_max: float = 8.0         # emergency decel clamp
    mobil_athr: float = 0.1    # MOBIL incentive threshold
    lane_change_cooldown: int = 20  # steps between lane changes
    # merge gap acceptance
    merge_gap_front: float = 8.0
    merge_gap_rear: float = 10.0
    record_every: int = 0      # 0 = no trajectory recording
    # neighborhood engine (repro_torch.core.neighbors): "reference",
    # "dense", "sort" or "cuda" (the hand-written kernel); all four are
    # bit-for-bit equivalent
    neighbor_impl: str = "sort"


class ScenarioParams(NamedTuple):
    """Per-instance randomized demand + driver-population parameters.

    One row per instance; the structure is shared by every registered
    scenario, unused fields are zeros, ``aux0``/``aux1`` are scenario
    knobs (speed limit, perturbation strength and period).
    """

    lambda_main: torch.Tensor   # [B, n_lanes] f32 arrival rate veh/s per lane
    lambda_ramp: torch.Tensor   # [B] f32 ramp arrival rate (ramp scenarios)
    p_cav: torch.Tensor         # [B] f32 CAV penetration
    v0_mean: torch.Tensor       # [B] f32 mean desired speed
    v0_ramp: torch.Tensor       # [B] f32 desired speed on the ramp
    seed: torch.Tensor          # [B] int64 instance seed (uint32 range)
    aux0: torch.Tensor          # [B] f32 scenario knob
    aux1: torch.Tensor          # [B] f32 scenario knob


def sample_scenario_params(key: torch.Tensor, cfg: SimConfig) -> ScenarioParams:
    """Draw a batch of instances' parameters (``key`` is ``[B, 2]``) for
    ``cfg.scenario`` (registry dispatch)."""
    from repro_torch.core.scenarios import get_scenario  # deferred: cycle

    return get_scenario(cfg.scenario).sample_params(key, cfg)


# Driver-type parameter tables (human, CAV): CAVs run tighter headways and
# react harder.
HUMAN = dict(T=1.5, a_max=1.4, b_comf=2.0, s0=2.0, politeness=0.3)
CAV = dict(T=0.9, a_max=2.0, b_comf=2.5, s0=1.5, politeness=0.5)


def driver_params(is_cav: torch.Tensor, jitter_key: torch.Tensor, n: int):
    """Per-vehicle IDM/MOBIL parameters ``[B, n]`` given the CAV mask
    ``[B, n]`` and one jitter key per instance ``[B, 2]``."""
    jt = prng.uniform(jitter_key, (n,), 0.85, 1.15)

    def const(x: float) -> torch.Tensor:
        return torch.full_like(jt, x)

    def mix(h: float, c: float) -> torch.Tensor:
        base = torch.where(is_cav, const(c), const(h))
        # humans get parameter jitter, CAVs are standardized
        return torch.where(is_cav, base, base * jt)

    return dict(
        T=mix(HUMAN["T"], CAV["T"]),
        a_max=mix(HUMAN["a_max"], CAV["a_max"]),
        b_comf=mix(HUMAN["b_comf"], CAV["b_comf"]),
        s0=mix(HUMAN["s0"], CAV["s0"]),
        politeness=torch.where(is_cav, const(CAV["politeness"]),
                               const(HUMAN["politeness"])),
    )
