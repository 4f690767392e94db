"""Scenario registry — the workload catalog behind ``SimConfig.scenario``.

Port of ``repro/core/scenarios/__init__.py``, same names in the same
registration order:

================== ======================= =====================
name               geometry                scenario metrics
================== ======================= =====================
highway_merge      3 lanes + on-ramp       merges_ok, ramp_blocked_steps
lane_drop          3 lanes, lane 0 ends    forced_merges, drop_blocked_steps
stop_and_go        ring road (wraps)       stopped_steps, min_ttc
speed_limit_zone   straight pipe, zone     zone_veh_steps, throughput
================== ======================= =====================
"""

from __future__ import annotations

from repro_torch.core.scenarios.base import (
    INF,
    RoadGeometry,
    Scenario,
    idm_accel,
)

_REGISTRY: dict[str, Scenario] = {}


def register_scenario(cls: type[Scenario]) -> type[Scenario]:
    """Class decorator: instantiate + register a scenario under ``cls.name``."""
    inst = cls()
    if not inst.name or inst.name == "base":
        raise ValueError(f"{cls.__name__} must set a unique `name`")
    if inst.name in _REGISTRY:
        raise ValueError(f"scenario {inst.name!r} already registered")
    _REGISTRY[inst.name] = inst
    return cls


def get_scenario(name: str) -> Scenario:
    """Look up a registered :class:`Scenario` singleton by name (``KeyError``
    listing the registered names for an unknown one)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {list(_REGISTRY)}"
        ) from None


def list_scenarios() -> list[str]:
    """Registered scenario names, in stable registration order."""
    return list(_REGISTRY)


# ---- built-in catalog (import order defines the stable ids) --------------

from repro_torch.core.scenarios.highway_merge import HighwayMerge  # noqa: E402
from repro_torch.core.scenarios.lane_drop import LaneDrop  # noqa: E402
from repro_torch.core.scenarios.stop_and_go import StopAndGo  # noqa: E402
from repro_torch.core.scenarios.speed_limit_zone import SpeedLimitZone  # noqa: E402

register_scenario(HighwayMerge)
register_scenario(LaneDrop)
register_scenario(StopAndGo)
register_scenario(SpeedLimitZone)

__all__ = [
    "INF",
    "RoadGeometry",
    "Scenario",
    "idm_accel",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
    "HighwayMerge",
    "LaneDrop",
    "StopAndGo",
    "SpeedLimitZone",
]
