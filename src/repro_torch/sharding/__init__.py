"""Sharding of the port (port of ``repro/sharding``): the parameter,
optimizer, batch and cache rules, their per-device plan, DTensor
placements on a ``DeviceMesh``, and the activation context."""

from repro_torch.sharding.axes import (
    batch_shardings,
    batch_specs,
    cache_shardings,
    cache_specs,
    dp_axes,
    local_shape,
    opt_state_shardings,
    opt_state_specs,
    param_shardings,
    param_specs,
    placements,
    plan_bytes,
    tp_axis,
)

__all__ = [
    "dp_axes",
    "tp_axis",
    "param_specs",
    "param_shardings",
    "opt_state_specs",
    "opt_state_shardings",
    "batch_specs",
    "batch_shardings",
    "cache_specs",
    "cache_shardings",
    "placements",
    "local_shape",
    "plan_bytes",
]
