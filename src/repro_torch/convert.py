"""Carry state across from the reference package, through numpy.

The sweep has no weights; its state plays their part. These functions take
a reference ``SweepState``/``SimState``/``SimMetrics``/``ScenarioParams``
whose leaves are numpy arrays (PRNG keys unwrapped to their ``[..., 2]``
uint32 words, as ``jax.random.key_data`` gives them) and build the port's
tensors on ``device`` (``None`` means ``cuda``, as everywhere in the
port), so both packages can start from one state. No JAX type is
imported: the input is read by field name.

Dtypes carry over (f32, i32, bool), except uint32 leaves (key words, the
instance seed) which become int64 holding the same values. A single
instance's tree (``pos`` of shape ``[N]``) gains a leading instance axis.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scenario import ScenarioParams
from repro_torch.core.simulator import SimMetrics, SimState
from repro_torch.core.sweep import SweepState
from repro_torch.device import resolve_device


def _tensor(x, device, batch: bool) -> torch.Tensor:
    a = np.array(x)   # a writable copy: device arrays read back read-only
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if batch:
        a = a[None]
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _convert(cls, tree, device, batch: bool):
    device = resolve_device(device)
    return cls(*(_tensor(getattr(tree, f), device, batch) for f in cls._fields))


def sim_state_from_numpy(tree, device) -> SimState:
    """A reference ``SimState`` (numpy leaves) → :class:`SimState`."""
    return _convert(SimState, tree, device, np.ndim(tree.pos) == 1)


def sim_metrics_from_numpy(tree, device) -> SimMetrics:
    """A reference ``SimMetrics`` (numpy leaves) → :class:`SimMetrics`."""
    return _convert(SimMetrics, tree, device, np.ndim(tree.steps) == 0)


def scenario_params_from_numpy(tree, device) -> ScenarioParams:
    """A reference ``ScenarioParams`` (numpy leaves) → :class:`ScenarioParams`."""
    return _convert(ScenarioParams, tree, device, np.ndim(tree.p_cav) == 0)


def sweep_state_from_numpy(tree, device) -> SweepState:
    """A reference ``SweepState`` (numpy leaves, no trace) → :class:`SweepState`."""
    if getattr(tree, "trace", None) is not None:
        raise ValueError("recorded traces are not ported yet")
    device = resolve_device(device)
    return SweepState(
        sim=sim_state_from_numpy(tree.sim, device),
        metrics=sim_metrics_from_numpy(tree.metrics, device),
        params=scenario_params_from_numpy(tree.params, device),
        horizon=_tensor(tree.horizon, device, False),
        done=_tensor(tree.done, device, False),
        chunk=_tensor(tree.chunk, device, False),
        scenario_id=_tensor(tree.scenario_id, device, False),
    )


def to_numpy(tree):
    """A port NamedTuple (possibly nested) → the same structure of numpy
    arrays, for comparison with the reference."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if tree is None:
        return None
    return type(tree)(*(to_numpy(x) for x in tree))
