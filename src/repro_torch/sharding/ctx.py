"""Activation-sharding context (port of ``repro/sharding/ctx.py``): models
call ``constrain(x, ...)`` with logical axis tags, and a launcher that
activates a mesh turns them into placements. With no active mesh
(single-card serving and training, the tests) ``constrain`` returns its
input and :func:`tp_size` is 1, so the models' numbers are unchanged.

Tags: ``"dp"`` (the batch over the pod and data axes), ``"tp"`` (the model
axis), ``None`` (replicated). Divisibility is checked per dim, falling
back to ``None``, as the parameter rules do.

The active mesh is a ``DeviceMesh`` or a
:class:`~repro_torch.config.base.MeshConfig` (the dry run's, which only
sizes the vocabulary pad of the logits). On a ``DeviceMesh``, a DTensor is
redistributed to the tags' placements: the counterpart of the reference's
``with_sharding_constraint``. A plain tensor is this rank's own data and
passes unchanged.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch

from repro_torch.sharding.axes import (
    _axis_size,
    _spec,
    dp_axes,
    mesh_axes,
    tp_axis,
)

_ACTIVE: ContextVar = ContextVar("activation_mesh", default=None)


@contextlib.contextmanager
def activation_sharding(mesh):
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def tp_size() -> int:
    """Size of the active mesh's ``model`` axis (1 with no active mesh)."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return 1
    ax = tp_axis(mesh)
    return int(mesh_axes(mesh)[ax]) if ax else 1


def constrain(x: torch.Tensor, *tags: str | None) -> torch.Tensor:
    """Apply a sharding hint; a no-op with no active mesh."""
    mesh = _ACTIVE.get()
    if mesh is None or len(tags) != x.ndim or not hasattr(x, "redistribute"):
        return x
    from repro_torch.sharding.axes import placements

    dp = dp_axes(mesh)
    tp = tp_axis(mesh)
    entries = []
    used: set = set()
    for tag, dim in zip(tags, x.shape):
        axis = dp if tag == "dp" else tp if tag == "tp" else None
        if axis is not None:
            names = set(axis) if isinstance(axis, tuple) else {axis}
            if (used & names) or dim % _axis_size(mesh, axis) != 0:
                axis = None
            else:
                used |= names
        entries.append(axis)
    return x.redistribute(mesh, placements(_spec(*entries), mesh))
