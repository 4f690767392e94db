"""Device lists and meshes: the torch counterpart of the reference's
``repro/launch/mesh.py``.

:func:`sweep_devices` names the devices a sweep's blocks run on
(:class:`repro_torch.core.sweep.SweepRunner` with ``devices=``), the
counterpart of ``make_host_mesh``. On ``cuda`` they are distinct cards; on
the CPU the list names the CPU ``n`` times, which is how the reference
runs N simulated host devices (``force_host_device_count``) and how the
port's tests run N blocks.

:func:`make_production_mesh` builds a ``DeviceMesh`` over the cards that
are present, and :func:`make_abstract_mesh` a
:class:`~repro_torch.config.base.MeshConfig`, the port's stand-in for
the reference's ``AbstractMesh``: axis names and sizes with no devices,
which the sharding rules and the dry run's memory plan read.
"""

from __future__ import annotations

import math

import torch

from repro_torch.config.base import MeshConfig
from repro_torch.device import resolve_device


def sweep_devices(n: int, device: str | torch.device | None = None
                  ) -> list[torch.device]:
    """``n`` devices for the sweep's blocks, the first one being ``device``
    (``None`` means ``cuda``).

    On ``cuda``: ``cuda:i .. cuda:i+n-1`` from the requested card ``i``
    (``cuda:0 .. cuda:n-1`` by default); raises when that needs more cards
    than ``torch.cuda.device_count()``. It never folds blocks onto fewer
    cards: a list that names one card twice is built by the caller. On the
    CPU: the CPU ``n`` times.
    """
    if n < 1:
        raise ValueError(f"device count must be >= 1, got {n}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n
    count = torch.cuda.device_count()
    if dev.index + n > count:
        raise ValueError(
            f"{n} CUDA devices requested from {dev} but only {count} "
            f"CUDA device(s) are present"
        )
    return [torch.device("cuda", dev.index + i) for i in range(n)]


def make_production_mesh(shape: tuple[int, ...] = (1, 1),
                         axes: tuple[str, ...] = ("data", "model")):
    """A ``DeviceMesh`` of ``shape`` over the cards, one process a card.

    The caller starts ``prod(shape)`` processes and initialises the
    default process group in each (``torch.distributed.init_process_group``
    with its address, world size and rank: nothing on the machine names a
    cluster). Raises when fewer cards are present than the mesh needs."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"CUDA devices, but {count} are present")
    return init_device_mesh("cuda", tuple(shape), mesh_dim_names=tuple(axes))


def make_abstract_mesh(shape, axes) -> MeshConfig:
    """A device-free mesh for spec validation and planning: a
    ``MeshConfig``, the port's counterpart of ``AbstractMesh``."""
    return MeshConfig(tuple(shape), tuple(axes))
