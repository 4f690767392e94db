"""The sweep's device list: the torch counterpart of the reference's
``repro/launch/mesh.py::make_host_mesh``.

:func:`sweep_devices` names the devices a sweep's blocks run on
(:class:`repro_torch.core.sweep.SweepRunner` with ``devices=``). On
``cuda`` they are distinct cards; on the CPU the list names the CPU ``n``
times, which is how the reference runs N simulated host devices
(``force_host_device_count``) and how the port's tests run N blocks.
The production meshes and ``AbstractMesh`` of the reference's module are
not ported here.
"""

from __future__ import annotations

import torch

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
