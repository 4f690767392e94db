"""Device selection shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, the CLI's ``--device cpu``). Asking for ``cuda`` on a
machine without one raises: nothing falls back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request without a card raises.

    A CUDA device always comes back with its index (``cuda`` becomes the
    current card, e.g. ``cuda:0``), so it compares equal to the device of
    the tensors made on it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(dev)!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are present"
        )
    return dev
