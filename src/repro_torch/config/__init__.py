"""Model and serving configuration of the port (its own copy of the
reference's ``config/base.py``: the port imports nothing of ``repro``)."""

from repro_torch.config.base import (
    ModelConfig,
    ServeConfig,
    get_arch,
    list_archs,
    register_arch,
)

__all__ = ["ModelConfig", "ServeConfig", "get_arch", "list_archs",
           "register_arch"]
