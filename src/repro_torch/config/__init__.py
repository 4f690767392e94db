"""Model, shape, training and serving configuration of the port (its own
copy of the reference's ``config/base.py``: the port imports nothing of
``repro``)."""

from repro_torch.config.base import (
    SHAPES,
    MeshConfig,
    ModelConfig,
    ServeConfig,
    ShapeConfig,
    TrainConfig,
    get_arch,
    list_archs,
    register_arch,
)

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "ServeConfig",
           "MeshConfig", "SHAPES", "get_arch", "list_archs", "register_arch"]
