"""The LM stack of the port: the dense GQA transformer families
(``global``/``local`` layers), served through :class:`Model`."""

from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
