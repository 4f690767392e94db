"""The model stack of the port: the decoder-only families (attention,
MLA, MoE, recurrent and rwkv layers; M-RoPE) and the encoder-decoder,
served through :class:`Model`."""

from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
