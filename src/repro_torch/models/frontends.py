"""Modality frontends: stubs, as in the reference
(port of ``repro/models/frontends.py``).

The audio and vision architectures specify the transformer backbone only;
these helpers make the stand-ins for the frontends' outputs, from the same
keys as the reference and to the same numbers (:mod:`repro_torch.core.prng`):

- audio (whisper): frames ``[B, T, d_model]``, what the mel and conv stack
  would emit after its stride-2 downsampling;
- vision (qwen2-vl): a merged token stream ``[B, S]`` plus M-RoPE position
  ids ``[3, B, S]``, what the ViT patch encoder and merger would emit.
"""

from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models.common import cdtype


def audio_frames_stub(key: torch.Tensor, cfg: ModelConfig, batch: int,
                      t: int) -> torch.Tensor:
    """``normal(key, [batch, t, d_model])`` in the model's type, on the
    key's device."""
    return prng.normal(key, (batch, t, cfg.d_model), cdtype(cfg))


def vision_stream_stub(key: torch.Tensor, cfg: ModelConfig, batch: int,
                       s: int, image_frac: float = 0.25):
    """Tokens ``[batch, s]`` int32 and M-RoPE positions ``[3, batch, s]``
    int32 of a stream whose leading ``image_frac`` stands for a merged
    image patch grid of ``side x side`` patches: their (t, h, w) ids follow
    the grid; the text after it has three equal streams that start at
    ``side`` (the reference's convention)."""
    dev = key.device
    tokens = prng.randint(prng.split(key)[0], (batch, s), 0, cfg.vocab_size)
    n_img = int(s * image_frac)
    side = max(int(n_img**0.5), 1)
    n_img = side * side
    idx = torch.arange(n_img, dtype=torch.int32, device=dev)
    text = torch.arange(s - n_img, dtype=torch.int32, device=dev) + side
    streams = [torch.zeros_like(idx), idx // side, idx % side]
    mrope = torch.stack([torch.cat([img, text]) for img in streams])
    return tokens, mrope[:, None, :].expand(3, batch, s).contiguous()
