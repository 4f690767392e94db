"""Model facade: one (init / apply / init_cache / prefill / decode) API
(port of ``repro/models/registry.py`` for the decoder-only families).

Batch dict convention, as the reference: ``{"tokens": [B, S] int}``. The
model runs on ``device`` (``None`` means ``cuda``, as everywhere in the
port); its caches are made there, and :meth:`Model.init` draws the weights
there from a ``torch.Generator`` on that device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm as _lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, generator: torch.Generator) -> _lm.LM:
        gen_dev = torch.device(generator.device)
        if gen_dev.type != self.device.type or (
                gen_dev.index is not None and gen_dev != self.device):
            raise ValueError(f"generator is on {gen_dev}, the model on "
                             f"{self.device}")
        return _lm.lm_init(self.cfg, generator)

    def apply(self, params: _lm.LM, batch: dict, remat: str = "none"):
        """Returns (logits [B,S,V] f32, moe_aux); ``remat`` is ``"none"``,
        ``"full"`` or ``"dots"`` (:func:`repro_torch.models.lm.lm_apply`)."""
        return _lm.lm_apply(params, self.cfg, batch["tokens"], remat=remat)

    def init_cache(self, batch: int, max_seq: int) -> list[dict]:
        return _lm.lm_cache_init(self.cfg, batch, max_seq, self.device)

    def prefill(self, params: _lm.LM, cache: list[dict], batch: dict):
        """Returns (last-position logits [B, V] f32, cache)."""
        return _lm.lm_prefill(params, self.cfg, cache, batch["tokens"])

    def decode(self, params: _lm.LM, cache: list[dict], tokens: torch.Tensor,
               pos: torch.Tensor):
        """tokens [B], pos [B] → (logits [B, V] f32, cache)."""
        return _lm.lm_decode(params, self.cfg, cache, tokens, pos)


def build_model(cfg: ModelConfig, device=None) -> Model:
    if cfg.is_encdec:
        raise NotImplementedError(
            "encoder-decoder models (whisper) are not ported yet "
            "(ROADMAP queue 1)")
    return Model(cfg, resolve_device(device))
