"""Model facade: one (init / apply / init_cache / prefill / decode) API over
every family (port of ``repro/models/registry.py``): decoder-only (dense,
MoE, MLA, hybrid, rwkv) and encoder-decoder.

Batch dict conventions, as the reference:

- decoder-only: ``{"tokens": [B, S] int}``, plus ``"mrope_pos": [3, B, S]``
  for the VLM backbone (M-RoPE; without it the model takes plain RoPE);
- encoder-decoder: ``{"frames": [B, T, D]`` (the stub frontend's output),
  ``"tokens": [B, S] int`` (the decoder side)``}``.

The model runs on ``device`` (``None`` means ``cuda``, as everywhere in the
port); its caches are made there, and :meth:`Model.init` draws the weights
there from a ``torch.Generator`` on that device. :meth:`Model.abstract_params`
and :meth:`Model.abstract_cache` build them on the ``meta`` device instead,
whatever ``device``: shapes and types with no storage (the dry run's).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as _encdec
from repro_torch.models import lm as _lm


def params_module(cfg: ModelConfig, device):
    """The uninitialised parameter container of ``cfg``: an
    :class:`~repro_torch.models.encdec.EncDec` or an
    :class:`~repro_torch.models.lm.LM`."""
    return (_encdec.EncDec if cfg.is_encdec else _lm.LM)(cfg, device)


def reference_ranks(params, cfg: ModelConfig) -> dict[str, int]:
    """Each parameter's rank in the reference's (stacked) tree, which
    weight decay follows."""
    if cfg.is_encdec:
        return _encdec.reference_ranks(params)
    return _lm.reference_ranks(params, cfg)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, generator: torch.Generator):
        gen_dev = torch.device(generator.device)
        if gen_dev.type != self.device.type or (
                gen_dev.index is not None and gen_dev != self.device):
            raise ValueError(f"generator is on {gen_dev}, the model on "
                             f"{self.device}")
        if self.cfg.is_encdec:
            return _encdec.encdec_init(self.cfg, generator)
        return _lm.lm_init(self.cfg, generator)

    def abstract_params(self):
        """The parameters on the ``meta`` device: no allocation."""
        return params_module(self.cfg, torch.device("meta"))

    def apply(self, params, batch: dict, remat: str = "none"):
        """Returns (logits [B,S,V] f32, moe_aux); ``remat`` is ``"none"``,
        ``"full"`` or ``"dots"`` (:func:`repro_torch.models.lm.lm_apply`)."""
        if self.cfg.is_encdec:
            return _encdec.encdec_apply(params, self.cfg, batch["frames"],
                                        batch["tokens"], remat=remat)
        return _lm.lm_apply(params, self.cfg, batch["tokens"],
                            mrope_pos=batch.get("mrope_pos"), remat=remat)

    def init_cache(self, batch: int, max_seq: int):
        if self.cfg.is_encdec:
            return _encdec.encdec_cache_init(self.cfg, batch, max_seq,
                                             self.device)
        return _lm.lm_cache_init(self.cfg, batch, max_seq, self.device)

    def abstract_cache(self, batch: int, max_seq: int):
        """The cache of :meth:`init_cache` on the ``meta`` device."""
        meta = dataclasses.replace(self, device=torch.device("meta"))
        return meta.init_cache(batch, max_seq)

    def prefill(self, params, cache, batch: dict):
        """Returns (last-position logits [B, V] f32, cache)."""
        if self.cfg.is_encdec:
            return _encdec.encdec_prefill(params, self.cfg, cache,
                                          batch["frames"], batch["tokens"])
        return _lm.lm_prefill(params, self.cfg, cache, batch["tokens"],
                              mrope_pos=batch.get("mrope_pos"))

    def decode(self, params, cache, tokens: torch.Tensor, pos: torch.Tensor,
               mrope_pos: torch.Tensor | None = None):
        """tokens [B], pos [B] (mrope_pos [3, B, 1] or None) → (logits
        [B, V] f32, cache)."""
        if self.cfg.is_encdec:
            return _encdec.encdec_decode(params, self.cfg, cache, tokens, pos)
        return _lm.lm_decode(params, self.cfg, cache, tokens, pos,
                             mrope_pos=mrope_pos)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, resolve_device(device))
