"""``meta``-device stand-ins for every (arch x shape) dry-run cell (port of
``repro/launch/specs.py``).

``input_specs(cfg, shape)`` returns the inputs of the function the cell
runs: the train step for training shapes, ``prefill`` for prefill shapes
and one decode step (a new token against a ``seq_len``-deep cache) for
decode shapes, as tensors on the ``meta`` device with the reference's
shapes and types: they carry no storage, so no cell allocates.
"""

from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.models.common import cdtype
from repro_torch.models.registry import Model

I32 = torch.int32
META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((b, s), I32), "labels": _sds((b, s), I32)}
    if cfg.is_encdec:
        batch["frames"] = _sds((b, s, cfg.d_model), cdtype(cfg))
    if cfg.mrope_sections:
        batch["mrope_pos"] = _sds((3, b, s), I32)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((b, s), I32)}
    if cfg.is_encdec:
        # the encoder takes the seq_len frames; the decoder a prompt
        batch["frames"] = _sds((b, s, cfg.d_model), cdtype(cfg))
        batch["tokens"] = _sds((b, min(s, 448)), I32)
    if cfg.mrope_sections:
        batch["mrope_pos"] = _sds((3, b, s), I32)
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Inputs of a decode step: one new token against a seq_len-deep
    cache."""
    b, s = shape.global_batch, shape.seq_len
    out = {
        "cache": Model(cfg, META).abstract_cache(b, s),
        "tokens": _sds((b,), I32),
        "pos": _sds((b,), I32),
    }
    if cfg.mrope_sections:
        out["mrope_pos"] = _sds((3, b, 1), I32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape)
    return decode_specs(cfg, shape)


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig
                       ) -> tuple[bool, str]:
    """long_500k runs only for sub-quadratic archs (the assignment's skip
    rule)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "full-attention KV at 512k context — skipped per assignment "
            "(run for SSM/hybrid/linear-attn only); see DESIGN.md §5"
        )
    return True, ""
