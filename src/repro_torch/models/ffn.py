"""FFN layers: the gated-linear-unit dense FFN (port of
``repro/models/ffn.py:21-50``). The mixture of experts comes with the MoE
families (ROADMAP queue 1)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.models.common import cdtype, dense_init, param


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, device, d_ff: int | None = None):
        super().__init__()
        dt = cdtype(cfg)
        d, m = cfg.d_model, d_ff or cfg.d_ff
        self.wi_gate = param((d, m), dt, device)
        self.wi_up = param((d, m), dt, device)
        self.wo = param((m, d), dt, device)

    def reset_parameters(self, generator) -> None:
        d, m = self.wi_gate.shape
        dense_init(self.wi_gate, d, generator)
        dense_init(self.wi_up, d, generator)
        dense_init(self.wo, m, generator)


def ffn_apply(cfg: ModelConfig, p: FFN, x: torch.Tensor) -> torch.Tensor:
    g = _act(cfg.activation, x @ p.wi_gate)
    u = x @ p.wi_up
    return (g * u) @ p.wo
