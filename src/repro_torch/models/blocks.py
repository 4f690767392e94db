"""Transformer blocks: init, apply, cache init, prefill and decode for the
attention layer kinds (port of ``repro/models/blocks.py``).

Layer kinds (``ModelConfig.layer_pattern`` entries):
- "global" — full causal attention + FFN
- "local"  — sliding-window attention + FFN

All blocks are pre-norm residual; gemma2 additionally applies post-norms
(``cfg.post_norms``). The "recurrent" and "rwkv" kinds, MLA and MoE come
with their families (ROADMAP queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.models.attention import (
    Attention,
    attn_apply,
    attn_decode,
    attn_prefill,
    kv_cache_init,
)
from repro_torch.models.common import Norm, norm
from repro_torch.models.ffn import FFN, ffn_apply

ATTENTION_KINDS = ("global", "local")


def _check_supported(cfg: ModelConfig, kind: str, moe: bool) -> None:
    if kind not in ATTENTION_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet: the recurrent and rwkv "
            "kinds come with their families (ROADMAP queue 1, item "
            "'recurrentgemma/rwkv6')")
    if cfg.use_mla or moe:
        raise NotImplementedError(
            "MLA and MoE layers are not ported yet (ROADMAP queue 1, item "
            "'MLA/MoE families')")


class Block(nn.Module):
    """One layer's parameters: ``norm1``, ``mixer``, ``norm2``, ``ffn`` and,
    with ``cfg.post_norms``, ``post_norm1``/``post_norm2``."""

    def __init__(self, cfg: ModelConfig, kind: str, device, moe: bool = False,
                 d_ff: int | None = None) -> None:
        super().__init__()
        _check_supported(cfg, kind, moe)
        self.kind = kind
        d = cfg.d_model
        self.norm1 = Norm(cfg, d, device)
        self.norm2 = Norm(cfg, d, device)
        self.mixer = Attention(cfg, device)
        self.ffn = FFN(cfg, device, d_ff=d_ff)
        if cfg.post_norms:
            self.post_norm1 = Norm(cfg, d, device)
            self.post_norm2 = Norm(cfg, d, device)

    def reset_parameters(self, generator) -> None:
        self.mixer.reset_parameters(generator)
        self.ffn.reset_parameters(generator)
        for m in self.children():
            if isinstance(m, Norm):
                m.reset_parameters()


def block_init(cfg: ModelConfig, kind: str, generator, device,
               moe: bool = False, d_ff: int | None = None) -> Block:
    """One block's parameters, drawn from ``generator``."""
    p = Block(cfg, kind, device, moe=moe, d_ff=d_ff)
    p.reset_parameters(generator)
    return p


def _residual(cfg: ModelConfig, p: Block, x, sub, post: str):
    if cfg.post_norms:
        sub = norm(cfg, getattr(p, post), sub)
    return x + sub


def block_apply(cfg: ModelConfig, p: Block, x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True):
    """Returns (x, moe_aux); the aux loss is 0 without MoE."""
    h = norm(cfg, p.norm1, x)
    sub = attn_apply(cfg, p.mixer, h, positions, p.kind, causal=causal)
    x = _residual(cfg, p, x, sub, "post_norm1")
    h = norm(cfg, p.norm2, x)
    x = _residual(cfg, p, x, ffn_apply(cfg, p.ffn, h), "post_norm2")
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     device) -> dict:
    _check_supported(cfg, kind, False)
    return kv_cache_init(cfg, batch, max_seq, kind, device)


def block_prefill(cfg: ModelConfig, p: Block, x: torch.Tensor,
                  positions: torch.Tensor, cache: dict):
    """Full-seq compute + cache fill (in place)."""
    h = norm(cfg, p.norm1, x)
    sub, cache = attn_prefill(cfg, p.mixer, h, positions, cache, p.kind)
    x = _residual(cfg, p, x, sub, "post_norm1")
    h = norm(cfg, p.norm2, x)
    x = _residual(cfg, p, x, ffn_apply(cfg, p.ffn, h), "post_norm2")
    return x, cache


def block_decode(cfg: ModelConfig, p: Block, x: torch.Tensor,
                 pos: torch.Tensor, cache: dict):
    """One token: x [B, 1, D], pos [B]; the cache is written in place."""
    h = norm(cfg, p.norm1, x)
    sub, cache = attn_decode(cfg, p.mixer, h, pos, cache, p.kind)
    x = _residual(cfg, p, x, sub, "post_norm1")
    h = norm(cfg, p.norm2, x)
    x = _residual(cfg, p, x, ffn_apply(cfg, p.ffn, h), "post_norm2")
    return x, cache
