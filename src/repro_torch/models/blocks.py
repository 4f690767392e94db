"""Blocks: init, apply, cache init, prefill and decode for every layer kind
the port serves (port of ``repro/models/blocks.py``).

Layer kinds (``ModelConfig.layer_pattern`` entries):
- "global"    — full causal attention (MLA with ``cfg.use_mla``) + FFN/MoE
- "local"     — sliding-window attention + FFN/MoE
- "recurrent" — Griffin RG-LRU block + FFN
- "rwkv"      — RWKV-6 time mix + channel mix (no FFN, no post-norms)

All blocks are pre-norm residual; gemma2 additionally applies post-norms
(``cfg.post_norms``). MoE-ness is decided by the stack
(:func:`repro_torch.models.lm.stack_plan`), so a block is built either
dense or MoE; ``block_apply`` returns the MoE's aux loss, prefill and
decode drop it. Caches are written in place.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.models.attention import (
    MLA,
    Attention,
    attn_apply,
    attn_decode,
    attn_prefill,
    kv_cache_init,
    mla_apply,
    mla_cache_init,
    mla_decode,
    mla_prefill,
)
from repro_torch.models.common import Norm, norm
from repro_torch.models.ffn import FFN, MoE, ffn_apply, moe_apply
from repro_torch.models.recurrent import (
    ChannelMix,
    RecurrentBlock,
    TimeMix,
    recurrent_block_apply,
    recurrent_block_seq,
    recurrent_block_step,
    recurrent_cache_init,
    rwkv_cache_init,
    rwkv_channel_mix_apply,
    rwkv_channel_mix_step,
    rwkv_time_mix_apply,
    rwkv_time_mix_seq,
    rwkv_time_mix_step,
)

KINDS = ("global", "local", "recurrent", "rwkv")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; expected one of "
                         f"{KINDS}")


class Block(nn.Module):
    """One layer's parameters: ``norm1``, ``norm2`` and either
    ``time_mix``/``channel_mix`` (rwkv) or ``mixer`` (attention, MLA or the
    Griffin block), ``ffn`` (dense or MoE) and, with ``cfg.post_norms``,
    ``post_norm1``/``post_norm2``."""

    def __init__(self, cfg: ModelConfig, kind: str, device, moe: bool = False,
                 d_ff: int | None = None) -> None:
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        self.moe = moe
        d = cfg.d_model
        self.norm1 = Norm(cfg, d, device)
        self.norm2 = Norm(cfg, d, device)
        if kind == "rwkv":
            self.time_mix = TimeMix(cfg, device)
            self.channel_mix = ChannelMix(cfg, device)
            return
        if kind == "recurrent":
            self.mixer = RecurrentBlock(cfg, device)
        elif cfg.use_mla:
            self.mixer = MLA(cfg, device)
        else:
            self.mixer = Attention(cfg, device)
        self.ffn = MoE(cfg, device) if moe else FFN(cfg, device, d_ff=d_ff)
        if cfg.post_norms:
            self.post_norm1 = Norm(cfg, d, device)
            self.post_norm2 = Norm(cfg, d, device)

    def reset_parameters(self, generator) -> None:
        for m in self.children():
            if isinstance(m, Norm):
                m.reset_parameters()
            else:
                m.reset_parameters(generator)


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


def _ffn_half(cfg: ModelConfig, p: Block, x: torch.Tensor):
    """The FFN (or MoE) half of a block: (x, moe_aux or None)."""
    h = norm(cfg, p.norm2, x)
    aux = None
    if p.moe:
        sub, aux = moe_apply(cfg, p.ffn, h)
    else:
        sub = ffn_apply(cfg, p.ffn, h)
    return _residual(cfg, p, x, sub, "post_norm2"), aux


def block_apply(cfg: ModelConfig, p: Block, x: torch.Tensor,
                positions: torch.Tensor,
                mrope_pos: torch.Tensor | None = None, causal: bool = True):
    """Returns (x, moe_aux); the aux loss is 0 without MoE."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm(cfg, p.norm1, x)
    if p.kind == "rwkv":
        x = x + rwkv_time_mix_apply(cfg, p.time_mix, h)
        h = norm(cfg, p.norm2, x)
        return x + rwkv_channel_mix_apply(cfg, p.channel_mix, h), aux
    if p.kind == "recurrent":
        sub = recurrent_block_apply(cfg, p.mixer, h)
    elif cfg.use_mla:
        sub = mla_apply(cfg, p.mixer, h, positions)
    else:
        sub = attn_apply(cfg, p.mixer, h, positions, p.kind,
                         mrope_pos=mrope_pos, causal=causal)
    x = _residual(cfg, p, x, sub, "post_norm1")
    x, moe_aux = _ffn_half(cfg, p, x)
    return x, aux if moe_aux is None else moe_aux


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     device) -> dict:
    _check_kind(kind)
    if kind == "rwkv":
        return rwkv_cache_init(cfg, batch, device)
    if kind == "recurrent":
        return recurrent_cache_init(cfg, batch, device)
    if cfg.use_mla:
        return mla_cache_init(cfg, batch, max_seq, device)
    return kv_cache_init(cfg, batch, max_seq, kind, device)


def block_prefill(cfg: ModelConfig, p: Block, x: torch.Tensor,
                  positions: torch.Tensor, cache: dict,
                  mrope_pos: torch.Tensor | None = None):
    """Full-seq compute + cache fill (in place). Recurrent kinds leave their
    final state in the cache."""
    h = norm(cfg, p.norm1, x)
    if p.kind == "rwkv":
        y, s_final, w = rwkv_time_mix_seq(cfg, p.time_mix, h)
        x = x + y
        h2 = norm(cfg, p.norm2, x)
        x = x + rwkv_channel_mix_apply(cfg, p.channel_mix, h2)
        return x, _rwkv_state_from_prefill(cache, s_final, w, h, h2)
    if p.kind == "recurrent":
        sub, cache = _recurrent_prefill(cfg, p.mixer, h, cache)
    elif cfg.use_mla:
        sub, cache = mla_prefill(cfg, p.mixer, h, positions, cache)
    else:
        sub, cache = attn_prefill(cfg, p.mixer, h, positions, cache, p.kind,
                                  mrope_pos)
    x = _residual(cfg, p, x, sub, "post_norm1")
    return _ffn_half(cfg, p, x)[0], cache


def block_decode(cfg: ModelConfig, p: Block, x: torch.Tensor,
                 pos: torch.Tensor, cache: dict,
                 mrope_pos: torch.Tensor | None = None):
    """One token: x [B, 1, D], pos [B], mrope_pos [3, B, 1] or None; the
    cache is written in place."""
    h = norm(cfg, p.norm1, x)
    if p.kind == "rwkv":
        y, cache = rwkv_time_mix_step(cfg, p.time_mix, h, cache)
        x = x + y
        h = norm(cfg, p.norm2, x)
        y, cache = rwkv_channel_mix_step(cfg, p.channel_mix, h, cache)
        return x + y, cache
    if p.kind == "recurrent":
        sub, cache = recurrent_block_step(cfg, p.mixer, h, cache)
    elif cfg.use_mla:
        sub, cache = mla_decode(cfg, p.mixer, h, pos, cache)
    else:
        sub, cache = attn_decode(cfg, p.mixer, h, pos, cache, p.kind,
                                 mrope_pos)
    x = _residual(cfg, p, x, sub, "post_norm1")
    return _ffn_half(cfg, p, x)[0], cache


# ---- prefill state helpers for recurrent kinds -----------------------------

def _recurrent_prefill(cfg: ModelConfig, p: RecurrentBlock, h, cache):
    """Griffin block over the prompt, then its final (h, conv) state.

    As the reference, the decode state ``h`` is the last RG-LRU output in
    the model's type, widened back to f32 (bf16-rounded in a bf16 model),
    not the scan's f32 final state. The conv history is the last
    ``conv_width - 1`` conv inputs, zero-padded on the left for a shorter
    prompt (the reference's slice would come out shorter than the cache).
    """
    out, u, y = recurrent_block_seq(cfg, p, h)
    keep = cfg.conv_width - 1
    hist = u[:, -keep:] if keep else u[:, :0]
    cache["h"].copy_(y[:, -1].float())
    cache["conv"].zero_()
    cache["conv"][:, keep - hist.shape[1]:] = hist
    return out, cache


def _rwkv_state_from_prefill(cache: dict, s_final, w, h_tm, h_cm) -> dict:
    """The RWKV state after the prompt, from the prefill's one ``wkv6``.

    The reference scans the prompt a second time from ``cache["S"]``; the
    scan is linear in its start state, so that is ``s_final`` (the scan from
    zeros) plus the product of the prompt's decays times ``cache["S"]``
    (zero for the fresh cache a prefill fills)."""
    cache["S"].copy_(s_final + w.prod(dim=1)[..., None] * cache["S"])
    cache["x_prev_tm"].copy_(h_tm[:, -1])
    cache["x_prev_cm"].copy_(h_cm[:, -1])
    return cache
