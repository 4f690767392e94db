"""Encoder-decoder (the Whisper large-v3 backbone; port of
``repro/models/encdec.py``).

The mel/conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``[B, T, d_model]``
(:func:`repro_torch.models.frontends.audio_frames_stub`). Positions are
fixed sinusoids on both sides.

Encoder: non-causal self-attention blocks. Decoder: causal self-attention,
cross-attention over the encoder states and an FFN per block, with a KV
cache for its self-attention and the cross K/V computed once at prefill.
Every full-sequence attention, the cross attention of a decode step
included (one query row), goes through
:func:`repro_torch.models.attention.full_attention`: the flash kernel on
the card, its plain version on the CPU or under ``attention_impl("xla")``.

The reference stacks each side's layers ``[n_layers, ...]`` and scans;
here ``enc_blocks`` and ``dec_blocks`` are ``nn.ModuleList`` s, unstacked
by :mod:`repro_torch.convert`. The cache is ``{"self": [per-layer KV
cache], "cross": [per-layer {"k", "v"} [B, T, H, hd]]}``; prefill writes
the self caches in place and replaces each layer's cross entry by the
prompt's encoder K/V, of the frames' length ``T`` whatever ``enc_ctx``
(the reference's scan output replaces the zeros of
:func:`encdec_cache_init` alike).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.models.attention import (
    Attention,
    CrossAttention,
    attn_apply,
    attn_decode,
    attn_prefill,
    cross_attn_apply,
    cross_attn_kv,
    kv_cache_init,
)
from repro_torch.models.common import (
    Embedding,
    Norm,
    cdtype,
    dense_init,
    embed_tokens,
    logits_from_hidden,
    norm,
    param,
    sinusoidal_at,
    sinusoidal_positions,
)
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.lm import REMAT, remat_call
from repro_torch.sharding.ctx import constrain


class EncBlock(nn.Module):
    """``norm1``, ``attn`` (non-causal), ``norm2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.norm2 = Norm(cfg, cfg.d_model, device)
        self.ffn = FFN(cfg, device)


class DecBlock(nn.Module):
    """``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``,
    ``ffn``."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.self_attn = Attention(cfg, device)
        self.norm_x = Norm(cfg, cfg.d_model, device)
        self.cross_attn = CrossAttention(cfg, device)
        self.norm2 = Norm(cfg, cfg.d_model, device)
        self.ffn = FFN(cfg, device)


def _reset_block(block: nn.Module, generator) -> None:
    for m in block.children():
        if isinstance(m, Norm):
            m.reset_parameters()
        else:
            m.reset_parameters(generator)


class EncDec(nn.Module):
    """Parameters of the encoder-decoder: ``frame_proj [d, d]``,
    ``enc_blocks``, ``enc_norm``, ``embed`` (tied to the output),
    ``dec_blocks``, ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        d = cfg.d_model
        self.frame_proj = param((d, d), cdtype(cfg), device)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, device) for _ in range(cfg.n_enc_layers))
        self.enc_norm = Norm(cfg, d, device)
        self.embed = Embedding(cfg, device)
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, d, device)

    def reset_parameters(self, generator) -> None:
        dense_init(self.frame_proj, self.frame_proj.shape[0], generator)
        for block in self.enc_blocks:
            _reset_block(block, generator)
        self.enc_norm.reset_parameters()
        self.embed.reset_parameters(generator)
        for block in self.dec_blocks:
            _reset_block(block, generator)
        self.final_norm.reset_parameters()


def encdec_init(cfg: ModelConfig, generator: torch.Generator) -> EncDec:
    """A seeded encoder-decoder on ``generator``'s device."""
    params = EncDec(cfg, generator.device)
    params.reset_parameters(generator)
    return params


STACKED = ("enc_blocks", "dec_blocks")


def reference_ranks(params: EncDec) -> dict[str, int]:
    """Each parameter's rank in the reference's tree: its own, plus the
    stack axis for a layer of ``enc_blocks`` or ``dec_blocks`` (a norm
    scale ``[d]`` there is a ``[n_layers, d]`` leaf)."""
    return {name: p.ndim + (name.split(".")[0] in STACKED)
            for name, p in params.named_parameters()}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

def _enc_layer(cfg: ModelConfig, bp: EncBlock, x, positions):
    h = norm(cfg, bp.norm1, x)
    x = x + attn_apply(cfg, bp.attn, h, positions, "global", causal=False)
    h = norm(cfg, bp.norm2, x)
    return constrain(x + ffn_apply(cfg, bp.ffn, h), "dp", None, None)


def encode(params: EncDec, cfg: ModelConfig, frames: torch.Tensor,
           remat: str = "none") -> torch.Tensor:
    """frames [B, T, D] (the stub frontend's output) → encoder states
    [B, T, D]; each layer one checkpoint under ``remat``."""
    b, t, _ = frames.shape
    x = frames @ params.frame_proj
    x = x + sinusoidal_positions(t, cfg.d_model, x.device).to(x.dtype)[None]
    x = constrain(x, "dp", None, None)
    positions = _positions(b, t, x.device)
    for bp in params.enc_blocks:
        x = remat_call(lambda x, bp: _enc_layer(cfg, bp, x, positions),
                       remat, x, bp)
    return norm(cfg, params.enc_norm, x)


# --------------------------------------------------------------------------
# decoder (teacher-forced, full sequence: training)
# --------------------------------------------------------------------------

def _embed_prompt(params: EncDec, cfg: ModelConfig, dec_tokens):
    x = embed_tokens(cfg, params.embed, dec_tokens)
    s = dec_tokens.shape[1]
    return x + sinusoidal_positions(s, cfg.d_model, x.device).to(x.dtype)[None]


def _ffn_half(cfg: ModelConfig, bp: DecBlock, x):
    h = norm(cfg, bp.norm2, x)
    return x + ffn_apply(cfg, bp.ffn, h)


def encdec_apply(params: EncDec, cfg: ModelConfig, frames: torch.Tensor,
                 dec_tokens: torch.Tensor, remat: str = "none"):
    """Teacher-forced forward: (logits [B, S, V] f32, 0.0 f32)."""
    if remat not in REMAT:
        raise ValueError(f"remat is one of {REMAT}, not {remat!r}")
    enc = encode(params, cfg, frames, remat=remat)
    b, s = dec_tokens.shape
    x = constrain(_embed_prompt(params, cfg, dec_tokens), "dp", None, None)
    positions = _positions(b, s, x.device)

    def layer(x, enc, bp):
        h = norm(cfg, bp.norm1, x)
        x = x + attn_apply(cfg, bp.self_attn, h, positions, "global")
        h = norm(cfg, bp.norm_x, x)
        kv = cross_attn_kv(cfg, bp.cross_attn, enc)
        x = x + cross_attn_apply(cfg, bp.cross_attn, h, kv)
        return constrain(_ffn_half(cfg, bp, x), "dp", None, None)

    for bp in params.dec_blocks:
        x = remat_call(layer, remat, x, enc, bp)
    x = norm(cfg, params.final_norm, x)
    logits = logits_from_hidden(cfg, params.embed, None, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# serving: prefill computes the encoder states and the cross K/V; decode
# steps the decoder against both caches
# --------------------------------------------------------------------------

def encdec_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> dict:
    shape = (batch, cfg.enc_ctx, cfg.n_heads, cfg.head_dim)
    dt = cdtype(cfg)
    return {
        "self": [kv_cache_init(cfg, batch, max_seq, "global", device)
                 for _ in range(cfg.n_layers)],
        "cross": [{"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device)}
                  for _ in range(cfg.n_layers)],
    }


def encdec_prefill(params: EncDec, cfg: ModelConfig, cache: dict,
                   frames: torch.Tensor, dec_tokens: torch.Tensor):
    """Encode ``frames [B, T, D]``, then run the decoder prompt
    ``[B, S0]``: returns (last-position logits [B, V] f32, cache), the self
    caches filled in place and each cross entry replaced by the layer's
    encoder K/V ``[B, T, H, hd]``."""
    enc = encode(params, cfg, frames)
    b, s = dec_tokens.shape
    x = _embed_prompt(params, cfg, dec_tokens)
    positions = _positions(b, s, x.device)
    for i, bp in enumerate(params.dec_blocks):
        h = norm(cfg, bp.norm1, x)
        sub, _ = attn_prefill(cfg, bp.self_attn, h, positions,
                              cache["self"][i], "global")
        x = x + sub
        k, v = cross_attn_kv(cfg, bp.cross_attn, enc)
        cache["cross"][i] = {"k": k, "v": v}
        h = norm(cfg, bp.norm_x, x)
        x = x + cross_attn_apply(cfg, bp.cross_attn, h, (k, v))
        x = _ffn_half(cfg, bp, x)
    x = norm(cfg, params.final_norm, x[:, -1:])
    logits = logits_from_hidden(cfg, params.embed, None, x)
    return logits[:, 0], cache


def encdec_decode(params: EncDec, cfg: ModelConfig, cache: dict,
                  tokens: torch.Tensor, pos: torch.Tensor):
    """One decoder step: tokens [B], pos [B] → (logits [B, V] f32, cache),
    the self caches written in place; each layer's cross attention is one
    query row over the cross K/V."""
    x = embed_tokens(cfg, params.embed, tokens[:, None])
    x = x + sinusoidal_at(pos, cfg.d_model)[:, None].to(x.dtype)
    for bp, sc, ckv in zip(params.dec_blocks, cache["self"], cache["cross"]):
        h = norm(cfg, bp.norm1, x)
        sub, _ = attn_decode(cfg, bp.self_attn, h, pos, sc, "global")
        x = x + sub
        h = norm(cfg, bp.norm_x, x)
        x = x + cross_attn_apply(cfg, bp.cross_attn, h, (ckv["k"], ckv["v"]))
        x = _ffn_half(cfg, bp, x)
    x = norm(cfg, params.final_norm, x)
    logits = logits_from_hidden(cfg, params.embed, None, x)
    return logits[:, 0], cache
