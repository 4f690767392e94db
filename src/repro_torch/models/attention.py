"""Attention: GQA with RoPE, sliding windows, logit softcaps, and KV caches
(ring-buffered for windowed layers). Port of the GQA part of
``repro/models/attention.py``; MLA and cross attention come with their
families (ROADMAP queue 1).

Layouts as the reference: activations ``[B, S, D]``; per-head tensors
``[B, S, H, hd]``; KV caches ``[B, S_cache, K, hd]`` with an entry-position
array ``[B, S_cache]`` (−1 = empty). Windowed ("local") layers allocate
``S_cache == window`` and write decode entries at ``pos % window``.

Unlike the reference's pure functions, prefill and decode write the cache
in place (and return the same dict): a full-width cache is gigabytes.

Every full-sequence attention goes through :func:`full_attention`. By
default it calls the flash attention kernel wrapper
(:func:`repro_torch.kernels.flash_attention.flash_attention`), which
launches the CUDA kernel on a CUDA tensor and runs its plain version on a
CPU tensor. ``attention_impl("xla")`` selects the plain path of the
reference's default (``sdpa``, tiled ``flash_xla`` above 2048 tokens)
explicitly; tests and the smoke script's comparison use it.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (
    Norm,
    apply_rope,
    cdtype,
    dense_init,
    param,
    rmsnorm,
    softcap,
)

NEG_INF = -2.0**30


# --------------------------------------------------------------------------
# scaled dot-product attention with grouped KV heads (no KV repeat in memory)
# --------------------------------------------------------------------------

def sdpa(q, k, v, mask, scale: float, cap: float = 0.0) -> torch.Tensor:
    """q [B, Sq, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv], mask
    [B, Sq, Sk] bool or None. Scores and softmax in f32; the probabilities
    are cast to ``v``'s type for the product with ``v``."""
    b, sq, h, d = q.shape
    kheads = k.shape[2]
    g = h // kheads
    qg = q.reshape(b, sq, kheads, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * scale
    scores = softcap(scores, cap)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return ctx.reshape(b, sq, h, v.shape[-1])


def causal_mask(sq: int, sk: int, window: int = 0, device=None):
    """[1, Sq, Sk] bool; queries at positions sk-sq..sk-1."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    m = qpos >= kpos
    if window > 0:
        m &= (qpos - kpos) < window
    return m[None]


# --------------------------------------------------------------------------
# tiled flash attention in plain PyTorch (the reference's ``flash_xla``)
#
# Python-unrolled q×kv tiles with online softmax: bounded score temps and
# O(S·window) cost for local layers (fully masked tiles are skipped). The
# reference asserts that the tiles divide the sequence; here the last tile
# of each axis may be shorter, so any prompt length runs.
# --------------------------------------------------------------------------

_FLASH_TILE = 2048


def flash_xla(q, k, v, *, causal: bool, window: int, scale: float,
              cap: float = 0.0, tile_q: int = _FLASH_TILE,
              tile_k: int = _FLASH_TILE) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kheads = k.shape[2]
    g = h // kheads
    if sq <= tile_q and sk <= tile_k:
        mask = causal_mask(sq, sk, window, q.device) if causal else None
        return sdpa(q, k, v, mask, scale, cap)

    dev = q.device
    offset = sk - sq  # query absolute position offset
    out_chunks = []
    for qs in range(0, sq, tile_q):
        qe = min(qs + tile_q, sq)
        cq = qe - qs
        qc = q[:, qs:qe].reshape(b, cq, kheads, g, d)
        m_run = torch.full((b, kheads, g, cq, 1), NEG_INF, device=dev)
        l_run = torch.zeros((b, kheads, g, cq, 1), device=dev)
        acc = torch.zeros((b, cq, kheads, g, v.shape[-1]), device=dev)
        for ks in range(0, sk, tile_k):
            ke = min(ks + tile_k, sk)
            if causal and qe - 1 + offset < ks:
                continue  # tile fully in the future
            if window > 0 and qs + offset - (ke - 1) >= window:
                continue  # tile fully outside the window
            s = torch.einsum("bqkgd,bskd->bkgqs", qc.float(),
                             k[:, ks:ke].float()) * scale
            s = softcap(s, cap)
            qpos = torch.arange(qs, qe, device=dev)[:, None] + offset
            kpos = torch.arange(ks, ke, device=dev)[None, :]
            msk = torch.ones((cq, ke - ks), dtype=torch.bool, device=dev)
            if causal:
                msk &= qpos >= kpos
            if window > 0:
                msk &= (qpos - kpos) < window
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new)
            l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha.permute(0, 3, 1, 2, 4) + torch.einsum(
                "bkgqs,bskd->bqkgd", p.to(v.dtype), v[:, ks:ke]
            ).float()
            m_run = m_new
        l_safe = l_run.clamp_min(1e-30).permute(0, 3, 1, 2, 4)
        out_chunks.append((acc / l_safe).to(q.dtype))
    out = torch.cat(out_chunks, dim=1)
    return out.reshape(b, sq, h, v.shape[-1])


_ATTN_IMPL: ContextVar = ContextVar("attn_impl", default="kernel")


@contextlib.contextmanager
def attention_impl(name: str):
    """Select the full-sequence attention path: ``"kernel"`` (the default:
    the flash attention kernel wrapper) or ``"xla"`` (the plain path)."""
    if name not in ("kernel", "xla"):
        raise ValueError(f"attention_impl is 'kernel' or 'xla', not {name!r}")
    token = _ATTN_IMPL.set(name)
    try:
        yield
    finally:
        _ATTN_IMPL.reset(token)


def full_attention(q, k, v, *, causal: bool, window: int, scale: float,
                   cap: float = 0.0) -> torch.Tensor:
    """Dispatch: the flash attention kernel wrapper by default; under
    ``attention_impl("xla")`` tiled ``flash_xla`` for long sequences,
    plain ``sdpa`` otherwise."""
    if _ATTN_IMPL.get() == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cap, scale=scale)
    if q.shape[1] > _FLASH_TILE or k.shape[1] > _FLASH_TILE:
        return flash_xla(q, k, v, causal=causal, window=window, scale=scale,
                         cap=cap)
    mask = causal_mask(q.shape[1], k.shape[1], window, q.device) \
        if causal else None
    return sdpa(q, k, v, mask, scale, cap)


# --------------------------------------------------------------------------
# standard (GQA) attention layer
# --------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        dt = cdtype(cfg)
        d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = param((d, h, hd), dt, device)
        self.wk = param((d, kh, hd), dt, device)
        self.wv = param((d, kh, hd), dt, device)
        self.wo = param((h, hd, d), dt, device)
        if cfg.qkv_bias:
            self.bq = param((h, hd), dt, device)
            self.bk = param((kh, hd), dt, device)
            self.bv = param((kh, hd), dt, device)
        if cfg.qk_norm:
            self.q_norm = Norm(cfg, hd, device)
            self.k_norm = Norm(cfg, hd, device)

    def reset_parameters(self, generator) -> None:
        d, h, hd = self.wq.shape
        dense_init(self.wq, d, generator)
        dense_init(self.wk, d, generator)
        dense_init(self.wv, d, generator)
        dense_init(self.wo, h * hd, generator)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        if hasattr(self, "q_norm"):
            self.q_norm.reset_parameters()
            self.k_norm.reset_parameters()


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).view(*x.shape[:-1], h, hd)


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor):
    q = _proj(x, p.wq)
    k = _proj(x, p.wk)
    v = _proj(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm.scale, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm.scale, k, cfg.norm_eps)
    return q, k, v


def _rope_qk(cfg: ModelConfig, q, k, positions):
    if cfg.rope_theta <= 0.0:
        return q, k
    if cfg.mrope_sections:
        raise NotImplementedError(
            "M-RoPE comes with the qwen2-vl slice (ROADMAP queue 1)")
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _out(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", ctx, wo) as one matrix product."""
    h, hd, d = wo.shape
    return ctx.reshape(*ctx.shape[:2], h * hd) @ wo.reshape(h * hd, d)


def attn_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor,
               positions: torch.Tensor, kind: str = "global",
               causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill compute)."""
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    window = cfg.window if kind == "local" else 0
    ctx = full_attention(q, k, v, causal=causal, window=window,
                         scale=cfg.head_dim**-0.5, cap=cfg.attn_logit_softcap)
    return _out(ctx, p.wo)


# --------------------------------------------------------------------------
# KV cache (standard layers)
# --------------------------------------------------------------------------

def kv_cache_init(cfg: ModelConfig, batch: int, max_seq: int, kind: str,
                  device) -> dict[str, torch.Tensor]:
    s = min(max_seq, cfg.window) if (kind == "local" and cfg.window) \
        else max_seq
    dt = cdtype(cfg)
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, s), -1, dtype=torch.int32, device=device),
    }


def attn_prefill(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict, kind: str):
    """Full-seq attention + fill the cache in place (ring-rolled for local
    layers whose window is shorter than the prompt)."""
    s = x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    window = cfg.window if kind == "local" else 0
    ctx = full_attention(q, k, v, causal=True, window=window,
                         scale=cfg.head_dim**-0.5, cap=cfg.attn_logit_softcap)
    y = _out(ctx, p.wo)

    s_cache = cache["k"].shape[1]
    pos = positions.to(torch.int32)
    if s <= s_cache:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["pos"][:, :s] = pos
    else:
        # keep only the last s_cache entries, at slot = pos % s_cache
        shift = s % s_cache
        cache["k"].copy_(torch.roll(k[:, s - s_cache:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, s - s_cache:], shift, dims=1))
        cache["pos"].copy_(torch.roll(pos[:, s - s_cache:], shift, dims=1))
    return y, cache


def attn_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                pos: torch.Tensor, cache: dict, kind: str):
    """Single-token decode against the cache (written in place).
    x [B, 1, D], pos [B] current position."""
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, pos[:, None])

    s_cache = cache["k"].shape[1]
    slot = (pos % s_cache).long()
    bi = torch.arange(b, device=x.device)
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    ck[bi, slot] = k[:, 0]
    cv[bi, slot] = v[:, 0]
    cp[bi, slot] = pos.to(torch.int32)

    age = pos[:, None] - cp                       # [B, S_cache]
    valid = (cp >= 0) & (age >= 0)
    if kind == "local" and cfg.window:
        valid &= age < cfg.window
    ctx = sdpa(q, ck, cv, valid[:, None, :], cfg.head_dim**-0.5,
               cfg.attn_logit_softcap)
    return _out(ctx, p.wo), cache
