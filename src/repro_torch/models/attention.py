"""Attention: GQA with RoPE, sliding windows, logit softcaps, and KV caches
(ring-buffered for windowed layers); MLA with its latent cache and
absorbed decode; cross attention (the encoder-decoder's). Port of
``repro/models/attention.py``. With ``cfg.mrope_sections`` and an
``mrope_pos [3, B, S]`` the rotary embedding is M-RoPE; without
``mrope_pos`` it is plain RoPE, as the reference falls back to it.

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

MLA's full-sequence attention (:func:`mla_attention`) has q/k head dims
``dn + dr`` and v head dim ``dv`` that the kernel does not take (one D
from :data:`~repro_torch.kernels.flash_attention.HEAD_DIMS` for all
three). On the kernel route q, k and v are zero-padded to the smallest
such D that holds them, which leaves every score and every output column
unchanged, and the context is sliced back to ``dv``; a D past the largest
raises. MLA's absorbed decode is plain PyTorch on both devices, as the
reference computes it outside any kernel.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
from repro_torch.models.common import (
    Norm,
    apply_mrope,
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


def _rope_qk(cfg: ModelConfig, q, k, positions, mrope_pos=None):
    if cfg.rope_theta <= 0.0:
        return q, k
    if cfg.mrope_sections and mrope_pos is not None:
        return (apply_mrope(q, mrope_pos, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, mrope_pos, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _out(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", ctx, wo) as one matrix product."""
    h, hd, d = wo.shape
    return ctx.reshape(*ctx.shape[:2], h * hd) @ wo.reshape(h * hd, d)


def attn_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor,
               positions: torch.Tensor, kind: str = "global",
               mrope_pos: torch.Tensor | None = None,
               causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill compute)."""
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions, mrope_pos)
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
                 positions: torch.Tensor, cache: dict, kind: str,
                 mrope_pos: torch.Tensor | None = None):
    """Full-seq attention + fill the cache in place (ring-rolled for local
    layers whose window is shorter than the prompt)."""
    s = x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions, mrope_pos)
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
                pos: torch.Tensor, cache: dict, kind: str,
                mrope_pos: torch.Tensor | None = None):
    """Single-token decode against the cache (written in place).
    x [B, 1, D], pos [B] current position, mrope_pos [3, B, 1] or None."""
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, pos[:, None], mrope_pos)

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


# --------------------------------------------------------------------------
# cross attention (the encoder-decoder's decoder)
# --------------------------------------------------------------------------

class CrossAttention(nn.Module):
    """``wq``, ``wk``, ``wv`` ``[d, H, hd]`` and ``wo`` ``[H, hd, d]``: K
    and V have ``n_heads`` heads (no grouping), no bias, no RoPE."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        dt = cdtype(cfg)
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        self.wq = param((d, h, hd), dt, device)
        self.wk = param((d, h, hd), dt, device)
        self.wv = param((d, h, hd), dt, device)
        self.wo = param((h, hd, d), dt, device)

    def reset_parameters(self, generator) -> None:
        d, h, hd = self.wq.shape
        for w in (self.wq, self.wk, self.wv):
            dense_init(w, d, generator)
        dense_init(self.wo, h * hd, generator)


def cross_attn_kv(cfg: ModelConfig, p: CrossAttention, enc: torch.Tensor):
    """The encoder states' keys and values ``[B, T, H, hd]``, each a fresh
    contiguous tensor (so the kernel takes it as it is)."""
    return _proj(enc, p.wk), _proj(enc, p.wv)


def cross_attn_apply(cfg: ModelConfig, p: CrossAttention, x: torch.Tensor,
                     kv: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Non-causal attention of ``x [B, S, D]`` (S = 1 in decode) over the
    encoder's ``kv``, through :func:`full_attention`."""
    k, v = kv
    ctx = full_attention(_proj(x, p.wq), k, v, causal=False, window=0,
                         scale=cfg.head_dim**-0.5)
    return _out(ctx, p.wo)


# --------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v2, minicpm3)
# --------------------------------------------------------------------------

class MLA(nn.Module):
    """``q_a``, ``q_a_norm``, ``q_b`` (with a q LoRA rank) or ``q_proj``;
    ``kv_a``, ``kv_a_norm``, ``kv_b``; ``wo``."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        dt = cdtype(cfg)
        d, h = cfg.d_model, cfg.n_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        if cfg.q_lora_rank > 0:
            self.q_a = param((d, cfg.q_lora_rank), dt, device)
            self.q_a_norm = Norm(cfg, cfg.q_lora_rank, device)
            self.q_b = param((cfg.q_lora_rank, h, dn + dr), dt, device)
        else:
            self.q_proj = param((d, h, dn + dr), dt, device)
        self.kv_a = param((d, cfg.kv_lora_rank + dr), dt, device)
        self.kv_a_norm = Norm(cfg, cfg.kv_lora_rank, device)
        self.kv_b = param((cfg.kv_lora_rank, h, dn + dv), dt, device)
        self.wo = param((h, dv, d), dt, device)

    def reset_parameters(self, generator) -> None:
        d = self.kv_a.shape[0]
        if hasattr(self, "q_a"):
            dense_init(self.q_a, d, generator)
            self.q_a_norm.reset_parameters()
            dense_init(self.q_b, self.q_b.shape[0], generator)
        else:
            dense_init(self.q_proj, d, generator)
        dense_init(self.kv_a, d, generator)
        self.kv_a_norm.reset_parameters()
        dense_init(self.kv_b, self.kv_b.shape[0], generator)
        h, dv, _ = self.wo.shape
        dense_init(self.wo, h * dv, generator)


def _mla_q(cfg: ModelConfig, p: MLA, x, positions):
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank > 0:
        qa = rmsnorm(p.q_a_norm.scale, x @ p.q_a, cfg.norm_eps)
        q = _proj(qa, p.q_b)
    else:
        q = _proj(x, p.q_proj)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(cfg: ModelConfig, p: MLA, x, positions):
    """The latent ``c [B, S, L]`` and the shared rope key ``[B, S, dr]``."""
    ckv = x @ p.kv_a
    c, k_rope = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    c = rmsnorm(p.kv_a_norm.scale, c, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c, k_rope[:, :, 0, :]


def mla_head_dim(d: int) -> int:
    """The smallest kernel head dim that holds ``d`` columns."""
    for hd in HEAD_DIMS:
        if hd >= d:
            return hd
    raise ValueError(f"MLA head dims need {d} columns; the flash kernel "
                     f"takes at most {HEAD_DIMS[-1]}")


def mla_attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal attention of ``q``/``k [B, S, H, dn + dr]`` and ``v
    [B, S, H, dv]``. The kernel route zero-pads all three to one head dim
    the kernel takes and slices the context back to ``dv``; under
    ``attention_impl("xla")`` the plain path runs on the unpadded
    tensors."""
    if _ATTN_IMPL.get() != "kernel":
        return full_attention(q, k, v, causal=True, window=0, scale=scale)
    dqk, dv = q.shape[-1], v.shape[-1]
    hd = mla_head_dim(max(dqk, dv))
    q, k, v = (F.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v))
    ctx = flash_attention(q, k, v, causal=True, window=0, softcap=0.0,
                          scale=scale, work_dims=(dqk, dv))
    return ctx[..., :dv]


def _mla_seq(cfg: ModelConfig, p: MLA, x, positions):
    """Full-sequence MLA (the naive expansion); returns (y, c, k_rope)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c, k_rope = _mla_ckv(cfg, p, x, positions)
    kv = _proj(c, p.kv_b)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    h = k_nope.shape[2]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    ctx = mla_attention(q, k, v, scale=(dn + dr) ** -0.5)
    return _out(ctx, p.wo), c, k_rope


def mla_apply(cfg: ModelConfig, p: MLA, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA (train / prefill compute)."""
    return _mla_seq(cfg, p, x, positions)[0]


def mla_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                   device) -> dict[str, torch.Tensor]:
    dt = cdtype(cfg)
    return {
        "c": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dt,
                         device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                              dtype=dt, device=device),
        "pos": torch.full((batch, max_seq), -1, dtype=torch.int32,
                          device=device),
    }


def mla_prefill(cfg: ModelConfig, p: MLA, x: torch.Tensor,
                positions: torch.Tensor, cache: dict):
    """Full-seq MLA + the prompt's latents written into the cache in
    place."""
    y, c, k_rope = _mla_seq(cfg, p, x, positions)
    s = x.shape[1]
    cache["c"][:, :s] = c
    cache["k_rope"][:, :s] = k_rope
    cache["pos"][:, :s] = positions.to(torch.int32)
    return y, cache


def mla_decode(cfg: ModelConfig, p: MLA, x: torch.Tensor, pos: torch.Tensor,
               cache: dict):
    """Absorbed-matrix MLA decode against the latent cache (written in
    place at ``pos``; MLA has no ring). A write at ``pos >= max_seq`` is
    dropped, as the reference's scatter drops it."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    b = x.shape[0]
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])     # [B,1,H,dn],[B,1,H,dr]
    c_new, kr_new = _mla_ckv(cfg, p, x, pos[:, None])    # [B,1,L],[B,1,dr]

    cc, ckr, cp = cache["c"], cache["k_rope"], cache["pos"]
    bi = torch.arange(b, device=x.device)
    inside = ((pos >= 0) & (pos < cc.shape[1]))[:, None]
    slot = pos.clamp(0, cc.shape[1] - 1).long()
    cc[bi, slot] = torch.where(inside, c_new[:, 0], cc[bi, slot])
    ckr[bi, slot] = torch.where(inside, kr_new[:, 0], ckr[bi, slot])
    cp[bi, slot] = torch.where(inside[:, 0], pos.to(torch.int32), cp[bi, slot])

    w_uk = p.kv_b[..., :dn]   # [L, H, dn]
    w_uv = p.kv_b[..., dn:]   # [L, H, dv]
    q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope, w_uk)
    scores = (
        torch.einsum("bqhl,bsl->bhqs", q_abs.float(), cc.float())
        + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), ckr.float())
    ) * (dn + dr) ** -0.5
    valid = (cp >= 0) & (cp <= pos[:, None])
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    prob = torch.softmax(scores, dim=-1).to(cc.dtype)
    ctx_c = torch.einsum("bhqs,bsl->bqhl", prob, cc)
    ctx = torch.einsum("bqhl,lhv->bqhv", ctx_c, w_uv)
    return _out(ctx, p.wo), cache
