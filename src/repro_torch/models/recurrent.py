"""Linear-recurrence layers: RG-LRU (Griffin/recurrentgemma) and the RWKV-6
time mix and channel mix (port of ``repro/models/recurrent.py``).

The reference runs the full-sequence recurrences as an associative scan
(RG-LRU, in log space) and a sequential ``lax.scan`` (WKV6), and keeps its
Pallas kernels for the TPU. Here every full-sequence recurrence goes to the
kernel wrappers by default: :func:`repro_torch.kernels.rglru.
rglru_linear_scan` and :func:`repro_torch.kernels.rwkv6.wkv6`, which launch
the hand-written CUDA kernels on a CUDA tensor and run their plain versions
(a step-by-step loop) on a CPU tensor. ``recurrence_impl("plain")`` selects
the plain versions explicitly on any device; tests and the smoke script's
comparison use it. The one-token decode steps are plain PyTorch, as in the
reference.

Parameters keep the reference's names, layouts and types: the RG-LRU's
``a_param`` and the time mix's ``w_base``, ``u``, ``ln_x_scale`` and
``ln_x_bias`` are f32 in a bf16 model. Decode steps write the caches in
place (and return the same dict), as the attention layers do.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.ref import ref_rglru, ref_wkv6
from repro_torch.kernels.rglru import rglru_linear_scan
from repro_torch.kernels.rwkv6 import wkv6
from repro_torch.models.common import cdtype, dense_init, param

SQRT_8 = 8.0      # RG-LRU 'c' constant
TS_LORA = 32      # RWKV-6 token-shift lora rank (5 mixes)
DECAY_LORA = 64   # RWKV-6 decay lora rank

_IMPL: ContextVar = ContextVar("recurrence_impl", default="kernel")


@contextlib.contextmanager
def recurrence_impl(name: str):
    """Select the full-sequence recurrences: ``"kernel"`` (the default: the
    kernel wrappers) or ``"plain"`` (their plain versions)."""
    if name not in ("kernel", "plain"):
        raise ValueError(f"recurrence_impl is 'kernel' or 'plain', not "
                         f"{name!r}")
    token = _IMPL.set(name)
    try:
        yield
    finally:
        _IMPL.reset(token)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's ``F.softplus``
    switches to the identity above 20, where the two differ by less than
    half an f32 ulp; this is the reference's formula itself)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token of every position, zero before the first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


# --------------------------------------------------------------------------
# RG-LRU recurrence core
# --------------------------------------------------------------------------

class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        dt = cdtype(cfg)
        w, h = cfg.lru_width, cfg.n_heads
        hd = w // h
        self.a_param = param((w,), torch.float32, device)
        self.wa = param((h, hd, hd), dt, device)   # block-diagonal gates
        self.wx = param((h, hd, hd), dt, device)
        self.ba = param((w,), dt, device)
        self.bx = param((w,), dt, device)

    def reset_parameters(self, generator) -> None:
        # a = exp(-8·softplus(Λ)·σ(...)) starts near 0.9..0.999
        lam = torch.rand(self.a_param.shape, generator=generator,
                         device=self.a_param.device) * (0.999 - 0.9) + 0.9
        self.a_param.copy_(torch.log(torch.exp(-torch.log(lam) / SQRT_8)
                                     - 1.0))     # softplus⁻¹
        hd = self.wa.shape[1]
        dense_init(self.wa, hd, generator)
        dense_init(self.wx, hd, generator)
        self.ba.zero_()
        self.bx.zero_()


def _rglru_gates(p: RGLRU, x: torch.Tensor, h: int):
    """x: [B, S, W] → (log_a, gated_x): the per-step decay (log) and gated
    input, both f32."""
    b, s, w = x.shape
    xh = x.reshape(b, s, h, w // h)
    ra = torch.sigmoid(torch.einsum("bshd,hde->bshe", xh, p.wa)
                       .reshape(b, s, w) + p.ba).float()
    rx = torch.sigmoid(torch.einsum("bshd,hde->bshe", xh, p.wx)
                       .reshape(b, s, w) + p.bx).float()
    log_a = -SQRT_8 * _softplus(p.a_param) * ra
    a2 = torch.exp(2.0 * log_a)
    gated_x = x.float() * rx * torch.sqrt(torch.clamp_min(1.0 - a2, 1e-6))
    return log_a, gated_x


def rglru_scan(p: RGLRU, x: torch.Tensor, h: int) -> torch.Tensor:
    """Full-sequence RG-LRU from a zero state, x: [B, S, W] → [B, S, W] in
    x's type: one ``rglru_linear_scan`` over the decays ``exp(log_a)`` and
    the f32 gated inputs (the reference's associative scan combines the
    same terms in log space)."""
    log_a, gx = _rglru_gates(p, x, h)
    h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                     device=x.device)
    scan = ref_rglru if _IMPL.get() == "plain" else rglru_linear_scan
    ys, _ = scan(torch.exp(log_a), gx, h0)
    return ys.to(x.dtype)


def rglru_step(p: RGLRU, x: torch.Tensor, hstate: torch.Tensor, h: int):
    """One decode step. x: [B, 1, W]; hstate: [B, W] f32. Returns (y
    [B, 1, W] in x's type, the new f32 state)."""
    log_a, gx = _rglru_gates(p, x, h)
    new_h = torch.exp(log_a[:, 0]) * hstate + gx[:, 0]
    return new_h.to(x.dtype)[:, None], new_h


# --------------------------------------------------------------------------
# Griffin recurrent block: in-proj → (gelu gate) ⊙ (conv1d → RG-LRU) → out
# --------------------------------------------------------------------------

class RecurrentBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        dt = cdtype(cfg)
        d, w = cfg.d_model, cfg.lru_width
        self.wi_gate = param((d, w), dt, device)
        self.wi_x = param((d, w), dt, device)
        self.conv_w = param((cfg.conv_width, w), dt, device)
        self.conv_b = param((w,), dt, device)
        self.lru = RGLRU(cfg, device)
        self.wo = param((w, d), dt, device)

    def reset_parameters(self, generator) -> None:
        d, w = self.wi_gate.shape
        dense_init(self.wi_gate, d, generator)
        dense_init(self.wi_x, d, generator)
        dense_init(self.conv_w, self.conv_w.shape[0], generator)
        self.conv_b.zero_()
        self.lru.reset_parameters(generator)
        dense_init(self.wo, w, generator)


def _causal_conv(p: RecurrentBlock, x: torch.Tensor, width: int):
    """Depthwise causal conv1d. x: [B, S, W]; the taps summed in the
    reference's order."""
    s = x.shape[1]
    pads = F.pad(x, (0, 0, width - 1, 0))
    out = pads[:, :s] * p.conv_w[0]
    for i in range(1, width):
        out = out + pads[:, i:i + s] * p.conv_w[i]
    return out + p.conv_b


def recurrent_block_seq(cfg: ModelConfig, p: RecurrentBlock,
                        x: torch.Tensor):
    """The block over a whole sequence. Returns (out [B, S, D], u [B, S, W]
    the conv's input, y [B, S, W] the RG-LRU's output): the prefill builds
    its cache from the last two."""
    gate = F.gelu(x @ p.wi_gate, approximate="tanh")
    u = x @ p.wi_x
    y = rglru_scan(p.lru, _causal_conv(p, u, cfg.conv_width), cfg.n_heads)
    return (gate * y) @ p.wo, u, y


def recurrent_block_apply(cfg: ModelConfig, p: RecurrentBlock,
                          x: torch.Tensor) -> torch.Tensor:
    return recurrent_block_seq(cfg, p, x)[0]


def recurrent_cache_init(cfg: ModelConfig, batch: int, device) -> dict:
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=cdtype(cfg),
                            device=device),
    }


def recurrent_block_step(cfg: ModelConfig, p: RecurrentBlock,
                         x: torch.Tensor, cache: dict):
    """One decode step, x: [B, 1, D]; the cache is written in place."""
    gate = F.gelu(x @ p.wi_gate, approximate="tanh")
    u = x @ p.wi_x                                        # [B, 1, W]
    hist = torch.cat([cache["conv"], u], dim=1)           # [B, cw, W]
    # the reference's einsum: f32 products summed in f32, rounded once
    conv = (hist.float() * p.conv_w.float()).sum(dim=1).to(x.dtype) \
        + p.conv_b
    y, h = rglru_step(p.lru, conv[:, None], cache["h"], cfg.n_heads)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return (gate * y) @ p.wo, cache


# --------------------------------------------------------------------------
# RWKV-6 time mix (WKV6) + channel mix
# --------------------------------------------------------------------------

class TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        dt, f32 = cdtype(cfg), torch.float32
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        # data-dependent token shift (ddlerp) lora: 5 mixes (r, k, v, w, g)
        self.mu_base = param((d,), dt, device)
        self.mu = param((5, d), dt, device)
        self.ts_w1 = param((d, 5 * TS_LORA), dt, device)
        self.ts_w2 = param((5, TS_LORA, d), dt, device)
        self.wr = param((d, d), dt, device)
        self.wk = param((d, d), dt, device)
        self.wv = param((d, d), dt, device)
        self.wg = param((d, d), dt, device)
        # decay lora
        self.w_base = param((d,), f32, device)
        self.w_lora1 = param((d, DECAY_LORA), dt, device)
        self.w_lora2 = param((DECAY_LORA, d), dt, device)
        self.u = param((d // hd, hd), f32, device)   # bonus
        self.wo = param((d, d), dt, device)
        self.ln_x_scale = param((d,), f32, device)
        self.ln_x_bias = param((d,), f32, device)

    def reset_parameters(self, generator) -> None:
        d = self.wr.shape[0]
        self.mu_base.fill_(0.5)
        self.mu.fill_(0.5)
        dense_init(self.ts_w1, d, generator)
        dense_init(self.ts_w2, TS_LORA, generator)
        for w in (self.wr, self.wk, self.wv, self.wg):
            dense_init(w, d, generator)
        self.w_base.fill_(-6.0)
        dense_init(self.w_lora1, d, generator)
        dense_init(self.w_lora2, DECAY_LORA, generator)
        dense_init(self.u, self.u.shape[1], generator)
        dense_init(self.wo, d, generator)
        self.ln_x_scale.fill_(1.0)
        self.ln_x_bias.zero_()


def _ddlerp(p: TimeMix, x: torch.Tensor, x_prev: torch.Tensor):
    """RWKV-6 data-dependent token shift → the 5 mixed inputs (r, k, v, w,
    g)."""
    base = x + (x_prev - x) * p.mu_base
    tshift = torch.tanh(base @ p.ts_w1)
    tshift = tshift.reshape(*tshift.shape[:-1], 5, TS_LORA)
    delta = torch.einsum("bsnl,nld->bsnd", tshift, p.ts_w2)   # [B, S, 5, D]
    mixed = x[..., None, :] + (x_prev[..., None, :] - x[..., None, :]) * (
        p.mu + delta)
    return mixed.unbind(dim=-2)


def _wkv_inputs(cfg: ModelConfig, p: TimeMix, x, x_prev):
    """(r, k, v [B, S, H, hd] in x's type, w [B, S, H, hd] f32 decay in
    (0, 1), g [B, S, D])."""
    hd = cfg.rwkv_head_dim
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r, k, v, g = xr @ p.wr, xk @ p.wk, xv @ p.wv, xg @ p.wg
    w_log = p.w_base + (torch.tanh(xw @ p.w_lora1) @ p.w_lora2).float()
    w = torch.exp(-torch.exp(w_log))
    shp = (*x.shape[:2], x.shape[-1] // hd, hd)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp), g


def _groupnorm_heads(p: TimeMix, y: torch.Tensor, eps: float = 64e-5):
    """Per-head group norm, [B, S, H, hd] → [B, S, D]; the population
    variance (``jnp.var``), eps inside the rsqrt."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    yn = ((y - mu) * torch.rsqrt(var + eps)).flatten(2)
    return yn * p.ln_x_scale + p.ln_x_bias


def rwkv_time_mix_seq(cfg: ModelConfig, p: TimeMix, x: torch.Tensor):
    """The time mix over a whole sequence from a zero state, x: [B, S, D].

    One ``wkv6`` gives both the output and the final state. Returns (out
    [B, S, D], S_final [B, H, hd, hd] f32, w [B, S, H, hd] the decays):
    the prefill builds its cache from the last two. r, k and v go to the
    recurrence in f32, as the reference casts them, so y reaches the
    group norm in f32.
    """
    b, _, d = x.shape
    hd = cfg.rwkv_head_dim
    r, k, v, w, g = _wkv_inputs(cfg, p, x, _shift(x))
    s0 = torch.zeros((b, d // hd, hd, hd), dtype=torch.float32,
                     device=x.device)
    scan = ref_wkv6 if _IMPL.get() == "plain" else wkv6
    y, state = scan(r.float(), k.float(), v.float(), w, p.u, s0)
    y = _groupnorm_heads(p, y).to(x.dtype)
    return (y * F.silu(g)) @ p.wo, state, w


def rwkv_time_mix_apply(cfg: ModelConfig, p: TimeMix,
                        x: torch.Tensor) -> torch.Tensor:
    return rwkv_time_mix_seq(cfg, p, x)[0]


def rwkv_cache_init(cfg: ModelConfig, batch: int, device) -> dict:
    dt = cdtype(cfg)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return {
        "S": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32,
                         device=device),
        "x_prev_tm": torch.zeros((batch, d), dtype=dt, device=device),
        "x_prev_cm": torch.zeros((batch, d), dtype=dt, device=device),
    }


def rwkv_time_mix_step(cfg: ModelConfig, p: TimeMix, x: torch.Tensor,
                       cache: dict):
    """One decode step, x: [B, 1, D]; the cache is written in place."""
    r, k, v, w, g = _wkv_inputs(cfg, p, x, cache["x_prev_tm"][:, None])
    r1, k1, v1, w1 = (z[:, 0].float() for z in (r, k, v, w))
    state = cache["S"]
    kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
    y = torch.einsum("bhk,bhkv->bhv", r1, state + p.u[None, :, :, None] * kv)
    state.copy_(w1[..., None] * state + kv)
    cache["x_prev_tm"].copy_(x[:, 0])
    y = _groupnorm_heads(p, y[:, None]).to(x.dtype)
    return (y * F.silu(g)) @ p.wo, cache


# ---- RWKV channel mix -------------------------------------------------------

class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        dt = cdtype(cfg)
        d, m = cfg.d_model, cfg.d_ff
        self.mu_k = param((d,), dt, device)
        self.mu_r = param((d,), dt, device)
        self.wk = param((d, m), dt, device)
        self.wv = param((m, d), dt, device)
        self.wr = param((d, d), dt, device)

    def reset_parameters(self, generator) -> None:
        d, m = self.wk.shape
        self.mu_k.fill_(0.5)
        self.mu_r.fill_(0.5)
        dense_init(self.wk, d, generator)
        dense_init(self.wv, m, generator)
        dense_init(self.wr, d, generator)


def _channel_mix(p: ChannelMix, x: torch.Tensor, x_prev: torch.Tensor):
    xk = x + (x_prev - x) * p.mu_k
    xr = x + (x_prev - x) * p.mu_r
    k = torch.square(F.relu(xk @ p.wk))
    return torch.sigmoid(xr @ p.wr) * (k @ p.wv)


def rwkv_channel_mix_apply(cfg: ModelConfig, p: ChannelMix,
                           x: torch.Tensor) -> torch.Tensor:
    return _channel_mix(p, x, _shift(x))


def rwkv_channel_mix_step(cfg: ModelConfig, p: ChannelMix, x: torch.Tensor,
                          cache: dict):
    """One decode step, x: [B, 1, D]; the cache is written in place."""
    y = _channel_mix(p, x, cache["x_prev_cm"][:, None])
    cache["x_prev_cm"].copy_(x[:, 0])
    return y, cache
