"""Shared model components: norms, RoPE, embeddings, initializers.

The port of ``repro/models/common.py``. Parameters live in ``nn.Module``
containers whose attribute names are the reference's dictionary keys and
whose tensors keep the reference's layouts (``wq`` is ``[d, H, hd]``), so
weights carry across one to one (:mod:`repro_torch.convert`). The
functions take those containers and mirror the reference's functions.

Parameters are created with ``requires_grad=False``, as serving needs no
gradient; the train step (:mod:`repro_torch.train.step`) switches them on.
Initial values are drawn from an explicit ``torch.Generator`` on the
parameters' device; they follow the reference's distributions, not its
numbers (a JAX key and a torch generator give different streams).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.core import xmath
from repro_torch.sharding.ctx import constrain, tp_size

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter (filled by an init or the converter)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def _truncated_normal(t: torch.Tensor, std: float, generator) -> None:
    """Fill ``t`` with N(0, 1) truncated to [-2, 2], times ``std``, drawn
    in f32 and cast (the reference draws in f32 and casts too)."""
    x = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.copy_(x * std)


def dense_init(t: torch.Tensor, in_axis_size: int, generator) -> None:
    """Truncated-normal fan-in init (LeCun-style)."""
    _truncated_normal(t, in_axis_size ** -0.5, generator)


def embed_init(t: torch.Tensor, generator) -> None:
    _truncated_normal(t, 0.02, generator)


# --------------------------------------------------------------------------
# norms — computed in f32 regardless of activation dtype
# --------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm (``scale``, zero-init: gemma-style ``1 + scale``) or
    LayerNorm (``scale`` one-init, ``bias`` zero-init)."""

    def __init__(self, cfg: ModelConfig, d: int, device) -> None:
        super().__init__()
        dt = cdtype(cfg)
        self.kind = cfg.norm_kind
        self.scale = param((d,), dt, device)
        if self.kind == "layernorm":
            self.bias = param((d,), dt, device)

    def reset_parameters(self) -> None:
        if self.kind == "layernorm":
            self.scale.fill_(1.0)
            self.bias.zero_()
        else:
            self.scale.zero_()


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    # gemma-style (1 + scale): zero-init scale == identity
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_kind == "layernorm":
        return layernorm(p.scale, p.bias, x, cfg.norm_eps)
    return rmsnorm(p.scale, x, cfg.norm_eps)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=device)
                  / half)
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, D]; positions: [B, S] int. Split-half convention, f32
    angles; the result in ``x``'s type."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # [half]
    ang = positions[..., None].float() * freqs                  # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: [B, S, H, D]; positions: [3, B, S]
    (temporal, height, width streams). ``sections`` are half-dim section
    lengths summing to D // 2; section ``i`` takes its angles from stream
    ``i``. With three equal streams this is :func:`apply_rope`."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # [half]
    ang_each = positions[..., None].float() * freqs             # [3,B,S,half]
    bounds = [0]
    for sec in sections:
        bounds.append(bounds[-1] + sec)
    ang = torch.cat([ang_each[i, ..., bounds[i]:bounds[i + 1]]
                     for i in range(len(sections))], dim=-1)    # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal embedding at integer positions ``pos``
    ``[...]`` → ``[..., d]`` f32: sines then cosines of ``pos · exp(-ln
    10000 · i / (d/2 - 1))``. The frequencies are computed as the
    reference's compiler computes them (the constant ``-ln 10000 / (d/2 -
    1)`` folded first, then :func:`repro_torch.core.xmath.exp`), so they
    are its float32 numbers bit for bit: an ulp of a frequency moves the
    angle at position 1500 by about 2e-4."""
    half = d // 2
    coef = (torch.tensor(-math.log(10000.0), dtype=torch.float32)
            / torch.tensor(half - 1, dtype=torch.float32))
    scale = xmath.exp(coef * torch.arange(half, dtype=torch.float32))
    ang = pos.float()[..., None] * scale.to(pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(n: int, d: int, device) -> torch.Tensor:
    """The fixed sinusoidal table ``[n, d]`` f32 of positions 0..n-1."""
    return sinusoidal_at(torch.arange(n, device=device), d)


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        self.table = param((cfg.vocab_size, cfg.d_model), cdtype(cfg), device)

    def reset_parameters(self, generator) -> None:
        embed_init(self.table, generator)


def embed_tokens(cfg: ModelConfig, p: Embedding, tokens: torch.Tensor):
    x = p.table[tokens]
    # the scale is cast to the activation type before it multiplies
    if cfg.emb_scale == "sqrt_d":
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    elif cfg.emb_scale == "const12":
        x = x * torch.tensor(12.0, dtype=x.dtype, device=x.device)
    return x


class _HalfProductF32(torch.autograd.Function):
    """``x2 [N, d] @ w[V, d]ᵀ`` of two bf16 (or f16) CUDA tensors as one GEMM
    with an f32 output. ``aten::mm.dtype`` has no autograd formula, so the
    backward is written here: what the reference's f32 einsum transposes
    to, both products in f32, each cast back to its operand's type."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ w.float()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gw = (g.t() @ x2.float()).to(w.dtype)
        return gx, gw


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., d] @ w[V, d]ᵀ`` in f32, as the reference's
    ``einsum(x.astype(f32), w.astype(f32))``.

    A bf16 product is exact in f32, so for a bf16 table on the card this
    is one bf16 GEMM that accumulates and writes in f32
    (``torch.mm(..., out_dtype=float32)``, with its backward in
    :class:`_HalfProductF32`): no f32 copy of the table (2.36 GB for
    gemma2-2b's tied 256,000 × 2,304 table) is made per forward call. On
    the CPU, which runs only reduced models, both operands are cast to f32.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype == w.dtype and w.dtype in (torch.bfloat16,
                                                        torch.float16):
        out = _HalfProductF32.apply(x2, w)
    else:
        out = x2.float() @ w.float().t()
    return out.reshape(*lead, w.shape[0])


def logits_from_hidden(cfg: ModelConfig, embed: Embedding, head,
                       x: torch.Tensor) -> torch.Tensor:
    """Final projection to the vocabulary, in f32, with the final softcap.

    Under an active mesh the vocabulary is padded up to a multiple of its
    model axis (vocab-parallel logits, as the reference's), so that an
    indivisible vocabulary (whisper's 51,866, minicpm3's 73,448) still
    shards; the pad columns carry -2^30, which softmax and the loss
    ignore, and are kept. With no active mesh (model axis 1) nothing is
    padded."""
    w = embed.table if (cfg.tie_embeddings or head is None) else head.w.t()
    v = w.shape[0]
    pad = (-v) % tp_size()
    if pad:
        w = torch.cat([w, w.new_zeros((pad, w.shape[1]))], dim=0)
    logits = softcap(f32_product(x, w), cfg.final_logit_softcap)
    if pad:
        neg = torch.full((pad,), -2.0**30, dtype=logits.dtype,
                         device=logits.device)
        logits = logits + torch.cat([logits.new_zeros((v,)), neg])
    # the vocabulary stays sharded over the model axis: the loss consumes
    # sharded logits without gathering the full [B, S, V] f32 tensor
    return constrain(logits, "dp", *([None] * (logits.ndim - 2)), "tp")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0.0 else x
