"""FFN layers: the gated-linear-unit dense FFN and the capacity-based
mixture of experts (port of ``repro/models/ffn.py``).

The MoE dispatches by scatter, as the reference: every (token, choice) is
ranked within its expert by a stable sort over expert ids, scattered into
an ``[E·cap, D]`` buffer (dropped past the capacity), the experts run as
batched matrix products over the expert axis, and their outputs are
gathered back and combined with the gates. The reference computes this
outside any Pallas kernel (``einsum`` and scatters), so it is plain
PyTorch on both devices.
"""

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


# --------------------------------------------------------------------------
# mixture of experts
# --------------------------------------------------------------------------

class MoE(nn.Module):
    """``router`` (f32 in any model) ``[d, e]``; ``wi_gate``/``wi_up``
    ``[e, d, m]``; ``wo`` ``[e, m, d]``; with shared experts a dense
    ``shared`` FFN of width ``moe_d_ff · n_shared_experts``."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        dt = cdtype(cfg)
        d, e, m = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = param((d, e), torch.float32, device)
        self.wi_gate = param((e, d, m), dt, device)
        self.wi_up = param((e, d, m), dt, device)
        self.wo = param((e, m, d), dt, device)
        if cfg.n_shared_experts > 0:
            self.shared = FFN(cfg, device,
                              d_ff=cfg.moe_d_ff * cfg.n_shared_experts)

    def reset_parameters(self, generator) -> None:
        e, d, m = self.wi_gate.shape
        dense_init(self.router, d, generator)
        dense_init(self.wi_gate, d, generator)
        dense_init(self.wi_up, d, generator)
        dense_init(self.wo, m, generator)
        if hasattr(self, "shared"):
            self.shared.reset_parameters(generator)


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(cap, cfg.top_k)


def moe_route(cfg: ModelConfig, p: MoE, xt: torch.Tensor):
    """Routing of ``xt [T, D]``: (probs [T, E] f32, gate [T, k] f32,
    expert [T, k], ranks [T, k], keep [T, k], cap).

    The top k is taken by a stable descending sort, so that on tied
    probabilities the lower expert id comes first, as ``jax.lax.top_k``
    puts it (``torch.topk`` promises no order). ``ranks`` is each choice's
    place in its expert's buffer: the index in a stable sort by expert id
    less the start of its expert's run (a ``cummax``). Ids are int64 where
    the reference's are int32."""
    t = xt.shape[0]
    k = cfg.top_k
    cap = moe_capacity(cfg, t)
    probs = torch.softmax(xt.float() @ p.router, dim=-1)          # [T, E]
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :k], expert[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = expert.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(t * k, device=xt.device)
    run_start = torch.ones_like(sorted_e, dtype=torch.bool)
    run_start[1:] = sorted_e[1:] != sorted_e[:-1]
    start_idx = torch.cummax(torch.where(run_start, idx, 0), dim=0).values
    ranks = torch.empty_like(idx).index_copy_(0, order, idx - start_idx)
    ranks = ranks.view(t, k)
    return probs, gate, expert, ranks, ranks < cap, cap


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """Returns (y, aux_loss). x: [B, S, D].

    The capacity counts the ``B·S`` tokens of this call, so tokens of one
    call compete for the experts' buffers (in decode: every slot, idle ones
    included). A dropped choice goes to row ``E·cap`` of a buffer one row
    longer, which the experts never see, and gathers a zero row back, as
    the reference's out-of-range scatter (``mode="drop"``) and padded
    gather do."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    probs, gate, expert, ranks, keep, cap = moe_route(cfg, p, xt)
    slot = torch.where(keep, expert * cap + ranks, e * cap)

    # tokens into the expert buffers; each kept slot receives one token
    src = xt.repeat_interleave(k, dim=0) * keep.reshape(-1, 1).to(x.dtype)
    buf = x.new_zeros((e * cap + 1, d)).index_add(0, slot.reshape(-1), src)
    buf = buf[: e * cap].view(e, cap, d)

    # the experts, batched over the expert axis
    g = _act(cfg.activation, torch.bmm(buf, p.wi_gate))
    u = torch.bmm(buf, p.wi_up)
    out = torch.bmm(g * u, p.wo).reshape(e * cap, d)

    # gather back; the gates are cast to the activations' type first
    out_pad = torch.cat([out, out.new_zeros((1, d))])
    gathered = out_pad[slot]                                       # [T, k, D]
    w = (gate * keep).to(gathered.dtype)
    y = torch.bmm(w[:, None, :], gathered).view(b, s, d)

    if cfg.n_shared_experts > 0:
        y = y + ffn_apply(cfg, p.shared, x)

    # switch-style load-balance aux loss, f32
    me = probs.mean(dim=0)
    ce = F.one_hot(expert[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)
    return y, aux
