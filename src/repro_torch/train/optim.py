"""AdamW + global-norm clipping + LR schedules (port of
``repro/train/optim.py``).

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(lm.named_parameters())`` for a model). The moments live on the
parameters' device in ``opt_state_dtype``; the update math runs in f32
whatever the parameters' type, with every constant an f32 tensor as the
reference's weakly typed Python scalars become f32 there. The update is
applied in place. Includes the reference's int8 error-feedback gradient
compression hook (off by default, exercised in tests).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.config.base import TrainConfig

class AdamWState(NamedTuple):
    step: torch.Tensor               # int32 scalar
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def adamw_init(params: dict[str, torch.Tensor],
               dtype: str = "float32") -> AdamWState:
    dt = getattr(torch, dtype)   # "float32", "bfloat16", "float16"
    dev = next(iter(params.values())).device

    def zeros():
        return {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                for k, p in params.items()}

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = torch.minimum(s / max(tc.warmup_steps, 1), _f32(1.0, s))
    if tc.schedule == "constant":
        decay = _f32(1.0, s)
    else:
        frac = torch.clamp(
            (s - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
            0.0, 1.0)
        if tc.schedule == "linear":
            decay = 1.0 - frac
        else:  # cosine
            decay = 0.5 * (1.0 + torch.cos(_f32(math.pi, s) * frac))
    return _f32(tc.learning_rate, s) * warm * decay


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    # an f32 numerator: torch's ``float / tensor`` is a reciprocal times
    # the float, which rounds differently from the reference's division
    scale = torch.minimum(_f32(1.0, norm),
                          _f32(max_norm, norm) / torch.clamp_min(norm, 1e-9))
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], state: AdamWState,
                 params: dict[str, torch.Tensor], tc: TrainConfig,
                 ranks: dict[str, int] | None = None):
    """One AdamW step, in place on ``params`` and ``state``'s moments.

    Returns ``(params, new state, {"grad_norm", "lr"})``. Decoupled weight
    decay applies to a leaf of rank ≥ 2, as in the reference. ``ranks``
    gives each leaf's rank in the reference's tree where it is not the
    tensor's own: the reference stacks its scanned layers, so a norm scale
    of such a layer is a rank-2 leaf there and is decayed
    (:func:`repro_torch.models.registry.reference_ranks`).
    """
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    step = state.step + 1
    lr = lr_schedule(tc, step)
    b1, b2 = _f32(tc.beta1, lr), _f32(tc.beta2, lr)
    one_m_b1, one_m_b2 = _f32(1 - tc.beta1, lr), _f32(1 - tc.beta2, lr)
    sf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** sf
    bc2 = 1.0 - b2 ** sf
    eps = _f32(tc.eps, lr)
    shrink = 1.0 - lr * _f32(tc.weight_decay, lr)
    for name, p in params.items():
        g, m, v = grads[name], state.m[name], state.v[name]
        gf = g.float()
        mf = b1 * m.float() + one_m_b1 * gf
        vf = b2 * v.float() + one_m_b2 * gf * gf
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        pf = p.float()
        rank = p.ndim if ranks is None else ranks[name]
        if rank >= 2:  # decoupled weight decay on matrices only
            pf = pf * shrink
        pf = pf - lr * delta
        p.copy_(pf)
        m.copy_(mf)
        v.copy_(vf)
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), stats


# --------------------------------------------------------------------------
# optional int8 error-feedback gradient compression (cross-pod links)
# --------------------------------------------------------------------------

def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization → (q, scale)."""
    gf = g.float()
    scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_grads_with_feedback(grads: dict[str, torch.Tensor],
                                   error: dict[str, torch.Tensor]):
    """int8-compress (grads + carried error); return (decompressed,
    new_error): the decompressed values are what crosses the slow link, the
    quantisation residual is fed into the next step."""
    new_g, new_e = {}, {}
    for k, g in grads.items():
        target = g.float() + error[k]
        deq = decompress_int8(*compress_int8(target))
        new_g[k] = deq.to(g.dtype)
        new_e[k] = target - deq
    return new_g, new_e
