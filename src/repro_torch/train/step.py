"""Train step: loss, gradient accumulation (microbatching), remat, metrics
(port of ``repro/train/step.py``).

``make_train_step`` builds the ``(params, opt_state, batch) → (params,
opt_state, metrics)`` function the trainer loop calls. It updates the
parameters and moments in place and returns them. Microbatches are
accumulated in f32 buffers, as the reference's scan accumulates, so the
activation working set is bounded at any global batch.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.models.attention import attention_impl
from repro_torch.models.recurrent import recurrence_impl
from repro_torch.models.registry import Model, reference_ranks
from repro_torch.train.optim import AdamWState, adamw_init, adamw_update


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 0.0):
    """Mean next-token cross entropy of ``logits [B, S, V]`` f32 against
    ``labels [B, S]``, plus ``z_loss · mean(logsumexp²)`` when set. Returns
    (loss, {"ce", "z_loss" where set}).

    The label's logit is gathered: the reference's masked sum over the
    vocabulary adds that one value to zeros, which is exact, so no
    ``[B, S, V]`` mask is built."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = (lse - picked).mean()
    metrics = {"ce": nll}
    if z_loss > 0.0:
        zl = z_loss * torch.square(lse).mean()
        nll = nll + zl
        metrics["z_loss"] = zl
    return nll, metrics


def make_loss_fn(model: Model, tc: TrainConfig) -> Callable:
    """(params, batch) → (loss, metrics): the cross entropy (with the
    z-loss where set) plus, in an MoE model, ``moe_aux_weight`` times the
    layers' summed load-balance aux loss, reported as ``moe_aux``."""

    def loss_fn(params, batch: dict):
        logits, aux = model.apply(params, batch, remat=tc.remat)
        loss, metrics = cross_entropy_loss(logits, batch["labels"], tc.z_loss)
        if model.cfg.n_experts > 0:
            loss = loss + tc.moe_aux_weight * aux
            metrics["moe_aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """[B, ...] → n batches of [B // n, ...], in order; ``mrope_pos``
    ``[3, B, S]`` is split on its batch axis, 1."""
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    m = b // n
    return [{k: v[:, i * m:(i + 1) * m] if k == "mrope_pos"
             else v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(model: Model, tc: TrainConfig):
    """The step switches ``requires_grad`` on for every parameter (they are
    created without it) and differentiates through the plain attention and
    recurrence paths, as the reference trains through XLA."""
    loss_fn = make_loss_fn(model, tc)

    def grads_of(params, names: list[str], leaves: list, batch: dict):
        # the reference's training path: XLA attention and the scans, not
        # the Pallas kernels; here the plain paths, since the CUDA kernels
        # have no backward
        with attention_impl("xla"), recurrence_impl("plain"):
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        return (dict(zip(names, grads)),
                {k: v.detach() for k, v in metrics.items()})

    def train_step(params, opt_state: AdamWState, batch: dict):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        names, leaves = list(named), list(named.values())
        if tc.microbatches > 1:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            metrics: dict[str, torch.Tensor] = {}
            for mb in _split_microbatches(batch, tc.microbatches):
                g, m = grads_of(params, names, leaves, mb)
                for k in names:
                    grads[k].add_(g[k])
                for k, v in m.items():
                    metrics[k] = metrics.get(k, torch.zeros_like(v)) + v
            inv = torch.tensor(1.0 / tc.microbatches, dtype=torch.float32,
                               device=leaves[0].device)
            grads = {k: g * inv for k, g in grads.items()}
            metrics = {k: v * inv for k, v in metrics.items()}
        else:
            grads, metrics = grads_of(params, names, leaves, batch)
        _, opt_state, stats = adamw_update(
            grads, opt_state, named, tc, reference_ranks(params, model.cfg))
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step


def abstract_train_state(model: Model, tc: TrainConfig):
    """(params, opt_state) on the ``meta`` device at the configured types:
    the parameters in the model's type, the moments in
    ``tc.opt_state_dtype``. Allocates nothing (the dry run's)."""
    params = model.abstract_params()
    opt_state = adamw_init(dict(params.named_parameters()),
                           dtype=tc.opt_state_dtype)
    return params, opt_state
