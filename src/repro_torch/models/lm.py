"""Decoder-only LM assembly (port of ``repro/models/lm.py``).

The reference stacks the repeated layers' parameters ``[n_blocks, ...]``
and scans over them; here the stack is an ``nn.ModuleList`` with one
:class:`~repro_torch.models.blocks.Block` per layer, in the reference's
order: the ``head`` layers, then ``n_blocks`` repetitions of
``cfg.layer_pattern``, then the ``tail`` layers (:func:`stack_plan`). The
converter (:func:`repro_torch.convert.lm_params_from_numpy`) unstacks the
reference's parameters into it. Caches are a list with one dict per layer.

``lm_apply(..., remat=)`` rematerialises as the reference does: each group
of ``pattern_len`` layers of the scanned blocks is one checkpoint (the
head and tail layers are not), ``"full"`` keeping only the group's input,
``"dots"`` also the outputs of the products without batch dims.
"""

from __future__ import annotations

import contextvars
import functools
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.config.base import ModelConfig
from repro_torch.models.blocks import (
    Block,
    block_apply,
    block_cache_init,
    block_decode,
    block_prefill,
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
)
from repro_torch.sharding.ctx import constrain


class StackPlan(NamedTuple):
    head: tuple[tuple[str, bool, int | None], ...]  # (kind, moe, d_ff)
    n_blocks: int
    pattern: tuple[tuple[str, bool], ...]           # (kind, moe) per position
    tail: tuple[tuple[str, bool], ...]


def stack_plan(cfg: ModelConfig) -> StackPlan:
    head = []
    for i in range(cfg.first_dense_layers):
        head.append((cfg.layer_kind(i), False, cfg.dense_d_ff or cfg.d_ff))
    rest = cfg.n_layers - len(head)
    plen = cfg.pattern_len
    n_blocks = rest // plen
    moe = cfg.n_experts > 0
    pattern = tuple(
        (cfg.layer_kind(len(head) + j), moe) for j in range(plen)
    )
    tail = tuple(
        (cfg.layer_kind(len(head) + n_blocks * plen + j), moe)
        for j in range(rest - n_blocks * plen)
    )
    return StackPlan(tuple(head), n_blocks, pattern, tail)


def stacked_layers(cfg: ModelConfig) -> range:
    """Indices of the layers the reference stacks ``[n_blocks, ...]`` and
    scans: those of ``stack_plan``'s blocks, between the head and the
    tail."""
    plan = stack_plan(cfg)
    start = len(plan.head)
    return range(start, start + plan.n_blocks * len(plan.pattern))


def reference_ranks(params: "LM", cfg: ModelConfig) -> dict[str, int]:
    """Each parameter's rank in the reference's tree: its own, plus the
    stack axis for a layer in :func:`stacked_layers` (a norm scale ``[d]``
    of such a layer is a ``[n_blocks, d]`` leaf there)."""
    stacked = stacked_layers(cfg)
    ranks = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        ranks[name] = p.ndim + (parts[0] == "layers"
                                and int(parts[1]) in stacked)
    return ranks


def layer_plan(cfg: ModelConfig) -> list[tuple[str, bool, int | None]]:
    """(kind, moe, d_ff) of every layer, in stack order."""
    plan = stack_plan(cfg)
    return (list(plan.head)
            + [(kind, moe, None) for kind, moe in plan.pattern] * plan.n_blocks
            + [(kind, moe, None) for kind, moe in plan.tail])


class LMHead(nn.Module):
    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        self.w = param((cfg.d_model, cfg.vocab_size), cdtype(cfg), device)


class LM(nn.Module):
    """Parameters of a decoder-only LM: ``embed``, ``layers``,
    ``final_norm`` and, without tied embeddings, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        self.embed = Embedding(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, kind, device, moe=moe, d_ff=d_ff)
            for kind, moe, d_ff in layer_plan(cfg))
        self.final_norm = Norm(cfg, cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg, device)

    def reset_parameters(self, generator) -> None:
        self.embed.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_norm.reset_parameters()
        if hasattr(self, "lm_head"):
            dense_init(self.lm_head.w, self.lm_head.w.shape[0], generator)


def lm_init(cfg: ModelConfig, generator: torch.Generator) -> LM:
    """A seeded LM on ``generator``'s device."""
    params = LM(cfg, generator.device)
    params.reset_parameters(generator)
    return params


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device)[None].expand(b, s)


REMAT = ("none", "full", "dots")
# products without batch dims: what the reference's "dots" policy
# (checkpoint_dots_with_no_batch_dims) keeps
_SAVED_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def _keep_products(ctx, op, *args, **kwargs):
    if op.overloadpacket in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, remat: str, *args):
    """``fn(*args)``, rematerialised as ``remat`` says: ``"none"`` calls
    it; ``"full"`` checkpoints it, keeping only its inputs; ``"dots"`` also
    keeps the outputs of the products without batch dims (the reference's
    ``checkpoint_dots_with_no_batch_dims``).

    On the card the autograd engine recomputes a checkpoint on its own
    thread, where this thread's context variables (``attention_impl``,
    ``recurrence_impl``) are unset: the recomputation runs in a copy of
    the context of this call."""
    if remat == "none":
        return fn(*args)
    kw = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _keep_products)}
          if remat == "dots" else {})
    ctx = contextvars.copy_context()

    def in_ctx(*a):
        return ctx.copy().run(fn, *a)

    return checkpoint(in_ctx, *args, use_reentrant=False, **kw)


def lm_apply(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
             positions: torch.Tensor | None = None,
             mrope_pos: torch.Tensor | None = None, remat: str = "none"):
    """Returns (logits [B,S,V] f32, moe_aux scalar); ``mrope_pos [3, B, S]``
    selects M-RoPE in a config with ``mrope_sections``."""
    if remat not in REMAT:
        raise ValueError(f"remat is one of {REMAT}, not {remat!r}")
    x = constrain(embed_tokens(cfg, params.embed, tokens), "dp", None, None)
    if positions is None:
        positions = _positions(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group(x, layers):
        a_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in layers:
            x, a = block_apply(cfg, p, x, positions, mrope_pos)
            x = constrain(x, "dp", None, None)
            a_sum = a_sum + a
        return x, a_sum

    # (layers, rematerialised): the head's layers one by one, then one
    # group of pattern_len layers per scanned block, then the tail's
    stacked = stacked_layers(cfg)
    layers = list(params.layers)
    segments = ([([p], False) for p in layers[:stacked.start]]
                + [(layers[i:i + cfg.pattern_len], remat != "none")
                   for i in stacked[::cfg.pattern_len]]
                + [([p], False) for p in layers[stacked.stop:]])
    for seg, remat_seg in segments:
        x, a = remat_call(group, remat if remat_seg else "none", x, seg)
        aux = aux + a
    x = norm(cfg, params.final_norm, x)
    logits = logits_from_hidden(cfg, params.embed,
                                getattr(params, "lm_head", None), x)
    return logits, aux


def lm_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                  device) -> list[dict]:
    return [block_cache_init(cfg, kind, batch, max_seq, device)
            for kind, _, _ in layer_plan(cfg)]


def lm_prefill(params: LM, cfg: ModelConfig, cache: list[dict],
               tokens: torch.Tensor, positions: torch.Tensor | None = None,
               mrope_pos: torch.Tensor | None = None):
    """Full-sequence prefill; returns (last-position logits [B,V], cache),
    the cache filled in place."""
    x = embed_tokens(cfg, params.embed, tokens)
    if positions is None:
        positions = _positions(x)
    for p, c in zip(params.layers, cache):
        x, _ = block_prefill(cfg, p, x, positions, c, mrope_pos)
    x = norm(cfg, params.final_norm, x[:, -1:])
    logits = logits_from_hidden(cfg, params.embed,
                                getattr(params, "lm_head", None), x)
    return logits[:, 0], cache


def lm_decode(params: LM, cfg: ModelConfig, cache: list[dict],
              tokens: torch.Tensor, pos: torch.Tensor,
              mrope_pos: torch.Tensor | None = None):
    """One decode step: tokens [B], pos [B] (mrope_pos [3, B, 1] or None)
    → (logits [B, V] f32, cache), the cache written in place."""
    x = embed_tokens(cfg, params.embed, tokens[:, None])
    for p, c in zip(params.layers, cache):
        x, _ = block_decode(cfg, p, x, pos, c, mrope_pos)
    x = norm(cfg, params.final_norm, x)
    logits = logits_from_hidden(cfg, params.embed,
                                getattr(params, "lm_head", None), x)
    return logits[:, 0], cache
