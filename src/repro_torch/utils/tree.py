"""Small tree utilities over the port's parameters, caches and optimizer
state (port of ``repro/utils/tree.py``).

A tree is an ``nn.Module`` (its named parameters), a dict, a list or a
NamedTuple (``AdamWState``), nested, with tensors as leaves; ``None`` is
an empty tree, and any other value is a leaf (a plain tuple too, such as
a sharding spec, so a tree of specs has the structure of its tensors').
A leaf's path joins the keys on its way with ``/``: a parameter ``layers.5.attn.wq`` is ``layers/5/attn/wq``, and a dict keyed
by parameter names (gradients, moments) gives the same paths.

With a config, :func:`reference_path` renames each path to the path of
the reference's leaf that holds it, so that rules written against the
reference's names (the sharding rules) read the same names here. The
reference stacks the layers it scans, ``[n_blocks, ...]``; the port holds
them one module each. A layer the reference stacks therefore gives one
port leaf per row, in order, all under the stacked leaf's path
(:func:`is_stacked`), and each such port leaf lacks the leading stack axis
of the reference's leaf. This is the one place that mapping is written.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

#: roots of the reference's stacked leaves: the LM's scanned ``blocks``
#: (parameters and caches), the encoder-decoder's ``enc_blocks`` and
#: ``dec_blocks`` and its ``self`` and ``cross`` caches
STACKED_ROOTS = ("blocks", "enc_blocks", "dec_blocks", "self", "cross")


def _leaf_bytes(x: Any) -> int:
    if not isinstance(x, torch.Tensor):
        return 0
    return x.numel() * x.element_size()


def _join(path: str, key) -> str:
    key = str(key).replace(".", "/")
    return f"{path}/{key}" if path else key


def _walk(tree: Any, path: str, visit: Callable[[str, Any], Any]) -> Any:
    """Apply ``visit(path, leaf)`` to every leaf, rebuilding the tree (a
    module becomes a dict keyed by parameter name)."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        return {name: visit(_join(path, name), p)
                for name, p in tree.named_parameters()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(getattr(tree, f), _join(path, f), visit)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _walk(v, _join(path, k), visit) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, _join(path, i), visit) for i, v in enumerate(tree)]
    return visit(path, tree)


def _layer_root(cfg, i: int, roots: tuple[str, str, str]) -> str:
    """The reference's path of LM layer ``i`` (in stack order) under
    ``roots`` = (head, scanned blocks, tail)."""
    from repro_torch.models.lm import stack_plan

    plan = stack_plan(cfg)
    n_head, plen = len(plan.head), len(plan.pattern)
    if i < n_head:
        return f"{roots[0]}/{i}"
    j = i - n_head
    if j < plan.n_blocks * plen:
        return f"{roots[1]}/l{j % plen}"
    return f"{roots[2]}/{j - plan.n_blocks * plen}"


def reference_path(cfg, path: str) -> str:
    """The path of the reference's leaf that holds the port's leaf at
    ``path`` (an LM or encoder-decoder of ``cfg``: its parameters, a dict
    of them, its cache, or an ``AdamWState`` of them).

    LM parameters ``layers/i/...`` become ``head_layers/i/...``,
    ``blocks/l{j}/...`` or ``tail_layers/k/...`` as
    :func:`~repro_torch.models.lm.stack_plan` places layer ``i``; an LM
    cache's ``i/...`` becomes ``head/i``, ``blocks/l{j}`` or ``tail/k``;
    the encoder-decoder's ``enc_blocks/i``, ``dec_blocks/i``, ``self/i``
    and ``cross/i`` lose the index (stacked). ``m/...`` and ``v/...`` of an
    optimizer state map their rest alike."""
    parts = path.split("/")
    if parts[0] in ("m", "v") and len(parts) > 1:
        return parts[0] + "/" + reference_path(cfg, "/".join(parts[1:]))
    rest = "/".join(parts[2:])
    if cfg.is_encdec:
        if parts[0] in STACKED_ROOTS and len(parts) > 1 and parts[1].isdigit():
            return f"{parts[0]}/{rest}"
        return path
    if parts[0] == "layers" and len(parts) > 1:
        root = _layer_root(cfg, int(parts[1]),
                           ("head_layers", "blocks", "tail_layers"))
        return f"{root}/{rest}"
    if parts[0].isdigit():
        root = _layer_root(cfg, int(parts[0]), ("head", "blocks", "tail"))
        return f"{root}/{'/'.join(parts[1:])}"
    return path


def is_stacked(path: str) -> bool:
    """Whether the reference's leaf at ``path`` (a reference path) is
    stacked: its first axis runs over layers, and the port's leaves under
    it are its rows."""
    parts = path.split("/")
    if parts[0] in ("m", "v") and len(parts) > 1:
        parts = parts[1:]
    return parts[0] in STACKED_ROOTS


def tree_leaves(tree: Any) -> list:
    out: list = []
    _walk(tree, "", lambda path, leaf: out.append(leaf))
    return out


def tree_bytes(tree: Any) -> int:
    """Total bytes of all tensor leaves (``meta`` tensors too)."""
    return sum(_leaf_bytes(x) for x in tree_leaves(tree))


def tree_param_count(tree: Any) -> int:
    """Total element count of all tensor leaves."""
    return sum(x.numel() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def tree_flatten_with_paths(tree: Any, cfg=None) -> list[tuple[str, Any]]:
    """Flatten to (path, leaf) pairs; with ``cfg``, the paths are the
    reference's (:func:`reference_path`)."""
    out: list = []
    _walk(tree, "", lambda path, leaf: out.append((path, leaf)))
    if cfg is not None:
        out = [(reference_path(cfg, p), x) for p, x in out]
    return out


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       cfg=None) -> Any:
    """Map ``fn(path, leaf)`` over a tree (a module maps to a dict keyed by
    parameter name); with ``cfg``, ``fn`` gets the reference's paths."""
    if cfg is None:
        return _walk(tree, "", fn)
    return _walk(tree, "", lambda p, x: fn(reference_path(cfg, p), x))
