"""Sharding rules: parameter, batch and cache specs with a divisibility
fallback (port of ``repro/sharding/axes.py``).

Strategy, as the reference's:

- mesh axes ``("data", "model")`` for one group of cards, ``("pod",
  "data", "model")`` for several; ``pod`` and ``data`` together form the
  data-parallel (FSDP) axis group;
- parameters: the d_model ("embed") dim sharded over ``data`` (FSDP);
  heads, d_ff, experts and the vocabulary over ``model`` (tensor
  parallel);
- activations and batches: the batch over ``("pod", "data")``;
- decode caches: the batch over ``data``, the cache's sequence over
  ``model`` (context-parallel decode).

Every rule checks that the axis divides the dim and else replicates it,
so one rule set holds across all 10 architectures.

A spec is a tuple with one entry a dim: an axis name, a tuple of axis
names (sharded over their product, major to minor) or ``None``. The rules
are pure functions of (config, path, shape, mesh axis names and sizes);
``mesh`` is a :class:`~repro_torch.config.base.MeshConfig` or a
``torch.distributed.device_mesh.DeviceMesh``, and no process group is
needed. Paths are the reference's (:mod:`repro_torch.utils.tree`); a layer
the reference stacks is a module of its own here, so its leaf's spec
lacks the reference's leading ``None`` for the stack axis
(:func:`reference_spec` adds it back). :func:`placements` turns a spec
into DTensor placements on a real mesh, and :func:`local_shape` and
:func:`plan_bytes` give each device's share by arithmetic, which is exact
because every sharded dim divides.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.utils.tree import (
    is_stacked,
    tree_flatten_with_paths,
    tree_map_with_path,
)

Spec = tuple


def _spec(*entries) -> Spec:
    """A spec, each entry normalised as ``PartitionSpec`` normalises it: a
    tuple of one axis is that axis, an empty tuple is ``None``."""
    return tuple((e[0] if len(e) == 1 else e or None)
                 if isinstance(e, tuple) else e for e in entries)


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``MeshConfig`` or a ``DeviceMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axes, mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def tp_axis(mesh) -> str | None:
    return "model" if "model" in mesh_axes(mesh) else None


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    names = mesh_axes(mesh)
    if isinstance(axis, tuple):
        return math.prod(names[a] for a in axis)
    return names[axis]


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

def _param_leaf_spec(cfg: ModelConfig, mesh, path: str,
                     shape: tuple[int, ...]) -> Spec:
    """The spec of one parameter leaf, by the suffix of its (reference)
    path and its shape (one layer's: no stack axis)."""
    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    dp = dp_axes(mesh)
    tp = tp_axis(mesh)
    nd = len(shape)

    def spec(*axes):
        resolved = []
        used: set = set()
        for ax, dim in zip(axes, shape):
            cand = ax
            if cand is not None:
                names = set(cand) if isinstance(cand, tuple) else {cand}
                if (used & names) or dim % _axis_size(mesh, cand) != 0:
                    cand = None
                else:
                    used |= names
            resolved.append(cand)
        return _spec(*resolved)

    # ---- embeddings / heads --------------------------------------------
    if name == "table":                       # [V, d]
        return spec(tp, dp)
    if parent == "lm_head" and name == "w":   # [d, V]
        return spec(dp, tp)

    # ---- MoE -------------------------------------------------------------
    if name == "router":                      # [d, E]
        return spec(dp, tp)
    if nd == 3 and shape[0] == cfg.n_experts and name in (
        "wi_gate", "wi_up", "wo"
    ):
        if name == "wo":                      # [E, m, d]
            return spec(tp, None, dp)
        return spec(tp, dp, None)             # [E, d, m]

    # ---- attention --------------------------------------------------------
    if name in ("wq", "q_proj") and nd == 3:  # [d, H, hd]
        return spec(dp, tp, None)
    if name in ("wk", "wv") and nd == 3:      # [d, K, hd]
        return spec(dp, tp, None)
    if name == "wo" and nd == 3:              # [H, hd, d]
        return spec(tp, None, dp)
    if name in ("bq", "bk", "bv"):            # [H, hd]
        return spec(tp, None)

    # ---- MLA ----------------------------------------------------------------
    if name == "q_a":                         # [d, q_lora]
        return spec(dp, None)
    if name in ("q_b", "kv_b"):               # [q_lora|L, H, dn+dr|dn+dv]
        # heads over the model axis where they divide, else replicated:
        # these low-rank expansions are small, and sharding them over data
        # would gather them in every layer
        return spec(None, tp, None)
    if name == "kv_a":                        # [d, L+dr]
        return spec(dp, None)

    # ---- dense FFN -----------------------------------------------------------
    if name in ("wi_gate", "wi_up") and nd == 2:
        # recurrent block in-projections [d, W] and the FFN's [d, m]
        return spec(dp, tp)
    if name == "wo" and nd == 2:              # [m|W, d] or rwkv [d, d]
        return spec(tp, dp)

    # ---- recurrent (RG-LRU) -----------------------------------------------
    if name == "wi_x":                        # [d, W]
        return spec(dp, tp)
    if name == "conv_w":                      # [cw, W]
        return spec(None, tp)
    if name in ("conv_b", "a_param", "ba", "bx"):
        return spec(tp)
    if name in ("wa", "wx") and nd == 3:      # [h, hd, hd] block-diag gates
        return spec(tp, None, None)

    # ---- RWKV ------------------------------------------------------------------
    if parent == "time_mix" and name in ("wr", "wk", "wv", "wg") and nd == 2:
        return spec(dp, tp)                   # [d, d]
    if parent == "channel_mix" and name in ("wk",) and nd == 2:
        return spec(dp, tp)                   # [d, m]
    if parent == "channel_mix" and name in ("wv",) and nd == 2:
        return spec(tp, dp)                   # [m, d]
    if parent == "channel_mix" and name in ("wr",) and nd == 2:
        return spec(dp, tp)
    if name == "ts_w1":                       # [d, 5*lora]
        return spec(dp, None)
    if name == "ts_w2":                       # [5, lora, d]
        return spec(None, None, dp)
    if name in ("w_lora1",):
        return spec(dp, None)
    if name in ("w_lora2",):
        return spec(None, dp)
    if name == "u":                           # [H, hd]
        return spec(tp, None)
    if name == "frame_proj":
        return spec(dp, tp)

    # ---- everything else (norm scales, mus, biases): replicated ------------
    return (None,) * nd


def param_specs(cfg: ModelConfig, params: Any, mesh) -> Any:
    """{parameter name: spec} of an LM or EncDec (or a dict of its
    tensors; ``meta`` ones too)."""
    return tree_map_with_path(
        lambda path, leaf: _param_leaf_spec(cfg, mesh, path,
                                            tuple(leaf.shape)),
        params, cfg)


def opt_state_specs(cfg: ModelConfig, opt_state: Any, params: Any,
                    mesh) -> Any:
    """AdamW's m and v mirror the parameters' specs; the scalar step is
    replicated. Returns an ``AdamWState`` of specs."""
    pspecs = param_specs(cfg, params, mesh)
    return type(opt_state)(step=(), m=pspecs, v=pspecs)


# --------------------------------------------------------------------------
# batch / cache specs
# --------------------------------------------------------------------------

def batch_specs(mesh, batch: Any) -> Any:
    """The batch dim over the data axes (where they divide it: a global
    batch of 1 replicates); M-RoPE positions are ``[3, B, S]``."""
    dp = dp_axes(mesh)

    def fit(dim):
        return dp if (dp and dim % _axis_size(mesh, dp) == 0) else None

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if path.endswith("mrope_pos"):
            return _spec(None, fit(shape[1]), *(None,) * (len(shape) - 2))
        return _spec(fit(shape[0]), *(None,) * (len(shape) - 1))

    return tree_map_with_path(one, batch)


def _cache_leaf_spec(mesh, batch: int, path: str,
                     shape: tuple[int, ...]) -> Spec:
    """Decode caches: the batch over ``data``, a long sequence dim over
    ``model`` (context parallel). One layer's leaves: KV caches ``{k, v:
    [B, S, K, hd], pos: [B, S]}``, MLA ``{c: [B, S, L], k_rope: [B, S,
    dr]}``, recurrent ``{h: [B, W], conv: [B, cw, W]}``, rwkv ``{S: [B, H,
    dk, dv], x_prev_*: [B, d]}``, the encoder-decoder's cross ``{k, v:
    [B, T, H, hd]}``."""
    dp = dp_axes(mesh)
    tp = tp_axis(mesh)
    name = path.split("/")[-1]

    def fit(axis, dim):
        return axis if (axis and dim % _axis_size(mesh, axis) == 0) else None

    bspec = fit(dp, shape[0])
    rest: list = [None] * (len(shape) - 1)
    if name in ("k", "v", "pos", "c", "k_rope") and len(shape) >= 2:
        rest[0] = fit(tp, shape[1])               # cache sequence dim
    elif name == "S" and len(shape) == 4:          # rwkv state [B,H,dk,dv]
        rest[0] = fit(tp, shape[1])
        if rest[0] is None:
            rest[2] = fit(tp, shape[3])
    elif name in ("h",) and len(shape) == 2:       # rglru state [B,W]
        rest[0] = fit(tp, shape[1])
    elif name == "conv" and len(shape) == 3:       # conv history [B,cw,W]
        rest[1] = fit(tp, shape[2])
    return _spec(bspec, *rest)


def cache_specs(mesh, cache: Any, batch: int) -> Any:
    """Specs of a model's cache, in the cache's own structure (the rules
    read a leaf's name alone, which the port's path shares with the
    reference's)."""
    return tree_map_with_path(
        lambda path, leaf: _cache_leaf_spec(mesh, batch, path,
                                            tuple(leaf.shape)),
        cache)


def reference_spec(path: str, spec: Spec) -> Spec:
    """The reference's spec of the leaf at ``path`` (a reference path)
    whose port leaf (one row, for a stacked leaf) has ``spec``: the
    stacked leaves' stack axis is replicated."""
    return ((None,) + tuple(spec)) if is_stacked(path) else tuple(spec)


# --------------------------------------------------------------------------
# per-device shapes and bytes; placements on a real mesh
# --------------------------------------------------------------------------

def local_shape(spec: Spec, shape, mesh) -> tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` leaf under ``spec``
    (every sharded dim divides, by the rules' fallback)."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = _axis_size(mesh, axis)
        if dim % n:
            raise ValueError(f"spec {spec} does not divide shape "
                             f"{tuple(shape)}")
        out.append(dim // n)
    return tuple(out)


def plan_bytes(tree: Any, specs: Any, mesh) -> int:
    """One device's bytes of ``tree`` under ``specs`` (a tree of specs of
    the same structure, as the ``*_specs`` functions give)."""
    leaves = tree_flatten_with_paths(tree)
    spec_of = dict(tree_flatten_with_paths(specs))
    total = 0
    for path, leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            continue
        spec = spec_of.get(path, ())
        total += (math.prod(local_shape(spec, leaf.shape, mesh))
                  * leaf.element_size())
    return total


def placements(spec: Spec, device_mesh) -> list:
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(d)`` on
    each mesh dim that the spec's entry ``d`` names, ``Replicate()`` on the
    others. An entry naming several axes shards dim ``d`` over them in the
    mesh's order, as the reference's axis tuples do."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in device_mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if entry == name or (
            isinstance(entry, tuple) and name in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _distribute(tree: Any, specs: Any, device_mesh) -> Any:
    from torch.distributed.tensor import distribute_tensor

    spec_of = dict(tree_flatten_with_paths(specs))
    return tree_map_with_path(
        lambda path, t: distribute_tensor(
            t.detach(), device_mesh,
            placements(spec_of.get(path, ()), device_mesh)),
        tree)


def param_shardings(cfg: ModelConfig, params: Any, device_mesh) -> Any:
    """{parameter name: DTensor} of ``params`` distributed onto
    ``device_mesh`` by :func:`param_specs`."""
    specs = param_specs(cfg, params, device_mesh)
    return _distribute(_as_dict(params), specs, device_mesh)


def opt_state_shardings(cfg: ModelConfig, opt_state: Any, params: Any,
                        device_mesh) -> Any:
    """An ``AdamWState`` of DTensors: m and v as the parameters, the step
    replicated."""
    specs = opt_state_specs(cfg, opt_state, params, device_mesh)
    return _distribute(opt_state, specs, device_mesh)


def cache_shardings(device_mesh, cache: Any, batch: int) -> Any:
    """The cache of DTensors distributed onto ``device_mesh``."""
    return _distribute(cache, cache_specs(device_mesh, cache, batch),
                       device_mesh)


def batch_shardings(device_mesh, batch: Any) -> Any:
    return _distribute(batch, batch_specs(device_mesh, batch), device_mesh)


def _as_dict(params: Any) -> Any:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params
