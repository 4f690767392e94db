"""Carry state and weights across from the reference package, through numpy.

:func:`lm_params_from_numpy` turns the reference's LM parameters (a nested
dict of numpy arrays) into the port's :class:`~repro_torch.models.lm.LM`.

The sweep has no weights; its state plays their part. These functions take
a reference ``SweepState``/``SimState``/``SimMetrics``/``ScenarioParams``
whose leaves are numpy arrays (PRNG keys unwrapped to their ``[..., 2]``
uint32 words, as ``jax.random.key_data`` gives them) and build the port's
tensors on ``device`` (``None`` means ``cuda``, as everywhere in the
port), so both packages can start from one state. No JAX type is
imported: the input is read by field name.

Dtypes carry over (f32, i32, bool), except uint32 leaves (key words, the
instance seed) which become int64 holding the same values. A single
instance's tree (``pos`` of shape ``[N]``) gains a leading instance axis.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core.record import TraceBuffer
from repro_torch.core.scenario import ScenarioParams
from repro_torch.core.simulator import SimMetrics, SimState
from repro_torch.core.sweep import SweepState
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM, stack_plan


def _tensor(x, device, batch: bool) -> torch.Tensor:
    a = np.array(x)   # a writable copy: device arrays read back read-only
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if batch:
        a = a[None]
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _convert(cls, tree, device, batch: bool):
    device = resolve_device(device)
    return cls(*(_tensor(getattr(tree, f), device, batch) for f in cls._fields))


def sim_state_from_numpy(tree, device) -> SimState:
    """A reference ``SimState`` (numpy leaves) → :class:`SimState`."""
    return _convert(SimState, tree, device, np.ndim(tree.pos) == 1)


def sim_metrics_from_numpy(tree, device) -> SimMetrics:
    """A reference ``SimMetrics`` (numpy leaves) → :class:`SimMetrics`."""
    return _convert(SimMetrics, tree, device, np.ndim(tree.steps) == 0)


def scenario_params_from_numpy(tree, device) -> ScenarioParams:
    """A reference ``ScenarioParams`` (numpy leaves) → :class:`ScenarioParams`."""
    return _convert(ScenarioParams, tree, device, np.ndim(tree.p_cav) == 0)


def trace_buffer_from_numpy(tree, device) -> TraceBuffer:
    """A reference ``TraceBuffer`` (numpy leaves) → :class:`TraceBuffer`."""
    return _convert(TraceBuffer, tree, device, np.ndim(tree.series) == 2)


def sweep_state_from_numpy(tree, device) -> SweepState:
    """A reference ``SweepState`` (numpy leaves, with or without a
    trace) → :class:`SweepState`."""
    device = resolve_device(device)
    trace = getattr(tree, "trace", None)
    return SweepState(
        sim=sim_state_from_numpy(tree.sim, device),
        metrics=sim_metrics_from_numpy(tree.metrics, device),
        params=scenario_params_from_numpy(tree.params, device),
        horizon=_tensor(tree.horizon, device, False),
        done=_tensor(tree.done, device, False),
        chunk=_tensor(tree.chunk, device, False),
        scenario_id=_tensor(tree.scenario_id, device, False),
        trace=None if trace is None else trace_buffer_from_numpy(trace, device),
    )


def _array_to_tensor(a) -> torch.Tensor:
    """numpy → CPU tensor; a bfloat16 array (``ml_dtypes``, as JAX hands
    them out) is carried across bit for bit through its uint16 words."""
    a = np.array(a, order="C")   # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _index(tree, i: int) -> dict:
    """Row ``i`` of every leaf of a stacked (scanned) parameter tree."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _flatten(tree, prefix: str, out: dict) -> dict:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", out)
        else:
            out[prefix + key] = val
    return out


def lm_params_from_numpy(tree, cfg: ModelConfig, device) -> LM:
    """The reference's ``lm_init`` parameters (nested dict, numpy leaves)
    → an :class:`LM` on ``device`` (``None`` means ``cuda``).

    The reference's scanned stack ``blocks/l{j}`` (leaves ``[n_blocks,
    ...]``) is unstacked into layers ``i * len(pattern) + j`` after the
    ``head_layers``, followed by the ``tail_layers`` (recurrentgemma's
    last two Griffin blocks). Values are cast to each parameter's type:
    ``cfg.dtype``, except the leaves the reference keeps in f32 in any
    model (the RG-LRU's ``mixer.lru.a_param``; the time mix's ``w_base``,
    ``u``, ``ln_x_scale`` and ``ln_x_bias``). Every parameter must be
    present and no other.
    """
    device = resolve_device(device)
    plan = stack_plan(cfg)
    layers = list(tree.get("head_layers", []))
    layers += [_index(tree["blocks"][f"l{j}"], i)
               for i in range(plan.n_blocks) for j in range(len(plan.pattern))]
    layers += list(tree.get("tail_layers", []))
    state = _flatten({k: v for k, v in tree.items()
                      if k not in ("blocks", "head_layers", "tail_layers")},
                     "", {})
    for i, layer in enumerate(layers):
        _flatten(layer, f"layers.{i}.", state)
    params = LM(cfg, device)
    want = params.state_dict()
    if set(state) != set(want):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(want))}")
    with torch.no_grad():
        for name, t in want.items():
            src = _array_to_tensor(state[name])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(t.dtype))
    return params


def to_numpy(tree):
    """A port NamedTuple (possibly nested) → the same structure of numpy
    arrays, for comparison with the reference."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if tree is None:
        return None
    return type(tree)(*(to_numpy(x) for x in tree))
