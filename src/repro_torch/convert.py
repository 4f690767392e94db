"""Carry state and weights across from the reference package, through numpy.

:func:`lm_params_from_numpy` turns the reference's model parameters (a
nested dict of numpy arrays) into the port's
:class:`~repro_torch.models.lm.LM` or, for an encoder-decoder config,
:class:`~repro_torch.models.encdec.EncDec`, and :func:`lm_params_to_numpy`
turns either, or its gradients or moments keyed by parameter name, back
into that layout;
:func:`adamw_state_from_numpy` and :func:`adamw_state_to_numpy` carry an
optimizer state across either way.

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
from repro_torch.models.encdec import STACKED as ENCDEC_STACKED
from repro_torch.models.lm import stack_plan
from repro_torch.models.registry import params_module
from repro_torch.train.optim import AdamWState


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


def _unstack(tree, cfg: ModelConfig) -> dict:
    """A tree in the reference's layout → ``{port parameter name: leaf}``,
    checked against the names and shapes of the port's parameters of
    ``cfg``.

    LM: the reference's scanned stack ``blocks/l{j}`` (leaves ``[n_blocks,
    ...]``) is unstacked into layers ``i * len(pattern) + j`` after the
    ``head_layers``, followed by the ``tail_layers`` (recurrentgemma's
    last two Griffin blocks). Encoder-decoder: ``enc_blocks`` and
    ``dec_blocks`` (leaves ``[n_layers, ...]``) into layers ``i`` of the
    lists of the same names."""
    if cfg.is_encdec:
        depth = {"enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_layers}
        groups = {key: [_index(tree[key], i) for i in range(depth[key])]
                  for key in ENCDEC_STACKED}
        skip = ENCDEC_STACKED
    else:
        plan = stack_plan(cfg)
        layers = list(tree.get("head_layers", []))
        layers += [_index(tree["blocks"][f"l{j}"], i)
                   for i in range(plan.n_blocks)
                   for j in range(len(plan.pattern))]
        layers += list(tree.get("tail_layers", []))
        groups = {"layers": layers}
        skip = ("blocks", "head_layers", "tail_layers")
    state = _flatten({k: v for k, v in tree.items() if k not in skip}, "", {})
    for key, layers in groups.items():
        for i, layer in enumerate(layers):
            _flatten(layer, f"{key}.{i}.", state)
    want = params_module(cfg, torch.device("meta")).state_dict()
    if set(state) != set(want):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(want))}")
    for name, t in want.items():
        if tuple(np.shape(state[name])) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(np.shape(state[name]))}, "
                             f"expected {tuple(t.shape)}")
    return state


def lm_params_from_numpy(tree, cfg: ModelConfig, device):
    """The reference's ``lm_init`` (or ``encdec_init``) parameters (nested
    dict, numpy leaves) → an :class:`~repro_torch.models.lm.LM` (or
    :class:`~repro_torch.models.encdec.EncDec`) on ``device`` (``None``
    means ``cuda``).

    The layers are unstacked as :func:`_unstack` says. Values are cast to
    each parameter's type: ``cfg.dtype``, except the leaves the reference
    keeps in f32 in any model (the RG-LRU's ``mixer.lru.a_param``; the
    time mix's ``w_base``, ``u``, ``ln_x_scale`` and ``ln_x_bias``; the
    MoE's ``ffn.router``).
    Every parameter must be present and no other.
    """
    state = _unstack(tree, cfg)
    params = params_module(cfg, resolve_device(device))
    with torch.no_grad():
        for name, t in params.state_dict().items():
            t.copy_(_array_to_tensor(state[name]).to(t.dtype))
    return params


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor → a numpy copy on the host (the tensor may be updated in
    place later); bf16 and f16 widen to f32 (exactly)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy().copy()


def lm_params_to_numpy(params, cfg: ModelConfig) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: an LM or EncDec, or any
    ``{parameter name: tensor}`` dict of one (gradients, moments), → the
    reference's nested tree, the layers it scans stacked again: an LM's
    ``stack_plan`` blocks ``[n_blocks, ...]`` under ``blocks/l{j}``, an
    encoder-decoder's ``enc_blocks`` and ``dec_blocks`` ``[n_layers,
    ...]``. Leaves are numpy arrays in the tensors' types, bf16 widened to
    f32."""
    named = (params if isinstance(params, dict)
             else dict(params.named_parameters()))
    stacked = ENCDEC_STACKED if cfg.is_encdec else ("layers",)
    tree: dict = {}
    layers: dict[str, dict[int, dict]] = {k: {} for k in stacked}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in stacked:
            node = layers[parts[0]].setdefault(int(parts[1]), {})
            parts = parts[2:]
        else:
            node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _host(t)

    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else np.stack([t[k] for t in trees]) for k in trees[0]}

    if cfg.is_encdec:
        for key, group in layers.items():
            tree[key] = stack([group[i] for i in range(len(group))])
        return tree
    plan = stack_plan(cfg)
    plen, n_head = len(plan.pattern), len(plan.head)
    layers = layers["layers"]
    if plan.head:
        tree["head_layers"] = [layers[i] for i in range(n_head)]
    if plan.n_blocks:
        tree["blocks"] = {
            f"l{j}": stack([layers[n_head + i * plen + j]
                            for i in range(plan.n_blocks)])
            for j in range(plen)}
    if plan.tail:
        first = n_head + plan.n_blocks * plen
        tree["tail_layers"] = [layers[first + i]
                               for i in range(len(plan.tail))]
    return tree


def adamw_state_from_numpy(tree, cfg: ModelConfig, device):
    """A reference ``AdamWState`` (``step``, and ``m``/``v`` in the
    reference's LM layout, numpy leaves) → the port's
    :class:`~repro_torch.train.optim.AdamWState` on ``device``: moments
    keyed by parameter name in the arrays' own types, step int32."""
    device = resolve_device(device)

    def moments(t):
        return {k: _array_to_tensor(a).to(device)
                for k, a in _unstack(t, cfg).items()}

    step = torch.tensor(int(np.asarray(tree.step)), dtype=torch.int32,
                        device=device)
    return AdamWState(step=step, m=moments(tree.m), v=moments(tree.v))


def adamw_state_to_numpy(state, cfg: ModelConfig):
    """The port's ``AdamWState`` → the same ``AdamWState`` type with numpy
    leaves in the reference's layout (:func:`lm_params_to_numpy`)."""
    return type(state)(step=np.asarray(state.step.cpu().numpy()),
                       m=lm_params_to_numpy(state.m, cfg),
                       v=lm_params_to_numpy(state.v, cfg))


def to_numpy(tree):
    """A port NamedTuple (possibly nested) → the same structure of numpy
    arrays, for comparison with the reference."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if tree is None:
        return None
    return type(tree)(*(to_numpy(x) for x in tree))
