"""Cost accounting for the roofline: a cell's FLOPs and bytes, counted on
the ``meta`` device at full depth (port of ``repro/launch/costing.py``).

The reference lowers python-unrolled variants of a cell and extrapolates,
because XLA's ``cost_analysis()`` counts a ``while`` loop's body once.
Eager PyTorch has no such loop: every layer's Python call is executed,
and every op it dispatches is seen. So the port runs the cell itself, at
full depth, on ``meta`` tensors (shapes and types, no storage, no
arithmetic), and counts what it dispatches. There is no affine
extrapolation over layer counts, and no correction for a scan that a
compiler counted once.

What is counted:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmul,
  convolution and attention formulas). It counts no element-wise FLOPs,
  where XLA's ``flops`` does: compare like with like.
- bytes: :class:`ByteCounter`, a ``TorchDispatchMode`` that adds each aten
  op's input and output bytes, and 0 for an op whose outputs alias an
  input (a view) and for an allocation (``empty``). It also follows the
  storages that the ops create while they live (autograd's saved tensors
  included), and reports the most bytes alive at once: the run's peak,
  without the caching allocator's rounding.
- the hand kernels: the count follows the path the card runs. Under
  :func:`counting`, the wrappers of ``kernels/{flash_attention, rglru,
  rwkv6, idm}.py`` take ``meta`` inputs, return ``meta`` outputs of the
  right shape, and add their own FLOPs and bytes (:func:`kernel_call`), by
  the formulas below, which are also the bounds ``chip_smoke.py`` holds
  each kernel's time against: flash 4·D flops a live (query, key) pair (an
  MLA call's unpadded 2·(dn + dr) + 2·dv), the recurrences' inputs and
  outputs once. A ``meta`` input with no counting active raises in the
  wrapper, as any device but the CPU and CUDA does: the costing is no
  fallback.

A cell's FLOPs and bytes are those of one device of a one-card mesh. On a
larger mesh the per-device work is not known without running the sharded
program (there is no SPMD partitioner to ask), so :func:`cell_costs`
takes none; the per-device memory plan on any mesh is
:mod:`repro_torch.sharding`'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from contextvars import ContextVar

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.specs import META, input_specs
from repro_torch.models.registry import Model
from repro_torch.train.step import abstract_train_state, make_train_step
from repro_torch.utils.tree import tree_map_with_path

# H100 SXM published peaks (NVIDIA's data sheet, at 700 W): HBM3 bandwidth,
# the float32 rate outside the tensor cores, and the dense tensor-core rate
# by input type (float32 through TF32)
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TENSOR_OPS_PER_S = {"bfloat16": 989e12, "float32": 495e12}


# --------------------------------------------------------------------------
# the kernels' work: their bounds on the card and their costing on meta
# --------------------------------------------------------------------------

def bound(bytes_moved: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take in ms, and what bounds it:
    ``bytes_moved`` over the memory rate, or ``ops`` over ``ops_per_s``."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def live_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that attention with these masks scores: query i
    at position i + sk - sq sees keys (pos - window, pos] (causal) or
    (pos - window, sk) (not causal); window 0 means no window."""
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def sort_search_ops(b: int, n: int, searches: int) -> int:
    """Comparisons the lead/follower search needs at least: a comparison
    sort of each instance's n keys (n log2 n) and one binary search (log2
    n) for each of ``searches`` queries a slot. The all-pairs form's n^2
    pair tests are one way to answer, not work the function needs."""
    lg = max(1, (n - 1).bit_length())
    return b * n * lg * (1 + searches)


def flash_cost(b: int, sq: int, sk: int, h: int, kh: int, d: int,
               causal: bool, window: int, elt: int,
               work_dims: tuple[int, int] | None = None) -> tuple[int, int]:
    """(flops, bytes) of one flash attention call: 4·D flops a live pair a
    head; q, k, v read and the output written once. ``work_dims`` = (q/k,
    v) head dims of inputs zero-padded to ``d`` (the MLA route): the work
    is the unpadded 2·(dn + dr) + 2·dv a pair and its bytes."""
    dqk, dv = work_dims or (d, d)
    pairs = live_pairs(sq, sk, causal, window) * b * h
    flops = (2 * dqk + 2 * dv) * pairs
    nbytes = (b * sq * h * (dqk + dv) + b * sk * kh * (dqk + dv)) * elt
    return flops, nbytes


def rglru_cost(b: int, s: int, w: int, elt: int) -> tuple[int, int]:
    """(ops, bytes) of one RG-LRU scan: a multiply and an add a step and
    channel; a (f32) and x read, ys written, h0 read and h_final written."""
    return 2 * b * s * w, b * s * w * (4 + 2 * elt) + 2 * b * w * 4


def wkv6_cost(b: int, s: int, h: int, kd: int, vd: int,
              elt: int) -> tuple[int, int]:
    """(ops, bytes) of one WKV6 call: the state update and readout a step
    and head; r, k (``elt``), w (f32), v read and y written, u read, the
    state read and written once."""
    ops = b * s * h * (5 * kd * vd + 3 * kd + 2 * vd)
    nbytes = (b * s * h * (kd * (2 * elt + 4) + 2 * vd * elt)
              + h * kd * 4 + 2 * b * h * kd * vd * 4)
    return ops, nbytes


def neighbor_cost(b: int, n: int, q: int,
                  query_lanes: bool) -> tuple[int, int]:
    """(ops, bytes) of one neighbor search: a sort and q searches a slot;
    pos, lane and active read, six [B, Q, N] outputs (18 bytes an entry)
    written, the query lanes read where given."""
    nbytes = b * n * (4 + 4 + 1) + b * q * n * 18 + (b * q * n * 4
                                                     if query_lanes else 0)
    return sort_search_ops(b, n, q), nbytes


def idm_accel_cost(b: int, n: int) -> tuple[int, int]:
    """(ops, bytes) of one IDM call: one own-lane search an ego and the
    IDM formula's 16 operations; nine [B, N] inputs read, one written."""
    return (sort_search_ops(b, n, 1) + 16 * b * n,
            b * n * (7 * 4 + 4 + 1) + b * n * 4)


# --------------------------------------------------------------------------
# counting on meta
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Counts:
    """What one :func:`counting` block counted."""

    aten_flops: int = 0
    aten_bytes: int = 0
    peak_bytes: int = 0
    kernel_flops: int = 0
    kernel_bytes: int = 0
    kernel_calls: dict = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> int:
        return self.aten_flops + self.kernel_flops

    @property
    def bytes(self) -> int:
        return self.aten_bytes + self.kernel_bytes


_ACTIVE: ContextVar = ContextVar("costing_counts", default=None)

_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


class ByteCounter(TorchDispatchMode):
    """Adds each aten op's input and output bytes to ``counts.aten_bytes``;
    a view (an output that aliases an input without writing it) and an
    allocation move nothing. Each storage an op creates is live until its
    Python object is collected (storages keep theirs while any tensor
    holds them); ``counts.peak_bytes`` is the most bytes live at once."""

    def __init__(self, counts: Counts) -> None:
        super().__init__()
        self.counts = counts
        self.live = 0
        self._storages: set[int] = set()

    def _freed(self, key: int, nbytes: int) -> None:
        self._storages.discard(key)
        self.live -= nbytes

    def _track(self, out) -> None:
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st._cdata in self._storages:
                continue
            self._storages.add(st._cdata)
            self.live += st.nbytes()
            self.counts.peak_bytes = max(self.counts.peak_bytes, self.live)
            weakref.finalize(st, self._freed, st._cdata, st.nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        alias = [r.alias_info for r in func._schema.returns
                 if r.alias_info is not None]
        if any(not a.is_write for a in alias):
            return out                     # a view
        if not alias:
            self._track(out)               # new storage
        if func.overloadpacket not in _ALLOCATIONS:
            self.counts.aten_bytes += (_tensor_bytes(args)
                                       + _tensor_bytes(list(kwargs.values()))
                                       + _tensor_bytes(out))
        return out


@contextlib.contextmanager
def counting():
    """Count the FLOPs and bytes of what runs inside, on ``meta`` tensors
    or real ones; yields the :class:`Counts`, complete on exit."""
    counts = Counts()
    token = _ACTIVE.set(counts)
    flops = FlopCounterMode(display=False)
    try:
        with flops, ByteCounter(counts):
            yield counts
    finally:
        _ACTIVE.reset(token)
    counts.aten_flops = flops.get_total_flops()


def kernel_call(name: str, flops: int, nbytes: int) -> None:
    """Add one call of hand kernel ``name`` to the active counts: what a
    wrapper does with ``meta`` inputs. Raises with no counting active."""
    counts = _ACTIVE.get()
    if counts is None:
        raise ValueError(f"{name} takes meta tensors only while the "
                         "costing counts (launch.costing.counting)")
    counts.kernel_flops += flops
    counts.kernel_bytes += nbytes
    counts.kernel_calls[name] = counts.kernel_calls.get(name, 0) + 1


# --------------------------------------------------------------------------
# a cell's cost
# --------------------------------------------------------------------------

def _on(tree, device: torch.device):
    """``tree`` (meta) itself on ``meta``; elsewhere zeros of its shapes
    and types on ``device`` (a module's parameters in place)."""
    if device.type == "meta":
        return tree
    if isinstance(tree, torch.nn.Module):
        tree.to_empty(device=device)
        with torch.no_grad():
            for p in tree.parameters():
                p.zero_()
        return tree
    return tree_map_with_path(
        lambda _, t: torch.zeros(t.shape, dtype=t.dtype, device=device),
        tree)


def run_cell(cfg: ModelConfig, shape: ShapeConfig,
             tc: TrainConfig | None = None, device=META) -> None:
    """Run one cell's step: the train step (plain attention and
    recurrences, as the card trains), or a prefill or a decode step
    through the kernel route. On ``meta`` the inputs are
    :func:`~repro_torch.launch.specs.input_specs`'; on another device they
    are zeros of the same shapes (a real run of the same work, for
    holding the count against ``FlopCounterMode`` on real tensors)."""
    device = torch.device(device)
    model = Model(cfg, device)
    specs = _on(input_specs(cfg, shape), device)
    if shape.kind == "train":
        params, opt = abstract_train_state(model, tc)
        make_train_step(model, tc)(_on(params, device), _on(opt, device),
                                   specs)
        return
    params = _on(model.abstract_params(), device)
    with torch.no_grad():
        if shape.kind == "prefill":
            cache = _on(model.abstract_cache(shape.global_batch,
                                             shape.seq_len), device)
            model.prefill(params, cache, specs)
        else:
            model.decode(params, specs["cache"], specs["tokens"],
                         specs["pos"], specs.get("mrope_pos"))


def cell_costs(cfg: ModelConfig, shape: ShapeConfig,
               tc: TrainConfig | None = None, n_devices: int = 1) -> dict:
    """The cell's FLOPs and bytes on one device of a one-card mesh,
    counted on ``meta`` at full depth; for a larger mesh, ``None`` and the
    reason."""
    if n_devices != 1:
        return {"flops_per_device": None, "bytes_per_device": None,
                "wire_bytes_per_device": None,
                "reason": "no SPMD partitioner: the per-device work of a "
                          f"{n_devices}-device mesh is not known without "
                          "running the sharded program",
                "method": None}
    with counting() as counts:
        run_cell(cfg, shape, tc)
    return {"flops_per_device": counts.flops,
            "bytes_per_device": counts.bytes,
            "wire_bytes_per_device": 0,
            "aten_flops": counts.aten_flops, "aten_bytes": counts.aten_bytes,
            "peak_bytes": counts.peak_bytes,
            "kernel_flops": counts.kernel_flops,
            "kernel_bytes": counts.kernel_bytes,
            "kernel_calls": dict(counts.kernel_calls),
            "method": "meta-device run at full depth: FlopCounterMode, "
                      "aten bytes, hand-kernel formulas"}

