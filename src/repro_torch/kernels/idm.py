"""Wrappers for the hand-written neighbor and IDM kernels (``csrc/idm.cu``).

``neighbor_kernel`` replaces ``repro/kernels/idm.py::neighbor_kernel`` and
``idm_accel_kernel`` replaces ``repro/kernels/idm.py::idm_accel_kernel``.
Both take a leading instance axis, so one launch serves a whole batch of
instances (the reference gets that with ``vmap`` of the ``pallas_call``).

On a CPU tensor a wrapper runs the kernel's plain PyTorch version
(``repro_torch.kernels.ref``). On a CUDA tensor it checks device, dtype,
shape and contiguity, allocates the outputs with ``torch.empty``, launches
the kernel on the tensors' card (under a device guard, so ``cuda:1`` works
whatever the current card is) and its current stream without
synchronising, raises if the launch was refused, and adds one to
``launches[<name>]``. There is no
fallback from a CUDA tensor to the plain version. On a ``meta`` tensor a
wrapper returns ``meta`` outputs and adds its work to the costing
(:func:`repro_torch.launch.costing.kernel_call`), which raises unless the
costing is counting.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor as _check
from repro_torch.kernels.build import launched, symbol
from repro_torch.kernels.ref import ref_idm_accel, ref_neighbor_mq

#: launch counts per kernel; only a real kernel launch increments them
#: (``idm_accel_wide``: the all-pairs oracle, which no path calls)
launches = {"neighbor_kernel": 0, "idm_accel_kernel": 0, "idm_accel_wide": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    """Set every launch count to 0."""
    launches.update(dict.fromkeys(launches, 0))


def neighbor_kernel(pos, lane, active, query_lanes, *, n_rows=None,
                    veh_len: float = 4.5):
    """Multi-query lead+follower search.

    ``pos`` f32, ``lane`` i32, ``active`` bool, all ``[B, N]``;
    ``query_lanes`` i32 ``[B, Q, N]``, or ``None`` with ``n_rows=Q``: row
    ``q`` then queries lane ``q`` for every vehicle (a per-lane table).
    Returns ``(lead_idx, lead_gap, has_lead, foll_idx, foll_gap,
    has_foll)``, each ``[B, Q, N]``, bit-exact with
    :func:`repro_torch.kernels.ref.ref_neighbor_mq`. On the card, N up to
    8192 runs the one-block sort and search, larger N the all-pairs kernel
    (``csrc/idm.cu``); one launch either way.
    """
    if (query_lanes is None) == (n_rows is None):
        raise ValueError("neighbor_kernel takes query_lanes or n_rows, not "
                         "both or neither")
    if pos.device.type == "cpu":
        return ref_neighbor_mq(pos, lane, active, query_lanes, veh_len,
                               n_rows=n_rows)
    if pos.device.type == "meta":
        from repro_torch.launch import costing

        b, n = pos.shape
        q = int(n_rows) if query_lanes is None else query_lanes.shape[1]
        ops, nbytes = costing.neighbor_cost(b, n, q, query_lanes is not None)
        costing.kernel_call("neighbor_kernel", ops, nbytes)
        return tuple(torch.empty((b, q, n), dtype=dt, device=pos.device)
                     for dt in (torch.int32, torch.float32, torch.bool) * 2)
    if pos.device.type != "cuda":
        raise ValueError(f"neighbor_kernel runs on cpu or cuda, not {pos.device}")
    b, n = pos.shape
    dev = pos.device
    _check("pos", pos, torch.float32, (b, n), dev)
    _check("lane", lane, torch.int32, (b, n), dev)
    _check("active", active, torch.bool, (b, n), dev)
    if query_lanes is None:
        q = int(n_rows)
        ql_ptr = None
    else:
        q = query_lanes.shape[1] if query_lanes.dim() == 3 else -1
        _check("query_lanes", query_lanes, torch.int32, (b, q, n), dev)
        ql_ptr = query_lanes.data_ptr()
    if q < 0:
        raise ValueError(f"neighbor_kernel takes Q >= 0 rows, got {q}")
    shape = (b, q, n)
    li = torch.empty(shape, dtype=torch.int32, device=dev)
    lg = torch.empty(shape, dtype=torch.float32, device=dev)
    lh = torch.empty(shape, dtype=torch.bool, device=dev)
    fi = torch.empty(shape, dtype=torch.int32, device=dev)
    fg = torch.empty(shape, dtype=torch.float32, device=dev)
    fh = torch.empty(shape, dtype=torch.bool, device=dev)
    fn = symbol("idm", "neighbor_mq_launch",
             [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P])
    with torch.cuda.device(dev):   # the runtime launches on its current card
        err = fn(pos.data_ptr(), lane.data_ptr(), active.data_ptr(), ql_ptr,
                 b, q, n, veh_len,
                 li.data_ptr(), lg.data_ptr(), lh.data_ptr(),
                 fi.data_ptr(), fg.data_ptr(), fh.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    launched("neighbor_kernel", err, launches)
    return li, lg, lh, fi, fg, fh


def idm_accel_kernel(pos, vel, lane, active, v0, T, a_max, b_comf, s0, *,
                     veh_len: float = 4.5):
    """Same-lane lead search fused with IDM: nine ``[B, N]`` inputs (f32,
    except ``lane`` i32 and ``active`` bool) → f32 ``[B, N]`` accelerations,
    within ``rtol = atol = 1e-6`` of
    :func:`repro_torch.kernels.ref.ref_idm_accel`.

    On the card, N up to 8192 runs the one-block sort and search of
    :func:`neighbor_kernel` (each ego's lead: the lowest slot at the nearest
    f32 gap ahead in its lane), larger N the all-pairs kernel
    (``csrc/idm.cu``); one launch either way. The lead, and so the result,
    equals the all-pairs form's bit for bit.
    """
    if pos.device.type == "cpu":
        return ref_idm_accel(pos, vel, lane, active, v0, T, a_max, b_comf, s0,
                             veh_len)
    if pos.device.type == "meta":
        from repro_torch.launch import costing

        costing.kernel_call("idm_accel_kernel", *costing.idm_accel_cost(
            *pos.shape))
        return torch.empty(pos.shape, dtype=torch.float32, device=pos.device)
    if pos.device.type != "cuda":
        raise ValueError(f"idm_accel_kernel runs on cpu or cuda, not {pos.device}")
    return _idm_launch("idm_accel_kernel", "idm_accel_launch", pos, vel, lane,
                       active, v0, T, a_max, b_comf, s0, veh_len)


def _idm_accel_wide(pos, vel, lane, active, v0, T, a_max, b_comf, s0, *,
                    veh_len: float = 4.5):
    """The all-pairs form of :func:`idm_accel_kernel` at any N, on CUDA
    tensors only: the oracle that the sort form equals bit for bit, and the
    time it is held against. No path calls it; its launches count under
    ``launches["idm_accel_wide"]``."""
    if pos.device.type != "cuda":
        raise ValueError(f"_idm_accel_wide runs on cuda only, not {pos.device}")
    return _idm_launch("idm_accel_wide", "idm_accel_wide_launch", pos, vel,
                       lane, active, v0, T, a_max, b_comf, s0, veh_len)


def _idm_launch(name, entry, pos, vel, lane, active, v0, T, a_max, b_comf,
                s0, veh_len):
    """Check the CUDA inputs, launch C entry ``entry`` of ``csrc/idm.cu``
    and count it under ``launches[name]``."""
    b, n = pos.shape
    dev = pos.device
    for arg, t, dt in (
        ("pos", pos, torch.float32), ("vel", vel, torch.float32),
        ("lane", lane, torch.int32), ("active", active, torch.bool),
        ("v0", v0, torch.float32), ("T", T, torch.float32),
        ("a_max", a_max, torch.float32), ("b_comf", b_comf, torch.float32),
        ("s0", s0, torch.float32),
    ):
        _check(arg, t, dt, (b, n), dev)
    acc = torch.empty((b, n), dtype=torch.float32, device=dev)
    fn = symbol("idm", entry, [_P] * 9 + [_I, _I, _F, _P, _P])
    with torch.cuda.device(dev):
        err = fn(pos.data_ptr(), vel.data_ptr(), lane.data_ptr(),
                 active.data_ptr(), v0.data_ptr(), T.data_ptr(),
                 a_max.data_ptr(), b_comf.data_ptr(), s0.data_ptr(), b, n,
                 veh_len, acc.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    launched(name, err, launches)
    return acc
