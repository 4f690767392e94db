"""Wrapper for the hand-written WKV6 kernel (``csrc/wkv6.cu``), which replaces
``repro/kernels/rwkv6.py::wkv6``.

On a CPU tensor ``wkv6`` runs the kernel's plain PyTorch version
(:func:`repro_torch.kernels.ref.ref_wkv6`). On a CUDA tensor it refuses
an input that needs a gradient (``build.refuse_grad``: no kernel has a
backward), checks device, dtype, shape and contiguity, allocates the
outputs and the chunked form's scratch (each chunk's aggregate, inclusive
state and flag, and the counter that orders the blocks) with
``torch.empty``, launches the kernels on the tensors' card (under a device
guard) and its current stream without synchronising, raises if a launch
was refused, and adds one to ``launches["wkv6"]``: one per call, however
many device kernels the call runs. There is no fallback from a CUDA tensor to the plain version.
On a ``meta`` tensor it returns ``meta`` outputs and adds its work to the
costing (:func:`repro_torch.launch.costing.kernel_call`), which raises
unless the costing is counting.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (check_tensor, launched, refuse_grad,
                                       symbol)
from repro_torch.kernels.ref import ref_wkv6

#: launch count; only a real kernel launch increments it
launches = {"wkv6": 0}

#: the largest key and value head dims the kernel takes; the scratch state
#: is padded to this
MAX_HEAD_DIM = 64
#: steps per chunk (``C`` in ``csrc/wkv6.cu``)
CHUNK = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 6 + [_P]


def reset_launches() -> None:
    """Set the launch count to 0."""
    launches.update(dict.fromkeys(launches, 0))


def wkv6(r, k, v, w, u, s0):
    """The WKV6 recurrence: ``r``, ``k`` ``[B, S, H, K]`` and ``v [B, S, H, V]``
    (bf16 or f32, one type), ``w [B, S, H, K]``, ``u [H, K]`` and ``s0
    [B, H, K, V]`` f32; ``y_t = r_tᵀ(S + u⊙k_t v_tᵀ)``, then ``S ← w_t⊙S +
    k_t v_tᵀ``. Returns ``(y [B, S, H, V]`` in ``v``'s type, ``S_final
    [B, H, K, V]`` f32)."""
    if v.device.type == "cpu":
        y, state = ref_wkv6(r, k, v, w, u, s0)
        return y.to(v.dtype), state
    if v.device.type == "meta":
        from repro_torch.launch import costing

        refuse_grad("wkv6", r, k, v, w, u, s0)
        b, s, h, kd = r.shape
        vd = v.shape[3]
        ops, nbytes = costing.wkv6_cost(b, s, h, kd, vd, v.element_size())
        costing.kernel_call("wkv6", ops, nbytes)
        return (torch.empty_like(v),
                torch.empty((b, h, kd, vd), dtype=torch.float32,
                            device=v.device))
    if v.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cpu or cuda, not {v.device}")
    refuse_grad("wkv6", r, k, v, w, u, s0)
    if v.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"v must be bfloat16 or float32, got {v.dtype}")
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"r and v must be [B, S, H, K] and [B, S, H, V], got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    b, s, h, kd = r.shape
    vd = v.shape[3]
    if min(b, h, kd, vd) == 0 or kd > MAX_HEAD_DIM or vd > MAX_HEAD_DIM:
        raise ValueError(f"wkv6 takes 1 <= K, V <= {MAX_HEAD_DIM} and "
                         f"B, H > 0, got r {tuple(r.shape)}, v "
                         f"{tuple(v.shape)}")
    if b > 65535:
        raise ValueError("wkv6 takes at most 65535 batch rows")
    dev = v.device
    for name, t, dtype, shape in (
        ("r", r, v.dtype, (b, s, h, kd)), ("k", k, v.dtype, (b, s, h, kd)),
        ("v", v, v.dtype, (b, s, h, vd)), ("w", w, torch.float32, (b, s, h, kd)),
        ("u", u, torch.float32, (h, kd)),
        ("s0", s0, torch.float32, (b, h, kd, vd)),
    ):
        check_tensor(name, t, dtype, shape, dev)
    y = torch.empty_like(v)
    state = torch.empty((b, h, kd, vd), dtype=torch.float32, device=dev)
    nc = max(1, -(-s // CHUNK))  # S 0 runs as one empty chunk
    scratch = torch.empty(
        b * h * nc * (2 * MAX_HEAD_DIM**2 + MAX_HEAD_DIM + 1) + 1,
        dtype=torch.float32, device=dev)
    fn = symbol("wkv6", "wkv6_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(), state.data_ptr(),
                 scratch.data_ptr(),
                 int(v.dtype == torch.bfloat16), b, s, h, kd, vd,
                 torch.cuda.current_stream(dev).cuda_stream)
    launched("wkv6", err, launches)
    return y, state
