"""Wrapper for the hand-written RG-LRU scan kernel (``csrc/rglru.cu``), which
replaces ``repro/kernels/rglru.py::rglru_linear_scan``.

On a CPU tensor ``rglru_linear_scan`` runs the kernel's plain PyTorch
version (:func:`repro_torch.kernels.ref.ref_rglru`). On a CUDA tensor it
refuses an input that needs a gradient (``build.refuse_grad``: no kernel
has a backward), checks device, dtype, shape and contiguity, allocates the
outputs and the chunked scan's scratch (each chunk's aggregate and
inclusive state, the flags and the counter that orders the blocks) with
``torch.empty``, launches the kernel on the tensors' card (under a device
guard) and its current stream without synchronising, raises if the launch
was refused, and adds one to ``launches["rglru_linear_scan"]``. There is no
fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (check_tensor, launched, refuse_grad,
                                       symbol)
from repro_torch.kernels.ref import ref_rglru

#: launch count; only a real kernel launch increments it
launches = {"rglru_linear_scan": 0}

#: steps a block of the chunked scan takes (``T`` in ``csrc/rglru.cu``)
CHUNK = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 4 + [_P]


def reset_launches() -> None:
    """Set the launch count to 0."""
    launches.update(dict.fromkeys(launches, 0))


def rglru_linear_scan(a, x, h0):
    """``h_t = a_t ⊙ h_{t−1} + x_t`` over ``a [B, S, W]`` f32, ``x [B, S, W]``
    (bf16 or f32) and ``h0 [B, W]`` f32. Returns ``(ys [B, S, W]`` in ``x``'s
    type, ``h_final [B, W]`` f32)."""
    if x.device.type == "cpu":
        ys, h = ref_rglru(a, x, h0)
        return ys.to(x.dtype), h
    if x.device.type != "cuda":
        raise ValueError(f"rglru_linear_scan runs on cpu or cuda, not "
                         f"{x.device}")
    refuse_grad("rglru_linear_scan", a, x, h0)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 3 or min(x.shape[0], x.shape[2]) == 0:
        raise ValueError(f"x must have shape [B, S, W] with B, W > 0, got "
                         f"{tuple(x.shape)}")
    b, s, w = x.shape
    dev = x.device
    check_tensor("a", a, torch.float32, (b, s, w), dev)
    check_tensor("x", x, x.dtype, (b, s, w), dev)
    check_tensor("h0", h0, torch.float32, (b, w), dev)
    ys = torch.empty_like(x)
    h_final = torch.empty((b, w), dtype=torch.float32, device=dev)
    nc = max(1, -(-s // CHUNK))  # S 0 runs as one empty chunk
    scratch = torch.empty(b * nc * (3 * w + -(-w // 32)) + 1,
                          dtype=torch.float32, device=dev)
    fn = symbol("rglru", "rglru_linear_scan_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(), ys.data_ptr(),
                 h_final.data_ptr(), scratch.data_ptr(),
                 int(x.dtype == torch.bfloat16), b, s, w,
                 torch.cuda.current_stream(dev).cuda_stream)
    launched("rglru_linear_scan", err, launches)
    return ys, h_final
