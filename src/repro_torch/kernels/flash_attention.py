"""Wrapper for the hand-written flash attention kernels
(``csrc/flash_attention.cu``), which replace
``repro/kernels/flash_attention.py::flash_attention``.

On a CPU tensor ``flash_attention`` runs the kernel's plain PyTorch version
(:func:`repro_torch.kernels.ref.ref_attention`). On a CUDA tensor it
refuses an input that needs a gradient (``build.refuse_grad``: no kernel
has a backward), checks device, dtype, shape, contiguity and 16-byte
alignment, allocates the output with ``torch.empty``, launches a kernel
on the tensors' card (under a device guard) and its current stream
without synchronising, raises if the launch was refused, and adds one to
``launches["flash_attention"]``.
There is no fallback from a CUDA tensor to the plain version, nor from one
kernel to the other. On a ``meta`` tensor it returns a ``meta`` output and
adds its work to the costing (:func:`repro_torch.launch.costing.kernel_call`),
which raises unless the costing is counting.

One C entry, two kernels: bf16 runs on the Hopper tensor cores
(``flash_fwd_wgmma``: wgmma for both products, K/V tiles by TMA into an
mbarrier ring, P·V formed from p at about f32 precision as the residual
sum of two bf16 products, as the Pallas kernel forms it from p in f32);
f32 runs on the CUDA cores (``flash_fwd``),
since wgmma takes no f32 input and TF32 would not hold the f32 tolerance.
The bf16 kernel's TMA descriptors are encoded per launch with
``cuTensorMapEncodeTiled``, reached through the CUDA runtime's driver
entry point, so the library links nothing beyond the runtime.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (check_tensor, launched, refuse_grad,
                                       symbol)
from repro_torch.kernels.ref import ref_attention

#: launch count; only a real kernel launch increments it
launches = {"flash_attention": 0}

#: head dims the kernel is instantiated for: the reduced configs' 16, the
#: Pallas kernel's tests' 32 and the published configs' widths
HEAD_DIMS = (16, 32, 64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 9 + [_F, _F, _P]


def reset_launches() -> None:
    """Set the launch count to 0."""
    launches.update(dict.fromkeys(launches, 0))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    work_dims: tuple[int, int] | None = None):
    """Online-softmax attention: ``q [B, Sq, H, D]``, ``k``/``v
    [B, Sk, K, D]`` (bf16 or f32, ``H % K == 0``) → ``[B, Sq, H, D]`` in
    ``q``'s type, with end-aligned causal masking, a sliding ``window``
    (0: none) and the tanh logit ``softcap`` (0: none). ``work_dims``
    names the unpadded (q/k, v) head dims of zero-padded inputs, for the
    costing alone."""
    b, sq, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal, window, softcap, scale)
    if q.device.type == "meta":
        from repro_torch.launch import costing

        refuse_grad("flash_attention", q, k, v)
        costing.kernel_call("flash_attention", *costing.flash_cost(
            b, sq, k.shape[1], h, k.shape[2], d, causal, window,
            q.element_size(), work_dims))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    refuse_grad("flash_attention", q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k must have shape [{b}, Sk, K, {d}], got "
                         f"{tuple(k.shape)}")
    sk, kh = k.shape[1], k.shape[2]
    if h % kh != 0:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if min(b, sq, sk) == 0:
        raise ValueError("flash_attention needs non-empty q and k")
    if b > 65535 or h > 65535:
        raise ValueError("flash_attention takes at most 65535 batch rows "
                         "and 65535 heads")
    for name, t, shape in (("q", q, (b, sq, h, d)), ("k", k, (b, sk, kh, d)),
                           ("v", v, (b, sk, kh, d))):
        check_tensor(name, t, q.dtype, shape, q.device)
        if t.data_ptr() % 16:
            # TMA (bf16) and 16-byte vector loads (f32) need aligned rows
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    fn = symbol("flash_attention", "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), b, sq, sk, h, kh, d,
                 int(causal), int(window), float(softcap), float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    launched("flash_attention", err, launches)
    return out
