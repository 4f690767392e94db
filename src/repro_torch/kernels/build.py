"""Build the hand-written CUDA kernels at first use and load them with
ctypes; check the tensors a wrapper hands them (refusing any that needs a
gradient: no kernel has a backward) and the code a launch returns.

A ``csrc/<name>.cu`` source is compiled by ``nvcc`` for Hopper into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch_kernels/lib<name>-<hash>.so \\
         src/repro_torch/kernels/csrc/<name>.cu

The library name carries a hash of its source and of the headers in
``csrc/`` (``*.cuh``) that sources include, so an edited kernel is rebuilt
and a stale one is never loaded. Output goes to
``build/repro_torch_kernels/`` at the repository root (``.gitignore`` lists
``build/``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, lib: Path) -> None:
    """Run nvcc into a temporary file, then move it into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, lib)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            _compile(name, path)
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


def symbol(lib: str, name: str, argtypes):
    """The C entry ``name`` of ``csrc/<lib>.cu``, built and loaded, with its
    argument types set and an ``int`` (a CUDA error code) as its result
    (ctypes caches the attribute, so its signature is set once)."""
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launched(name: str, err: int, launches: dict[str, int]) -> None:
    """Raise if the launch of kernel ``name`` returned CUDA error ``err``;
    else add one to ``launches[name]``."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launches[name] += 1


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
                 device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's C interface takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through kernel ``name``: grad
    mode is on and an input requires grad. The kernels write their outputs
    through raw pointers, so those outputs would carry no ``grad_fn`` and
    the gradient would stop there without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            "grad. Train through the plain paths, attention_impl(\"xla\") "
            "and recurrence_impl(\"plain\"), or call it under "
            "torch.no_grad().")
