"""Bit-exact threefry2x32 counter PRNG in plain tensor integer code.

The reference draws every random number of the sweep from ``jax.random``
with the ``threefry2x32`` implementation and ``jax_threefry_partitionable``
on. The port reproduces those streams bit for bit, so that a sweep started
from the same seed spawns the same vehicles with the same drivers:

- a key is a ``[..., 2]`` int64 tensor holding two unsigned 32-bit words
  (``jax.random.key_data`` of a reference key);
- ``key``, ``fold_in``, ``split``, ``random_bits``, ``uniform``,
  ``randint`` and ``normal`` follow ``jax/_src/prng.py`` and
  ``jax/_src/random.py`` (partitionable ``random_bits``/``split``;
  ``uniform``'s mantissa trick then ``max(minval, ·)``; ``randint``'s two
  bit draws and span arithmetic; ``normal`` as ``sqrt(2)·erfinv`` of a
  uniform on ``(nextafter(-1, 0), 1)``);
- every function takes a batch of keys: leading key dimensions broadcast,
  the requested ``shape`` is appended after them.

torch's ``uint32`` lacks most arithmetic, so words live in int64 and are
masked back to 32 bits after every add, multiply and rotate.
"""

from __future__ import annotations

import torch

from repro_torch.core.xmath import erf_inv

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block function on broadcastable int64 word tensors.

    Returns the two output words, each of the broadcast shape.
    """
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for r in range(5):
        for rot in _ROT[r % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, rot) ^ x1
        x1 = (x1 + ks[(r + 1) % 3]) & M32
        x2 = (x2 + ks[(r + 2) % 3] + (r + 1)) & M32
    return x1, x2


def key(seed: int, device: str | torch.device) -> torch.Tensor:
    """``jax.random.key(seed)`` as its two words: ``[2]`` int64 on ``device``."""
    hi = (seed >> 32) & M32 if seed >= 0 else 0
    return torch.tensor([hi, seed & M32], dtype=torch.int64, device=device)


def _bcast_words(k: torch.Tensor, shape: tuple[int, ...]):
    """Key words shaped ``[..., 1, ..., 1]`` to broadcast against ``shape``."""
    view = k.shape[:-1] + (1,) * len(shape)
    return k[..., 0].reshape(view), k[..., 1].reshape(view)


def _counts(shape: tuple[int, ...], device) -> tuple[torch.Tensor, torch.Tensor]:
    """``iota_2x32_shape``: the flat index over ``shape`` as (hi, lo) words."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return flat >> 32, flat & M32


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` keys → ``[..., num, 2]``."""
    k1, k2 = _bcast_words(k, (num,))
    hi, lo = _counts((num,), k.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is an int or an integer tensor that
    broadcasts against the key batch ``k.shape[:-1]``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element: ``[..., 2]`` keys → ``[..., *shape]``."""
    shape = tuple(shape)
    k1, k2 = _bcast_words(k, shape)
    hi, lo = _counts(shape, k.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(k: torch.Tensor, shape: tuple[int, ...] = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``[..., 2]`` keys → ``[..., *shape]``.

    ``minval``/``maxval`` are Python floats (converted to float32 first,
    as the reference does).
    """
    f32 = torch.float32
    lo = torch.tensor(minval, dtype=f32, device=k.device)
    hi = torch.tensor(maxval, dtype=f32, device=k.device)
    bits = random_bits(k, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(f32) - 1.0
    # the reference's compiler contracts ``floats * span + lo`` into one
    # fused multiply-add; float64 holds that product and sum exactly for
    # a 23-bit mantissa times a float32 span, so one rounding back to
    # float32 reproduces the fused result bit for bit
    f64 = torch.float64
    scaled = (floats.to(f64) * (hi - lo).to(f64) + lo.to(f64)).to(f32)
    return torch.maximum(lo, scaled)


def randint(k: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` to int32 for Python-int bounds within int32."""
    if not (-2**31 <= minval < 2**31 and -2**31 <= maxval < 2**31):
        raise ValueError("randint bounds must fit in int32")
    ks = split(k, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (2**16) % span
    mult = ((mult * mult) & M32) % span
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    return (minval + off).to(torch.int32)


# --------------------------------------------------------------------------
# normal
# --------------------------------------------------------------------------

def normal(k: torch.Tensor, shape: tuple[int, ...] = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32 or bfloat16: ``[..., 2]`` keys →
    ``[..., *shape]``.

    float32: ``uniform`` on ``(nextafter(-1, 0), 1)``, then ``sqrt(2) ·
    erf_inv`` with the reference compiler's polynomials and contractions
    (within 2 ulps of the reference; almost all draws bit-equal).
    bfloat16: the reference draws 8 bits an element (a bfloat16 has 7
    mantissa bits), the low byte of the 32-bit draw; their top 7 bits make
    the mantissa of a number in [1, 2), which gives the uniform on
    ``(nextafter(-1, 0), 1)`` exactly; ``erf_inv`` is evaluated in float32
    and rounded, then multiplied by ``sqrt(2)`` in bfloat16.
    """
    f32 = torch.float32
    if dtype == f32:
        lo = -0.99999994039535522   # nextafter(-1, 0) in float32
        return erf_inv(uniform(k, shape, lo, 1.0)) * torch.tensor(
            2.0 ** 0.5, dtype=f32, device=k.device)
    if dtype != torch.bfloat16:
        raise TypeError(f"normal draws float32 or bfloat16, not {dtype}")
    bf16 = torch.bfloat16
    bits = random_bits(k, shape) & 0xFF
    floats = ((bits >> 1) | 0x3F80).to(torch.int16).view(bf16) - 1.0
    lo = torch.tensor(-1.0 + 2.0 ** -8, dtype=bf16, device=k.device)
    # floats * (1 - lo) + lo: 1 - lo rounds to 2 in bfloat16; every step is
    # exact in float32 and the sum is a bfloat16 number
    u = torch.maximum(lo, (floats.float() * 2.0 + lo.float()).to(bf16))
    return erf_inv(u.float()).to(bf16) * torch.tensor(2.0 ** 0.5, dtype=bf16,
                                                        device=k.device)
