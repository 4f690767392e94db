"""Synthetic token batches: deterministic and seekable (restart-friendly).

Port of ``repro/data/synthetic.py``. Step ``s`` draws from
``fold_in(key(seed), s)`` through the port's threefry
(:mod:`repro_torch.core.prng`), so the tokens equal the reference's bit for
bit and a restart at ``start_step`` resumes the same stream. A batch carries its
family's extras as the reference's does
(:func:`repro_torch.data.sim_dataset.lm_extras`, frames from
``fold_in(fold_in(key(seed), step), 1)``).
"""

from __future__ import annotations

from typing import Iterator

import torch

from repro_torch.core import prng
from repro_torch.data.sim_dataset import lm_extras
from repro_torch.device import resolve_device

PATTERNS = ("walk", "uniform")


def synthetic_batches(
    cfg,
    batch: int,
    seq: int,
    seed: int = 0,
    start_step: int = 0,
    pattern: str = "walk",
    device: str | torch.device | None = None,
) -> Iterator[dict]:
    """``{"tokens", "labels"}`` (i32 ``[batch, seq]`` on ``device``,
    ``cuda`` unless ``cpu``), with the family's extras, forever.

    ``pattern="walk"``: a random start per row, then the +1 successor walk
    over the vocabulary (learnable, so loss curves mean something);
    ``"uniform"``: i.i.d. tokens (throughput benchmarking).
    """
    if pattern not in PATTERNS:
        raise ValueError(f"pattern must be one of {PATTERNS}, got {pattern!r}")
    dev = resolve_device(device)
    return _batches(cfg, batch, seq, prng.key(seed, dev), start_step,
                    pattern)


def _batches(cfg, batch: int, seq: int, base: torch.Tensor, step: int,
             pattern: str) -> Iterator[dict]:
    vocab = cfg.vocab_size
    walk = torch.arange(seq + 1, dtype=torch.int64, device=base.device)[None]
    while True:
        k = prng.fold_in(base, step)
        if pattern == "uniform":
            toks = prng.randint(k, (batch, seq + 1), 0, vocab)
        else:
            start = prng.randint(k, (batch, 1), 0, vocab).to(torch.int64)
            toks = ((start + walk) % vocab).to(torch.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               **lm_extras(cfg, batch, seq, prng.fold_in(k, 1))}
        step += 1
