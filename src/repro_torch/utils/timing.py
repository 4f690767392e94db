"""Timing helpers for benchmarks (port of ``repro/utils/timing.py``).

:class:`Timer` reads the host clock. :func:`bench` times a call that may
run on the card, where PyTorch returns before the device finishes: on
``cuda`` it brackets each call with CUDA events and waits for the end
event, so the reading is the device's time for the call; on the CPU it
reads the host clock around a call whose work is done when it returns.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class Timer:
    """Accumulating timer; ``with timer.measure(): ...`` adds one sample."""

    def __init__(self) -> None:
        self.samples: list[float] = []

    @contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    @property
    def total(self) -> float:
        return sum(self.samples)

    @property
    def mean(self) -> float:
        return self.total / len(self.samples) if self.samples else 0.0

    @property
    def best(self) -> float:
        return min(self.samples) if self.samples else 0.0

    def us_per_call(self) -> float:
        return self.best * 1e6


def _device(x) -> torch.device | None:
    """The device of the first tensor in ``x`` (a tensor or a nested
    tuple, list or dict of them)."""
    if isinstance(x, torch.Tensor):
        return x.device
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for item in items:
        dev = _device(item)
        if dev is not None:
            return dev
    return None


def bench(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Best-of-``iters`` seconds of ``fn(*args)``, after ``warmup`` calls.

    The device is the first tensor's among the arguments, or else the
    result's. On ``cuda`` each call is timed by CUDA events on the
    current stream; elsewhere by the host clock."""
    dev = _device(args)
    for _ in range(warmup):
        out = fn(*args)
        dev = dev or _device(out)
    if dev is None:
        dev = _device(fn(*args))
    if dev is None or dev.type != "cuda":
        t = Timer()
        for _ in range(iters):
            with t.measure():
                fn(*args)
        return t.best
    times = []
    with torch.cuda.device(dev):
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    return min(times)
