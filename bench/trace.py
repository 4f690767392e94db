"""The device trace of a run: the profiler's device operations, the time the
device was busy, and where it was idle.

The profiler records device activity only: host events for a window's
hundreds of thousands of kernels would cost more than the kernels. What
the host was doing in an idle gap comes from the benchmark's own spans.
Device timestamps come on the wall clock (``time.time_ns``); the spans are
``time.perf_counter_ns`` readings, so events are moved by the offset
between the two, read once when tracing starts.
"""

from __future__ import annotations

import bisect
import contextlib
import time

TOP = 10          # entries in each list of the breakdown
NAME_CHARS = 96   # a kernel's name is cut to this many characters


class DeviceTrace:
    """Profiles the device while active; ``events`` then holds ``(name,
    start_ns, end_ns)`` of every device operation (kernels, copies,
    memsets) on the ``perf_counter_ns`` clock."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: list[tuple[str, int, int]] | None = None
        self._stack = contextlib.ExitStack()
        self._prof = None
        self._offset = 0
        self.stop_s = 0.0  # seconds the profiler took to stop

    def __enter__(self) -> "DeviceTrace":
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = self._stack.enter_context(
                profile(activities=[ProfilerActivity.CUDA]))
            self._offset = time.time_ns() - time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t0 = time.perf_counter()
        self._stack.close()
        self.stop_s = time.perf_counter() - t0
        if self._prof is None or exc[0] is not None:
            return
        from torch.autograd import DeviceType

        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
                continue
            start = e.start_ns() - self._offset
            events.append((e.name(), start, start + e.duration_ns()))
        events.sort(key=lambda ev: ev[1])
        self.events = events


def busy_intervals(events, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of the events' intervals, clipped to ``[lo, hi]``."""
    out: list[list[int]] = []
    for _, s, e in events:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(events, lo: int, hi: int) -> int:
    """Nanoseconds of ``[lo, hi]`` in which some device operation ran."""
    return sum(e - s for s, e in busy_intervals(events, lo, hi))


def top_ops(events) -> list[list]:
    """The device operations that took most time, summed by name:
    ``[[name, seconds], ...]``."""
    totals: dict[str, int] = {}
    for name, s, e in events:
        totals[name] = totals.get(name, 0) + (e - s)
    ranked = sorted(totals.items(), key=lambda kv: kv[1], reverse=True)
    return [[name[:NAME_CHARS], ns / 1e9] for name, ns in ranked[:TOP]]


def idle_gaps(events, lo: int, hi: int, spans) -> list[list]:
    """The longest stretches of ``[lo, hi]`` with no device operation, each
    named by the host span it lies in (``supervisor`` outside every span),
    with the chunk it belongs to: ``[[what, seconds], ...]``."""
    busy = busy_intervals(events, lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    starts = [s for _, s, _ in spans]
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0:
            what = "window start, before chunk 0"
        elif mid < spans[i][2]:
            what = f"{spans[i][0]} chunk {i}"
        else:
            what = f"supervisor after chunk {i}"
        named.append([what, (e - s) / 1e9])
    named.sort(key=lambda g: g[1], reverse=True)
    return named[:TOP]
