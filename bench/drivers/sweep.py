"""The sweep driver: one configuration's sweep under one traffic mix.

Set-up: the neighbour kernel built (``nvcc``, into the program's fixed
build directory inside the checkout) and loaded, the sweep's state drawn
on the device from ``--seed`` by the runner's own ``init``, and one warm-up
chunk of ``warmup_steps`` steps through the same loop and a runner of the
same configuration, so that every shape of every group call has run once.

The window drives the launcher's loop,
:func:`repro_torch.core.fleet.run_supervised` over a
:class:`repro_torch.core.sweep.SweepRunner`, with no fault model,
checkpoint or writer, in whole chunks: it starts at a chunk boundary and
ends at the first chunk boundary at or after ``seconds`` (or when the
sweep completes). The benchmark's spans wrap each ``run_chunk`` call.

Then the peak memory is read, a sample of ``check_rows`` instances drawn
from the seed is copied to the host, the program's state is freed, and
the plain reference (:mod:`bench.reference`) re-derives those instances
from the seed and replays them for the steps the window ran. The
comparison is exact: every state, draw, metric and trace element of the
sample must equal the reference's bit for bit (the limits and the
readings they rest on are in ``PERF.md``).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from bench.harness import Check, Run
from bench.reference import sim as ref_sim
from bench.reference.replay import Sweep, replay
from bench.trace import DeviceTrace

# the numbers compared and their limits: the count of elements of the
# sample that differ from the reference by any bit
LIMITS = {"state_bits_differ": 0, "metrics_bits_differ": 0,
          "trace_bits_differ": 0}


class _WindowClosed(Exception):
    """Raised from the supervisor's progress hook at the first chunk
    boundary at or after the window's end."""


class _Timed:
    """The runner as ``run_supervised`` sees it: every attribute is the
    runner's, and ``run_chunk`` is wrapped in a span."""

    def __init__(self, runner, end_ns: int):
        self._runner = runner
        self._end_ns = end_ns
        self.spans: list[tuple[str, int, int]] = []
        self.state = None

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def run_chunk(self, state, hold=None):
        t0 = time.perf_counter_ns()
        state = self._runner.run_chunk(state, hold=hold)
        self.spans.append(("run_chunk", t0, time.perf_counter_ns()))
        self.state = state
        return state

    def progress(self, chunk: int, done_frac: float) -> None:
        # called after the chunk's completion bitmap reached the host, so
        # the device has finished the chunk
        if time.perf_counter_ns() >= self._end_ns:
            raise _WindowClosed


def roster(config: dict) -> tuple[str, ...]:
    return tuple(config["roster"])


def program_config(config: dict, traffic: dict, n: int, seed: int):
    """The program's ``SweepConfig`` for this cell."""
    from repro_torch.core.record import RecordConfig
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.sweep import SweepConfig

    names = roster(config)
    rec = traffic["record"]
    return SweepConfig(
        n_instances=n,
        steps_per_instance=config["sweep"]["steps_per_instance"],
        chunk_steps=config["sweep"]["chunk_steps"],
        sim=SimConfig(**config["sim"], scenario=names[0]),
        seed=seed,
        vary_horizon=traffic["vary_horizon"],
        min_horizon_frac=traffic.get("min_horizon_frac", 0.5),
        compaction=config["sweep"]["compaction"],
        scenario_mix=names if len(names) > 1 else (),
        dispatch=config["sweep"]["dispatch"],
        record=(RecordConfig(record_every=rec["every"],
                             fields=tuple(rec["fields"]),
                             k_slots=rec["k_slots"]) if rec else None),
    )


def reference_sweep(config: dict, traffic: dict,
                    dtype: torch.dtype = torch.float32) -> Sweep:
    """The reference's description of the same sweep, its floating state
    in ``dtype``."""
    sim = {k: v for k, v in config["sim"].items() if k != "neighbor_impl"}
    rec = traffic["record"]
    return Sweep(
        roster=roster(config),
        sim=ref_sim.SimConfig(**sim, dtype=dtype),
        steps_per_instance=config["sweep"]["steps_per_instance"],
        record=(ref_sim.RecordConfig(rec["every"], tuple(rec["fields"]),
                                     rec["k_slots"]) if rec else None),
        vary_horizon=traffic["vary_horizon"],
        min_horizon_frac=traffic.get("min_horizon_frac", 0.5),
    )


def groups(config: dict, n: int) -> list[dict]:
    """Each batched call of one step as the cell defines it: the
    instances of each roster entry, stepped with that scenario's physics."""
    names = roster(config)
    sim = ref_sim.SimConfig(**{k: v for k, v in config["sim"].items()
                               if k != "neighbor_impl"})
    out = []
    for r, name in enumerate(names):
        geom = ref_sim.SCENARIOS[name].geometry(sim)
        out.append({"scenario": name, "rows": len(range(r, n, len(names))),
                    "n_slots": sim.n_slots, "n_lanes": sim.n_lanes,
                    "n_lanes_total": geom.n_lanes_total})
    return out


def sample_ids(seed: int, n: int, k: int) -> np.ndarray:
    """The instances checked against the reference, drawn from the seed."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def _rows(tree, idx):
    if tree is None:
        return None
    return type(tree)(*(x.index_select(0, idx).cpu() for x in tree))


def _differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element: does ``a`` (in ``b``'s type) differ from ``b`` by any
    bit?"""
    a = a.to(b.dtype)
    if b.is_floating_point():
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[b.element_size()]
        return a.view(width) != b.view(width)
    return a != b


def compare(got: dict, want: dict) -> tuple[list[Check], int]:
    """The checks of a sample (``got`` and ``want`` as :func:`replay`
    returns them) and the number of sampled instances that differ."""
    parts = {"state_bits_differ": ("state", "params"),
             "metrics_bits_differ": ("metrics",),
             "trace_bits_differ": ("trace",)}
    checks, bad_rows = [], None
    for name, keys in parts.items():
        if want[keys[0]] is None:
            continue
        total = 0
        for key in keys:
            for a, b in zip(got[key], want[key]):
                d = _differ(a, b).reshape(b.shape[0], -1)
                total += int(d.sum())
                row = d.any(dim=1)
                bad_rows = row if bad_rows is None else bad_rows | row
        checks.append(Check(name, total, LIMITS[name]))
    return checks, int(bad_rows.sum())


def _allocator(device: torch.device) -> dict:
    """The caching allocator's counts of device mallocs and of retries
    after a failed one (a malloc in the window stalls the device)."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ("num_device_alloc",
                                         "num_alloc_retries")}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config: dict, traffic: dict, seed: int, seconds: float,
        profiled: bool, device: str, t_start: float,
        instances: int | None = None) -> Run:
    """One run of the cell: set-up, the window (under the profiler where
    ``profiled``), the check. ``instances`` overrides the traffic's count
    (the CPU tests' tiny runs)."""
    from repro_torch.core.fleet import run_supervised
    from repro_torch.core.sweep import SweepRunner

    dev = torch.device(device)
    n = int(instances or traffic["instances"])
    cfg = program_config(config, traffic, n, seed)
    phases = {"imports": time.perf_counter()}
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)  # the context
        phases["cuda"] = time.perf_counter()
        if cfg.sim.neighbor_impl == "cuda":
            from repro_torch.kernels import build

            build.load("idm")
            phases["kernel"] = time.perf_counter()
    runner = SweepRunner(cfg, device=dev)
    state = runner.init()
    _synchronize(dev)
    phases["init"] = time.perf_counter()
    # the warm-up chunk goes through the window's own loop, so that the
    # allocator also holds what the loop holds (the chunk's snapshot)
    warm = int(traffic["warmup_steps"])
    state, _ = run_supervised(
        SweepRunner(dataclasses.replace(cfg, chunk_steps=warm), device=dev),
        state=state, max_chunks=1)
    t_warm = state.sim.t.cpu().numpy().astype(np.int64)
    horizon = state.horizon.cpu().numpy().astype(np.int64)
    _synchronize(dev)
    phases["warmup"] = time.perf_counter()
    setup_s = phases["warmup"] - t_start
    marks = [t_start, *phases.values()]
    print("setup: " + ", ".join(f"{name} {b - a:.3f} s" for name, a, b in
                                zip(phases, marks, marks[1:])),
          file=sys.stderr, flush=True)

    allocs = _allocator(dev)
    with DeviceTrace(profiled and dev.type == "cuda") as trace:
        # the profiler takes seconds to start: the window opens after it
        start = time.perf_counter_ns()
        timed = _Timed(runner, start + int(seconds * 1e9))
        timed.state = state
        try:
            run_supervised(timed, state=state, max_chunks=10**9,
                           on_progress=timed.progress)
        except _WindowClosed:
            pass
        end = time.perf_counter_ns()
    if trace.events is not None:
        print(f"trace: {len(trace.events)} device operations, the "
              f"profiler stopped in {trace.stop_s:.3f} s, read in "
              f"{(time.perf_counter_ns() - end) / 1e9 - trace.stop_s:.3f} s",
              file=sys.stderr, flush=True)
    del state
    chunks = len(timed.spans)
    chunk = cfg.chunk_steps
    t_end = np.minimum(t_warm + chunks * chunk, horizon)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    after = _allocator(dev)
    print("window: " + " ".join(
        f"{(s - p) / 1e6:.1f}+{(e - s) / 1e6:.1f}" for (_, s, e), p in zip(
            timed.spans, [start] + [e for _, _, e in timed.spans]))
        + " ms (supervisor+run_chunk a chunk); allocator in the window: "
        + ", ".join(f"{k} {after[k] - allocs[k]}" for k in allocs),
        file=sys.stderr, flush=True)

    ids = sample_ids(seed, n, int(traffic["check_rows"]))
    idx = torch.as_tensor(ids, device=dev)
    final = timed.state
    got = {"state": _rows(final.sim, idx), "metrics": _rows(final.metrics, idx),
           "params": _rows(final.params, idx),
           "trace": _rows(final.trace, idx)}
    spans = timed.spans
    del final, timed, runner
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # steps past every horizon change nothing: the reference stops there
    want = replay(reference_sweep(config, traffic), seed, ids,
                  int(min(warm + chunks * chunk, horizon.max())), dev)
    checks, failed = compare(got, want)
    return Run(
        config=config, traffic=traffic, setup_s=setup_s,
        window_start_ns=start, window_end_ns=end,
        steps=chunks * chunk, chunks=chunks,
        instance_steps=int((t_end - t_warm).sum()),
        attempted=n, failed=failed, checks=checks,
        memory_peak_bytes=int(memory_peak), groups=groups(config, n),
        spans=spans, device_events=trace.events,
    )
