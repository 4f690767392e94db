#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card   — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build  — compile ``src/repro_torch/kernels/csrc/idm.cu`` with nvcc;
3. kernels — hold each hand-written kernel against its plain PyTorch version
   on the card (``neighbor_kernel`` bit-exact on all six outputs;
   ``idm_accel_kernel`` within rtol = atol = 1e-6, because its IDM epilogue
   divides, takes a square root and sums in an order the compiler may
   schedule differently from PyTorch's element-wise kernels), at the sweep's
   own shapes and larger ones, and time kernel, plain version and bound;
4. sweep  — the port's launcher in-process at full size (1024 instances,
   128 slots, the four-scenario mix, grouped dispatch, ``--neighbor-impl
   cuda``): completion must reach 1.0 and the neighbor kernel's launch
   count must equal 2 x chunk_steps x the batched chunk calls made;
5. reference — a small sweep on the card (``cuda`` impl) against the same
   sweep on the CPU (``sort`` impl): integer counters equal, floats close;
6. parity — 64 instances, 400 steps: the ``cuda`` and ``sort`` impls on the
   card must give a bit-identical final ``SweepState``;
7. profile — host ms per step of one sweep group, and under
   ``torch.profiler`` the device's busy time, its share of the profiled
   wall time and of the unprofiled step, and the heaviest kernels.

The second-to-last lines are the kernels JSON and the ``nvidia-smi`` line;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# non-tensor-core float32 rate
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
N_LANES = 4                       # 3 main lanes + ramp, as the sweep
SWEEP = dict(instances=1024, slots=128, steps=1200, chunk_steps=400)
SOURCE = "src/repro_torch/kernels/csrc/idm.cu"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 10, trials: int = 21) -> float:
    """Device time of one ``fn()`` call in ms: the median over ``trials``
    CUDA-event timings, each over ``reps`` back-to-back calls, after
    warm-up.

    The stream is first held busy with ``torch.cuda._sleep`` for longer
    than the host takes to enqueue the timed launches, so the events
    bracket launches that run back to back on the device and the host's
    launch overhead stays out of the reading.
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host_s, 1e-3) * 3 * 2.0e9)
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def rand_world(gen, b: int, n: int, p_act: float = 0.8):
    """Random worlds with forced exact position ties and inactive slots
    (the tie-break edge cases of the neighbor contract)."""
    import torch

    dev = gen.device
    pos = torch.rand((b, n), generator=gen, device=dev) * 900.0
    lane = torch.randint(0, N_LANES, (b, n), generator=gen, device=dev,
                         dtype=torch.int32)
    if n > 4:
        pos[:, 1] = pos[:, 0]
        pos[:, 4] = pos[:, 0]
        lane[:, 1] = lane[:, 0]
        lane[:, 4] = lane[:, 0]
    active = torch.rand((b, n), generator=gen, device=dev) < p_act
    return pos, lane, active


def lane_tables_query(b: int, q: int, n: int, lane):
    """The query rows the sweep gives the kernel: one row per lane for a
    table build, the vehicles' own lanes for the single query."""
    import torch

    if q == 1:
        return lane[:, None, :].contiguous()
    rows = torch.arange(q, dtype=torch.int32, device=lane.device)
    return rows[None, :, None].expand(b, q, n).contiguous()


def same_lane_pairs(lane, active, query_lanes) -> int:
    """Ego/other pairs the search must test: active ego, active other in
    the ego's query lane (counts this input's work, not the worst case)."""
    import torch

    lanes = int(max(lane.max(), query_lanes.max())) + 1
    per_lane = torch.zeros((lane.shape[0], lanes), dtype=torch.int64,
                           device=lane.device)
    per_lane.scatter_add_(1, lane.long(), active.long())
    hits = per_lane.gather(1, query_lanes.flatten(1).long())
    hits = hits.view(query_lanes.shape) * active[:, None, :]
    return int(hits.sum())


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, idm, ref):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b_main = SWEEP["instances"] // 4
    n_main = SWEEP["slots"]
    shapes = [
        (b_main, n_main, 4), (b_main, n_main, 3), (b_main, n_main, 1),
        (1024, 128, 4), (1024, 128, 1), (48, 512, 4),
    ]
    results = []
    for b, n, q in shapes:
        pos, lane, active = rand_world(gen, b, n)
        ql = lane_tables_query(b, q, n, lane)
        got = idm.neighbor_kernel(pos, lane, active, ql, veh_len=4.5)
        want = ref.ref_neighbor_mq(pos, lane, active, ql, 4.5)
        torch.cuda.synchronize()
        for name, g, w in zip(("lead_idx", "lead_gap", "has_lead", "foll_idx",
                               "foll_gap", "has_foll"), got, want):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(
                    f"neighbor_kernel != ref_neighbor_mq on {name} at "
                    f"B={b} N={n} Q={q} ({bad} elements differ)")
        err = max(float((g.float() - w.float()).abs().max()) for g, w in
                  zip(got, want))
        ms = device_ms(lambda: idm.neighbor_kernel(pos, lane, active, ql,
                                                   veh_len=4.5))
        plain_ms = device_ms(lambda: ref.ref_neighbor_mq(pos, lane, active,
                                                         ql, 4.5), reps=2)
        bytes_moved = b * n * (4 + 4 + 1) + b * q * n * 4 + b * q * n * 18
        ops = 3 * same_lane_pairs(lane, active, ql)
        bound_ms, bound_by = bound(bytes_moved, ops)
        results.append(dict(B=b, N=n, Q=q, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by))
        log(f"neighbor_kernel B={b} N={n} Q={q}: bit-exact; kernel {ms:.5f} ms,"
            f" plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})")

    idm_results = []
    for b, n in ((b_main, n_main), (1024, 128), (48, 512)):
        pos, lane, active = rand_world(gen, b, n)

        def rnd(lo, hi):
            return torch.rand((b, n), generator=gen, device="cuda") * (hi - lo) + lo

        vel, v0, T = rnd(0.0, 35.0), rnd(20.0, 35.0), rnd(0.8, 1.8)
        a_max, b_comf, s0 = rnd(1.0, 2.5), rnd(1.5, 3.0), rnd(1.0, 2.5)
        args = (pos, vel, lane, active, v0, T, a_max, b_comf, s0)
        got = idm.idm_accel_kernel(*args, veh_len=4.5)
        want = ref.ref_idm_accel(*args, 4.5)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        err = float((got - want).abs().max())
        ms = device_ms(lambda: idm.idm_accel_kernel(*args, veh_len=4.5))
        plain_ms = device_ms(lambda: ref.ref_idm_accel(*args, 4.5), reps=2)
        bytes_moved = b * n * (7 * 4 + 4 + 1) + b * n * 4
        own = lane[:, None, :]
        ops = 3 * same_lane_pairs(lane, active, own) + 16 * b * n
        bound_ms, bound_by = bound(bytes_moved, ops)
        idm_results.append(dict(B=b, N=n, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by))
        log(f"idm_accel_kernel B={b} N={n}: max |err| {err:.3g} (tol 1e-6); "
            f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
    return results, idm_results


def profile_phase(torch) -> dict:
    """Where a group call's time goes: host time per step without the
    profiler, then a ``torch.profiler`` window over the same steps for the
    device's busy share and its heaviest kernels (one highway_merge group
    of the sweep: B = instances / 4, N = slots, after 100 warm-up steps)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.simulator import rollout_chunk
    from repro_torch.core.sweep import SweepConfig, SweepRunner

    steps = 20
    cfg = SweepConfig(n_instances=SWEEP["instances"] // 4,
                      steps_per_instance=10**6, chunk_steps=steps,
                      sim=SimConfig(n_slots=SWEEP["slots"],
                                    neighbor_impl="cuda"))
    state = SweepRunner(cfg, device="cuda").init()
    sp, h = state.params, state.horizon
    sim, m = rollout_chunk(state.sim, state.metrics, sp, h, cfg.sim, 100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim, m = rollout_chunk(sim, m, sp, h, cfg.sim, steps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout_chunk(sim, m, sp, h, cfg.sim, steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device's own events (kernels, copies, memsets); the CPU ops that
    # launched them carry the same time again as their "self device" time
    events = [e for e in prof.key_averages() if dev_us(e) > 0 and
              "cuda" in str(getattr(e, "device_type", "")).lower()]
    busy_us = sum(dev_us(e) for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:6]
    device_ms = busy_us / steps / 1e3
    # two shares of one busy time: over the profiled window's own wall
    # time (the profiler slows the host, so this understates the share),
    # and over the unprofiled step measured just before (two windows of
    # the same 20 steps; the device's work per step is the same in both)
    out = dict(host_ms_per_step=host_ms,
               profiled_wall_ms_per_step=wall_us / steps / 1e3,
               device_ms_per_step=device_ms,
               device_busy_share=busy_us / wall_us if busy_us else None,
               device_share_of_unprofiled_step=(device_ms / host_ms
                                                if busy_us else None),
               device_kernels_per_step=launches / steps,
               top=[(e.key[:60], dev_us(e) / steps / 1e3) for e in top])
    if busy_us:
        log(f"profile: highway_merge group B={cfg.n_instances} N="
            f"{SWEEP['slots']}: {host_ms:.3f} ms/step unprofiled; under the "
            f"profiler {out['profiled_wall_ms_per_step']:.3f} ms/step wall, "
            f"device busy {device_ms:.4f} ms/step = "
            f"{100 * out['device_busy_share']:.2f}% of the profiled wall, "
            f"{100 * out['device_share_of_unprofiled_step']:.2f}% of the "
            f"unprofiled step (idle {100 - 100 * out['device_share_of_unprofiled_step']:.2f}%), "
            f"{out['device_kernels_per_step']:.0f} device kernels/step")
        for name, ms in out["top"]:
            log(f"profile:   {ms:.5f} ms/step  {name}")
    else:
        log(f"profile: {host_ms:.3f} ms/step unprofiled; the profiler "
            "recorded no device time: device busy share not measured")
    return out


def states_equal(torch, a, b, path="state") -> None:
    if a is None and b is None:
        return
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError(f"{path} differs between cuda and sort")
        return
    for name, x, y in zip(a._fields, a, b):
        states_equal(torch, x, y, f"{path}.{name}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[chip_smoke] torch.cuda.is_available() is False: "
                         "this script needs an NVIDIA GPU")
    from repro_torch.convert import to_numpy
    from repro_torch.kernels import build, idm, ref
    from repro_torch.launch import sweep as launcher

    # 1. card
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind}")

    # 2. build
    t0 = time.perf_counter()
    build.load("idm")
    log(f"built {SOURCE} for sm_90a in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    nb_results, idm_results = kernel_phase(torch, idm, ref)

    # 4. the sweep at full size through the launcher
    argv = [
        "--instances", str(SWEEP["instances"]), "--slots", str(SWEEP["slots"]),
        "--steps", str(SWEEP["steps"]), "--chunk-steps",
        str(SWEEP["chunk_steps"]), "--scenario-mix", "all",
        "--dispatch", "grouped", "--neighbor-impl", "cuda", "--seed", "0",
        "--device", "cuda",
    ]
    idm.reset_launches()
    res = launcher.main(argv)
    counts = dict(idm.launches)
    state = res["state"]
    done = float(state.done.float().mean())
    if done != 1.0:
        raise AssertionError(f"sweep completion {done}, expected 1.0")
    want = 2 * SWEEP["chunk_steps"] * res["group_calls"]
    if counts["neighbor_kernel"] != want:
        raise AssertionError(
            f"neighbor_kernel launched {counts['neighbor_kernel']} times, "
            f"expected 2 x {SWEEP['chunk_steps']} x {res['group_calls']} = {want}")
    m = to_numpy(state.metrics)
    for name in m._fields:
        x = getattr(m, name)
        if x.shape != (SWEEP["instances"],):
            raise AssertionError(f"metrics.{name} has shape {x.shape}")
        if x.dtype.kind == "f" and not (x[x < 1e9] >= 0).all():
            raise AssertionError(f"metrics.{name} has negative values")
    import numpy as np

    if not all(np.isfinite(getattr(m, f)).all() for f in m._fields):
        raise AssertionError("non-finite sweep metrics")
    if not (m.steps == SWEEP["steps"]).all():
        raise AssertionError("some instance did not run every step")
    inst_steps = SWEEP["instances"] * SWEEP["steps"]
    veh_steps = float(m.speed_count.sum())
    wall = res["seconds"]
    log(f"sweep: {SWEEP['instances']} instances x {SWEEP['steps']} steps, "
        f"{SWEEP['slots']} slots, 4-scenario mix, grouped, cuda impl: "
        f"wall {wall:.3f} s, {inst_steps / wall:.1f} instance-steps/s, "
        f"{veh_steps / wall:.1f} vehicle-steps/s ({veh_steps:.0f} active "
        f"vehicle-steps), neighbor_kernel launches {counts['neighbor_kernel']}"
        f" = 2 x {SWEEP['chunk_steps']} x {res['group_calls']} group calls")

    # 5. a small sweep on the card against the same sweep on the CPU
    small = ["--instances", "8", "--slots", "16", "--steps", "120",
             "--chunk-steps", "40", "--scenario-mix", "all", "--seed", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        gpu = launcher.main(small + ["--neighbor-impl", "cuda", "--device", "cuda"])
        cpu = launcher.main(small + ["--neighbor-impl", "sort", "--device", "cpu"])
    g, c = to_numpy(gpu["state"].metrics), to_numpy(cpu["state"].metrics)
    for name, x, y in zip(g._fields, g, c):
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-3,
                                       err_msg=f"metrics.{name}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"metrics.{name}")
    log("reference: 8-instance sweep on the card (cuda impl) matches the CPU "
        "(sort impl): counters equal, floats within rtol 1e-5")

    # 6. cuda == sort on the card, bit for bit
    parity = ["--instances", "64", "--slots", str(SWEEP["slots"]), "--steps",
              "400", "--chunk-steps", "400", "--scenario-mix", "all",
              "--dispatch", "grouped", "--seed", "0", "--device", "cuda"]
    with contextlib.redirect_stdout(io.StringIO()):
        a = launcher.main(parity + ["--neighbor-impl", "cuda"])
        b = launcher.main(parity + ["--neighbor-impl", "sort"])
    states_equal(torch, a["state"], b["state"])
    log("parity: cuda and sort give a bit-identical final SweepState "
        "(64 instances, 400 steps)")

    # 7. where a group call's time goes
    profile_phase(torch)

    main_nb = nb_results[0]
    main_idm = idm_results[0]
    kernels = [
        dict(name="neighbor_kernel", route="cuda", source=SOURCE,
             replaces="src/repro/kernels/idm.py:242",
             launches=counts["neighbor_kernel"],
             max_abs_err=max(r["max_abs_err"] for r in nb_results),
             ms=main_nb["ms"], plain_ms=main_nb["plain_ms"],
             bound_ms=main_nb["bound_ms"], bound_by=main_nb["bound_by"],
             library_ms=None, shapes=nb_results),
        dict(name="idm_accel_kernel", route="cuda", source=SOURCE,
             replaces="src/repro/kernels/idm.py:130",
             launches=counts["idm_accel_kernel"],
             max_abs_err=max(r["max_abs_err"] for r in idm_results),
             ms=main_idm["ms"], plain_ms=main_idm["plain_ms"],
             bound_ms=main_idm["bound_ms"], bound_by=main_idm["bound_by"],
             library_ms=None, shapes=idm_results),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
