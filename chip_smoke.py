#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card   — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build  — compile ``src/repro_torch/kernels/csrc/{idm,flash_attention,
   rglru,wkv6}.cu`` with nvcc, one ``build.load`` per source, all four
   started together;
3. kernels — hold each sweep kernel against its plain PyTorch version
   on the card (``neighbor_kernel`` bit-exact on all six outputs;
   ``idm_accel_kernel`` within rtol = atol = 1e-6, because its IDM epilogue
   divides, takes a square root and sums in an order the compiler may
   schedule differently from PyTorch's element-wise kernels), at the sweep's
   own shapes (table builds in rows mode, row q asking for lane q, and the
   own-lane query), random query lanes, larger shapes, 65536 instances and
   8193 slots (past the sort's 8192, where the all-pairs kernel answers),
   and time kernel, plain version and bound beside the card's launch floor
   (a one-element in-place add, timed alike); the main table build's line
   carries its bar of 0.008 ms and target of 0.004 ms. ``idm_accel_kernel``
   (which sorts and searches up to 8192 slots) must also equal its
   all-pairs form (``idm._idm_accel_wide``) bit for bit at every shape,
   B 256/1024 x N 128, 48 x 512, 65536 x 16, 2 x 8192 and 2 x 8193, and
   each line up to 8192 slots times both forms; both bounds count the
   comparisons a sort and binary searches need, not all-pairs tests;
4. sweep  — the port's launcher in-process at full size (1024 instances,
   128 slots, the four-scenario mix, grouped dispatch, ``--neighbor-impl
   cuda``, ``--devices 1``): completion must reach 1.0 and the neighbor
   kernel's launch count must equal 2 x chunk_steps x the batched chunk
   calls made;
5. reference — a small sweep on the card (``cuda`` impl) against the same
   sweep on the CPU (``sort`` impl): integer counters equal, floats close;
6. parity — 64 instances, 400 steps: the ``cuda`` and ``sort`` impls on the
   card must give a bit-identical final ``SweepState``;
6a. blocks — phase 6's sweep through 2 and 4 blocks on one card
   (``devices=[cuda:0] * k``, a stream each) and, where there are as many
   cards, on distinct cards: each final ``SweepState`` must equal phase
   6's bit for bit and the neighbor launches must equal 2 x chunk_steps x
   the batched calls made; then phase 4's sweep at full width through 2
   blocks on one card for one chunk of 100 steps, its instance-steps/s and
   vehicle-steps/s beside phase 4's;
7. profile — host ms per step of one sweep group, and under
   ``torch.profiler`` the device's busy time, its share of the profiled
   wall time and of the unprofiled step, and the heaviest kernels;
7a. record — the recording sweep in-process on the card (64 instances, 128
   slots, 400 steps in chunks of 100, the four-scenario mix, grouped,
   ``cuda`` neighbors, a row every 10 steps, 8 recorded slots): a
   fault-free ``run_supervised`` with a ``DatasetWriter`` and checkpoints
   (neighbor launches = 2 x chunk_steps x its batched chunk calls), and the
   same sweep under ``FaultModel.random_model`` (crashes, hangs,
   stragglers, one poison instance; 8 workers) killed after chunk 2 and
   resumed from its checkpoint and journal; the final states and every
   array of every shard must agree, bit for bit (or, where the card gives
   other bits, naming the field, within the CPU sweep tests' tolerance),
   on every instance but the poison one, which must be quarantined; and
   recording off (phase 6's ``cuda`` run of the same sweep) must give the
   same final state as recording on; both runs once more pipelined (the
   fault-free one through 2 blocks on one card): states, every shard
   array and the faulted run's journal bit-equal to the synchronous runs';
7b. pipeline — the gate: ``python -m repro_torch.launch.controller
   --chaos-kills 2`` over the full-size recording sweep, through the
   launcher's default pipelined I/O and ``--devices 1`` (1024 instances,
   128 slots, 1200 steps in chunks of 200, the four-scenario mix, grouped,
   ``cuda`` neighbors, 8 workers, crash 0.1, hang 0.05, straggler 0.05,
   one poison instance, a row every 10 steps, 8 slots, shards of 64): the
   controller must exit 0 with eligible completion 1.0, ``verify_shards``
   must repair nothing, the dataset must hold the 1023 other instances
   once each, and the final worker's neighbor launches must equal 2 x
   chunk_steps x its batched chunk calls; prints the wall time beside
   phase 4's, chunks, restarts, faults by kind, the host seconds of each
   chunk's checkpoint save, shard drain and whole commit on the I/O
   thread and the loop's wait for it, and the dataset's bytes;
7c. tokens — 7b's dataset as LM inputs: its token corpus
   (``shard_token_corpus``) and 4 ``sim_token_batches`` of 8 x 1024 on the
   card for gemma2-2b; prints their shape and vocabulary;
8. attention — ``flash_attention`` against ``ref_attention`` at gemma2-2b's
   prefill shapes (B 1, H 8, K 4, D 256, S 37/512/6000, global and local
   window 4096, softcap 50), once more at S 512 with q scaled by 20 so that
   the scores reach the cap, at qwen1.5-0.5b's (H = K = 16, D 64) and at
   recurrentgemma-2b's local layers (H 10, K 1, D 256, window 2048, no
   softcap, S 512/2100/6000; 2100 puts the window edge off the tile grid),
   in bf16 (the wgmma kernel; rtol 2e-2, atol 8e-3) and f32 (the CUDA-core
   kernel; rtol 2e-3, atol 2e-4), the tolerances of
   ``tests/test_kernels.py``; kernel (with its TFLOP/s, 4·D per live pair
   per head, and its share of the bound in bf16), plain version, bound and
   the library call timed:
   ``scaled_dot_product_attention`` for the causal shapes without softcap,
   compiled ``flex_attention`` (softcap ``score_mod``, causal/window block
   mask, GQA) for the other shapes in bf16 (each held against
   ``ref_attention`` first; the port never calls either); then 64 seeded
   q x 20 draws at gemma2-2b's global S 512 shape in bf16: none may cross
   the bf16 tolerance; prints the largest ratio of error to tolerance, and
   the same for a plain attention that rounds p to bf16 before
   normalising (where the first Hopper build rounded it);
9. recurrences — ``rglru_linear_scan`` against ``ref_rglru`` (B 1 and 4,
   W 2560, S 37/512/6000 with mild decays and at B 1, S 6000 strong ones
   with exact zeros and ones; ys rtol 2e-2 atol 2e-3 in bf16, 1e-5 in f32,
   h_final 1e-4; each line with its share of the bound, the main shape's
   with its bar of 0.20 ms and target of 0.110 ms) and ``wkv6`` against
   ``ref_wkv6`` (B 1, H 40, K = V = 64,
   S 37/512/4096/6000 with mild decays and S 6000 with strong ones that
   include exact zeros and ones; 5e-2 in bf16, 1e-4 in f32, the state 1e-3),
   x or r/k/v in bf16 and f32, the tolerances of ``tests/test_kernels.py``;
   two chunks through ``h0``/``s0`` equal one; kernel, plain version (one
   trial at S > 1024: a Python loop) and bound timed, each wkv6 line with its share of the bound and the main
   shape's with its bar of 1.0 ms and target of 0.30 ms (no single PyTorch
   call computes either recurrence);

then, for each served model in turn (gemma2-2b, recurrentgemma-2b,
rwkv6-3b), freeing each before the next:

10. serve — the model at full width (bf16, seeded random weights) through
   the serve launcher: 8 requests (prompt lengths 16..7999 drawn from
   seed 0) through 4 slots, max_seq 8192, 32 new tokens each; every
   request must complete with 32 tokens, and each kernel must have
   launched once per layer of its kind per prefill (flash_attention per
   attention layer, rglru_linear_scan per Griffin block, wkv6 per rwkv
   layer; the counts set to 0 just before and read just after); prints
   time to first token and prefill/decode tokens/s;
11. serve vs plain — one long prompt's (longer than the model's local
   window) last-position prefill logits through the kernels against the plain path (``attention_impl("xla")``
   and ``recurrence_impl("plain")``), full width: in f32 within rtol =
   atol = 1e-3; in bf16 the kernels' distance to the f32 logits at most
   1.25x the plain path's (``serve_vs_plain`` says why the bf16 paths are
   not held to 3e-2 of each other);
12. serve profile — one 6000-token prefill and 8 decode steps at 4 slots
   under ``torch.profiler``: device busy time and share, each kernel's
   time and share, the heaviest kernels;
13. engine = greedy — the model at full width in f32: the engine's tokens
   (6 requests through 4 slots) equal per-request greedy prefill + decode.

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
# phase 6: the cuda = sort parity sweep, which phase 6a replays through
# blocks and phase 7a records
PARITY = dict(instances=64, steps=400)
# phase 7a: a fault-free and a faulted, killed and resumed recording sweep
RECORD = dict(instances=PARITY["instances"], slots=128,
              steps=PARITY["steps"], chunk_steps=100,
              record_every=10, k_slots=8, workers=8, shard_size=16, poison=37)
# phase 7b: the controller over the full-size recording sweep, chunks of 200
# steps (six chunks, so both chaos kills land mid-run), 8 workers (the
# paper's instances per node)
PIPELINE = dict(instances=1024, slots=128, steps=1200, chunk_steps=200,
                workers=8, fail_prob=0.1, hang_prob=0.05, straggler_prob=0.05,
                poison=517, record_every=10, record_slots=8, shard_size=64,
                chaos_kills=2, timeout_s=900)
# phase 7c: LM batches of phase 7b's dataset
TOKENS = dict(batch=8, seq=1024, batches=4)
# phase 6a: phase 4's sweep at full width timed through 2 blocks on one card
# for one chunk of 100 steps (every chunk of phase 4 steps all instances, so
# one chunk's rate is the sweep's; the short chunk keeps the script inside
# its time limit on slower hosts)
BLOCKS_FULL = dict(instances=1024, steps=100)
WORK = ROOT / "build" / "chip_smoke_run"  # checkpoints, datasets, journals
SOURCE = "src/repro_torch/kernels/csrc/idm.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
RGLRU_SOURCE = "src/repro_torch/kernels/csrc/rglru.cu"
WKV6_SOURCE = "src/repro_torch/kernels/csrc/wkv6.cu"
# dense tensor-core peaks of an H100 SXM (NVIDIA data sheet), by input type
TENSOR_OPS_PER_S = {"bfloat16": 989e12, "float32": 495e12}  # f32 via TF32
FLASH_TOL = {"bfloat16": dict(rtol=2e-2, atol=8e-3),
             "float32": dict(rtol=2e-3, atol=2e-4)}
FLASH_MARGIN_DRAWS = 64
SERVE = dict(requests=8, slots=4, max_seq=8192, max_new=32, min_prompt=16,
             max_prompt=8000)
# (arch, prompt length of the serve-vs-plain phase): longer than each local
# window (gemma2 4096, recurrentgemma 2048), so the window masks keys; the
# plain WKV6 is a Python loop over the sequence, hence rwkv6's shorter prompt
SERVE_ARCHS = (("gemma2-2b", 5000), ("recurrentgemma-2b", 3000),
               ("rwkv6-3b", 2048))
# the kernel each layer kind's prefill launches
KERNEL_OF_KIND = {"global": "flash_attention", "local": "flash_attention",
                  "recurrent": "rglru_linear_scan", "rwkv": "wkv6"}
# device-kernel names of the hand-written serving kernels in a profile
PROFILE_NAMES = {"flash_attention": "flash_fwd",
                 "rglru_linear_scan": "rglru_chunk", "wkv6": "wkv6_fwd"}
RGLRU_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-3),
             "float32": dict(rtol=1e-5, atol=1e-5)}
WKV6_TOL = {"bfloat16": dict(rtol=5e-2, atol=5e-2),
            "float32": dict(rtol=1e-4, atol=1e-4)}
# (S, decays) of phase 9's wkv6 draws: mild decays U(0.8, 0.999) as the
# reference's tests draw them, and at the main length strong ones,
# exp(-exp(U(-8, 5))) with one entry in 16 exactly 0 and one in 16 exactly 1
WKV6_DRAWS = ((37, "mild"), (512, "mild"), (4096, "mild"), (6000, "mild"),
              (6000, "strong"))
# trials of the plain recurrences (Python loops over S, 10^3-10^4 times the
# kernels' time) at S > 1024: each trial waits out a sleep as long as the
# loop's enqueue, so one trial there keeps phase 9 inside the time limit
PLAIN_LOOP_TRIALS = 1
# the main shape's f32 time that the chunked kernel must and should reach
WKV6_BAR_MS, WKV6_TARGET_MS = 1.0, 0.30
# the same for the neighbor kernel's table build at the sweep's shape (B 256,
# N 128, Q 4 rows) and for RG-LRU at B 1, S 6000, W 2560, f32
NEIGHBOR_BAR_MS, NEIGHBOR_TARGET_MS = 0.008, 0.004
# the most slots idm_accel_kernel sorts; past it the all-pairs form answers
IDM_SORT_SLOTS = 8192
RGLRU_BAR_MS, RGLRU_TARGET_MS = 0.20, 0.110


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print one line, stamped with the seconds since the script started."""
    print(f"[chip_smoke +{time.perf_counter() - T_START:.1f}s] {msg}",
          flush=True)


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


def query_rows(gen, mode: str, b: int, q: int, n: int, lane):
    """The query rows of one ``neighbor_kernel`` call: ``rows`` (a table
    build, row q asking for lane q: no query-lane tensor, as the sweep
    calls it), ``own`` (the vehicles' own lanes, Q 1, the sweep's single
    query) or ``lanes`` (random lanes per vehicle). Returns the
    ``query_lanes`` argument (None for rows)."""
    import torch

    if mode == "rows":
        return None
    if mode == "own":
        return lane[:, None, :].contiguous()
    return torch.randint(0, N_LANES, (b, q, n), generator=gen,
                         device=lane.device, dtype=torch.int32)


def sort_search_ops(b: int, n: int, searches: int) -> int:
    """Comparisons the lead/follower search needs at least: a comparison
    sort of each instance's n keys (n log2 n) and one binary search (log2
    n) for each of ``searches`` queries a slot. The all-pairs form's n^2
    pair tests are one way to answer, not work the function needs."""
    lg = max(1, (n - 1).bit_length())
    return b * n * lg * (1 + searches)


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, idm, ref):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b_main = SWEEP["instances"] // 4
    n_main = SWEEP["slots"]
    # the launch floor: one one-element in-place add, timed as the kernels
    # are (no kernel can take less; the neighbor bound lies below it)
    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(lambda: one.add_(1.0))
    log(f"launch floor: a one-element in-place add takes {floor_ms:.5f} ms")
    shapes = [
        (b_main, n_main, 4, "rows"), (b_main, n_main, 3, "rows"),
        (b_main, n_main, 1, "own"), (b_main, n_main, 4, "lanes"),
        (1024, 128, 4, "rows"), (1024, 128, 1, "own"), (48, 512, 4, "rows"),
        (65536, 16, 4, "rows"), (65536, 16, 1, "own"), (2, 8193, 4, "rows"),
        (2, 8193, 2, "lanes"),
    ]
    results = []
    for b, n, q, mode in shapes:
        pos, lane, active = rand_world(gen, b, n)
        ql = query_rows(gen, mode, b, q, n, lane)
        n_rows = q if ql is None else None
        got = idm.neighbor_kernel(pos, lane, active, ql, n_rows=n_rows,
                                  veh_len=4.5)
        want = ref.ref_neighbor_mq(pos, lane, active, ql, 4.5, n_rows=n_rows)
        torch.cuda.synchronize()
        for name, g, w in zip(("lead_idx", "lead_gap", "has_lead", "foll_idx",
                               "foll_gap", "has_foll"), got, want):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(
                    f"neighbor_kernel != ref_neighbor_mq on {name} at "
                    f"B={b} N={n} Q={q} {mode} ({bad} elements differ)")
        err = max(float((g.float() - w.float()).abs().max()) for g, w in
                  zip(got, want))
        ms = device_ms(lambda: idm.neighbor_kernel(pos, lane, active, ql,
                                                   n_rows=n_rows, veh_len=4.5))
        plain_ms = device_ms(lambda: ref.ref_neighbor_mq(
            pos, lane, active, ql, 4.5, n_rows=n_rows), reps=2)
        bytes_moved = (b * n * (4 + 4 + 1) + b * q * n * 18
                       + (0 if ql is None else b * q * n * 4))
        ops = sort_search_ops(b, n, q)
        bound_ms, bound_by = bound(bytes_moved, ops)
        results.append(dict(B=b, N=n, Q=q, rows=mode, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, floor_ms=floor_ms))
        bar = (f"; the bar {NEIGHBOR_BAR_MS} ms, the target "
               f"{NEIGHBOR_TARGET_MS} ms" if (b, n, q, mode) ==
               (b_main, n_main, 4, "rows") else "")
        log(f"neighbor_kernel B={b} N={n} Q={q} {mode}: bit-exact; kernel "
            f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), launch floor {floor_ms:.5f} ms{bar}")

    idm_results = []
    for b, n in ((b_main, n_main), (1024, 128), (48, 512), (65536, 16),
                 (2, 8192), (2, 8193)):
        pos, lane, active = rand_world(gen, b, n)

        def rnd(lo, hi):
            return torch.rand((b, n), generator=gen, device="cuda") * (hi - lo) + lo

        vel, v0, T = rnd(0.0, 35.0), rnd(20.0, 35.0), rnd(0.8, 1.8)
        a_max, b_comf, s0 = rnd(1.0, 2.5), rnd(1.5, 3.0), rnd(1.0, 2.5)
        args = (pos, vel, lane, active, v0, T, a_max, b_comf, s0)
        got = idm.idm_accel_kernel(*args, veh_len=4.5)
        wide = idm._idm_accel_wide(*args, veh_len=4.5)
        want = ref.ref_idm_accel(*args, 4.5)
        torch.cuda.synchronize()
        if not torch.equal(got, wide):
            raise AssertionError(
                f"idm_accel_kernel != its all-pairs form at B={b} N={n} "
                f"({int((got != wide).sum())} elements differ)")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        err = float((got - want).abs().max())
        ms = device_ms(lambda: idm.idm_accel_kernel(*args, veh_len=4.5))
        form = "sort" if n <= IDM_SORT_SLOTS else "all-pairs"
        # past the sort's slots the kernel is the all-pairs form: one timing
        wide_ms = (device_ms(lambda: idm._idm_accel_wide(*args, veh_len=4.5))
                   if form == "sort" else ms)
        plain_ms = device_ms(lambda: ref.ref_idm_accel(*args, 4.5), reps=2)
        bytes_moved = b * n * (7 * 4 + 4 + 1) + b * n * 4
        # one own-lane search an ego, then the IDM formula's 16 operations
        ops = sort_search_ops(b, n, 1) + 16 * b * n
        bound_ms, bound_by = bound(bytes_moved, ops)
        idm_results.append(dict(B=b, N=n, form=form, max_abs_err=err, ms=ms,
                                all_pairs_ms=wide_ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                floor_ms=floor_ms))
        log(f"idm_accel_kernel B={b} N={n} ({form}): bit-equal to the "
            f"all-pairs form, max |err| {err:.3g} (tol 1e-6); kernel "
            f"{ms:.5f} ms, all-pairs {wide_ms:.5f} ms, plain {plain_ms:.5f} "
            f"ms, bound {bound_ms:.5f} ms ({bound_by}), launch floor "
            f"{floor_ms:.5f} ms")
    return results, idm_results


def device_events(prof) -> list[tuple[str, float, int]]:
    """(name, device µs, count) of a profile's device events (kernels,
    copies, memsets), heaviest first; the CPU ops that launched them carry
    the same time again as their "self device" time and are left out."""

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
              if dev_us(e) > 0 and
              "cuda" in str(getattr(e, "device_type", "")).lower()]
    return sorted(events, key=lambda e: e[1], reverse=True)


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

    events = device_events(prof)
    busy_us = sum(us for _, us, _ in events)
    launches = sum(count for _, _, count in events)
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
               top=[(key[:60], us / steps / 1e3)
                    for key, us, _ in events[:6]])
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


def rows_equal(torch, a, b, keep, what: str) -> list[str]:
    """Hold every ``[N]`` leaf of two states (or shard row dicts) equal on
    the rows ``keep``: bit for bit, or, where the card gives other bits,
    within the CPU sweep tests' tolerance (rtol 1e-5; atol 1e-3 for
    positions, 1e-4 otherwise) for floats, and exactly for everything
    else. Returns the leaves that were not bit-equal."""
    from repro_torch.ckpt.io import flatten_with_paths

    la, lb = flatten_with_paths(a), flatten_with_paths(b)
    pa, pb = [p for p, _ in la], [p for p, _ in lb]
    if pa != pb:
        raise AssertionError(f"{what}: leaves differ: {sorted(set(pa) ^ set(pb))}"
                             f" ({len(pa)} against {len(pb)})")
    loose = []
    for (path, x), (_, y) in zip(la, lb):
        if x.dim() == 0:
            continue
        x, y = x[keep], y[keep]
        if torch.equal(x, y):
            continue
        loose.append(path)
        if not x.is_floating_point():
            raise AssertionError(f"{what}: {path} differs")
        torch.testing.assert_close(
            x, y, rtol=1e-5, atol=1e-3 if path.endswith("pos") else 1e-4,
            msg=lambda m: f"{what}: {path}: {m}")
    if loose:
        log(f"{what}: not bit-equal, held within the CPU tolerance: {loose}")
    return loose


def shard_rows(torch, root) -> dict:
    """Every instance's row of every array of a dataset, by instance id."""
    from repro_torch.data.shards import ShardedDataset

    rows = {}
    for z in ShardedDataset.load(str(root)).iter_shards():
        for j, i in enumerate(z["instance"]):
            rows[int(i)] = {k: torch.from_numpy(v[j:j + 1])
                            for k, v in z.items()}
    return rows


def record_phase(torch, idm, plain) -> dict:
    """Phase 7a: the recording, checkpointed, supervised sweep in-process.

    A fault-free ``run_supervised`` with a ``DatasetWriter`` and
    checkpoints, and the same sweep under ``FaultModel.random_model``
    (crashes, hangs, stragglers, one poison instance) killed after chunk
    2 and resumed from its checkpoint and journal: their final states and
    every array of every shard must agree on every instance that the
    faulted run did not quarantine, and the poison instance must be
    reported quarantined. Recording on and off must give the same final
    simulator state, bit for bit: ``plain`` is phase 6's ``cuda`` run of
    the same sweep without recording (in one chunk of all its steps; the
    chunk size changes no bit). Both runs go once more pipelined (the fault-free
    one through 2 blocks on one card, 2 x 4 workers): their final states,
    every shard array and the faulted run's journal must equal the
    synchronous runs' bit for bit."""
    import shutil

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.fault import FaultModel
    from repro_torch.core.fleet import RetryPolicy, RunJournal, run_supervised
    from repro_torch.core.record import RecordConfig
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.scenarios import list_scenarios
    from repro_torch.core.sweep import SweepConfig, SweepRunner
    from repro_torch.data.shards import DatasetWriter

    r = RECORD
    work = WORK / "record"
    shutil.rmtree(work, ignore_errors=True)
    cfg = SweepConfig(
        n_instances=r["instances"], steps_per_instance=r["steps"],
        chunk_steps=r["chunk_steps"], seed=0,
        sim=SimConfig(n_slots=r["slots"], neighbor_impl="cuda"),
        scenario_mix=tuple(list_scenarios()), dispatch="grouped",
        record=RecordConfig(record_every=r["record_every"],
                            k_slots=r["k_slots"]))
    n_chunks = r["steps"] // r["chunk_steps"] * 3
    one = [torch.device("cuda", 0)]

    def runner(devices=one):
        return SweepRunner(cfg, devices=devices,
                           workers_per_device=r["workers"] // len(devices))

    def writer(name):
        return DatasetWriter(str(work / name), cfg,
                             shard_size=r["shard_size"])

    # the first seed whose schedule crashes, hangs and straggles a worker
    # in chunk 0, where every instance runs (a fault on a worker whose
    # instances are all held or done leaves no event)
    for seed in range(1000):
        fm = FaultModel.random_model(
            r["workers"], n_chunks, 0.1, hang_prob=0.05, straggler_prob=0.05,
            poison_instances=(r["poison"],), seed=seed)
        if fm.plan.get(0) and fm.hangs.get(0) and fm.stragglers.get(0):
            break
    policy = RetryPolicy(max_retries=2)

    def clean_run(name, pipeline, devices=one):
        idm.reset_launches()
        t0 = time.perf_counter()
        run = runner(devices)
        w = writer(name + "_ds")
        state, info = run_supervised(
            run, ckpt=CheckpointManager(str(work / (name + "_ck"))),
            writer=w, pipeline=pipeline)
        w.finalize(fault_info=info)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = idm.launches["neighbor_kernel"]
        want = 2 * r["chunk_steps"] * run.group_calls
        if launches != want or info["completion_rate"] != 1.0:
            raise AssertionError(f"{name} recording run: completion "
                                 f"{info['completion_rate']}, neighbor_kernel "
                                 f"launched {launches} times, expected {want}")
        return state, info, wall, launches, run.group_calls

    def faulted_run(name, pipeline):
        t0 = time.perf_counter()
        ck = CheckpointManager(str(work / (name + "_ck")))
        jr = RunJournal(str(work / (name + "_ck") / "journal.jsonl"))
        w = writer(name + "_ds")
        _, first = run_supervised(runner(), fm, policy, ckpt=ck, writer=w,
                                  journal=jr, max_chunks=3, pipeline=pipeline)
        del w  # the kill: buffered instances are lost with the process
        w = writer(name + "_ds")
        state, info = run_supervised(runner(), fm, policy, ckpt=ck, writer=w,
                                     journal=jr, pipeline=pipeline)
        w.finalize(fault_info=info)
        torch.cuda.synchronize()
        events = [{k: v for k, v in e.items() if k != "time"}
                  for e in RunJournal.read(jr.path)]
        return state, info, first, time.perf_counter() - t0, events

    clean, info, clean_s, launches, calls = clean_run("clean", False)
    faulted, info_f, first, fault_s, events = faulted_run("fault", False)
    kinds = [e.get("fault", e["kind"]) for e in events]
    for kind in ("crash", "hang", "straggler", "poison", "quarantine",
                 "resume"):
        if kind not in kinds:
            raise AssertionError(f"faulted recording run: no {kind} event")
    if (info_f["quarantined"] != [r["poison"]]
            or info_f["eligible_completion_rate"] != 1.0):
        raise AssertionError(f"faulted run: quarantined "
                             f"{info_f['quarantined']}, eligible completion "
                             f"{info_f['eligible_completion_rate']}")
    keep = torch.ones(r["instances"], dtype=torch.bool, device="cuda")
    keep[r["poison"]] = False
    loose = rows_equal(torch, clean, faulted, keep, "record: final state")

    a, b = shard_rows(torch, work / "clean_ds"), shard_rows(torch, work / "fault_ds")
    ids = sorted(set(range(r["instances"])) - {r["poison"]})
    if sorted(a) != list(range(r["instances"])) or sorted(b) != ids:
        raise AssertionError(f"datasets hold {len(a)} and {len(b)} instances")
    for i in ids:
        loose += rows_equal(torch, a[i], b[i], slice(None), f"record: shard row {i}")

    if (plain.horizon.shape != clean.horizon.shape
            or not torch.equal(plain.horizon, clean.horizon)):
        raise AssertionError("phase 6's sweep is not this phase's sweep")
    states_equal(torch, plain.sim, clean.sim)
    states_equal(torch, plain.metrics, clean.metrics)

    # the same two runs pipelined: bit-equal to the synchronous ones
    two = [torch.device("cuda", 0)] * 2
    clean_p, _, clean_ps, launches_p, calls_p = clean_run("clean_pipe", True,
                                                          two)
    faulted_p, info_fp, _, fault_ps, events_p = faulted_run("fault_pipe", True)
    states_equal(torch, clean, clean_p, "record: pipelined 2-block state")
    states_equal(torch, faulted, faulted_p, "record: pipelined faulted state")
    if events_p != events or info_fp["quarantined"] != info_f["quarantined"]:
        raise AssertionError("record: the pipelined faulted run's journal "
                             "differs from the synchronous run's")
    for sync_name, pipe_name in (("clean", "clean_pipe"),
                                 ("fault", "fault_pipe")):
        x = shard_rows(torch, work / f"{sync_name}_ds")
        y = shard_rows(torch, work / f"{pipe_name}_ds")
        if sorted(x) != sorted(y):
            raise AssertionError(f"record: {pipe_name} holds other instances")
        for i in x:
            if list(x[i]) != list(y[i]) or not all(
                    torch.equal(x[i][k], y[i][k]) for k in x[i]):
                raise AssertionError(f"record: {pipe_name} shard row {i} "
                                     "differs from the synchronous run's")
    log(f"record: {r['instances']} instances x {r['steps']} steps, "
        f"{r['slots']} slots, chunks of {r['chunk_steps']}, 4-scenario mix, "
        f"grouped, cuda impl, every {r['record_every']} steps, "
        f"{r['k_slots']} slots: fault-free run {clean_s:.3f} s "
        f"({info['chunks_run']} chunks, neighbor_kernel launches {launches} "
        f"= 2 x {r['chunk_steps']} x {calls}); faulted run (fault "
        f"seed {seed}: {kinds.count('crash')} crash, {kinds.count('hang')} "
        f"hang, {kinds.count('straggler')} straggler, {kinds.count('poison')}"
        f" poison events; killed after {first['chunks_run']} chunks, "
        f"resumed for {info_f['chunks_run']}) {fault_s:.3f} s; final state "
        f"and every shard array of the {len(ids)} non-quarantined instances "
        f"{'bit-equal' if not loose else 'within tolerance'}, instance "
        f"{r['poison']} quarantined; recording off (phase 6) = on bit for "
        f"bit")
    log(f"record: pipelined: fault-free through 2 blocks on one card "
        f"{clean_ps:.3f} s (neighbor_kernel launches {launches_p} = 2 x "
        f"{r['chunk_steps']} x {calls_p}), faulted, killed and resumed "
        f"{fault_ps:.3f} s: states, every shard array and the journal "
        f"({len(events)} events) equal the synchronous runs' bit for bit")
    return dict(clean_s=clean_s, fault_s=fault_s, clean_pipe_s=clean_ps,
                fault_pipe_s=fault_ps, launches=launches, group_calls=calls,
                launches_pipe=launches_p, group_calls_pipe=calls_p,
                fault_seed=seed, loose=sorted(set(loose)),
                quarantined=info_f["quarantined"])


def blocks_phase(torch, idm, plain, sweep: dict) -> dict:
    """Phase 6a: the block executor. Phase 6's sweep (``PARITY``, one
    chunk, ``cuda`` neighbors) through 2 and 4 blocks on one
    card (``devices=[cuda:0] * k``: k streams, enqueued in turn) and,
    where there are as many cards, on distinct cards: each final
    ``SweepState`` must equal phase 6's bit for bit, and the neighbor
    launches must equal 2 x chunk_steps x the batched calls made (the
    counts set to 0 just before each run). Then phase 4's sweep at full
    width through 2 blocks on one card for one chunk (``BLOCKS_FULL``), its
    rates beside phase 4's."""
    from repro_torch.core.fleet import run_supervised
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.scenarios import list_scenarios
    from repro_torch.core.sweep import SweepConfig, SweepRunner
    from repro_torch.launch.mesh import sweep_devices

    def cfg(n, steps, chunk):
        return SweepConfig(n_instances=n, steps_per_instance=steps,
                           chunk_steps=chunk, seed=0,
                           sim=SimConfig(n_slots=SWEEP["slots"],
                                         neighbor_impl="cuda"),
                           scenario_mix=tuple(list_scenarios()),
                           dispatch="grouped")

    def run(c, devices):
        runner = SweepRunner(c, devices=devices)
        state = runner.init()
        torch.cuda.synchronize()
        idm.reset_launches()
        t0 = time.perf_counter()
        state, info = run_supervised(runner, state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = idm.launches["neighbor_kernel"]
        want = 2 * c.chunk_steps * runner.group_calls
        if launches != want or info["completion_rate"] != 1.0:
            raise AssertionError(
                f"{len(devices)} blocks on {sorted(set(map(str, devices)))}: "
                f"completion {info['completion_rate']}, neighbor_kernel "
                f"launched {launches} times, expected 2 x {c.chunk_steps} x "
                f"{runner.group_calls} = {want}")
        return state, wall, launches, runner.group_calls

    n_par, steps_par = PARITY["instances"], PARITY["steps"]
    small = cfg(n_par, steps_par, steps_par)
    layouts = [("one card", k, [torch.device("cuda", 0)] * k) for k in (2, 4)]
    for k in (2, 4):
        if torch.cuda.device_count() >= k:
            layouts.append(("distinct cards", k, sweep_devices(k, "cuda:0")))
    out = dict(parity=[], launches=0)
    for where, k, devices in layouts:
        state, wall, launches, calls = run(small, devices)
        states_equal(torch, plain, state)
        out["parity"].append(dict(where=where, blocks=k, wall_s=wall,
                                  group_calls=calls, launches=launches))
        out["launches"] += launches
        log(f"blocks: phase 6's sweep through {k} blocks on {where}: "
            f"final SweepState = phase 6's bit for bit; wall {wall:.3f} s, "
            f"{n_par * steps_par / wall:.1f} instance-steps/s, "
            f"neighbor_kernel launches {launches} = 2 x {steps_par} x {calls}")
    if torch.cuda.device_count() < 2:
        log("blocks: one card visible: the distinct-card layouts not run")

    n, steps = BLOCKS_FULL["instances"], BLOCKS_FULL["steps"]
    full = cfg(n, steps, steps)
    state, wall, launches, calls = run(full, [torch.device("cuda", 0)] * 2)
    out["launches"] += launches
    m = state.metrics
    veh_steps = float(m.speed_count.sum())
    if not bool((m.steps == steps).all()):
        raise AssertionError("blocks: some instance did not run every step")
    out["full"] = dict(instances=n, steps=steps, wall_s=wall,
                       instance_steps_per_s=n * steps / wall,
                       vehicle_steps_per_s=veh_steps / wall,
                       group_calls=calls, launches=launches)
    log(f"blocks: phase 4's sweep at full width ({n} instances, "
        f"{SWEEP['slots']} slots), one chunk of {steps} steps, through 2 "
        f"blocks on one card: wall {wall:.3f} s, "
        f"{n * steps / wall:.1f} instance-steps/s, "
        f"{veh_steps / wall:.1f} vehicle-steps/s; phase 4 through one "
        f"device: {sweep['wall_s']:.3f} s, "
        f"{sweep['instance_steps_per_s']:.1f} instance-steps/s, "
        f"{sweep['vehicle_steps_per_s']:.1f} vehicle-steps/s")
    return out


def pipeline_phase(torch, sweep_wall: float) -> dict:
    """Phase 7b, the gate: the port's controller over the full-size
    recording sweep with injected crashes, hangs, stragglers, one poison
    instance and two SIGKILLs. The controller must exit 0 with eligible
    completion 1.0, the port's ``verify_shards`` must find nothing to
    repair, the dataset must hold every non-quarantined instance once, and
    the final worker's neighbor launches must equal 2 x chunk_steps x its
    batched chunk calls."""
    import os
    import re
    import shutil
    import signal

    from repro_torch.core.fleet import RunJournal
    from repro_torch.core.record import RecordConfig
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.scenarios import list_scenarios
    from repro_torch.core.sweep import SweepConfig
    from repro_torch.data.shards import DatasetWriter, ShardedDataset

    p = PIPELINE
    work = WORK / "pipeline"
    shutil.rmtree(work, ignore_errors=True)
    run_dir, ds = work / "run", work / "ds"
    worker = [
        "--instances", str(p["instances"]), "--slots", str(p["slots"]),
        "--steps", str(p["steps"]), "--chunk-steps", str(p["chunk_steps"]),
        "--scenario-mix", "all", "--dispatch", "grouped",
        "--neighbor-impl", "cuda", "--workers", str(p["workers"]),
        "--fail-prob", str(p["fail_prob"]), "--hang-prob", str(p["hang_prob"]),
        "--straggler-prob", str(p["straggler_prob"]),
        "--poison", str(p["poison"]), "--record-every", str(p["record_every"]),
        "--record-slots", str(p["record_slots"]),
        "--shard-size", str(p["shard_size"]), "--dataset-dir", str(ds),
        "--device", "cuda", "--devices", "1",
    ]
    cmd = [sys.executable, "-m", "repro_torch.launch.controller",
           "--ckpt-dir", str(run_dir), "--chaos-kills", str(p["chaos_kills"]),
           "--heartbeat-timeout", "600", "--poll", "0.5", "--", *worker]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=str(ROOT), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=p["timeout_s"])
    finally:
        if proc.poll() is None:  # the controller and its worker, on timeout
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t0
    (work / "controller.log").write_text(out)
    if proc.returncode != 0:
        raise AssertionError(f"controller exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    result = json.loads((run_dir / "result.json").read_text())
    info = result["fault_info"]
    if info["eligible_completion_rate"] != 1.0:
        raise AssertionError(f"eligible completion "
                             f"{info['eligible_completion_rate']}")
    cfg = SweepConfig(
        n_instances=p["instances"], steps_per_instance=p["steps"],
        chunk_steps=p["chunk_steps"],
        sim=SimConfig(n_slots=p["slots"], neighbor_impl="cuda"),
        scenario_mix=tuple(list_scenarios()), dispatch="grouped",
        record=RecordConfig(record_every=p["record_every"],
                            k_slots=p["record_slots"]))
    audit = DatasetWriter(str(ds), cfg, shard_size=p["shard_size"])
    if audit.repaired or audit.verify_shards():
        raise AssertionError(f"verify_shards repaired {audit.repaired}")
    data = ShardedDataset.load(str(ds))
    ids = [i for s in data.manifest["shards"] for i in s["instances"]]
    want_ids = sorted(set(range(p["instances"])) - {p["poison"]})
    if sorted(ids) != want_ids or data.n_instances != len(want_ids):
        raise AssertionError(f"dataset holds {len(ids)} instance rows "
                             f"({len(set(ids))} distinct), expected "
                             f"{len(want_ids)}")
    if info["quarantined"] != [p["poison"]]:
        raise AssertionError(f"quarantined {info['quarantined']}")
    runs = [json.loads(line[len("[sweep] run: "):])
            for line in out.splitlines() if line.startswith("[sweep] run: ")]
    if not runs or not runs[-1]["pipeline"]:
        raise AssertionError("the final worker printed no pipelined run line")
    stats = runs[-1]
    launches = stats["launches"]["neighbor_kernel"]
    want = 2 * p["chunk_steps"] * stats["group_calls"]
    if launches != want:
        raise AssertionError(f"final worker: neighbor_kernel launched "
                             f"{launches} times, expected 2 x "
                             f"{p['chunk_steps']} x {stats['group_calls']}")

    ctl = RunJournal.read(str(run_dir / "controller.jsonl"))
    jr = RunJournal.read(str(run_dir / "journal.jsonl"))
    kills = sum(e["kind"] == "worker_kill" for e in ctl)
    spawns = sum(e["kind"] == "spawn" for e in ctl)
    faults: dict[str, int] = {}
    for e in jr:
        kind = e.get("fault") or e["kind"]
        if e["kind"] in ("failure", "straggler", "quarantine",
                         "corrupt_ckpt", "corrupt_shard", "shard_repair"):
            faults[kind] = faults.get(kind, 0) + 1
    committed = sum(e["kind"] == "chunk" for e in jr)
    timing = [(int(c), *(float(x) for x in t)) for c, *t in re.findall(
        r"chunk ([0-9]+) host seconds: chunk ([0-9.]+), checkpoint save "
        r"([0-9.]+), shard drain ([0-9.]+), commit ([0-9.]+), waited "
        r"([0-9.]+)", out)]
    ds_bytes = sum(f.stat().st_size for f in ds.iterdir())
    ck_bytes = sum(f.stat().st_size for f in run_dir.rglob("arrays.npz"))
    if kills != p["chaos_kills"]:
        raise AssertionError(f"{kills} chaos kills, expected {p['chaos_kills']}")
    log(f"pipeline: controller over {p['instances']} instances x "
        f"{p['steps']} steps, {p['slots']} slots, chunks of "
        f"{p['chunk_steps']}, {p['workers']} workers, recording every "
        f"{p['record_every']} steps, pipelined I/O: wall {wall:.3f} s "
        f"(commits {sum(t[4] for t in timing):.3f} s on the I/O thread, the "
        f"loop waited {sum(t[5] for t in timing):.3f} s; phase 4's sweep "
        f"{sweep_wall:.3f} s); {committed} chunks committed over {spawns} "
        f"worker attempts ({kills} SIGKILLs, {spawns - 1} restarts); faults "
        f"{faults}; eligible completion 1.0, completion "
        f"{info['completion_rate']:.6f}, quarantined {info['quarantined']}; "
        f"dataset {data.n_instances} instances once each, verify_shards "
        f"repaired nothing, {ds_bytes} bytes; checkpoints {ck_bytes} bytes "
        f"on disk; final worker's neighbor_kernel launches {launches} = 2 x "
        f"{p['chunk_steps']} x {stats['group_calls']}")
    for c, chunk_s, ckpt_s, drain_s, commit_s, wait_s in timing:
        log(f"pipeline:   chunk {c}: host seconds: chunk {chunk_s:.4f}, "
            f"checkpoint save {ckpt_s:.4f}, shard drain {drain_s:.4f}, "
            f"commit {commit_s:.4f}, waited {wait_s:.4f}")
    return dict(dataset=ds, wall_s=wall, sweep_wall_s=sweep_wall,
                chunks=committed,
                spawns=spawns, kills=kills, faults=faults,
                completion_rate=info["completion_rate"],
                dataset_bytes=ds_bytes, checkpoint_bytes=ck_bytes,
                launches_final_worker=launches, timing=timing)


def tokens_phase(torch, ds) -> dict:
    """Phase 7c: the LM inputs of phase 7b's dataset. Its token corpus
    (``shard_token_corpus``, the vocabulary from its manifest) and a few
    ``sim_token_batches`` on the card at gemma2-2b's vocabulary: i32
    ``[batch, seq]`` tensors on ``cuda``, labels the tokens shifted by
    one, every token inside the sim vocabulary, the first row the
    corpus's first window."""
    from repro_torch.config.base import get_arch
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.tokens import vocab_size
    from repro_torch.data.sim_dataset import shard_token_corpus, sim_token_batches

    t = TOKENS
    t0 = time.perf_counter()
    corpus, vocab = shard_token_corpus(str(ds))
    corpus_s = time.perf_counter() - t0
    want_vocab = vocab_size(SimConfig(n_slots=PIPELINE["slots"]))
    if vocab != want_vocab or corpus.min() < 0 or corpus.max() >= vocab:
        raise AssertionError(f"tokens: vocab {vocab} (expected {want_vocab}),"
                             f" corpus in [{corpus.min()}, {corpus.max()}]")
    cfg = get_arch("gemma2-2b")
    it = sim_token_batches(cfg, SimConfig(n_slots=PIPELINE["slots"]),
                           t["batch"], t["seq"], shard_dir=str(ds),
                           device="cuda")
    t0 = time.perf_counter()
    batches = [next(it) for _ in range(t["batches"])]
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    shape = (t["batch"], t["seq"])
    for b in batches:
        tok, lab = b["tokens"], b["labels"]
        if (tok.device.type != "cuda" or tok.dtype != torch.int32
                or tuple(tok.shape) != shape or tuple(lab.shape) != shape
                or not torch.equal(tok[:, 1:], lab[:, :-1])
                or int(tok.max()) >= vocab or int(tok.min()) < 0):
            raise AssertionError(f"tokens: a batch of {tok.dtype} "
                                 f"{tuple(tok.shape)} on {tok.device} is not "
                                 f"a shifted i32 {shape} window of the corpus")
    first = torch.from_numpy(corpus[:t["seq"]].astype("int32")).cuda()
    if not torch.equal(batches[0]["tokens"][0], first):
        raise AssertionError("tokens: the first row is not the corpus's start")
    log(f"tokens: phase 7b's dataset: corpus {corpus.size} tokens, "
        f"vocabulary {vocab} (manifest), read in {corpus_s:.3f} s; "
        f"{len(batches)} sim_token_batches on the card for gemma2-2b "
        f"(vocabulary {cfg.vocab_size}): tokens and labels i32 {shape}, "
        f"{batch_s:.4f} s")
    return dict(corpus_tokens=int(corpus.size), vocab=vocab,
                batches=len(batches), shape=list(shape), corpus_s=corpus_s,
                batch_s=batch_s)


def live_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that attention with these masks scores: query i
    at position i + sk - sq sees keys (pos - window, pos] (causal) or
    (pos - window, sk) (not causal); window 0 means no window."""
    import numpy as np

    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.clip(hi - lo + 1, 0, None).sum())


# (label, B, S, H, K, D, window, softcap, q scale): gemma2-2b's prefill
# shapes (global and local layers) and qwen1.5-0.5b's; at unit scores a
# softcap of 50 moves the output by about 1e-4, inside the tolerance, so
# one more shape scales q by 20 (scores of about N(0, 20^2)) to reach it
FLASH_SHAPES = [
    (f"{arch} S={s}", 1, s, h, kh, d, window, cap, 1.0)
    for s in (37, 512, 6000)
    for arch, h, kh, d, window, cap in (
        ("gemma2-2b global", 8, 4, 256, 0, 50.0),
        ("gemma2-2b local", 8, 4, 256, 4096, 50.0),
        ("qwen1.5-0.5b", 16, 16, 64, 0, 0.0))
] + [("gemma2-2b global S=512 q x 20", 1, 512, 8, 4, 256, 0, 50.0, 20.0)] + [
    (f"recurrentgemma-2b local S={s}", 1, s, 10, 1, 256, 2048, 0.0, 1.0)
    for s in (512, 2100, 6000)  # 2100: the window edge off the tile grid
]

_FLEX: dict = {}  # the compiled flex_attention and its mods, made once


def flex_call(torch, q, k, v, window: int, cap: float):
    """One PyTorch call that computes the kernel's function with a softcap
    or a window: compiled ``flex_attention`` with ``cap * tanh(s / cap)``
    as its ``score_mod`` (none at cap 0), the causal (and window) mask as a
    block mask, and GQA. Timed as the library yardstick only; the port
    never calls it.

    The cap and the window are 0-d tensors that the mods capture, so the
    compiled graph does not depend on their values: it is compiled once
    with a softcap and once without, and once more when the sequence length
    first changes (after that the length is dynamic). Called in bf16 only:
    its Triton compile for f32 at D 256 takes most of the script's time
    limit on an H100.
    """
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    if not _FLEX:
        cap_t = torch.zeros((), device="cuda")
        window_t = torch.zeros((), dtype=torch.int64, device="cuda")

        def score_mod(score, b, h, qi, ki):
            return cap_t * torch.tanh(score / cap_t)

        def mask_mod(b, h, qi, ki):
            return (qi >= ki) & (qi - ki < window_t)

        _FLEX.update(fn=torch.compile(flex_attention), cap=cap_t,
                     window=window_t, score_mod=score_mod, mask_mod=mask_mod)
    _FLEX["cap"].fill_(cap)
    _FLEX["window"].fill_(window if window > 0 else 2**30)
    s = q.shape[1]
    block_mask = create_block_mask(_FLEX["mask_mod"], None, None, s, s,
                                   device="cuda")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    score_mod = _FLEX["score_mod"] if cap > 0 else None
    return lambda: _FLEX["fn"](qt, kt, vt, score_mod=score_mod,
                               block_mask=block_mask, enable_gqa=True)


def flash_phase(torch, fa, ref) -> list[dict]:
    """``flash_attention`` against ``ref_attention`` on the card, timed
    beside its bound and the one PyTorch call that computes the same
    function: ``scaled_dot_product_attention`` for causal attention without
    softcap or window, compiled ``flex_attention`` (bf16 only) with a
    softcap or a window, SDPA with the window as a dense mask in f32."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    results = []
    for label, b, s, h, kh, d, window, cap, q_scale in FLASH_SHAPES:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       for shape in ((b, s, h, d), (b, s, kh, d),
                                     (b, s, kh, d)))
            q, k, v = (q * q_scale).to(dt), k.to(dt), v.to(dt)
            kw = dict(causal=True, window=window, softcap=cap)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.ref_attention(q, k, v, True, window, cap)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       **FLASH_TOL[dtype])
            if q_scale != 1.0:
                # the cap must move this output by far more than the
                # tolerance, or the shape would not test it
                moved = float((ref.ref_attention(q, k, v, True, window, 0.0)
                               .float() - want.float()).abs().max())
                if moved <= 50 * FLASH_TOL[dtype]["atol"]:
                    raise AssertionError(
                        f"{label}: the softcap moves the output by only "
                        f"{moved:.3g}")
            err = float((got.float() - want.float()).abs().max())
            reps, trials = (2, 5) if s > 1024 else (10, 21)
            ms = device_ms(lambda: fa.flash_attention(q, k, v, **kw), reps,
                           trials)
            plain_ms = device_ms(
                lambda: ref.ref_attention(q, k, v, True, window, cap), 1,
                trials)
            if dtype == "bfloat16" and (cap > 0.0 or window > 0):
                library = "flex_attention"
                lib = flex_call(torch, q, k, v, window, cap)
            elif cap == 0.0:
                library = "sdpa"
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                mask = None
                if window > 0:
                    i = torch.arange(s, device="cuda")
                    mask = (i[:, None] >= i[None]) & (i[:, None] - i[None]
                                                      < window)

                def lib():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                        enable_gqa=True)
            else:
                library = lib = None
            library_ms = None
            if lib is not None:
                torch.testing.assert_close(lib().transpose(1, 2).float(),
                                           want.float(), **FLASH_TOL[dtype])
                library_ms = device_ms(lib, reps, trials)
            pairs = live_pairs(s, s, True, window) * b * h
            bytes_moved = (2 * b * s * h * d + 2 * b * s * kh * d) \
                * q.element_size()
            bound_ms, bound_by = bound(bytes_moved, 4 * d * pairs,
                                       TENSOR_OPS_PER_S[dtype])
            tflops = 4 * d * pairs / ms / 1e9
            results.append(dict(shape=label, B=b, S=s, H=h, K=kh, D=d,
                                window=window, softcap=cap, q_scale=q_scale,
                                dtype=dtype, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, tflops=tflops,
                                bound_share=bound_ms / ms, library=library,
                                library_ms=library_ms))
            lib_txt = (f"{library} {library_ms:.5f} ms" if library else
                       "flex_attention not timed in f32")
            rate = (f", {tflops:.1f} TFLOP/s, {100 * bound_ms / ms:.2f}% of "
                    "its bound" if dtype == "bfloat16" else "")
            log(f"flash_attention {label} {dtype}: max |err| {err:.3g} "
                f"(tol {FLASH_TOL[dtype]}); kernel {ms:.5f} ms{rate}, plain "
                f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
                f"{lib_txt}")
            del q, k, v, got, want
    return results


def rounded_before_normalising(torch, q, k, v, cap: float, tile: int = 64):
    """Causal softcapped attention with p rounded to bf16 before it is
    normalised: the online softmax over ``tile``-key tiles with a running
    max, p = exp(s - m) rounded to bf16 for its product with v, the row sum
    in f32 (the first Hopper build's placement of the rounding, and
    ``flash_xla``'s). Plain PyTorch, the diagnosis of phase 8's margin."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    sc = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, s, kh, h // kh, d)
                      .float(), k.float()) * d**-0.5
    sc = cap * torch.tanh(sc / cap)
    i = torch.arange(s, device=q.device)
    sc = torch.where(i[:, None] >= i[None], sc, -2.0**30)
    m = torch.full(sc.shape[:-1] + (1,), -2.0**30, device=q.device)
    l, acc = torch.zeros_like(m), None
    for k0 in range(0, s, tile):
        t = sc[..., k0:k0 + tile]
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(t - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16().float(),
                          v[:, k0:k0 + tile].float())
        acc = pv if acc is None else acc * alpha + pv
        m = m_new
    return (acc / l).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def flash_margin(torch, fa, ref, draws: int = FLASH_MARGIN_DRAWS) -> dict:
    """How close the bf16 kernel comes to its tolerance on large scores:
    ``draws`` seeded draws of gemma2-2b's global shape at S 512 with q x 20
    (scores of about N(0, 20^2), past the softcap of 50), each held
    against ``ref_attention``. Reports the draws that cross rtol 2e-2,
    atol 8e-3 and the largest ratio of |err| to the tolerance (``main``
    fails on a crossing), and the same for the plain
    :func:`rounded_before_normalising`, which rounds p where the first
    build of the kernel did."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    b, s, h, kh, d, cap = 1, 512, 8, 4, 256, 50.0
    tol = FLASH_TOL["bfloat16"]
    crossed, worst, crossed_b, worst_b = 0, 0.0, 0, 0.0

    def ratio(got, want):
        return float(((got - want).abs()
                      / (tol["atol"] + tol["rtol"] * want.abs())).max())

    for _ in range(draws):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
        q, k, v = (q * 20.0).bfloat16(), k.bfloat16(), v.bfloat16()
        got = fa.flash_attention(q, k, v, causal=True, softcap=cap).float()
        want = ref.ref_attention(q, k, v, True, 0, cap).float()
        r = ratio(got, want)
        crossed += r > 1.0
        worst = max(worst, r)
        r = ratio(rounded_before_normalising(torch, q, k, v, cap), want)
        crossed_b += r > 1.0
        worst_b = max(worst_b, r)
    log(f"flash_attention bf16 margin: {draws} draws of gemma2-2b global "
        f"S={s} q x 20 (softcap {cap}): the kernel crosses the tolerance "
        f"{tol} on {crossed}, the largest |err| / tolerance is {worst:.4f}; "
        f"p rounded to bf16 before normalising (plain) crosses on "
        f"{crossed_b}, largest {worst_b:.4f}")
    return dict(draws=draws, crossed=crossed, max_ratio=worst,
                rounded_before_normalising=dict(crossed=crossed_b,
                                                max_ratio=worst_b))


def rglru_decays(torch, gen, shape, decay: str):
    """RG-LRU decays: ``mild`` U(0.7, 0.999) as the reference's tests draw
    them, or ``strong`` exp(-exp(U(-8, 5))) with one entry in 16 exactly 0
    and one in 16 exactly 1."""
    if decay == "mild":
        return torch.rand(shape, generator=gen, device="cuda") * 0.299 + 0.7
    a = torch.exp(-torch.exp(torch.rand(shape, generator=gen, device="cuda")
                             * 13 - 8))
    pick = torch.rand(shape, generator=gen, device="cuda")
    return torch.where(pick < 1 / 16, 0.0, torch.where(pick > 15 / 16, 1.0, a))


def recurrence_phase(torch, rg, rw, ref) -> tuple[list[dict], list[dict]]:
    """``rglru_linear_scan`` and ``wkv6`` against their plain versions on the
    card at recurrentgemma-2b's and rwkv6-3b's widths, two chunks against
    one, and each timed beside its plain version and its bound (bytes read
    once and written once over 3.35 TB/s; the recurrence's f32 operations
    over 67 TFLOP/s: 2 per RG-LRU element; per WKV6 step, 5 per state entry
    (the read-out ``r·S`` 2, the update ``w·S + k·v`` 3) and the bonus
    ``(Σ_k r_k u_k k_k) v`` at 3 per key and 2 per value)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rg_results = []
    w = 2560
    for b, s, decay in ((1, 37, "mild"), (1, 512, "mild"), (1, 6000, "mild"),
                        (1, 6000, "strong"), (4, 37, "mild"),
                        (4, 512, "mild"), (4, 6000, "mild")):
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            a = rglru_decays(torch, gen, (b, s, w), decay)
            x = torch.randn((b, s, w), generator=gen, device="cuda").to(dt)
            h0 = torch.randn((b, w), generator=gen, device="cuda")
            ys, hf = rg.rglru_linear_scan(a, x, h0)
            want_ys, want_h = ref.ref_rglru(a, x, h0)
            torch.cuda.synchronize()
            torch.testing.assert_close(ys.float(), want_ys,
                                       **RGLRU_TOL[dtype])
            torch.testing.assert_close(hf, want_h, rtol=1e-4, atol=1e-4)
            err = max(float((ys.float() - want_ys).abs().max()),
                      float((hf - want_h).abs().max()))
            trials = 5 if s > 1024 else 21
            ms = device_ms(lambda: rg.rglru_linear_scan(a, x, h0), 10, trials)
            plain_ms = device_ms(lambda: ref.ref_rglru(a, x, h0), 1,
                                 PLAIN_LOOP_TRIALS if s > 1024 else 5)
            bound_ms, bound_by = bound(
                b * s * w * (4 + 2 * x.element_size()) + 2 * b * w * 4,
                2 * b * s * w)
            main = (b, s, decay, dtype) == (1, 6000, "mild", "float32")
            rg_results.append(dict(B=b, S=s, W=w, dtype=dtype, decay=decay,
                                   max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by,
                                   bound_share=bound_ms / ms))
            bar = (f"; the bar {RGLRU_BAR_MS} ms, the target "
                   f"{RGLRU_TARGET_MS} ms" if main else "")
            log(f"rglru_linear_scan B={b} S={s} W={w} {dtype} {decay} decays:"
                f" max |err| {err:.3g} (tol {RGLRU_TOL[dtype]}, h_final "
                f"1e-4); kernel {ms:.5f} ms, {100 * bound_ms / ms:.2f}% of "
                f"its bound, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms"
                f" ({bound_by}){bar}")
    for decay in ("mild", "strong"):
        a = rglru_decays(torch, gen, (1, 512, 2560), decay)
        x = torch.randn((1, 512, 2560), generator=gen, device="cuda")
        h0 = torch.zeros((1, 2560), device="cuda")
        y_all, h_all = rg.rglru_linear_scan(a, x, h0)
        y1, h1 = rg.rglru_linear_scan(a[:, :200].contiguous(),
                                      x[:, :200].contiguous(), h0)
        y2, h2 = rg.rglru_linear_scan(a[:, 200:].contiguous(),
                                      x[:, 200:].contiguous(), h1)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y_all, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(h2, h_all, rtol=1e-5, atol=1e-5)
    log("rglru_linear_scan: S 512 in chunks of 200 and 312 through h0 equals "
        "one scan (1e-5), mild and strong decays")

    rw_results = []
    b, h, kd, vd = 1, 40, 64, 64
    for s, decay in WKV6_DRAWS:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            r, k = (torch.randn((b, s, h, kd), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            v = torch.randn((b, s, h, vd), generator=gen, device="cuda").to(dt)
            if decay == "strong":
                w = torch.exp(-torch.exp(torch.rand(
                    (b, s, h, kd), generator=gen, device="cuda") * 13 - 8))
                pick = torch.rand((b, s, h, kd), generator=gen, device="cuda")
                w = torch.where(pick < 1 / 16, 0.0,
                                torch.where(pick > 15 / 16, 1.0, w))
            else:
                w = torch.rand((b, s, h, kd), generator=gen, device="cuda") \
                    * 0.199 + 0.8
            u = torch.randn((h, kd), generator=gen, device="cuda")
            s0 = torch.randn((b, h, kd, vd), generator=gen, device="cuda")
            args = (r, k, v, w, u, s0)
            y, sf = rw.wkv6(*args)
            want_y, want_s = ref.ref_wkv6(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), want_y, **WKV6_TOL[dtype])
            torch.testing.assert_close(sf, want_s, rtol=1e-3, atol=1e-3)
            err = max(float((y.float() - want_y).abs().max()),
                      float((sf - want_s).abs().max()))
            trials = 5 if s > 1024 else 21
            ms = device_ms(lambda: rw.wkv6(*args), 2 if s > 1024 else 10,
                           trials)
            plain_ms = device_ms(lambda: ref.ref_wkv6(*args), 1,
                                 PLAIN_LOOP_TRIALS if s > 1024 else 5)
            elt = v.element_size()
            bytes_moved = (b * s * h * (kd * (2 * elt + 4) + 2 * vd * elt)
                           + h * kd * 4 + 2 * b * h * kd * vd * 4)
            bound_ms, bound_by = bound(
                bytes_moved, b * s * h * (5 * kd * vd + 3 * kd + 2 * vd))
            rw_results.append(dict(B=b, S=s, H=h, K=kd, V=vd, dtype=dtype,
                                   decay=decay, max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by,
                                   bound_share=bound_ms / ms))
            bar = (f"; the bar {WKV6_BAR_MS} ms, the target "
                   f"{WKV6_TARGET_MS} ms" if (s, decay, dtype) ==
                   (6000, "mild", "float32") else "")
            log(f"wkv6 B={b} S={s} H={h} K={kd} V={vd} {dtype} {decay} "
                f"decays: max |err| {err:.3g} (tol {WKV6_TOL[dtype]}, state "
                f"1e-3); kernel {ms:.5f} ms, {100 * bound_ms / ms:.2f}% of "
                f"its bound, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} "
                f"ms ({bound_by}){bar}")
            del r, k, v, w, args, y, want_y
    r, k, v = (torch.randn((1, 512, h, kd), generator=gen, device="cuda")
               for _ in range(3))
    w = torch.rand((1, 512, h, kd), generator=gen, device="cuda") * 0.2 + 0.8
    s0 = torch.zeros((1, h, kd, vd), device="cuda")
    y_all, s_all = rw.wkv6(r, k, v, w, u, s0)
    y1, s1 = rw.wkv6(*(z[:, :200].contiguous() for z in (r, k, v, w)), u, s0)
    y2, s2 = rw.wkv6(*(z[:, 200:].contiguous() for z in (r, k, v, w)), u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s2, s_all, rtol=1e-4, atol=1e-4)
    log("wkv6: S 512 in chunks of 200 and 312 through s0 equals one scan "
        "(1e-4)")
    return rg_results, rw_results


def kernels_per_prefill(cfg) -> dict[str, int]:
    """How many times one prefill launches each serving kernel: once per
    layer of the kind that calls it."""
    from repro_torch.models.lm import layer_plan

    counts = {name: 0 for name in PROFILE_NAMES}
    for kind, _, _ in layer_plan(cfg):
        counts[KERNEL_OF_KIND[kind]] += 1
    return counts


def serve_phase(torch, arch: str, counters) -> dict:
    """``arch`` at full width through the serve launcher; the launch counts
    of every serving kernel (``counters``: the wrapper modules) are set to 0
    just before and read just after."""
    from repro_torch.launch import serve as serve_launcher

    argv = ["--arch", arch, "--full-width", "--seed", "0", "--device", "cuda"]
    for key, val in SERVE.items():
        argv += ["--" + key.replace("_", "-"), str(val)]
    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.reset_launches()
    res = serve_launcher.main(argv)
    launches = {name: n for mod in counters for name, n in mod.launches.items()}
    cfg, st = res["model"].cfg, res["stats"]
    lens = [len(p) for p in res["prompts"]]
    if "local" in cfg.layer_pattern and max(lens) <= cfg.window:
        raise AssertionError(f"no prompt longer than the window: {lens}")
    if sorted(res["results"]) != list(range(SERVE["requests"])):
        raise AssertionError(f"requests completed: {sorted(res['results'])}")
    for rid, toks in res["results"].items():
        if len(toks) != SERVE["max_new"] or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid} returned {toks}")
    per = kernels_per_prefill(cfg)
    want = {name: n * st["prefills"] for name, n in per.items()}
    if st["prefills"] != SERVE["requests"] or launches != want:
        raise AssertionError(
            f"{arch}: kernels launched {launches} for {st['prefills']} "
            f"prefills, expected {want} ({per} per prefill)")
    ttft = sorted(st["first_token_s"].values())
    out = dict(arch=arch, prompt_lens=lens, launches=launches,
               launches_per_prefill=per,
               ttft_median_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
               prefill_tokens=st["prefill_tokens"], prefill_s=st["prefill_s"],
               prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
               decode_tokens=st["decode_tokens"],
               decode_steps=st["decode_steps"], decode_s=st["decode_s"],
               decode_tokens_per_s=st["decode_tokens"] / st["decode_s"],
               wall_s=res["seconds"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    counted = ", ".join(f"{name} {n} = {per[name]} x {st['prefills']}"
                        for name, n in launches.items() if per[name])
    log(f"serve: {arch} full width bf16, {SERVE['requests']} requests "
        f"through {SERVE['slots']} slots, prompt lengths {lens}, "
        f"{SERVE['max_new']} new tokens each: wall {out['wall_s']:.3f} s; "
        f"time to first token median {out['ttft_median_s']:.4f} s, max "
        f"{out['ttft_max_s']:.4f} s; prefill {out['prefill_tokens']} tokens, "
        f"{out['prefill_tokens_per_s']:.1f} tokens/s; decode "
        f"{out['decode_tokens']} tokens in {out['decode_steps']} steps, "
        f"{out['decode_tokens_per_s']:.1f} tokens/s; launches {counted} "
        f"prefills; peak memory {out['peak_gb']:.2f} GB")
    out["model"], out["params"] = res["model"], res["params"]
    return out


def serve_profile(torch, model, params, n: int = 6000, steps: int = 8) -> dict:
    """Where serving's time goes: one n-token prefill and ``steps`` decode
    steps at 4 live slots under ``torch.profiler``: wall time, device busy
    time, each hand-written kernel's time and share, the heaviest
    kernels."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (1, n))).cuda()
    out = {}
    with torch.inference_mode():
        model.prefill(params, model.init_cache(1, n), {"tokens": toks[:, :64]})
        cache = model.init_cache(4, n + steps + 1)
        batch = {"tokens": toks.expand(4, n)}
        model.prefill(params, cache, batch)  # fill 4 rows for the decode
        tok = torch.zeros(4, dtype=torch.int64, device="cuda")
        for phase in ("prefill", "decode"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if phase == "prefill":
                    model.prefill(params, model.init_cache(1, n),
                                  {"tokens": toks})
                else:
                    for i in range(steps):
                        pos = torch.full((4,), n + i, dtype=torch.int32,
                                         device="cuda")
                        logits, cache = model.decode(params, cache, tok, pos)
                        tok = logits.argmax(-1)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = device_events(prof)
            busy_ms = sum(e[1] for e in events) / 1e3
            per = steps if phase == "decode" else 1
            kernel_ms = {
                name: sum(e[1] for e in events if sym in e[0]) / 1e3 / per
                for name, sym in PROFILE_NAMES.items()}
            out[phase] = dict(
                wall_ms=wall_ms / per, device_busy_ms=busy_ms / per,
                busy_share=busy_ms / wall_ms if wall_ms else None,
                kernel_ms=kernel_ms,
                kernel_share={k: v * per / busy_ms if busy_ms else None
                              for k, v in kernel_ms.items()},
                device_kernels=sum(e[2] for e in events) / per,
                top=[(k[:60], us / 1e3 / per) for k, us, _ in events[:6]])
            o = out[phase]
            what = (f"one {n}-token prefill" if phase == "prefill" else
                    f"per decode step at 4 slots (cache {n + steps + 1})")
            mine = ", ".join(
                f"{k} {v:.3f} ms ({100 * (o['kernel_share'][k] or 0):.2f}%)"
                for k, v in kernel_ms.items() if v)
            log(f"serve profile, {model.cfg.name}, {what}: wall "
                f"{o['wall_ms']:.3f} ms under the profiler, device busy "
                f"{o['device_busy_ms']:.3f} ms "
                f"({100 * (o['busy_share'] or 0):.2f}%), "
                f"{mine or 'no hand-written kernel'}, "
                f"{o['device_kernels']:.0f} device kernels")
            for name, ms in o["top"]:
                log(f"serve profile:   {ms:.4f} ms  {name}")
    return out


def serve_vs_plain(torch, model, params, n: int):
    """Last-position prefill logits of one ``n``-token prompt through the
    kernels and through the plain path (``attention_impl("xla")`` and
    ``recurrence_impl("plain")``), at full width, in bf16 and in f32 (the
    same weights, widened exactly).

    Checks: (1) in f32 the two paths agree within rtol = atol = 1e-3 (the
    same f32 arithmetic, summed in other orders); (2) in bf16 the kernels'
    logits are no further from the f32 logits than 1.25x the plain path's
    (the kernels are at least as accurate as the reference's algorithm).
    The bf16 kernel-vs-plain distance is printed against rtol = atol =
    3e-2, the reduced-model bound of ``tests/test_kernels_integration.py``,
    but not enforced: over 26 layers at d_model 2304 two bf16 paths that
    round at other places drift further apart than over 4 layers at
    d_model 64 (PERF.md). Returns the f32 model and weights for the
    next phase.
    """
    import dataclasses

    import numpy as np

    from repro_torch.models.attention import attention_impl
    from repro_torch.models.lm import LM
    from repro_torch.models.recurrent import recurrence_impl
    from repro_torch.models.registry import build_model

    if "local" in model.cfg.layer_pattern and n <= model.cfg.window:
        raise AssertionError(f"prompt of {n} within the window "
                             f"{model.cfg.window}: no key is masked by it")
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab_size, (1, n))
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"),
                          "cuda")
    params32 = LM(model32.cfg, model32.device)
    params32.load_state_dict(params.state_dict())
    logits = {}
    with torch.inference_mode():
        for name, m, p in (("bf16", model, params), ("f32", model32,
                                                     params32)):
            logits[name, "kernel"], _ = m.prefill(p, m.init_cache(1, n), batch)
            with attention_impl("xla"), recurrence_impl("plain"):
                logits[name, "plain"], _ = m.prefill(p, m.init_cache(1, n),
                                                     batch)
    truth = logits["f32", "plain"]

    def dist(a, b):
        return float((a - b).abs().max())

    kern, plain = logits["bf16", "kernel"], logits["bf16", "plain"]
    tol = 3e-2 + 3e-2 * plain.abs()
    out = dict(n=n, max_abs_logit=float(truth.abs().max()),
               bf16_kernel_vs_plain=dist(kern, plain),
               bf16_outside_3e2=int(((kern - plain).abs() > tol).sum()),
               f32_kernel_vs_plain=dist(logits["f32", "kernel"], truth),
               bf16_kernel_vs_f32=dist(kern, truth),
               bf16_plain_vs_f32=dist(plain, truth),
               same_argmax=bool(kern.argmax() == plain.argmax()
                                == truth.argmax()))
    log(f"serve vs plain: {model.cfg.name}, {n}-token prompt, last-position "
        f"logits (max "
        f"|logit| {out['max_abs_logit']:.4g}): f32 kernel vs plain max |err| "
        f"{out['f32_kernel_vs_plain']:.4g} (tol rtol = atol = 1e-3); bf16 "
        f"kernel vs f32 {out['bf16_kernel_vs_f32']:.4g}, bf16 plain vs f32 "
        f"{out['bf16_plain_vs_f32']:.4g} (the kernel's must be <= 1.25x); "
        f"bf16 kernel vs plain {out['bf16_kernel_vs_plain']:.4g}, "
        f"{out['bf16_outside_3e2']} of {plain.numel()} outside rtol = atol "
        f"= 3e-2 (reported); same argmax {out['same_argmax']}")
    torch.testing.assert_close(logits["f32", "kernel"], truth, rtol=1e-3,
                               atol=1e-3)
    if out["bf16_kernel_vs_f32"] > 1.25 * out["bf16_plain_vs_f32"]:
        raise AssertionError(f"{model.cfg.name}: the bf16 kernel path is "
                             "further from the f32 logits than 1.25x the "
                             "bf16 plain path")
    return out, model32, params32


def engine_vs_greedy(torch, model, params) -> dict:
    """The model at full width in f32: the engine's tokens (more requests
    than slots) equal per-request greedy prefill and decode."""
    import numpy as np

    from repro_torch.config.base import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    cfg = model.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 40))
               for _ in range(6)]
    n_new, max_seq = 8, 64
    refs, margins = [], []
    with torch.inference_mode():
        for pr in prompts:
            cache = model.init_cache(1, max_seq)
            logits, cache = model.prefill(
                params, cache, {"tokens": torch.from_numpy(pr[None]).cuda()})
            toks, marg = [], []
            for t in range(n_new):
                top = logits[0].topk(2).values
                toks.append(int(logits[0].argmax()))
                marg.append(float(top[0] - top[1]))
                if t < n_new - 1:
                    pos = torch.tensor([len(pr) + t], dtype=torch.int32,
                                       device="cuda")
                    logits, cache = model.decode(
                        params, cache, torch.tensor([toks[-1]], device="cuda"),
                        pos)
            refs.append(toks)
            margins.append(marg)
    eng = ServeEngine(model, params, ServeConfig(max_batch=4, max_seq=max_seq))
    rids = [eng.submit(pr, max_new=n_new) for pr in prompts]
    results = eng.run()
    for rid, ref_toks, marg in zip(rids, refs, margins):
        got = results[rid]
        if got != ref_toks:
            step = next(i for i, (a, b) in enumerate(zip(got, ref_toks))
                        if a != b)
            raise AssertionError(
                f"engine != greedy for request {rid} at step {step}: "
                f"{got} vs {ref_toks}; the reference's top-2 logit margin "
                f"there is {marg[step]:.3g}")
    out = dict(requests=len(prompts), slots=4, new_tokens=n_new,
               min_margin=min(min(m) for m in margins))
    log(f"engine = greedy: {cfg.name} full width f32, {len(prompts)} requests "
        f"through 4 slots, {n_new} tokens each: equal (smallest top-2 logit "
        f"margin {out['min_margin']:.3g})")
    return out


def states_equal(torch, a, b, path="state") -> None:
    if a is None and b is None:
        return
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError(f"{path} differs")
        return
    for name, x, y in zip(a._fields, a, b):
        states_equal(torch, x, y, f"{path}.{name}")


def main() -> None:
    from concurrent.futures import ThreadPoolExecutor

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[chip_smoke] torch.cuda.is_available() is False: "
                         "this script needs an NVIDIA GPU")
    from repro_torch.convert import to_numpy
    from repro_torch.kernels import build, idm, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6 as rw
    from repro_torch.launch import sweep as launcher

    # 1. card
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind}")

    # f32 products in full f32 (the engine = greedy phase compares tokens)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(build.load, ("idm", "flash_attention", "rglru", "wkv6")))
    log(f"built {SOURCE}, {FLASH_SOURCE}, {RGLRU_SOURCE} and {WKV6_SOURCE} "
        f"for sm_90a in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    nb_results, idm_results = kernel_phase(torch, idm, ref)

    # 4. the sweep at full size through the launcher
    argv = [
        "--instances", str(SWEEP["instances"]), "--slots", str(SWEEP["slots"]),
        "--steps", str(SWEEP["steps"]), "--chunk-steps",
        str(SWEEP["chunk_steps"]), "--scenario-mix", "all",
        "--dispatch", "grouped", "--neighbor-impl", "cuda", "--seed", "0",
        "--device", "cuda", "--devices", "1",
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
    sweep = dict(wall_s=wall, instance_steps_per_s=inst_steps / wall,
                 vehicle_steps_per_s=veh_steps / wall)
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
    parity = ["--instances", str(PARITY["instances"]), "--slots",
              str(SWEEP["slots"]), "--steps", str(PARITY["steps"]),
              "--chunk-steps", str(PARITY["steps"]), "--scenario-mix", "all",
              "--dispatch", "grouped", "--seed", "0", "--device", "cuda"]
    with contextlib.redirect_stdout(io.StringIO()):
        a = launcher.main(parity + ["--neighbor-impl", "cuda"])
        b = launcher.main(parity + ["--neighbor-impl", "sort"])
    states_equal(torch, a["state"], b["state"])
    log("parity: cuda and sort give a bit-identical final SweepState "
        f"({PARITY['instances']} instances, {PARITY['steps']} steps)")

    # 6a. the same sweep through blocks, and phase 4's through 2 blocks
    blocks = blocks_phase(torch, idm, a["state"], sweep)

    # 7. where a group call's time goes
    profile_phase(torch)

    # 7a. the recording, checkpointed, supervised sweep in-process; 7b. the
    # controller over the full-size recording sweep (the gate)
    record = record_phase(torch, idm, a["state"])
    pipeline = pipeline_phase(torch, wall)
    # 7c. the LM inputs of 7b's dataset
    tokens_phase(torch, pipeline["dataset"])

    main_nb = nb_results[0]
    main_idm = idm_results[0]
    kernels = [
        dict(name="neighbor_kernel", route="cuda", source=SOURCE,
             replaces="src/repro/kernels/idm.py:242",
             launches=counts["neighbor_kernel"],
             launches_by_path={"sweep": counts["neighbor_kernel"],
                               "blocks": blocks["launches"],
                               "record": record["launches"],
                               "record pipelined, 2 blocks":
                                   record["launches_pipe"],
                               "pipeline (final worker)":
                                   pipeline["launches_final_worker"]},
             max_abs_err=max(r["max_abs_err"] for r in nb_results),
             ms=main_nb["ms"], plain_ms=main_nb["plain_ms"],
             bound_ms=main_nb["bound_ms"], bound_by=main_nb["bound_by"],
             library_ms=None, shapes=nb_results),
        dict(name="idm_accel_kernel", route="cuda", source=SOURCE,
             replaces="src/repro/kernels/idm.py:130",
             launches=counts["idm_accel_kernel"],
             max_abs_err=max(r["max_abs_err"] for r in idm_results),
             ms=main_idm["ms"], all_pairs_ms=main_idm["all_pairs_ms"],
             plain_ms=main_idm["plain_ms"], bound_ms=main_idm["bound_ms"],
             bound_by=main_idm["bound_by"], library_ms=None,
             shapes=idm_results),
    ]

    # 8. flash attention against its plain version
    fl_results = flash_phase(torch, fa, ref)
    margin = flash_margin(torch, fa, ref)
    if margin["crossed"]:
        raise AssertionError(f"flash_attention bf16: {margin['crossed']} of "
                             f"{margin['draws']} q x 20 draws cross the "
                             "tolerance")

    # 9. the recurrence kernels against their plain versions
    rg_results, rw_results = recurrence_phase(torch, rg, rw, ref)

    # 10-13 for each served model: serve, serve vs plain, profile,
    # engine = greedy; each model is freed before the next
    served = {}
    for arch, plain_n in SERVE_ARCHS:
        out = serve_phase(torch, arch, (fa, rg, rw))
        model, params = out.pop("model"), out.pop("params")
        out["vs_plain"], model32, params32 = serve_vs_plain(
            torch, model, params, plain_n)
        out["profile"] = serve_profile(torch, model, params)
        del model, params
        torch.cuda.empty_cache()
        out["engine_vs_greedy"] = engine_vs_greedy(torch, model32, params32)
        del model32, params32
        torch.cuda.empty_cache()
        served[arch] = out

    def launched(name):
        return sum(out["launches"][name] for out in served.values())

    main_fl = next(r for r in fl_results if r["dtype"] == "bfloat16" and
                   r["S"] == 6000 and r["window"] == 0 and r["D"] == 256)
    main_rg = next(r for r in rg_results if r["dtype"] == "float32" and
                   r["S"] == 6000 and r["B"] == 1 and r["decay"] == "mild")
    main_rw = next(r for r in rw_results if r["dtype"] == "float32" and
                   r["S"] == 6000 and r["decay"] == "mild")
    kernels.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SOURCE,
        replaces="src/repro/kernels/flash_attention.py:135",
        launches=launched("flash_attention"),
        launches_by_path={arch: out["launches"]["flash_attention"]
                          for arch, out in served.items()},
        max_abs_err=max(r["max_abs_err"] for r in fl_results),
        ms=main_fl["ms"], plain_ms=main_fl["plain_ms"],
        bound_ms=main_fl["bound_ms"], bound_by=main_fl["bound_by"],
        library=main_fl["library"], library_ms=main_fl["library_ms"],
        shapes=fl_results, bf16_margin=margin,
        serve=served["gemma2-2b"]))
    for name, source, replaces, main_row, rows, arch in (
            ("rglru_linear_scan", RGLRU_SOURCE,
             "src/repro/kernels/rglru.py:74", main_rg, rg_results,
             "recurrentgemma-2b"),
            ("wkv6", WKV6_SOURCE, "src/repro/kernels/rwkv6.py:79", main_rw,
             rw_results, "rwkv6-3b")):
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launched(name),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=None, shapes=rows, serve=served[arch]))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
