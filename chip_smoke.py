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
   wall time and of the unprofiled step, and the heaviest kernels;
8. attention — ``flash_attention`` against ``ref_attention`` at gemma2-2b's
   prefill shapes (B 1, H 8, K 4, D 256, S 37/512/6000, global and local
   window 4096, softcap 50), once more at S 512 with q scaled by 20 so that
   the scores reach the cap, at qwen1.5-0.5b's (H = K = 16, D 64) and at
   recurrentgemma-2b's local layers (H 10, K 1, D 256, window 2048, no
   softcap, S 512/6000), in bf16 (rtol 2e-2, atol 8e-3) and f32 (rtol
   2e-3, atol 2e-4), the tolerances of ``tests/test_kernels.py``; kernel,
   plain version, bound and the library call timed:
   ``scaled_dot_product_attention`` for the causal shapes without softcap,
   compiled ``flex_attention`` (softcap ``score_mod``, causal/window block
   mask, GQA) for the other shapes in bf16 (each held against
   ``ref_attention`` first; the port never calls either);
9. recurrences — ``rglru_linear_scan`` against ``ref_rglru`` (B 1 and 4,
   W 2560, S 37/512/6000; ys rtol 2e-2 atol 2e-3 in bf16, 1e-5 in f32,
   h_final 1e-4) and ``wkv6`` against ``ref_wkv6`` (B 1, H 40, K = V = 64,
   S 37/512/4096/6000; 5e-2 in bf16, 1e-4 in f32, the state 1e-3), x or
   r/k/v in bf16 and f32, the tolerances of ``tests/test_kernels.py``; two
   chunks through ``h0``/``s0`` equal one; kernel, plain version and bound
   timed (no single PyTorch call computes either recurrence);

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
SOURCE = "src/repro_torch/kernels/csrc/idm.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
RGLRU_SOURCE = "src/repro_torch/kernels/csrc/rglru.cu"
WKV6_SOURCE = "src/repro_torch/kernels/csrc/wkv6.cu"
# dense tensor-core peaks of an H100 SXM (NVIDIA data sheet), by input type
TENSOR_OPS_PER_S = {"bfloat16": 989e12, "float32": 495e12}  # f32 via TF32
FLASH_TOL = {"bfloat16": dict(rtol=2e-2, atol=8e-3),
             "float32": dict(rtol=2e-3, atol=2e-4)}
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
                 "rglru_linear_scan": "rglru_scan", "wkv6": "wkv6_fwd"}
RGLRU_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-3),
             "float32": dict(rtol=1e-5, atol=1e-5)}
WKV6_TOL = {"bfloat16": dict(rtol=5e-2, atol=5e-2),
            "float32": dict(rtol=1e-4, atol=1e-4)}


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
    for s in (512, 6000)
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
            results.append(dict(shape=label, B=b, S=s, H=h, K=kh, D=d,
                                window=window, softcap=cap, q_scale=q_scale,
                                dtype=dtype, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library=library,
                                library_ms=library_ms))
            lib_txt = (f"{library} {library_ms:.5f} ms" if library else
                       "flex_attention not timed in f32")
            log(f"flash_attention {label} {dtype}: max |err| {err:.3g} "
                f"(tol {FLASH_TOL[dtype]}); kernel {ms:.5f} ms, plain "
                f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
                f"{lib_txt}")
            del q, k, v, got, want
    return results


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
    for b in (1, 4):
        for s in (37, 512, 6000):
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                a = torch.rand((b, s, w), generator=gen, device="cuda") \
                    * 0.299 + 0.7
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
                ms = device_ms(lambda: rg.rglru_linear_scan(a, x, h0), 10,
                               trials)
                plain_ms = device_ms(lambda: ref.ref_rglru(a, x, h0), 1, 5)
                bound_ms, bound_by = bound(
                    b * s * w * (4 + 2 * x.element_size()) + 2 * b * w * 4,
                    2 * b * s * w)
                rg_results.append(dict(B=b, S=s, W=w, dtype=dtype,
                                       max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=bound_by))
                log(f"rglru_linear_scan B={b} S={s} W={w} {dtype}: max |err| "
                    f"{err:.3g} (tol {RGLRU_TOL[dtype]}, h_final 1e-4); "
                    f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
                    f"{bound_ms:.5f} ms ({bound_by})")
    a = torch.rand((1, 512, 2560), generator=gen, device="cuda") * 0.2 + 0.8
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
        "one scan (1e-5)")

    rw_results = []
    b, h, kd, vd = 1, 40, 64, 64
    for s in (37, 512, 4096, 6000):
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            r, k = (torch.randn((b, s, h, kd), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            v = torch.randn((b, s, h, vd), generator=gen, device="cuda").to(dt)
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
            plain_ms = device_ms(lambda: ref.ref_wkv6(*args), 1, 5)
            elt = v.element_size()
            bytes_moved = (b * s * h * (kd * (2 * elt + 4) + 2 * vd * elt)
                           + h * kd * 4 + 2 * b * h * kd * vd * 4)
            bound_ms, bound_by = bound(
                bytes_moved, b * s * h * (5 * kd * vd + 3 * kd + 2 * vd))
            rw_results.append(dict(B=b, S=s, H=h, K=kd, V=vd, dtype=dtype,
                                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by))
            log(f"wkv6 B={b} S={s} H={h} K={kd} V={vd} {dtype}: max |err| "
                f"{err:.3g} (tol {WKV6_TOL[dtype]}, state 1e-3); kernel "
                f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} "
                f"ms ({bound_by})")
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
            raise AssertionError(f"{path} differs between cuda and sort")
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

    # 8. flash attention against its plain version
    fl_results = flash_phase(torch, fa, ref)

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
                   r["S"] == 6000 and r["B"] == 1)
    main_rw = next(r for r in rw_results if r["dtype"] == "float32" and
                   r["S"] == 6000)
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
        shapes=fl_results,
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
