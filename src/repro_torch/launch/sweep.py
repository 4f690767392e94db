"""Sweep launcher — the paper's Phase II/III pipeline as one command, on a GPU.

``python -m repro_torch.launch.sweep --instances 1024 --slots 128
--scenario-mix all --neighbor-impl cuda`` runs the sweep on the card;
``--device cpu`` runs it on the CPU. The loop is always the supervised one
(:func:`repro_torch.core.fleet.run_supervised`). Flags:

``--instances --steps --chunk-steps --slots``
    sweep size, horizon and walltime slice (defaults as the reference);
``--scenario`` / ``--scenario-mix`` (names, or ``all``)
    the workload roster, assigned to instances round-robin;
``--dispatch {auto,switch,grouped}``
    how a mixed roster maps onto batched calls (bit-identical results);
``--neighbor-impl {reference,dense,sort,cuda}``
    the neighborhood engine; ``cuda`` is the hand-written kernel;
``--fail-prob --hang-prob --straggler-prob --poison``
    the injected faults (``FaultModel.random_model`` from ``--seed``, over
    a ``--workers`` grid, the paper's instances per node);
``--devices N --workers W``
    blocks: the instance axis is packed into one block per device (every
    visible card on ``cuda`` by default; on ``--device cpu`` the CPU N
    times, 1 by default), and W is the instances per device, so the fault
    injector's worker grid is N x W;
``--pipeline`` / ``--no-pipeline``
    commit each chunk (checkpoint, shards, journal, heartbeat) on an I/O
    thread while the next chunk runs (the default), or synchronously; both
    write the same bits;
``--max-retries --chunk-deadline``
    the retry budget before quarantine, and the journaled chunk deadline;
``--ckpt-dir --journal --heartbeat-file``
    checkpoints after every chunk (a rerun resumes from the newest valid
    one), the run journal (default ``<ckpt-dir>/journal.jsonl``) and the
    atomic liveness beacon that :mod:`repro_torch.launch.controller` polls;
``--dataset-dir --record-every --record-slots --shard-size``
    trajectory recording and the sharded Phase-III dataset
    (``--dataset-dir`` alone records every 10 steps);
``--seed --vary-horizon --out --device``.

It prints what the reference launcher prints: the roster line (devices x
workers and the I/O mode), per-chunk completion, the final line with
``eligible`` completion, the fleet table and the summary JSON; and, per
chunk, the host seconds of the chunk, its checkpoint save, its shard
drain, its whole commit and the loop's wait for it; and last a ``[sweep]
run:`` JSON line with the devices, the wall seconds, the batched chunk
calls and this process's kernel launch counts. ``--out`` holds what the
reference's does (summary, records, fault info), so two runs that differ
only in ``--devices`` or ``--pipeline`` write the same file.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _write_heartbeat(path: str, chunk: int, done: float) -> None:
    """Atomically publish a liveness beacon (tmp + rename, never torn)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"chunk": chunk, "done": done, "time": time.time()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _parser(scenarios: list[str]) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sweep",
                                 allow_abbrev=False)
    ap.add_argument("--instances", type=int, default=48)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--chunk-steps", type=int, default=400)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--scenario", default="highway_merge", choices=scenarios,
                    help="workload every instance runs (registry name)")
    ap.add_argument("--scenario-mix", default=None,
                    help="comma-separated scenario names assigned to "
                         "instances round-robin, or 'all' for the whole "
                         "registry (overrides --scenario)")
    ap.add_argument("--dispatch", default="auto",
                    choices=["auto", "switch", "grouped"],
                    help="mixed-sweep chunk dispatch: grouped = per-scenario "
                         "dense batches, switch = every branch on every row "
                         "then a per-row select, auto = grouped iff mixed")
    ap.add_argument("--neighbor-impl", default="sort",
                    choices=["reference", "dense", "sort", "cuda"],
                    help="neighborhood engine implementation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vary-horizon", action="store_true")
    ap.add_argument("--fail-prob", type=float, default=0.0,
                    help="per-worker per-chunk probability of an injected "
                         "crash (chunk progress lost, instances reverted "
                         "and re-queued)")
    ap.add_argument("--hang-prob", type=float, default=0.0,
                    help="per-worker per-chunk probability of an injected "
                         "hang (same revert as a crash, journaled as a hang)")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="per-worker per-chunk probability of a journaled "
                         "slow-but-successful chunk (results kept)")
    ap.add_argument("--poison", default="",
                    help="comma-separated logical instance ids that crash "
                         "every chunk they run (quarantined once their "
                         "retry budget is spent)")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="per-instance retry budget before quarantine")
    ap.add_argument("--chunk-deadline", type=float, default=None,
                    help="wall-clock seconds per chunk before a 'deadline' "
                         "event is journaled")
    ap.add_argument("--heartbeat-file", default=None,
                    help="write an atomic {chunk, done, time} liveness "
                         "beacon here after every committed chunk")
    ap.add_argument("--journal", default=None,
                    help="append-only jsonl run journal (default: "
                         "<ckpt-dir>/journal.jsonl when --ckpt-dir is set)")
    ap.add_argument("--devices", type=int, default=None,
                    help="devices the instance axis is packed over, one "
                         "block each (default: every visible card on cuda, "
                         "1 on the CPU; on the CPU the blocks share it)")
    ap.add_argument("--workers", type=int, default=1,
                    help="instances per device (the paper's per-node "
                         "parallelism): the fault injector's worker grid is "
                         "devices x workers, and blocks are padded to a "
                         "multiple of it")
    ap.add_argument("--pipeline", dest="pipeline", action="store_true",
                    default=True,
                    help="commit each chunk on an I/O thread while the next "
                         "one runs (the default)")
    ap.add_argument("--no-pipeline", dest="pipeline", action="store_false",
                    help="the synchronous chunk loop (same bits, no "
                         "overlap)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None, help="write records JSON here")
    ap.add_argument("--dataset-dir", default=None,
                    help="stream a sharded Phase-III dataset here "
                         "(npz/jsonl shards + manifest); implies recording")
    ap.add_argument("--record-every", type=int, default=0,
                    help="trajectory recording stride in steps (0 = off; "
                         "--dataset-dir defaults it to 10)")
    ap.add_argument("--record-slots", type=int, default=8,
                    help="vehicle slots recorded for token streams")
    ap.add_argument("--shard-size", type=int, default=16,
                    help="instances per dataset shard")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns ``{"state", "summary", "info", "seconds",
    "group_calls", "timings"}`` for in-process callers."""
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.aggregate import aggregate_metrics, metrics_to_records
    from repro_torch.core.fault import FaultModel
    from repro_torch.core.fleet import (
        RetryPolicy,
        RunJournal,
        format_completion_table,
        run_supervised,
    )
    from repro_torch.core.record import RecordConfig
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.scenarios import list_scenarios
    from repro_torch.core.sweep import SweepConfig, SweepRunner
    from repro_torch.data.shards import DatasetWriter
    from repro_torch.device import resolve_device
    from repro_torch.kernels import idm
    from repro_torch.launch.mesh import sweep_devices

    ap = _parser(list_scenarios())
    args = ap.parse_args(argv)
    if args.workers < 1:
        ap.error("--workers must be >= 1 (instances per device)")
    if args.devices is not None and args.devices < 1:
        ap.error("--devices must be >= 1")
    home = resolve_device(args.device)
    n_devices = args.devices
    if n_devices is None:
        n_devices = (torch.cuda.device_count() - home.index
                     if home.type == "cuda" else 1)
    devices = sweep_devices(n_devices, home)
    try:
        poison = tuple(int(p) for p in args.poison.split(",") if p.strip())
    except ValueError:
        ap.error("--poison takes comma-separated integer instance ids")

    record_every = args.record_every
    if args.dataset_dir and record_every == 0:
        record_every = 10
    record = (RecordConfig(record_every=record_every, k_slots=args.record_slots)
              if record_every > 0 else None)
    if args.scenario_mix:
        mix = (
            tuple(list_scenarios())
            if args.scenario_mix.strip() == "all"
            else tuple(s.strip() for s in args.scenario_mix.split(",") if s.strip())
        )
    else:
        mix = ()
    cfg = SweepConfig(
        n_instances=args.instances,
        steps_per_instance=args.steps,
        chunk_steps=args.chunk_steps,
        sim=SimConfig(n_slots=args.slots, neighbor_impl=args.neighbor_impl,
                      scenario=args.scenario),
        seed=args.seed,
        vary_horizon=args.vary_horizon,
        scenario_mix=mix,
        dispatch=args.dispatch,
        record=record,
    )
    runner = SweepRunner(cfg, devices=devices,
                         workers_per_device=args.workers)
    faults = FaultModel.random_model(
        n_workers=runner._n_workers(),
        n_chunks=max(args.steps // args.chunk_steps * 3, 8),
        fail_prob=args.fail_prob,
        hang_prob=args.hang_prob,
        straggler_prob=args.straggler_prob,
        poison_instances=poison,
        seed=args.seed,
    )
    policy = RetryPolicy(max_retries=args.max_retries)
    journal_path = args.journal or (
        os.path.join(args.ckpt_dir, "journal.jsonl") if args.ckpt_dir else None
    )
    journal = RunJournal(journal_path) if journal_path else None
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    writer = (DatasetWriter(args.dataset_dir, cfg, shard_size=args.shard_size)
              if args.dataset_dir else None)

    print(f"[sweep] scenarios: {', '.join(cfg.scenarios)} "
          f"({'mixed round-robin' if len(cfg.scenarios) > 1 else 'uniform'}) "
          f"| dispatch {cfg.effective_dispatch} "
          f"| neighbor impl {cfg.sim.neighbor_impl} "
          f"| {runner.n_devices} device(s) x {args.workers} worker(s) "
          f"on {', '.join(str(d) for d in runner.devices)} "
          f"| {'pipelined' if args.pipeline else 'synchronous'} I/O"
          + (f" | recording every {record_every} steps" if record else ""),
          flush=True)

    def on_progress(c: int, done: float) -> None:
        print(f"[sweep] chunk {c}: {done*100:.1f}% complete", flush=True)
        if args.heartbeat_file:
            # the beacon goes out once the chunk's checkpoint is on disk, so
            # a worker killed after a beacon resumes from that chunk
            if ckpt is not None:
                ckpt.wait()
            _write_heartbeat(args.heartbeat_file, c, done)

    timings: list[dict] = []

    def on_timing(c: int, t: dict) -> None:
        timings.append(dict(chunk=c, **t))
        print(f"[sweep] chunk {c} host seconds: chunk {t['chunk_s']:.4f}, "
              f"checkpoint save {t['ckpt_s']:.4f}, shard drain "
              f"{t['drain_s']:.4f}, commit {t['commit_s']:.4f}, waited "
              f"{t['wait_s']:.4f}", flush=True)

    t0 = time.perf_counter()
    state, info = run_supervised(
        runner, faults, policy=policy, ckpt=ckpt, writer=writer,
        journal=journal, pipeline=args.pipeline,
        chunk_deadline=args.chunk_deadline,
        on_progress=on_progress, on_timing=on_timing,
    )
    if ckpt is not None:
        ckpt.wait()
    for dev in dict.fromkeys(runner.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    summary = aggregate_metrics(
        state.metrics, scenario_ids=state.scenario_id,
        scenario_names=cfg.scenarios,
    )
    print(f"[sweep] done in {dt:.1f}s — completion "
          f"{info['completion_rate']*100:.0f}% "
          f"(eligible {info['eligible_completion_rate']*100:.0f}%), "
          f"{info['chunks_run']} chunks, {runner.group_calls} batched chunk "
          f"calls, {len(info['failure_events'])} failure events, "
          f"{len(info['quarantined'])} quarantined")
    print(format_completion_table(info["report"]))
    print(f"[sweep] {json.dumps(summary, indent=1)}")
    if writer is not None:
        manifest = writer.finalize(summary=summary, fault_info=info)
        print(f"[sweep] wrote sharded dataset: {manifest} "
              f"({len(writer.written)} instances)")
    if args.out:
        records = metrics_to_records(
            state.metrics, state.params,
            scenario_ids=state.scenario_id, scenario_names=cfg.scenarios,
        )
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "records": records,
                       "fault_info": info}, f, indent=1)
        print(f"[sweep] wrote dataset to {args.out}")
    print("[sweep] run: " + json.dumps({
        "devices": [str(d) for d in runner.devices], "workers": args.workers,
        "pipeline": args.pipeline, "seconds": dt,
        "group_calls": runner.group_calls, "launches": dict(idm.launches)}),
        flush=True)
    return {"state": state, "summary": summary, "info": info, "seconds": dt,
            "group_calls": runner.group_calls, "timings": timings}


if __name__ == "__main__":
    main()
