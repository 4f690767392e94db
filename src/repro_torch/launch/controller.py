"""Unattended-run process controller: heartbeats, SIGKILL, resume, gate.

Port of ``repro/launch/controller.py``: the process half of the paper's
§5.2 contract (the in-process half is ``repro_torch.core.fleet``). It runs
the port's sweep as a child worker (``python -m repro_torch.launch.sweep``)
and keeps it alive without a human —

- **Heartbeats.** The worker publishes an atomic ``{chunk, done, time}``
  beacon after every committed chunk (``--heartbeat-file``). The
  controller polls it; a beacon older than ``--heartbeat-timeout``
  means the worker is hung (a real hang, not the simulated
  ``FaultModel`` kind) and gets SIGKILLed.
- **Resume.** A killed or crashed worker is respawned with the same
  arguments; the sweep resumes from the last *valid* checkpoint (the
  digest-verified fallback restore in ``repro_torch.ckpt``) and replays its
  fleet state from the run journal. ``--max-worker-restarts`` bounds the
  respawn loop.
- **Chaos mode.** ``--chaos-kills N`` makes the controller itself
  SIGKILL the worker N times after it has made progress
  (``--chaos-min-chunks`` committed chunks since spawn) — the CI smoke
  proof that an unattended run survives real process death, not just
  injected reverts. Chaos kills do not consume the restart budget.
- **Completion gate.** When the worker finally exits 0, the controller
  reads its ``--out`` result JSON and exits 0 only if
  ``eligible_completion_rate == 1.0`` — every instance the fleet kept
  scheduling finished; quarantined instances are reported, not hidden.

The controller imports neither torch nor anything else heavy (it must stay
alive and cheap while the worker owns the card), so it keeps its own local
journal append rather than importing ``repro_torch.core.fleet``.

Typical invocation (everything after ``--`` goes to the worker verbatim;
the controller appends ``--ckpt-dir``, ``--heartbeat-file`` and
``--out`` itself)::

    python -m repro_torch.launch.controller --ckpt-dir run \\
        --chaos-kills 2 -- --instances 8 --steps 200 --fail-prob 0.1 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _append_journal(path: str, event: dict) -> None:
    """Durably append one controller event to the jsonl journal (same
    torn-tail-tolerant format as ``repro_torch.core.fleet.RunJournal``)."""
    event = dict(event, time=time.time(), source="controller")
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(event) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _read_heartbeat(path: str) -> dict | None:
    """The worker's latest liveness beacon, or None when absent/torn."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _spawn_worker(
    worker_args: list[str], ckpt_dir: str, heartbeat: str, out: str
) -> subprocess.Popen:
    """Launch one sweep worker attempt (controller-owned plumbing flags
    appended after the user's passthrough arguments)."""
    cmd = [
        sys.executable, "-m", "repro_torch.launch.sweep", *worker_args,
        "--ckpt-dir", ckpt_dir, "--heartbeat-file", heartbeat, "--out", out,
    ]
    return subprocess.Popen(cmd)


def _supervise_once(
    proc: subprocess.Popen,
    heartbeat: str,
    *,
    timeout: float,
    poll: float,
    chaos_left: int,
    chaos_min_chunks: int,
    journal: str,
) -> tuple[int | None, str]:
    """Monitor one worker attempt until it exits or must be killed.

    Returns ``(returncode, reason)`` where reason is "exit" (worker
    terminated on its own), "chaos" (intentional chaos SIGKILL) or
    "hang" (heartbeat went stale past ``timeout``).
    """
    spawned = time.time()
    base_hb = _read_heartbeat(heartbeat)
    base_chunk = base_hb["chunk"] if base_hb else -1
    while True:
        rc = proc.poll()
        if rc is not None:
            return rc, "exit"
        hb = _read_heartbeat(heartbeat)
        now = time.time()
        progressed = (
            hb is not None and hb["chunk"] - base_chunk >= chaos_min_chunks
        )
        if chaos_left > 0 and progressed:
            _append_journal(journal, {
                "kind": "worker_kill", "reason": "chaos",
                "pid": proc.pid, "chunk": hb["chunk"],
            })
            proc.kill()
            return proc.wait(), "chaos"
        # freshness: newest of spawn time (covers start-up and the kernel
        # builds before the first beacon) and the last beacon published
        last_beat = max(spawned, hb["time"] if hb else 0.0)
        if now - last_beat > timeout:
            _append_journal(journal, {
                "kind": "heartbeat_miss", "pid": proc.pid,
                "stale_s": now - last_beat,
                "chunk": hb["chunk"] if hb else None,
            })
            proc.kill()
            return proc.wait(), "hang"
        time.sleep(poll)


def main() -> None:
    """CLI entry point — see the module docstring for the contract."""
    ap = argparse.ArgumentParser(
        allow_abbrev=False,
        description="supervise an unattended sweep worker: heartbeat "
                    "monitoring, SIGKILL on hang, resume from the last "
                    "valid checkpoint, completion-rate gate",
    )
    ap.add_argument("--ckpt-dir", required=True,
                    help="durable run directory (checkpoints, journal, "
                         "heartbeat, result) shared with the worker")
    ap.add_argument("--heartbeat-timeout", type=float, default=120.0,
                    help="seconds without a fresh beacon before the worker "
                         "is declared hung and SIGKILLed")
    ap.add_argument("--poll", type=float, default=0.5,
                    help="heartbeat poll interval in seconds")
    ap.add_argument("--max-worker-restarts", type=int, default=10,
                    help="respawn budget for crashed/hung workers (chaos "
                         "kills are exempt)")
    ap.add_argument("--chaos-kills", type=int, default=0,
                    help="SIGKILL the worker this many times after it has "
                         "made progress — the kill/resume CI smoke")
    ap.add_argument("--chaos-min-chunks", type=int, default=1,
                    help="committed chunks since spawn before a chaos kill "
                         "may fire")
    ap.add_argument("--result-json", default=None,
                    help="worker result JSON path (default: "
                         "<ckpt-dir>/result.json); the completion gate "
                         "reads fault_info from it")
    ap.add_argument("--journal", default=None,
                    help="controller event journal (default: "
                         "<ckpt-dir>/controller.jsonl)")
    argv = sys.argv[1:]
    if "--" in argv:
        split = argv.index("--")
        own, worker_args = argv[:split], argv[split + 1:]
    else:
        own, worker_args = argv, []
    args = ap.parse_args(own)

    os.makedirs(args.ckpt_dir, exist_ok=True)
    heartbeat = os.path.join(args.ckpt_dir, "heartbeat.json")
    result = args.result_json or os.path.join(args.ckpt_dir, "result.json")
    journal = args.journal or os.path.join(args.ckpt_dir, "controller.jsonl")

    chaos_left = args.chaos_kills
    restarts = 0
    attempt = 0
    while True:
        attempt += 1
        proc = _spawn_worker(worker_args, args.ckpt_dir, heartbeat, result)
        _append_journal(journal, {
            "kind": "spawn", "attempt": attempt, "pid": proc.pid,
            "restarts": restarts, "chaos_left": chaos_left,
        })
        rc, reason = _supervise_once(
            proc, heartbeat,
            timeout=args.heartbeat_timeout, poll=args.poll,
            chaos_left=chaos_left, chaos_min_chunks=args.chaos_min_chunks,
            journal=journal,
        )
        _append_journal(journal, {
            "kind": "worker_exit", "attempt": attempt, "returncode": rc,
            "reason": reason,
        })
        if reason == "chaos":
            chaos_left -= 1
            continue
        if rc == 0:
            break
        restarts += 1
        if restarts > args.max_worker_restarts:
            _append_journal(journal, {
                "kind": "giveup", "restarts": restarts,
            })
            print(f"[controller] giving up after {restarts} restarts",
                  file=sys.stderr)
            sys.exit(2)

    try:
        with open(result) as f:
            info = json.load(f)["fault_info"]
    except (OSError, KeyError, json.JSONDecodeError) as e:
        print(f"[controller] worker exited 0 but result JSON is unusable: "
              f"{e}", file=sys.stderr)
        sys.exit(2)
    eligible = info.get("eligible_completion_rate", 0.0)
    _append_journal(journal, {
        "kind": "complete",
        "attempts": attempt,
        "restarts": restarts,
        "chaos_kills": args.chaos_kills - chaos_left,
        "completion_rate": info.get("completion_rate"),
        "eligible_completion_rate": eligible,
        "quarantined": info.get("quarantined", []),
    })
    print(f"[controller] run complete after {attempt} attempt(s): "
          f"completion {info.get('completion_rate', 0.0)*100:.1f}%, "
          f"eligible {eligible*100:.1f}%, "
          f"quarantined {info.get('quarantined', [])}")
    if eligible != 1.0:
        print("[controller] GATE FAILED: eligible completion below 100%",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
