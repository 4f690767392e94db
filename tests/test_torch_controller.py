"""The port's process controller (``repro_torch.launch.controller``):
heartbeat parsing, SIGKILL of a hung worker, chaos kills only after
progress, and an end-to-end run on the CPU that survives two SIGKILLs and
passes the completion gate with a complete dataset. Exact checks: event
kinds and counts, completion rates and the dataset's instance ids."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.launch.controller import (
    _append_journal,
    _read_heartbeat,
    _supervise_once,
)

SRC = Path(__file__).resolve().parents[1] / "src"


def test_read_heartbeat_absent_torn_and_whole(tmp_path):
    path = str(tmp_path / "hb.json")
    assert _read_heartbeat(path) is None
    Path(path).write_text('{"chunk": 3, "done"')
    assert _read_heartbeat(path) is None
    Path(path).write_text(json.dumps({"chunk": 3, "done": 0.5, "time": 1.0}))
    assert _read_heartbeat(path)["chunk"] == 3
    journal = str(tmp_path / "sub" / "ctl.jsonl")
    _append_journal(journal, {"kind": "spawn", "attempt": 1})
    events = [json.loads(line) for line in open(journal)]
    assert events[0]["kind"] == "spawn" and events[0]["source"] == "controller"


def test_supervise_kills_hung_worker_and_waits_for_progress(tmp_path):
    """A silent worker is SIGKILLed after the timeout; a chaos kill fires
    only after the configured number of new chunks; a clean exit is one."""
    journal = str(tmp_path / "ctl.jsonl")
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    t0 = time.monotonic()
    rc, reason = _supervise_once(proc, str(tmp_path / "none.json"),
                                 timeout=1.0, poll=0.05, chaos_left=0,
                                 chaos_min_chunks=1, journal=journal)
    assert (reason, rc != 0) == ("hang", True)
    assert time.monotonic() - t0 < 30

    hb = str(tmp_path / "hb.json")
    beat = ("import json, sys, time\n"
            "for c in range(200):\n"
            "    json.dump({'chunk': c, 'done': 0.0, 'time': time.time()},"
            " open(sys.argv[1], 'w'))\n"
            "    time.sleep(0.05)\n")
    proc = subprocess.Popen([sys.executable, "-c", beat, hb])
    rc, reason = _supervise_once(proc, hb, timeout=30.0, poll=0.05,
                                 chaos_left=1, chaos_min_chunks=3,
                                 journal=journal)
    assert reason == "chaos" and rc != 0
    events = [json.loads(line) for line in open(journal)]
    assert [e["kind"] for e in events] == ["heartbeat_miss", "worker_kill"]
    assert events[1]["chunk"] >= 2

    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    assert _supervise_once(proc, hb + ".x", timeout=30.0, poll=0.05,
                           chaos_left=0, chaos_min_chunks=1,
                           journal=journal) == (0, "exit")


def test_controller_survives_two_sigkills_on_cpu(tmp_path):
    """Two real SIGKILLs mid-run, resume from the last valid checkpoint,
    injected crashes and a poison instance: the gate passes with eligible
    completion 1.0 and the dataset holds every other instance once."""
    run, ds = tmp_path / "run", tmp_path / "ds"
    cmd = [sys.executable, "-m", "repro_torch.launch.controller",
           "--ckpt-dir", str(run), "--heartbeat-timeout", "300",
           "--poll", "0.1", "--chaos-kills", "2", "--",
           "--device", "cpu", "--instances", "8", "--steps", "80",
           "--chunk-steps", "20", "--slots", "16",
           "--scenario-mix", "highway_merge,lane_drop", "--workers", "4",
           "--fail-prob", "0.1", "--poison", "5", "--max-retries", "2",
           "--seed", "3", "--dataset-dir", str(ds), "--record-slots", "4",
           "--shard-size", "3"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    ctl = [json.loads(line) for line in open(run / "controller.jsonl")]
    kinds = [e["kind"] for e in ctl]
    assert kinds.count("worker_kill") == 2 and kinds.count("spawn") == 3
    assert ctl[-1]["kind"] == "complete"
    assert ctl[-1]["eligible_completion_rate"] == 1.0
    assert ctl[-1]["quarantined"] == [5]
    worker = [json.loads(line) for line in open(run / "journal.jsonl")]
    assert sum(e["kind"] == "resume" for e in worker) == 2
    manifest = json.loads((ds / "manifest.json").read_text())
    ids = [i for s in manifest["shards"] for i in s["instances"]]
    assert sorted(ids) == [0, 1, 2, 3, 4, 6, 7]
    with np.load(ds / manifest["shards"][0]["file"]) as z:
        assert z["series"].shape[0] == len(manifest["shards"][0]["instances"])
    assert "quarantined" in res.stdout
