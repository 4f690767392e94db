"""Checkpoints of the port (``repro_torch.ckpt``), held to the reference's
format and crash-safety contract. All checks are exact: a roundtrip gives
back the same bits, dtype and shape; a corrupt or torn checkpoint is
detected; the reference's ``verify_checkpoint`` accepts a port checkpoint
and the port's accepts a reference one.
"""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.ckpt import save_pytree as j_save_pytree
from repro.ckpt import verify_checkpoint as j_verify_checkpoint
from repro_torch.ckpt import (
    CheckpointManager,
    latest_step,
    load_pytree,
    save_pytree,
    valid_steps,
    verify_checkpoint,
)
from repro_torch.ckpt.io import MANIFEST, PAYLOAD, flatten_with_paths
from repro_torch.core.record import RecordConfig
from repro_torch.core.scenario import SimConfig
from repro_torch.core.sweep import SweepConfig, SweepRunner


def _tree(step=0):
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3) + step,
            "b": {"c": torch.tensor(step, dtype=torch.int32),
                  "d": torch.ones(4, dtype=torch.bfloat16) * (step + 0.5)}}


def _step_dir(root, step):
    return os.path.join(str(root), f"step_{step:09d}")


def _equal(a, b):
    for (pa, x), (pb, y) in zip(flatten_with_paths(a), flatten_with_paths(b)):
        assert pa == pb
        assert x.dtype == y.dtype and tuple(x.shape) == tuple(y.shape), pa
        assert torch.equal(x, y), pa


def _sweep_state():
    cfg = SweepConfig(n_instances=3, steps_per_instance=20, chunk_steps=10,
                      sim=SimConfig(n_slots=8), record=RecordConfig(k_slots=2))
    runner = SweepRunner(cfg, device="cpu")
    return runner, runner.run_chunk(runner.init())


def test_sweep_state_roundtrip_keeps_keys_and_paths(tmp_path):
    """The whole SweepState, PRNG key words and trace included, comes back
    bit for bit; the leaf paths are the reference's."""
    runner, state = _sweep_state()
    save_pytree(str(tmp_path / "c"), state, meta={"step": 1})
    out = load_pytree(str(tmp_path / "c"), runner.init())
    _equal(out, state)
    assert out.sim.key.dtype == torch.int64 and out.chunk.dim() == 0
    with open(tmp_path / "c" / MANIFEST) as f:
        paths = [e["path"] for e in json.load(f)["leaves"]]
    assert paths[0] == ".sim/.pos" and ".sim/.key" in paths
    assert paths[-1] == ".trace/.active" and ".chunk" in paths


def test_reference_verify_accepts_port_checkpoint_and_back(tmp_path):
    _, state = _sweep_state()
    save_pytree(str(tmp_path / "port"), state)
    assert j_verify_checkpoint(str(tmp_path / "port"))
    j_save_pytree(str(tmp_path / "ref"), {"x": np.ones((2, 3), np.float32)})
    assert verify_checkpoint(str(tmp_path / "ref"))
    out = load_pytree(str(tmp_path / "ref"), {"x": torch.zeros(2, 3)})
    assert torch.equal(out["x"], torch.ones(2, 3))


@settings(max_examples=12, deadline=None)
@given(shape=st.lists(st.integers(0, 4), min_size=0, max_size=3),
       dtype=st.sampled_from(["float32", "int32", "int64", "bool", "bfloat16",
                              "float16", "uint8"]))
def test_property_any_shape_dtype_roundtrips(tmp_path_factory, shape, dtype):
    tmp = tmp_path_factory.mktemp("ck")
    dt = getattr(torch, dtype)
    x = (torch.arange(int(np.prod(shape)), dtype=torch.float32) * 0.37 - 1
         ).reshape(shape).to(dt)
    save_pytree(str(tmp / "c"), {"x": x})
    out = load_pytree(str(tmp / "c"), like={"x": torch.empty_like(x)})
    assert out["x"].dtype == dt and tuple(out["x"].shape) == tuple(shape)
    assert torch.equal(out["x"], x)


def test_leaf_count_mismatch_raises(tmp_path):
    save_pytree(str(tmp_path / "c"), _tree())
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "c"), {"a": torch.zeros(2, 3)})


def test_manager_retention_async_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, _tree(s))
    out, meta = mgr.restore(like=_tree())  # waits for the writer
    assert meta["step"] == 3 and latest_step(str(tmp_path)) == 3
    _equal(out, _tree(3))
    assert valid_steps(str(tmp_path)) == [2, 3]


def test_verify_detects_truncation_and_missing_payload(tmp_path):
    path = str(tmp_path / "c")
    save_pytree(path, _tree(), meta={"step": 1})
    assert verify_checkpoint(path)
    payload = os.path.join(path, PAYLOAD)
    with open(payload, "r+b") as f:
        f.truncate(os.path.getsize(payload) // 2)
    assert not verify_checkpoint(path)
    os.remove(payload)
    assert not verify_checkpoint(path)
    assert not verify_checkpoint(str(tmp_path / "nope"))
    os.makedirs(tmp_path / "torn")
    (tmp_path / "torn" / MANIFEST).write_text('{"leaves": [')
    assert not verify_checkpoint(str(tmp_path / "torn"))


def test_restore_falls_back_past_corrupt_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for s in (1, 2, 3):
        mgr.save(s, _tree(s))
    mgr.wait()   # step 3 on disk before it is damaged
    payload = os.path.join(_step_dir(tmp_path, 3), PAYLOAD)
    with open(payload, "r+b") as f:
        f.truncate(10)
    out, meta = mgr.restore(like=_tree())
    assert meta["step"] == 2 and mgr.last_skipped == [3]
    _equal(out, _tree(2))
    with pytest.raises(FileNotFoundError, match="step 3"):
        mgr.restore(like=_tree(), step=3)
    for s in (1, 2):
        os.remove(os.path.join(_step_dir(tmp_path, s), PAYLOAD))
    assert not mgr.has_checkpoint()
    with pytest.raises(FileNotFoundError, match="skipped"):
        mgr.restore(like=_tree())


def test_mid_save_kill_artifacts_are_invisible_and_gced(tmp_path):
    """A staging dir left by a killed writer (and a step dir without its
    manifest) is never listed, and the next commit removes the staging
    dir."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1))
    mgr.wait()   # committed, so its GC has run before the stale dir exists
    stale = tmp_path / ".tmp-step_000000002-99999"
    stale.mkdir()
    (stale / PAYLOAD).write_bytes(b"partial")
    os.makedirs(_step_dir(tmp_path, 5))   # no manifest: uncommitted
    assert valid_steps(str(tmp_path)) == [1]
    assert mgr.restore(like=_tree())[1]["step"] == 1
    mgr.save(2, _tree(2))
    mgr.wait()
    assert not stale.exists()
    assert valid_steps(str(tmp_path)) == [1, 2]


def test_async_writer_error_reaches_the_caller(tmp_path):
    root = tmp_path / "ck"
    mgr = CheckpointManager(str(root))
    root.rmdir()
    root.write_text("a file where the checkpoint directory was")
    mgr.save(1, _tree(1))
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()   # the error is reported once
