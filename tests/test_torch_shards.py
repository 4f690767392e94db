"""The port's Phase-III dataset (``repro_torch.data.shards``) against the
reference's format, and its kill/resume and repair guarantees.

Levels:
- cross-package, for the same sweep: the reference's ``ShardedDataset``
  reads the port's dataset and the port's reads the reference's; the
  manifests, shard layout, npz keys and dtypes, and the record keys are
  identical; integer arrays and counters exactly, float arrays within the
  sweep tests' tolerance (rtol 1e-5; atol 1e-4 on speeds);
- within the port, bit for bit: a killed and resumed writer's shards equal
  an uninterrupted run's; every instance is written exactly once.
- the token streams: ``trace_token_streams`` equals the reference's on the
  same slabs, bit for bit.
"""

import os

import numpy as np
import pytest

from repro.core.record import RecordConfig as JRecordConfig
from repro.core.scenario import SimConfig as JSimConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import SweepRunner as JSweepRunner
from repro.core.tokens import trace_token_streams as j_trace_token_streams
from repro.data.shards import ShardedDataset as JShardedDataset
from repro.data.shards import write_dataset as j_write_dataset
from repro_torch.core.fault import FailureInjector, run_with_failures
from repro_torch.core.record import RecordConfig
from repro_torch.core.scenario import SimConfig
from repro_torch.core.sweep import SweepConfig, SweepRunner
from repro_torch.core.tokens import BOS, PAD, trace_token_streams
from repro_torch.data.shards import DatasetWriter, ShardedDataset, write_dataset

MIX = ("lane_drop",)  # one compile of the reference; its metric aliases
N = 6
_RUNS: dict = {}


def cfgs(**kw):
    base = dict(n_instances=N, steps_per_instance=60, chunk_steps=30,
                seed=5, scenario_mix=MIX, vary_horizon=True,
                min_horizon_frac=0.3)
    base.update(kw)
    return (JSweepConfig(sim=JSimConfig(n_slots=16),
                         record=JRecordConfig(record_every=10, k_slots=4),
                         **base),
            SweepConfig(sim=SimConfig(n_slots=16),
                        record=RecordConfig(record_every=10, k_slots=4),
                        **base))


def port_state():
    if "torch" not in _RUNS:
        _RUNS["torch"] = SweepRunner(cfgs()[1], device="cpu").run()
    return _RUNS["torch"]


def by_instance(ds):
    out = {}
    for z in ds.iter_shards():
        for j, i in enumerate(z["instance"]):
            out[int(i)] = {k: v[j] for k, v in z.items()}
    return out


def test_token_streams_match_reference_bitwise():
    rng = np.random.default_rng(0)
    lane = rng.integers(0, 4, (7, 9, 5)).astype(np.int32)
    speed = rng.uniform(-1.0, 45.0, (7, 9, 5)).astype(np.float32)
    speed.flat[:8] = [0.0, 2.5, 5.0, 37.5, 40.0, 39.999996, 2.4999998, 45.0]
    active = rng.uniform(size=(7, 9, 5)) < 0.7
    valid = rng.integers(0, 10, 7)
    want = j_trace_token_streams(lane, speed, active, valid, JSimConfig())
    got = trace_token_streams(lane, speed, active, valid, SimConfig())
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
        assert a.dtype == b.dtype


def test_datasets_cross_read_between_packages(tmp_path):
    """Each package's reader reads the other's dataset of the same sweep,
    with the same layout, keys, dtypes and (within tolerance) values."""
    jcfg, cfg = cfgs()
    j_write_dataset(str(tmp_path / "ref"), JSweepRunner(jcfg).run(), jcfg,
                    shard_size=4)
    write_dataset(str(tmp_path / "port"), port_state(), cfg, shard_size=4)
    ref_by_port = ShardedDataset.load(str(tmp_path / "ref"))
    port_by_ref = JShardedDataset.load(str(tmp_path / "port"))
    for name, ds in (("port reads ref", ref_by_port),
                     ("ref reads port", port_by_ref)):
        assert ds.n_instances == N, name
        assert [s["instances"] for s in ds.manifest["shards"]] == [
            [0, 1, 2, 3], [4, 5]], name
    man_r, man_p = ref_by_port.manifest, port_by_ref.manifest
    for key in ("format", "scenarios", "record", "n_buckets", "v_max",
                "vocab_size", "metric_aliases", "shards"):
        assert man_p[key] == man_r[key], key
    assert set(man_p["sweep"]) == set(man_r["sweep"])
    a, b = by_instance(port_by_ref), by_instance(ref_by_port)
    assert a.keys() == b.keys() == set(range(N))
    for i in a:
        assert a[i].keys() == b[i].keys()
        for k in a[i]:
            x, y = a[i][k], b[i][k]
            assert x.dtype == y.dtype, k
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-4,
                                           err_msg=f"{i}/{k}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{i}/{k}")
    ra, rb = port_by_ref.records(), ref_by_port.records()
    assert [list(r) for r in ra] == [list(r) for r in rb]
    for x, y in zip(ra, rb):
        for k in x:
            if isinstance(x[k], float):
                assert x[k] == pytest.approx(y[k], rel=1e-5), k
            else:
                assert x[k] == y[k], k
    fields, series, valid = port_by_ref.series()
    assert fields == list(cfg.record.fields) and series.shape[0] == N
    streams, lengths = port_by_ref.token_streams()
    assert (streams[:, 0] == BOS).all()
    corpus = ref_by_port.token_corpus()
    assert corpus.shape[0] == lengths.sum() and (corpus != PAD).all()


def test_shards_hold_the_in_memory_trace(tmp_path):
    cfg = cfgs()[1]
    state = port_state()
    write_dataset(str(tmp_path / "ds"), state, cfg, shard_size=4)
    _, series, valid = ShardedDataset.load(str(tmp_path / "ds")).series()
    np.testing.assert_array_equal(series, state.trace.series.numpy())
    np.testing.assert_array_equal(valid, state.horizon.numpy() // 10)


def test_kill_resume_never_drops_or_duplicates(tmp_path):
    """A writer torn down mid-sweep, then a fresh one on the same directory
    and a rerun: every instance lands once, and the payloads equal an
    uninterrupted run's bit for bit."""
    cfg = cfgs(chunk_steps=20)[1]
    root = str(tmp_path / "ds")
    runner = SweepRunner(cfg, device="cpu")
    w1 = DatasetWriter(root, cfg, shard_size=2)
    state = runner.init()
    for _ in range(2):
        state = runner.run_chunk(state)
        w1.drain(state)
    persisted = set(w1.written)
    assert persisted   # some shards were committed before the kill
    del w1             # buffered instances die with the process
    w2 = DatasetWriter(root, cfg, shard_size=2)
    assert w2.written == persisted
    _, info = run_with_failures(SweepRunner(cfg, device="cpu"),
                                FailureInjector(4, {1: [2]}), writer=w2)
    assert info["completion_rate"] == 1.0
    w2.finalize()
    ds = ShardedDataset.load(root)
    ids = [i for s in ds.manifest["shards"] for i in s["instances"]]
    assert sorted(ids) == list(range(N))
    write_dataset(str(tmp_path / "clean"), port_state(), cfgs()[1],
                  shard_size=2)
    a = by_instance(ds)
    b = by_instance(ShardedDataset.load(str(tmp_path / "clean")))
    for i in range(N):
        for k in b[i]:
            np.testing.assert_array_equal(a[i][k], b[i][k], err_msg=f"{i}/{k}")


def test_torn_temp_files_are_ignored(tmp_path):
    root = tmp_path / "ds"
    root.mkdir()
    (root / ".tmp_shard_00000.npz").write_bytes(b"torn write")
    (root / "shard_00001.npz.tmp.npz").write_bytes(b"torn write")
    (root / ".tmp_records_00000.jsonl").write_text('{"torn":')
    cfg = cfgs()[1]
    w = DatasetWriter(str(root), cfg, shard_size=4)
    assert w.written == set()
    w.drain(port_state())
    w.finalize()
    ds = ShardedDataset.load(str(root))
    assert sorted(r["instance"] for r in ds.records()) == list(range(N))


def test_truncated_shard_is_repaired(tmp_path):
    """At construction (rescan) and mid-run (``verify_shards``) a
    truncated shard is dropped with its records and drained again."""
    cfg = cfgs()[1]
    root = str(tmp_path / "ds")
    w = DatasetWriter(root, cfg, shard_size=2)
    w.drain(port_state())
    assert w.verify_shards() == []
    victim = os.path.join(root, "shard_00001.npz")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    w2 = DatasetWriter(root, cfg, shard_size=2)
    assert w2.repaired == [1] and not os.path.exists(victim)
    assert len(w2.written) == N - 2
    w2.drain(port_state())
    victim = os.path.join(root, "shard_00000.npz")
    with open(victim, "r+b") as f:
        f.truncate(3)
    assert w2.verify_shards() == [0]
    w2.drain(port_state())
    w2.finalize()
    ds = ShardedDataset.load(root)
    assert ds.manifest["repaired_shards"] == [0, 1]
    assert sorted(r["instance"] for r in ds.records()) == list(range(N))


def test_writer_requires_recording_config(tmp_path):
    with pytest.raises(ValueError):
        DatasetWriter(str(tmp_path), SweepConfig(record=None))
    with pytest.raises(ValueError):
        DatasetWriter(str(tmp_path), cfgs()[1], shard_size=0)
