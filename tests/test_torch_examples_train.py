"""The port's training examples (``examples_torch/quickstart.py``,
``phase3_dataset.py``, ``train_lm.py``) against the reference's, on the
CPU: the levels and helpers of ``tests/test_torch_examples.py``, in a file
of their own so that the two files' reference runs share no worker.

quickstart's sweep runs 200 of its 600 steps on both sides (its
``SweepConfig`` replaced in each module): a step costs the same at any
depth, and the aggregate is held at every field.
"""

import numpy as np
import pytest

from repro.core.sweep import SweepConfig as JSweepConfig
from repro.data.shards import ShardedDataset as JShardedDataset
from repro_torch.core.sweep import SweepConfig
from test_torch_examples import (N_TRAIN, _one_torch_thread,  # noqa: F401
                                 assert_ces_close, assert_digest_close, ces,
                                 load, reference_ces, run_port, run_reference,
                                 training_patched)

QUICK_STEPS = 200


# ------------------------------------------------------------- quickstart

@pytest.fixture(scope="module")
def quickstart():
    ref, port = load("examples", "quickstart"), load("examples_torch",
                                                     "quickstart")
    summaries = []
    with training_patched(ref, port), pytest.MonkeyPatch.context() as mp:
        for mod, cls in ((ref, JSweepConfig), (port, SweepConfig)):
            mp.setattr(mod, "SweepConfig", lambda cls=cls, **kw: cls(**{
                **kw, "steps_per_instance": QUICK_STEPS,
                "chunk_steps": QUICK_STEPS // 2}))
        agg = ref.aggregate_metrics
        mp.setattr(ref, "aggregate_metrics",
                   lambda *a, **kw: summaries.append(agg(*a, **kw))
                   or summaries[-1])
        ref_out = run_reference(ref, [])
        got, port_out = run_port(port, [])
    return dict(want=summaries[0], got=got, ref_out=ref_out,
                port_out=port_out)


def test_quickstart_sweep_aggregate_matches_reference(quickstart):
    got = quickstart["got"]
    assert got["completion"] == 1.0
    assert_digest_close(got["summary"], quickstart["want"])
    assert "completion rate: 100%" in quickstart["port_out"]


def test_quickstart_training_matches_reference(quickstart):
    assert_ces_close(ces(quickstart["got"]["trainer"].history),
                     reference_ces(quickstart["ref_out"]))


# --------------------------------------------------------- phase3_dataset

@pytest.fixture(scope="module")
def phase3(tmp_path_factory):
    ref, port = load("examples", "phase3_dataset"), load("examples_torch",
                                                         "phase3_dataset")
    root = tmp_path_factory.mktemp("phase3")
    argv = ["--quick", "--instances", "4", "--dataset-dir"]
    with training_patched(ref, port):
        ref_out = run_reference(ref, argv + [str(root / "ref")])
        got, port_out = run_port(port, argv + [str(root / "port")])
    return dict(got=got, ref_out=ref_out, port_out=port_out,
                want=JShardedDataset.load(str(root / "ref")))


def test_phase3_dataset_matches_reference(phase3):
    got, want = phase3["got"], phase3["want"]
    ds = got["dataset"]
    assert got["info"]["completion_rate"] == 1.0
    assert ds.n_instances == want.n_instances == 4
    man_p, man_r = ds.manifest, want.manifest
    for key in ("format", "scenarios", "record", "n_buckets", "v_max",
                "vocab_size", "metric_aliases", "shards", "fault_info"):
        assert man_p[key] == man_r[key], key
    assert_digest_close(man_p["summary"], man_r["summary"])
    fields, series, valid = want.series()
    assert got["fields"] == fields
    np.testing.assert_array_equal(got["valid"], valid)
    np.testing.assert_allclose(got["series"], series, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got["corpus"], want.token_corpus())
    lines = [x for x in phase3["port_out"].splitlines()
             if x.startswith("[phase3]")]
    assert lines[0] == "[phase3] sweep complete: 100% (1 failure events " \
        "survived)"
    assert lines[2] == [x for x in phase3["ref_out"].splitlines()
                        if x.startswith("[phase3]")][2]


def test_phase3_training_matches_reference(phase3):
    assert_ces_close(ces(phase3["got"]["trainer"].history),
                     reference_ces(phase3["ref_out"]))


# --------------------------------------------------------------- train_lm

@pytest.mark.parametrize("flags", [
    ["--data", "synthetic", "--ckpt-dir"],
    ["--arch", "gemma2-2b", "--shard-dir"],
])
def test_train_lm_matches_reference(flags, phase3, tmp_path):
    """``--data synthetic`` with a checkpoint directory, and ``--shard-dir``
    (phase3's port dataset, which both packages read) with gemma2-2b."""
    ref, port = load("examples", "train_lm"), load("examples_torch",
                                                   "train_lm")
    small = ["--d-model", "64", "--n-layers", "2", "--steps", "8",
             "--batch", "2", "--seq", "32"]
    if flags[-1] == "--ckpt-dir":
        ref_flags = flags + [str(tmp_path / "ref")]
        port_flags = flags + [str(tmp_path / "port")]
    else:
        ref_flags = port_flags = flags + [str(phase3["got"]["root"])]
    with training_patched(ref, port):
        ref_out = run_reference(ref, small + ref_flags)
        got, port_out = run_port(port, small + port_flags)
    assert port_out.splitlines()[0] == ref_out.splitlines()[0]
    assert port_out.splitlines()[0].startswith("[train_lm] ")
    assert_ces_close(ces(got["trainer"].history), reference_ces(ref_out))
    if flags[-1] == "--ckpt-dir":
        assert (tmp_path / "port" / f"step_{N_TRAIN:09d}" /
                "manifest.json").exists()
