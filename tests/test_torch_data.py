"""Phase-III data → LM inputs: the port's token streams and batches equal the
reference's token for token.

- ``record_rollout`` + ``trajectory_to_tokens`` per scenario, and
  ``sweep_token_dataset`` over a batch of drawn instances;
- ``sim_token_batches`` over an in-process recording sweep;
- ``shard_token_corpus`` over shards the port wrote, read by both packages;
- ``synthetic_batches`` (``walk`` and ``uniform``, from a start step);
- the encoder-decoder and M-RoPE extras come with the batches (their
  parity with the reference is in ``test_torch_encdec.py`` and
  ``test_torch_mrope.py``).

Token buckets cut the recorded float speeds, which may differ from the
reference's in the last bit (see ``test_torch_simulator.py``); no speed of
these runs lies that close to a bucket edge, so every token is compared
exactly, as are the integer counters of the recorded rollouts.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import get_arch as j_get_arch
from repro.core.scenario import SimConfig as JSimConfig
from repro.core.scenarios import get_scenario as j_get_scenario
from repro.core.tokens import record_rollout as j_record_rollout
from repro.core.tokens import sweep_token_dataset as j_sweep_token_dataset
from repro.core.tokens import trajectory_to_tokens as j_trajectory_to_tokens
from repro.data.sim_dataset import shard_token_corpus as j_shard_token_corpus
from repro.data.sim_dataset import sim_token_batches as j_sim_token_batches
from repro.data.synthetic import synthetic_batches as j_synthetic_batches
from repro_torch.config.base import get_arch
from repro_torch.convert import scenario_params_from_numpy
from repro_torch.core import prng
from repro_torch.core.fleet import run_supervised
from repro_torch.core.record import RecordConfig
from repro_torch.core.scenario import SimConfig
from repro_torch.core.scenarios import get_scenario
from repro_torch.core.sweep import SweepConfig, SweepRunner
from repro_torch.core.tokens import (
    BOS,
    EOS,
    SEP,
    Trajectory,
    record_rollout,
    sweep_token_dataset,
    trajectory_to_tokens,
    vocab_size,
)
from repro_torch.data.shards import DatasetWriter
from repro_torch.data.sim_dataset import (
    shard_token_corpus,
    sim_token_batches,
    sim_token_corpus,
)
from repro_torch.data.synthetic import synthetic_batches

sys.path.insert(0, str(Path(__file__).parent))
from conftest import state_tree_np  # noqa: E402

SCENARIOS = ["highway_merge", "lane_drop", "stop_and_go", "speed_limit_zone"]
COUNTERS = ("throughput", "spawned", "speed_count", "collisions", "merges_ok",
            "ramp_blocked_steps", "lane_changes", "steps")
ARCH = "gemma2-2b"  # reduced: vocab 256 covers the sim vocabulary


def take(batches, n):
    return [next(batches) for _ in range(n)]


@pytest.mark.parametrize("name", SCENARIOS)
def test_trajectory_tokens_match_reference(name):
    jcfg = JSimConfig(n_slots=16, scenario=name)
    jsp = j_get_scenario(name).sample_params(jax.random.key(1), jcfg)
    jm, jtraj = j_record_rollout(jax.random.key(0), jsp, jcfg, 200, 10, 8)
    want = np.asarray(j_trajectory_to_tokens(jtraj, jcfg))

    cfg = SimConfig(n_slots=16, scenario=name)
    sp = scenario_params_from_numpy(state_tree_np(jsp), "cpu")
    m, traj = record_rollout(prng.key(0, "cpu")[None], sp, cfg, 200, 10, 8)
    assert traj.lane.shape == (1, 20, 8)
    got = trajectory_to_tokens(Trajectory(*(x[0] for x in traj)), cfg)
    assert got.dtype == torch.int32 and got.shape == (20 * 9 + 2,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == BOS and got[-1] == EOS and (got[9::9][:-1] == SEP).all()
    jm = state_tree_np(jm)
    for field in COUNTERS:
        np.testing.assert_array_equal(getattr(m, field).numpy()[0],
                                      getattr(jm, field), err_msg=field)


def test_sweep_token_dataset_matches_reference():
    name, n = "highway_merge", 4
    jcfg = JSimConfig(n_slots=16, scenario=name)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(
        jnp.arange(n))
    jsp = jax.vmap(lambda k: j_get_scenario(name).sample_params(k, jcfg))(
        jkeys)
    want = np.asarray(j_sweep_token_dataset(jkeys, jsp, jcfg, n_steps=120,
                                            k_slots=6))

    cfg = SimConfig(n_slots=16, scenario=name)
    keys = prng.fold_in(prng.key(3, "cpu"), torch.arange(n))
    sp = get_scenario(name).sample_params(keys, cfg)
    got = sweep_token_dataset(keys, sp, cfg, n_steps=120, k_slots=6)
    assert got.shape == (n, 12 * 7 + 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < vocab_size(cfg)


def test_sim_token_batches_match_reference():
    sim_j, sim = JSimConfig(n_slots=16), SimConfig(n_slots=16)
    want = take(j_sim_token_batches(j_get_arch(ARCH).reduced(), sim_j, 2, 64,
                                    n_instances=3, seed=1), 3)
    got = take(sim_token_batches(get_arch(ARCH).reduced(), sim, 2, 64,
                                 n_instances=3, seed=1, device="cpu"), 3)
    for w, g in zip(want, got):
        assert sorted(g) == ["labels", "tokens"]
        for k in g:
            assert g[k].dtype == torch.int32 and g[k].shape == (2, 64)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    corpus = sim_token_corpus(sim, 3, 1, device="cpu")
    np.testing.assert_array_equal(got[0]["tokens"][0].numpy(), corpus[:64])


def test_shard_token_corpus_matches_reference(tmp_path):
    cfg = SweepConfig(n_instances=6, steps_per_instance=80, chunk_steps=40,
                      sim=SimConfig(n_slots=16), seed=2, vary_horizon=True,
                      scenario_mix=("highway_merge", "stop_and_go"),
                      record=RecordConfig(record_every=10, k_slots=4))
    root = str(tmp_path / "ds")
    w = DatasetWriter(root, cfg, shard_size=4)
    _, info = run_supervised(SweepRunner(cfg, devices=["cpu"] * 2),
                             writer=w, pipeline=True)
    w.finalize(fault_info=info)
    want, want_vocab = j_shard_token_corpus(root)
    got, vocab = shard_token_corpus(root)
    assert vocab == want_vocab == vocab_size(cfg.sim)
    np.testing.assert_array_equal(got, want)
    assert got.size > 6 * 2
    batches = take(sim_token_batches(get_arch(ARCH).reduced(), cfg.sim, 2,
                                     16, shard_dir=root, device="cpu"), 2)
    jb = take(j_sim_token_batches(j_get_arch(ARCH).reduced(),
                                  JSimConfig(n_slots=16), 2, 16,
                                  shard_dir=root), 2)
    for g, w_ in zip(batches, jb):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w_[k]))


@pytest.mark.parametrize("pattern", ["walk", "uniform"])
@pytest.mark.parametrize("start_step", [0, 5])
def test_synthetic_batches_match_reference(pattern, start_step):
    want = take(j_synthetic_batches(j_get_arch(ARCH).reduced(), 3, 17, seed=7,
                                    start_step=start_step, pattern=pattern), 3)
    got = take(synthetic_batches(get_arch(ARCH).reduced(), 3, 17, seed=7,
                                 start_step=start_step, pattern=pattern,
                                 device="cpu"), 3)
    for w, g in zip(want, got):
        assert sorted(g) == ["labels", "tokens"]
        for k in g:
            assert g[k].dtype == torch.int32 and g[k].shape == (3, 17)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_lm_extras_raise_until_their_families_are_ported():
    """The families are ported: an encoder-decoder config's batches carry
    ``frames [B, enc_ctx, d_model]`` in the model's type and an M-RoPE
    config's ``mrope_pos [3, B, S]``, from both batchers, where they
    raised before; a bad pattern or a too small vocabulary still raises."""
    base = get_arch(ARCH).reduced()
    sim = SimConfig(n_slots=16)
    for cfg in (dataclasses.replace(base, is_encdec=True),
                dataclasses.replace(base, mrope_sections=(2, 3, 3))):
        for b in (next(synthetic_batches(cfg, 2, 8, device="cpu")),
                  next(sim_token_batches(cfg, sim, 2, 8, n_instances=1,
                                         device="cpu"))):
            if cfg.is_encdec:
                assert b["frames"].shape == (2, cfg.enc_ctx, cfg.d_model)
                assert b["frames"].dtype == torch.bfloat16
            else:
                assert b["mrope_pos"].shape == (3, 2, 8)
                assert b["mrope_pos"][2, 1].tolist() == list(range(8))
    with pytest.raises(ValueError, match="pattern"):
        synthetic_batches(base, 2, 8, pattern="zipf", device="cpu")
    small = dataclasses.replace(base, vocab_size=16)
    with pytest.raises(ValueError, match="vocab"):
        sim_token_batches(small, sim, 2, 8, n_instances=1, device="cpu")
