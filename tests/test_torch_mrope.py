"""The port's M-RoPE family (qwen2-vl-2b reduced: 2 layers, d_model 64, 4
heads over 2 KV heads of 16, QKV bias, sections 2/3/3) against the
reference's, on the CPU: weights carried across by
``repro_torch.convert.lm_params_from_numpy`` (norms and biases redrawn with
numpy), the same numpy tokens and positions through both, the port on its
plain path.

Levels and tolerances:

* ``apply_mrope`` within f32 1e-6 of the reference's; with three equal
  streams it is ``apply_rope``, within f32 1e-6;
* the vision stub's tokens and ``[3, B, S]`` positions bit-equal, the text
  positions starting at the grid's side;
* ``lm_apply`` and ``lm_prefill`` with ``mrope_pos``, ``lm_decode`` with
  and without it, in f32 within 1e-5 of each tensor's largest entry;
* ``greedy_generate(..., extras={"mrope_pos": ...})``: tokens equal in f32
  (the decode steps take plain RoPE positions, as the reference's);
* ``sim_token_batches`` and ``synthetic_batches``: ``mrope_pos`` exact;
* the train step with ``mrope_pos`` split into 2 microbatches on its
  batch axis (1): the loss within rtol 1e-5, every gradient leaf at
  ``test_torch_train_parity.py``'s level, the parameters after the first
  step within its first-step noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_arch
from repro.core.scenario import SimConfig as JSimConfig
from repro.data.sim_dataset import sim_token_batches as j_sim_token_batches
from repro.data.synthetic import synthetic_batches as j_synthetic_batches
from repro.models import build_model as jax_build
from repro.models.common import apply_mrope as j_apply_mrope
from repro.models.frontends import vision_stream_stub as j_vision_stream_stub
from repro.serve.engine import greedy_generate as j_greedy_generate
from repro_torch.config.base import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import prng
from repro_torch.core.scenario import SimConfig
from repro_torch.data.sim_dataset import sim_token_batches
from repro_torch.data.synthetic import synthetic_batches
from repro_torch.models.attention import attention_impl
from repro_torch.models.common import apply_mrope, apply_rope
from repro_torch.models.frontends import vision_stream_stub
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import greedy_generate
from repro_torch.train.step import _split_microbatches
from test_torch_train_parity import _perturb, assert_train_step_matches

ARCH = "qwen2-vl-2b"
VOCAB = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = jax_build(jcfg)
    jp = _perturb(jm.init(jax.random.key(0)), np.random.default_rng(1))
    tm = build_model(cfg, "cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp


def _rel(got, want, tol, what=""):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _stream(batch, s, seed=3):
    """The vision stub's tokens and M-RoPE positions from both packages,
    which must be bit-equal."""
    jt, jpos = j_vision_stream_stub(jax.random.key(seed),
                                    jax_arch(ARCH).reduced(), batch, s)
    tt, tpos = vision_stream_stub(prng.key(seed, "cpu"),
                                  get_arch(ARCH).reduced(), batch, s)
    assert tt.dtype == tpos.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    return jt, jpos, tt, tpos


@pytest.mark.parametrize("sections,d", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_mrope_matches_reference(sections, d):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, d)).astype(np.float32)
    pos = rng.integers(0, 3000, (3, 2, 9))
    want = j_apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * np.abs(x).max() * 4)
    same = np.broadcast_to(pos[:1], pos.shape)
    np.testing.assert_allclose(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same.copy()), 1e6,
                    sections).numpy(),
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6).numpy(),
        rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (2, 3))


def test_vision_stream_stub_matches_reference():
    """22 x 22 = 484 image tokens of a 2048-token stream (a quarter, to a
    square), then text whose three streams start at 22, the grid's side."""
    _, _, tt, tpos = _stream(2, 2048)
    assert tt.shape == (2, 2048) and tpos.shape == (3, 2, 2048)
    assert int(tpos[1, 0, 483]) == int(tpos[2, 0, 483]) == 21
    assert tpos[:, 0, 484].tolist() == [22, 22, 22]
    assert bool((tpos[:, 1] == tpos[:, 0]).all())


def test_lm_with_mrope_matches_reference_f32():
    """``apply`` and ``prefill`` with the stub's positions, then 2 decode
    steps with M-RoPE positions and 2 without (plain RoPE)."""
    jm, jp, tm, tp = _pair()
    jt, jpos, tt, tpos = _stream(2, 40)
    jl, _ = jax.jit(jm.apply)(jp, {"tokens": jt, "mrope_pos": jpos})
    tl, _ = tm.apply(tp, {"tokens": tt, "mrope_pos": tpos})
    _rel(tl, jl, 1e-5, "apply")
    plain, _ = tm.apply(tp, {"tokens": tt})
    assert float((plain - tl).abs().max()) > 1e-3   # M-RoPE moves them
    jc, tc = jm.init_cache(2, 48), tm.init_cache(2, 48)
    jl, jc = jax.jit(jm.prefill)(jp, jc, {"tokens": jt, "mrope_pos": jpos})
    tl, tc = tm.prefill(tp, tc, {"tokens": tt, "mrope_pos": tpos})
    _rel(tl, jl, 1e-5, "prefill")
    for i in range(4):
        tok = np.asarray([3 + i, 70 - i])
        pos = np.full((2,), 40 + i, np.int32)
        mp = np.full((3, 2, 1), 40 - 8 + i, np.int32) if i < 2 else None
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                           mrope_pos=None if mp is None else jnp.asarray(mp))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok),
                           torch.from_numpy(pos),
                           mrope_pos=None if mp is None else torch.from_numpy(mp))
        _rel(tl, jl, 1e-5, f"decode {i}")
    for i, c in enumerate(tc):
        for name in ("k", "v"):
            _rel(c[name], jc["blocks"]["l0"][name][i], 1e-5, f"cache {name}")


def test_greedy_generate_with_mrope_matches_reference():
    jm, jp, tm, tp = _pair()
    jt, jpos, tt, tpos = _stream(2, 24)
    want = j_greedy_generate(jm, jp, jt, 5, extras={"mrope_pos": jpos})
    got = greedy_generate(tm, tp, tt, 5, extras={"mrope_pos": tpos})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with attention_impl("xla"):
        plain = greedy_generate(tm, tp, tt, 5, extras={"mrope_pos": tpos})
    assert torch.equal(plain, got)


def test_mrope_batches_match_reference():
    """``mrope_pos`` [3, B, S] of three equal streams 0..S-1, exactly as
    the reference's, from both batchers."""
    cfg, jcfg = get_arch(ARCH).reduced(), jax_arch(ARCH).reduced()
    got = next(synthetic_batches(cfg, 2, 8, seed=1, device="cpu"))
    want = next(j_synthetic_batches(jcfg, 2, 8, seed=1))
    assert sorted(got) == sorted(want) == ["labels", "mrope_pos", "tokens"]
    for k in got:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got = next(sim_token_batches(cfg, SimConfig(n_slots=16), 2, 8,
                                 n_instances=2, device="cpu"))
    want = next(j_sim_token_batches(jcfg, JSimConfig(n_slots=16), 2, 8,
                                    n_instances=2))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_step_with_mrope_matches_reference():
    """``mrope_pos`` [3, B, S] splits on its batch axis (1); the loss and
    every gradient leaf, then 2 steps of 2 microbatches
    (``assert_train_step_matches``), on batches with the vision stub's
    positions."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(5)
    batches = []
    for seed in range(2):
        toks = rng.integers(0, VOCAB, (4, 17)).astype(np.int32)
        _, jpos, _, _ = _stream(4, 16, seed)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                        "mrope_pos": np.array(jpos)})
    parts = _split_microbatches({k: torch.from_numpy(v)
                                 for k, v in batches[0].items()}, 2)
    assert [p["mrope_pos"].shape for p in parts] == [(3, 2, 16)] * 2
    assert torch.equal(parts[1]["mrope_pos"],
                       torch.from_numpy(batches[0]["mrope_pos"][:, 2:]))
    assert_train_step_matches(jm, jp, tm, tp, batches)
