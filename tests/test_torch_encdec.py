"""The port's encoder-decoder (whisper-large-v3 reduced: 2 + 2 layers,
d_model 64, 4 heads of 16, ``enc_ctx`` 8) against the reference's, on the
CPU: weights carried across by ``repro_torch.convert.lm_params_from_numpy``
(the reference's seeded parameters with every norm scale and bias redrawn
with numpy, so none is at its identity init); the same numpy frames and
tokens through both; the port on its plain path (the flash kernel's plain
version on a CPU tensor), the reference through XLA.

Levels and tolerances:

* ``sinusoidal_positions`` and ``_sinusoidal_at`` within f32 1e-6 (the
  port computes the frequencies as the reference's compiler does at run
  time; at d_model 64 it folds the small table at compile time with the
  host's ``exp`` instead, an ulp off in a frequency or two, 1e-6 at
  position 12);
* ``prng.normal`` (the audio stub's frames): the uniform bits exact; the
  values bit-equal in bf16 and within 2 ulps in f32;
* ``encode``, ``apply``, ``prefill`` (logits, every self cache entry, the
  cross K/V of frames as long as ``enc_ctx`` and longer) and 4 decode
  steps in f32 within 1e-5 of each tensor's largest entry (measured: below
  1e-6);
* bf16 layer by layer from the same state (an encoder layer, a decoder
  layer with its cross attention): within 2^-6 of each output's largest
  entry, about two bf16 ulps of it;
* ``greedy_generate(..., extras={"frames": ...})``: tokens equal in f32;
* the batchers' frames (``synthetic_batches``, ``sim_token_batches``):
  bit-equal in bf16, within 2 ulps in f32;
* the train step: the loss within rtol 1e-5, every gradient leaf at
  ``test_torch_train_parity.py``'s level, two steps in 2 microbatches at
  its first-step-noise level, weight decay by the reference's leaf ranks;
* conversion there and back: bit-equal.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_arch as jax_arch
from repro.core.scenario import SimConfig as JSimConfig
from repro.data.sim_dataset import sim_token_batches as j_sim_token_batches
from repro.data.synthetic import synthetic_batches as j_synthetic_batches
from repro.launch import serve as j_serve_launcher
from repro.models import build_model as jax_build
from repro.models import encdec as jencdec
from repro.models.attention import attn_apply as j_attn_apply
from repro.models.attention import cross_attn_apply as j_cross_attn_apply
from repro.models.attention import cross_attn_kv as j_cross_attn_kv
from repro.models.common import norm as j_norm
from repro.models.common import sinusoidal_positions as j_sinusoidal_positions
from repro.models.ffn import ffn_apply as j_ffn_apply
from repro.models.frontends import audio_frames_stub as j_audio_frames_stub
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.engine import greedy_generate as j_greedy_generate
from repro_torch.config.base import ServeConfig, get_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.core import prng
from repro_torch.core.scenario import SimConfig
from repro_torch.data.sim_dataset import sim_token_batches
from repro_torch.data.synthetic import synthetic_batches
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import encdec
from repro_torch.models.attention import (
    attention_impl,
    attn_apply,
    cross_attn_apply,
    cross_attn_kv,
)
from repro_torch.models.common import norm, sinusoidal_at, sinusoidal_positions
from repro_torch.models.frontends import audio_frames_stub
from repro_torch.models.registry import build_model, reference_ranks
from repro_torch.serve.engine import ServeEngine, greedy_generate
from test_torch_train_parity import (_leaves, _perturb,
                                     assert_train_step_matches)

ARCH = "whisper-large-v3"
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
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("n,d", [(12, 64), (1500, 1280)])
def test_sinusoidal_tables_match_reference(n, d):
    want = np.asarray(jax.jit(lambda: j_sinusoidal_positions(n, d))())
    got = sinusoidal_positions(n, d, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    pos = np.asarray([0, 1, 5, n - 1], np.int32)
    want = np.asarray(jax.jit(lambda p: jencdec._sinusoidal_at(p, d))(
        jnp.asarray(pos)))
    np.testing.assert_allclose(sinusoidal_at(torch.from_numpy(pos), d).numpy(),
                               want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normal_matches_reference(seed, dtype):
    """``prng.normal`` against ``jax.random.normal``. A bf16 draw takes 8
    bits an element (a bf16 has 7 mantissa bits): the low byte of the
    32-bit draw, as ``jax.random.bits`` at uint8 and uint16 give the low
    bits of the uint32 draw."""
    k = jax.random.fold_in(jax.random.key(seed), 3)
    tk = prng.fold_in(prng.key(seed, "cpu"), 3)
    shape = (4, 60, 70)
    b32 = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(), b32)
    for width in (jnp.uint8, jnp.uint16):
        bits = np.asarray(jax.random.bits(k, shape, width)).astype(np.int64)
        np.testing.assert_array_equal(
            bits, b32 & (2 ** (8 * jnp.dtype(width).itemsize) - 1))
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax.random.normal(k, shape, jdt).astype(jnp.float32))
    got = prng.normal(tk, shape, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        ulps = np.abs(got - want) / np.spacing(np.abs(want))
        assert ulps.max() <= 2, ulps.max()
    cfg = get_arch(ARCH).reduced(dtype=dtype)
    frames = audio_frames_stub(prng.key(seed, "cpu"), cfg, 2, 9)
    jframes = j_audio_frames_stub(jax.random.key(seed), jax_arch(ARCH).reduced(
        dtype=dtype), 2, 9)
    assert frames.shape == (2, 9, 64)
    np.testing.assert_allclose(frames.float().numpy(),
                               np.asarray(jframes.astype(jnp.float32)),
                               rtol=2 * 2.0**-23, atol=0)


@pytest.mark.parametrize("t", [8, 12])
def test_encdec_matches_reference_f32(t):
    """Frames of ``enc_ctx`` (8) and of 12 frames: the reference's prefill
    returns cross K/V of the frames' length whatever ``enc_ctx``, and so
    does the port's."""
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(2, t, 64)).astype(np.float32)
    toks = rng.integers(0, VOCAB, (2, 10))
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)}
    tol = 1e-5
    _rel(encdec.encode(tp, cfg, tb["frames"]),
         jax.jit(lambda p, f: jencdec.encode(p, jm.cfg, f))(jp, jb["frames"]),
         tol, "encode")
    jl, jaux = jax.jit(jm.apply)(jp, jb)
    tl, aux = tm.apply(tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == (2, 10, VOCAB)
    assert float(aux) == float(jaux) == 0.0
    _rel(tl, jl, tol, "apply")
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    assert tc["cross"][0]["k"].shape == (2, cfg.enc_ctx, 4, 16)
    jl, jc = jax.jit(jm.prefill)(jp, jc, jb)
    tl, tc = tm.prefill(tp, tc, tb)
    _rel(tl, jl, tol, "prefill")

    def caches():
        for i in range(cfg.n_layers):
            for name in ("k", "v"):
                assert tc["cross"][i][name].shape == (2, t, 4, 16)
                _rel(tc["cross"][i][name], jc["cross"][name][i], tol,
                     f"cross {name} {i}")
                _rel(tc["self"][i][name], jc["self"][name][i], tol,
                     f"self {name} {i}")
            np.testing.assert_array_equal(tc["self"][i]["pos"].numpy(),
                                          np.asarray(jc["self"]["pos"][i]))

    caches()
    jdecode = jax.jit(jm.decode)
    for step in range(4):
        tok = rng.integers(0, VOCAB, (2,))
        pos = np.full((2,), 10 + step, np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok),
                           torch.from_numpy(pos))
        _rel(tl, jl, tol, f"decode {step}")
    caches()


def test_bf16_layers_match_reference():
    """An encoder layer and a decoder layer (causal self-attention, cross
    attention over 12 encoder rows, FFN) from the same bf16 state: within
    2^-6 of each output's largest entry."""
    jm, jp, tm, tp = _pair("bfloat16")
    cfg, jcfg = tm.cfg, jm.cfg
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    enc = rng.normal(size=(2, 12, 64)).astype(np.float32)
    jx, jenc = (jnp.asarray(a, jnp.bfloat16) for a in (x, enc))
    tx, tenc = (torch.from_numpy(a).bfloat16() for a in (x, enc))
    pos = jnp.broadcast_to(jnp.arange(12)[None], (2, 12))
    jl = jax.tree.map(lambda a: a[1], jp["enc_blocks"])
    h = j_norm(jcfg, jl["norm1"], jx)
    want = jx + j_attn_apply(jcfg, jl["attn"], h, pos, "global", causal=False)
    want = want + j_ffn_apply(jcfg, jl["ffn"], j_norm(jcfg, jl["norm2"], want))
    tpos = torch.from_numpy(np.array(pos))
    got = encdec._enc_layer(cfg, tp.enc_blocks[1], tx, tpos)
    _rel(got, want, 2.0**-6, "encoder layer")
    jl = jax.tree.map(lambda a: a[1], jp["dec_blocks"])
    h = j_norm(jcfg, jl["norm1"], jx)
    want = jx + j_attn_apply(jcfg, jl["self_attn"], h, pos, "global")
    h = j_norm(jcfg, jl["norm_x"], want)
    want = want + j_cross_attn_apply(jcfg, jl["cross_attn"], h,
                                     j_cross_attn_kv(jcfg, jl["cross_attn"],
                                                     jenc))
    want = want + j_ffn_apply(jcfg, jl["ffn"], j_norm(jcfg, jl["norm2"], want))
    bp = tp.dec_blocks[1]
    got = tx + attn_apply(cfg, bp.self_attn, norm(cfg, bp.norm1, tx), tpos)
    got = got + cross_attn_apply(cfg, bp.cross_attn, norm(cfg, bp.norm_x, got),
                                 cross_attn_kv(cfg, bp.cross_attn, tenc))
    got = encdec._ffn_half(cfg, bp, got)
    _rel(got, want, 2.0**-6, "decoder layer")


def test_greedy_generate_with_frames_matches_reference():
    """``greedy_generate(..., extras=)`` passes the frames to the prefill,
    as the reference's does; the tokens are equal in f32."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(4)
    frames = rng.normal(size=(2, 8, 64)).astype(np.float32)
    prompt = rng.integers(0, VOCAB, (2, 6))
    want = j_greedy_generate(jm, jp, jnp.asarray(prompt), 5,
                             extras={"frames": jnp.asarray(frames)})
    got = greedy_generate(tm, tp, torch.from_numpy(prompt), 5,
                          extras={"frames": torch.from_numpy(frames)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with attention_impl("xla"):
        plain = greedy_generate(tm, tp, torch.from_numpy(prompt), 5,
                                extras={"frames": torch.from_numpy(frames)})
    assert torch.equal(plain, got)


def test_engine_keeps_the_reference_limit(monkeypatch, capsys):
    """The reference's engine takes an encoder-decoder and fails at its
    first prefill (``KeyError: 'frames'``: its requests are tokens alone);
    the port's engine and serve launcher refuse it up front, saying so."""
    jm, jp, tm, tp = _pair()
    eng = JaxServeEngine(jm, jp, JaxServeConfig(max_batch=2, max_seq=32))
    eng.submit(np.asarray([1, 2, 3]), max_new=2)
    with pytest.raises(KeyError, match="frames"):
        eng.run()
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH,
                                      "--requests", "1"])
    with pytest.raises(KeyError, match="frames"):
        j_serve_launcher.main()
    with pytest.raises(NotImplementedError, match="KeyError: 'frames'"):
        ServeEngine(tm, tp, ServeConfig(max_batch=2, max_seq=32))
    with pytest.raises(NotImplementedError, match="greedy_generate"):
        serve_launcher.main(["--device", "cpu", "--arch", ARCH,
                             "--requests", "1"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_frames_match_reference(dtype):
    """The synthetic batches' frames are ``normal`` draws from the step's
    key folded with 1, in the model's type: bit-equal in bf16, within 2
    ulps in f32; tokens and labels equal."""
    cfg = get_arch(ARCH).reduced(dtype=dtype)
    jcfg = jax_arch(ARCH).reduced(dtype=dtype)
    got = synthetic_batches(cfg, 2, 8, seed=3, start_step=4, device="cpu")
    want = j_synthetic_batches(jcfg, 2, 8, seed=3, start_step=4)
    for _ in range(2):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == ["frames", "labels", "tokens"]
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        assert g["frames"].dtype == getattr(torch, dtype)
        assert g["frames"].shape == (2, cfg.enc_ctx, cfg.d_model)
        np.testing.assert_allclose(
            g["frames"].float().numpy(),
            np.asarray(w["frames"].astype(jnp.float32)),
            rtol=0 if dtype == "bfloat16" else 2 * 2.0**-23, atol=0)


def test_sim_batches_frames_match_reference():
    """``sim_token_batches``' frames are ``normal`` draws from
    ``fold_in(key(seed), step)`` in the model's type (bf16: bit-equal);
    tokens and labels equal, over an in-process recording sweep."""
    cfg, jcfg = get_arch(ARCH).reduced(), jax_arch(ARCH).reduced()
    got = sim_token_batches(cfg, SimConfig(n_slots=16), 2, 8, n_instances=2,
                            seed=3, start_step=1, device="cpu")
    want = j_sim_token_batches(jcfg, JSimConfig(n_slots=16), 2, 8,
                               n_instances=2, seed=3, start_step=1)
    for _ in range(2):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == ["frames", "labels", "tokens"]
        assert g["frames"].dtype == torch.bfloat16
        for k in g:
            np.testing.assert_array_equal(
                g[k].float().numpy() if k == "frames" else g[k].numpy(),
                np.asarray(w[k].astype(jnp.float32) if k == "frames"
                           else w[k]))


def test_conversion_round_trip_and_decay_ranks():
    """from_numpy then to_numpy is bit-equal (f32 and bf16), and each
    parameter's rank for weight decay is its leaf's rank in the reference's
    stacked tree."""
    for dtype in ("float32", "bfloat16"):
        jm, jp, tm, tp = _pair(dtype)
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        got = lm_params_to_numpy(tp, tm.cfg)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    ranks = reference_ranks(tp, tm.cfg)
    by_name = lm_params_to_numpy({k: torch.zeros(()) + r
                                  for k, r in ranks.items()}, tm.cfg)
    for (path, leaf), (_, r) in zip(_leaves(jp), _leaves(by_name)):
        assert np.all(r == np.ndim(leaf)), jax.tree_util.keystr(path)


def test_train_step_matches_reference():
    """The loss and every gradient leaf (remat "full" on both sides), then
    2 steps of 2 microbatches at weight decay 0.1
    (``assert_train_step_matches``), on batches with frames."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, VOCAB, (4, 17)).astype(np.int32)
        frames = rng.normal(size=(4, 8, 64)).astype(np.float32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                        "frames": frames})
    assert_train_step_matches(jm, jp, tm, tp, batches)
