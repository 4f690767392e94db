"""The port's recurrences against the reference's, on the CPU.

Kernels: ``repro_torch.kernels.rglru.rglru_linear_scan`` and
``repro_torch.kernels.rwkv6.wkv6`` (on a CPU tensor, their plain versions
``ref_rglru``/``ref_wkv6``) against the JAX oracles and against the Pallas
kernels run in interpret mode, at the shapes of ``tests/test_kernels.py``
and with its tolerances: RG-LRU outputs bf16 ``rtol=2e-2, atol=2e-3``, f32
``1e-5``, final state ``1e-4``; WKV6 outputs bf16 ``5e-2``, f32 ``1e-4``,
final state ``1e-3``.

Layers: the RG-LRU, the Griffin block, the RWKV-6 time mix and channel mix
(full sequence and one decode step) and the prefill state helpers, with the
reference's seeded parameters carried across by
``repro_torch.convert.lm_params_from_numpy``, in f32: ``rtol=1e-5,
atol=2e-5`` (the same f32 arithmetic; the reference's RG-LRU is a log-space
associative scan, the port's a sequential one, equal in exact arithmetic).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_arch
from repro.kernels import ops as pallas
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro.models import build_model as jax_build
from repro.models import recurrent as jrec
from repro_torch.config.base import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rglru import rglru_linear_scan
from repro_torch.kernels.rwkv6 import wkv6
from repro_torch.models import blocks as tblocks
from repro_torch.models import recurrent as trec

RG_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
          "bfloat16": dict(rtol=2e-2, atol=2e-3)}
WKV_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
LAYER_TOL = dict(rtol=1e-5, atol=2e-5)


def _both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype`` (both
    round f32 to bf16 to nearest even, so they hold the same values)."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(j, np.float32), t.float().numpy())
    return j, t


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


# --------------------------------------------------------------- rg-lru

def _rglru_inputs(seed, b, s, w, dtype, lo=0.7):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 0.999, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return _both(a, "float32"), _both(x, dtype), _both(h0, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w,bs,bw", [
    (2, 64, 128, 16, 128),
    (1, 128, 256, 128, 128),   # multiple width tiles
    (1, 96, 128, 32, 128),     # multiple seq tiles
])
def test_rglru_matches_reference_and_pallas(b, s, w, bs, bw, dtype):
    (ja, ta), (jx, tx), (jh, th) = _rglru_inputs(s + w, b, s, w, dtype)
    ys, hf = rglru_linear_scan(ta, tx, th)
    assert ys.dtype == tx.dtype and hf.dtype == torch.float32
    ys_ref, hf_ref = jref.ref_rglru(ja, jx, jh)
    ys_pl, hf_pl = pallas.rglru_linear_scan(ja, jx, jh, block_s=bs,
                                            block_w=bw, interpret=True)
    np.testing.assert_allclose(_np(ys), _np(ys_ref), **RG_TOL[dtype])
    np.testing.assert_allclose(_np(ys), _np(ys_pl), **RG_TOL[dtype])
    for want in (hf_ref, hf_pl):
        np.testing.assert_allclose(_np(hf), _np(want), rtol=1e-4, atol=1e-4)
    # the plain version itself is the reference oracle's f32 contract
    ys32, _ = tref.ref_rglru(ta, tx, th)
    np.testing.assert_allclose(_np(ys32), _np(ys_ref), **RG_TOL["float32"])


@pytest.mark.parametrize("split", [32, 1, 37])
def test_rglru_chunked_equals_whole(split):
    """State handoff through ``h0``: two chunks equal one (1e-5, as the
    reference's test); 37 is not a divisor of S."""
    (_, a), (_, x), _ = _rglru_inputs(3, 1, 64, 128, "float32", lo=0.8)
    h0 = torch.zeros((1, 128))
    y_all, h_all = rglru_linear_scan(a, x, h0)
    y1, h1 = rglru_linear_scan(a[:, :split], x[:, :split], h0)
    y2, h2 = rglru_linear_scan(a[:, split:], x[:, split:], h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, h_all, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- wkv6

def _wkv6_inputs(seed, b, s, h, dk, dv, dtype):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = normal(b, s, h, dk), normal(b, s, h, dk), normal(b, s, h, dv)
    w = rng.uniform(0.8, 0.999, (b, s, h, dk)).astype(np.float32)
    u, s0 = normal(h, dk), normal(b, h, dk, dv)
    return ([_both(z, dtype) for z in (r, k, v)]
            + [_both(z, "float32") for z in (w, u, s0)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,dk,dv,bs", [
    (1, 32, 2, 16, 16, 16),
    (2, 64, 2, 64, 64, 32),    # full rwkv6 head size, multiple seq tiles
    (1, 48, 1, 32, 16, 16),    # dk != dv
])
def test_wkv6_matches_reference_and_pallas(b, s, h, dk, dv, bs, dtype):
    pairs = _wkv6_inputs(s + dk + dv, b, s, h, dk, dv, dtype)
    jargs = [j for j, _ in pairs]
    targs = [t for _, t in pairs]
    y, sf = wkv6(*targs)
    assert y.dtype == targs[2].dtype and sf.dtype == torch.float32
    y_ref, sf_ref = jref.ref_wkv6(*jargs)
    y_pl, sf_pl = pallas.wkv6(*jargs, block_s=bs, interpret=True)
    for want_y, want_s in ((y_ref, sf_ref), (y_pl, sf_pl)):
        np.testing.assert_allclose(_np(y), _np(want_y), **WKV_TOL[dtype])
        np.testing.assert_allclose(_np(sf), _np(want_s), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("split", [32, 13])
def test_wkv6_chunked_equals_whole(split):
    """State handoff through ``s0`` (1e-4, as the reference's test)."""
    r, k, v, w, u, _ = (t for _, t in _wkv6_inputs(5, 1, 64, 2, 16, 16,
                                                    "float32"))
    s0 = torch.zeros((1, 2, 16, 16))
    y_all, s_all = wkv6(r, k, v, w, u, s0)
    cut = [z[:, :split] for z in (r, k, v, w)]
    rest = [z[:, split:] for z in (r, k, v, w)]
    y1, s1 = wkv6(*cut, u, s0)
    y2, s2 = wkv6(*rest, u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s2, s_all, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- layers

def _layer(arch: str, kind_key: str):
    """Layer 0's parameters of the reduced f32 ``arch``: the reference's
    (a dict) and the port's (the converted module), and both configs."""
    jcfg = jax_arch(arch).reduced(dtype="float32")
    cfg = get_arch(arch).reduced(dtype="float32")
    jp = jax_build(jcfg).init(jax.random.key(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"])
    return jcfg, cfg, jl[kind_key], getattr(tp.layers[0], kind_key), jl, \
        tp.layers[0]


def _x(seed, *shape, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_rglru_scan_and_step_match_reference():
    jcfg, cfg, jp, tp, _, _ = _layer("recurrentgemma-2b", "mixer")
    jx, tx = _x(0, 2, 40, cfg.lru_width)
    np.testing.assert_allclose(
        _np(trec.rglru_scan(tp.lru, tx, cfg.n_heads)),
        _np(jrec.rglru_scan(jp["lru"], jx, jcfg.n_heads)), **LAYER_TOL)
    jh, th = _x(1, 2, cfg.lru_width)
    jy, jh2 = jrec.rglru_step(jp["lru"], jx[:, :1], jh, jcfg.n_heads)
    ty, th2 = trec.rglru_step(tp.lru, tx[:, :1], th, cfg.n_heads)
    np.testing.assert_allclose(_np(ty), _np(jy), **LAYER_TOL)
    np.testing.assert_allclose(_np(th2), _np(jh2), **LAYER_TOL)


def test_rglru_plain_and_kernel_impls_agree_on_cpu():
    """``recurrence_impl("plain")`` selects the plain versions; on a CPU
    tensor the kernel wrappers run them too, so both give the same bits."""
    _, cfg, _, tp, _, _ = _layer("recurrentgemma-2b", "mixer")
    _, tx = _x(2, 1, 9, cfg.lru_width)
    with trec.recurrence_impl("plain"):
        plain = trec.rglru_scan(tp.lru, tx, cfg.n_heads)
    assert torch.equal(plain, trec.rglru_scan(tp.lru, tx, cfg.n_heads))
    with pytest.raises(ValueError):
        with trec.recurrence_impl("xla"):
            pass


def test_recurrent_block_apply_and_step_match_reference():
    jcfg, cfg, jp, tp, _, _ = _layer("recurrentgemma-2b", "mixer")
    jx, tx = _x(3, 2, 40, cfg.d_model)
    np.testing.assert_allclose(
        _np(trec.recurrent_block_apply(cfg, tp, tx)),
        _np(jrec.recurrent_block_apply(jcfg, jp, jx)), **LAYER_TOL)
    jh, th = _x(4, 2, cfg.lru_width)
    jconv, tconv = _x(5, 2, cfg.conv_width - 1, cfg.lru_width)
    jout, jc = jrec.recurrent_block_step(jcfg, jp, jx[:, :1],
                                         {"h": jh, "conv": jconv})
    cache = {"h": th.clone(), "conv": tconv.clone()}
    tout, tc = trec.recurrent_block_step(cfg, tp, tx[:, :1], cache)
    assert tc is cache
    np.testing.assert_allclose(_np(tout), _np(jout), **LAYER_TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **LAYER_TOL)


def test_rwkv_time_mix_apply_and_step_match_reference():
    jcfg, cfg, jp, tp, _, _ = _layer("rwkv6-3b", "time_mix")
    jx, tx = _x(6, 2, 40, cfg.d_model)
    np.testing.assert_allclose(
        _np(trec.rwkv_time_mix_apply(cfg, tp, tx)),
        _np(jrec.rwkv_time_mix_apply(jcfg, jp, jx)), **LAYER_TOL)
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    jS, tS = _x(7, 2, h, hd, hd)
    jprev, tprev = _x(8, 2, cfg.d_model)
    jcache = {"S": jS, "x_prev_tm": jprev, "x_prev_cm": jprev}
    cache = {"S": tS.clone(), "x_prev_tm": tprev.clone(),
             "x_prev_cm": tprev.clone()}
    jout, jc = jrec.rwkv_time_mix_step(jcfg, jp, jx[:, :1], jcache)
    tout, tc = trec.rwkv_time_mix_step(cfg, tp, tx[:, :1], cache)
    np.testing.assert_allclose(_np(tout), _np(jout), **LAYER_TOL)
    for name in ("S", "x_prev_tm", "x_prev_cm"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **LAYER_TOL)


def test_rwkv_channel_mix_apply_and_step_match_reference():
    jcfg, cfg, jp, tp, _, _ = _layer("rwkv6-3b", "channel_mix")
    jx, tx = _x(9, 2, 40, cfg.d_model)
    np.testing.assert_allclose(
        _np(trec.rwkv_channel_mix_apply(cfg, tp, tx)),
        _np(jrec.rwkv_channel_mix_apply(jcfg, jp, jx)), **LAYER_TOL)
    jprev, tprev = _x(10, 2, cfg.d_model)
    jout, jc = jrec.rwkv_channel_mix_step(
        jcfg, jp, jx[:, :1], {"x_prev_cm": jprev})
    tout, tc = trec.rwkv_channel_mix_step(
        cfg, tp, tx[:, :1], {"x_prev_cm": tprev.clone()})
    np.testing.assert_allclose(_np(tout), _np(jout), **LAYER_TOL)
    np.testing.assert_allclose(_np(tc["x_prev_cm"]), _np(jc["x_prev_cm"]),
                               **LAYER_TOL)


def _prefill_both(arch, kind, seed, s, cache_fn):
    jcfg, cfg, _, _, jl, tl = _layer(arch, "norm1")
    jx, tx = _x(seed, 1, s, cfg.d_model, scale=0.5)
    pos = np.arange(s)[None]
    jcache, tcache = cache_fn(cfg)
    jy, jc = jblocks.block_prefill(jcfg, jl, kind, False, jx,
                                   jnp.asarray(pos), jcache)
    ty, tc = tblocks.block_prefill(cfg, tl, tx, torch.from_numpy(pos), tcache)
    assert tc is tcache
    np.testing.assert_allclose(_np(ty), _np(jy), **LAYER_TOL)
    return jc, tc


def _zero_caches(kind):
    def make(cfg):
        t = tblocks.block_cache_init(cfg, kind, 1, 64, "cpu")
        return {k: jnp.asarray(v.numpy()) for k, v in t.items()}, t
    return make


def test_recurrent_prefill_cache_matches_reference():
    """The decode state is the last RG-LRU output in the model's type
    widened to f32, and the conv history the last three conv inputs."""
    jc, tc = _prefill_both("recurrentgemma-2b", "recurrent", 11, 23,
                           _zero_caches("recurrent"))
    for name in ("h", "conv"):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **LAYER_TOL)


def test_recurrent_prefill_pads_a_short_prompt_history():
    """A prompt shorter than the conv history leaves zeros before it (the
    reference's slice would come out shorter than its cache)."""
    _, cfg, _, _, _, tl = _layer("recurrentgemma-2b", "norm1")
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 2, cfg.d_model)).astype(np.float32))
    cache = tblocks.block_cache_init(cfg, "recurrent", 1, 8, "cpu")
    cache["conv"].fill_(7.0)
    tblocks.block_prefill(cfg, tl, x, torch.arange(2)[None], cache)
    _, u, _ = trec.recurrent_block_seq(
        cfg, tl.mixer, tblocks.norm(cfg, tl.norm1, x))
    assert cache["conv"].shape == (1, cfg.conv_width - 1, cfg.lru_width)
    assert torch.equal(cache["conv"][:, :1], torch.zeros(1, 1, cfg.lru_width))
    assert torch.equal(cache["conv"][:, 1:], u)


@pytest.mark.parametrize("start", ["zero", "random"])
def test_rwkv_prefill_state_matches_reference(start):
    """One ``wkv6`` from a zero state gives the prefill's output and its
    state; a non-zero cache state is carried through by the product of the
    prompt's decays, as the reference's second scan from ``cache["S"]``."""
    def caches(cfg):
        jc, tc = _zero_caches("rwkv")(cfg)
        if start == "random":
            s = np.random.default_rng(13).standard_normal(
                tuple(tc["S"].shape)).astype(np.float32)
            jc["S"] = jnp.asarray(s)
            tc["S"].copy_(torch.from_numpy(s))
        return jc, tc

    jc, tc = _prefill_both("rwkv6-3b", "rwkv", 14, 29, caches)
    for name in ("S", "x_prev_tm", "x_prev_cm"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **LAYER_TOL)


def test_recurrent_params_keep_their_f32_leaves():
    """In a bf16 model the reference keeps ``a_param``, ``w_base``, ``u`` and
    the group norm's scale and bias in f32; the converter keeps them so."""
    for arch in ("recurrentgemma-2b", "rwkv6-3b"):
        cfg = get_arch(arch).reduced()
        tree = jax.tree.map(np.asarray,
                            jax_build(jax_arch(arch).reduced()).init(
                                jax.random.key(0)))
        params = lm_params_from_numpy(tree, cfg, "cpu")
        f32 = {n for n, t in params.named_parameters()
               if t.dtype == torch.float32}
        want = {f"layers.{i}.{leaf}" for i, layer in enumerate(params.layers)
                for leaf in (("mixer.lru.a_param",) if layer.kind == "recurrent"
                             else ("time_mix.w_base", "time_mix.u",
                                   "time_mix.ln_x_scale",
                                   "time_mix.ln_x_bias")
                             if layer.kind == "rwkv" else ())}
        assert f32 == want, arch
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_arch(arch).reduced())
