"""The port's attention against the reference's, on the CPU.

* ``repro_torch.kernels.ref.ref_attention`` (the flash kernel's plain
  version) against the Pallas ``flash_attention`` in interpret mode and the
  reference's ``ref_attention``;
* ``repro_torch.models.attention.full_attention`` on the default path
  (the kernel wrapper, which runs ``ref_attention`` on a CPU tensor) and
  under ``attention_impl("xla")`` (``sdpa``, tiled ``flash_xla``) against
  the reference's ``full_attention``/``sdpa``/``flash_xla``.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: f32 ``rtol=2e-5, atol=2e-6`` (the same f32 algorithm, sums in
another order); bf16 ``rtol=2e-2, atol=8e-3``, the reference's own
bf16 kernel tolerance (``tests/test_kernels.py``): one bf16 ulp at 1.0 is
7.8e-3 and the two frameworks round p and the product at other places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels.ref import ref_attention as jax_ref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import ref_attention
from repro_torch.models import attention as tattn

TOL = {"float32": dict(rtol=2e-5, atol=2e-6),
       "bfloat16": dict(rtol=2e-2, atol=8e-3)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, sq, sk, h, kh, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    # bf16 values carried across exactly: round in JAX, widen to f32
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(TDT[dtype])
          for a in jx]
    return jx, tx


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,kh,d,causal,window,cap",
    [
        (1, 64, 2, 2, 64, True, 0, 0.0),     # MHA causal
        (2, 64, 4, 2, 16, True, 0, 0.0),     # GQA
        (1, 96, 4, 1, 16, True, 32, 0.0),    # MQA + sliding window
        (1, 64, 4, 2, 64, True, 24, 50.0),   # gemma2: GQA, window, softcap
        (1, 64, 2, 2, 16, False, 0, 0.0),    # non-causal
    ],
)
def test_ref_attention_matches_pallas_kernel(b, s, h, kh, d, causal, window,
                                             cap, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(s + d, b, s, s, h, kh, d, dtype)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, softcap=cap,
                     block_q=32, block_k=32, interpret=True)
    got = ref_attention(tq, tk, tv, causal, window, cap)
    assert got.dtype == TDT[dtype] and got.shape == (b, s, h, d)
    _close(got, want, dtype)
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window,
                        softcap=cap), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_attention_end_aligned_queries(dtype):
    """Fewer queries than keys: queries sit at the end (Sk - Sq offset)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(5, 1, 24, 64, 4, 2, 16, dtype)
    want = jax_ref(jq, jk, jv, causal=True, window=20, softcap=30.0)
    _close(ref_attention(tq, tk, tv, True, 20, 30.0), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0),
                                               (True, 16, 50.0),
                                               (False, 0, 0.0)])
def test_full_attention_both_paths_match_reference(causal, window, cap,
                                                   dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(9, 2, 48, 48, 4, 2, 16, dtype)
    kw = dict(causal=causal, window=window, scale=16**-0.5, cap=cap)
    want = jattn.full_attention(jq, jk, jv, **kw)
    before = dict(fa.launches)
    _close(tattn.full_attention(tq, tk, tv, **kw), want, dtype)
    with tattn.attention_impl("xla"):
        _close(tattn.full_attention(tq, tk, tv, **kw), want, dtype)
    assert fa.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_xla_matches_reference_tiles(dtype):
    """The plain tiled path with tiles smaller than the sequence, against
    the reference's ``flash_xla`` with the same tiles."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(11, 1, 64, 64, 4, 2, 16, dtype)
    kw = dict(causal=True, window=20, scale=0.25, cap=50.0)
    want = jattn.flash_xla(jq, jk, jv, tile_q=16, tile_k=16, **kw)
    got = tattn.flash_xla(tq, tk, tv, tile_q=16, tile_k=16, **kw)
    _close(got, want, dtype)


def test_flash_xla_ragged_tiles_match_ref_attention():
    """Tiles that do not divide the sequence (the reference asserts they
    do): the last tile is shorter and the result is unchanged."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(13, 1, 45, 45, 4, 2, 16, "float32")
    want = jax_ref(jq, jk, jv, causal=True, window=12, softcap=50.0)
    got = tattn.flash_xla(tq, tk, tv, causal=True, window=12, scale=0.25,
                          cap=50.0, tile_q=16, tile_k=16)
    _close(got, want, "float32")


def test_sdpa_with_cache_mask_matches_reference():
    (jq, jk, jv), (tq, tk, tv) = _inputs(17, 2, 1, 32, 4, 2, 16, "float32")
    mask = np.random.default_rng(3).uniform(size=(2, 1, 32)) < 0.7
    want = jattn.sdpa(jq, jk, jv, jnp.asarray(mask), 0.25, 50.0)
    got = tattn.sdpa(tq, tk, tv, torch.from_numpy(mask), 0.25, 50.0)
    _close(got, want, "float32")


def test_cpu_tensor_never_touches_the_kernel_library(monkeypatch):
    """On a CPU tensor the wrapper runs the plain version: it neither loads
    the kernel library nor counts a launch."""
    from repro_torch.kernels import build

    def refuse(name):
        raise AssertionError(f"kernel library {name} loaded for a CPU tensor")

    monkeypatch.setattr(build, "load", refuse)
    _, (tq, tk, tv) = _inputs(19, 1, 16, 16, 2, 1, 16, "float32")
    before = dict(fa.launches)
    out = fa.flash_attention(tq, tk, tv, causal=True, window=8, softcap=5.0)
    torch.testing.assert_close(out, ref_attention(tq, tk, tv, True, 8, 5.0),
                               rtol=0, atol=0)
    assert fa.launches == before


def test_attention_impl_rejects_unknown_path():
    with pytest.raises(ValueError):
        with tattn.attention_impl("pallas"):
            pass
