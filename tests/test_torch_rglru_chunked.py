"""The chunked RG-LRU kernel's arithmetic (``csrc/rglru.cu``), on the CPU.

The CUDA kernel cannot run here, so its arithmetic is written out below in
plain torch, in the kernel's order: the sequence cut into chunks of ``T``
steps (past S, a is 1 and x is 0); per chunk, from a zero state, the
aggregate ``P = ∏ a_t`` and ``L`` (``L ← a_t L + x_t``); the carry into
chunk c found by the look-back, newest chunk first, ``acc ← acc + ap L_j``,
``ap ← ap P_j``, until a chunk whose inclusive state ``H_j`` is out (or
``h0`` before chunk 0), ``carry = acc + ap H_j``, then ``H_c = P carry +
L``; then the chunk run again from the carry, ``h ← a_t h + x_t``, giving
ys, and the last chunk's h as h_final. Every product and sum rounds on its
own in f32, as the kernel's ``__fmul_rn``/``__fadd_rn`` do. How far a
block looks back depends on which blocks have published when it looks, so
the mirror takes the look-back's depth as an argument.

That mirror is held against the reference's ``ref_rglru`` and its Pallas
``rglru_linear_scan`` in interpret mode, with the card tests' tolerances
(``tests/test_torch_kernels_cuda.py``): ys ``rtol = atol = 1e-5`` in f32,
``rtol 2e-2, atol 2e-3`` in bf16; h_final ``1e-4``. Draws: the reference
tests' mild decays U(0.7, 0.999) and strong ones ``exp(-exp(U(-8, 5)))``
with one entry in 16 exactly 0 and one in 16 exactly 1; S at 1, T - 1, T,
T + 1, 2T - 1, 2T, 2T + 1 and 300 for the kernel's T = ``rglru.CHUNK``
(64); W not a multiple of the kernel's 128-lane tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as pallas
from repro.kernels import ref as jref
from repro_torch.kernels import rglru as rg

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def rglru_inputs(seed, b, s, w, strong=True):
    """numpy a, x, h0 (f32); with ``strong`` the decays are
    ``exp(-exp(U(-8, 5)))`` (zero in f32 past about U 4.6) with about one
    entry in 16 set to exactly 0 and one in 16 to exactly 1, else
    ``U(0.7, 0.999)`` (the reference's test draw). The same function is in
    ``tests/test_torch_kernels_cuda.py``."""
    rng = np.random.default_rng(seed)
    if strong:
        a = np.exp(-np.exp(rng.uniform(-8.0, 5.0, (b, s, w))))
        pick = rng.uniform(size=a.shape)
        a[pick < 1 / 16] = 0.0
        a[pick > 15 / 16] = 1.0
    else:
        a = rng.uniform(0.7, 0.999, (b, s, w))
    x = rng.standard_normal((b, s, w))
    h0 = rng.standard_normal((b, w))
    return a.astype(np.float32), x.astype(np.float32), h0.astype(np.float32)


def chunked_rglru(a, x, h0, chunk, depth=None):
    """The kernel's chunked scan on ``a`` f32, ``x`` (bf16 or f32) ``[B, S,
    W]`` and ``h0`` f32 ``[B, W]``: returns ``(ys`` in x's type, ``h_final``
    f32). ``depth(c)`` is how many aggregates chunk c folds before it meets
    an inclusive state (``None``: none, every chunk meets its predecessor's,
    as in a chunk-by-chunk pass; a depth past chunk 0 folds down to h0)."""
    b, s, w = x.shape
    nc = max(1, -(-s // chunk))
    pad = nc * chunk - s
    af = F.pad(a.float(), (0, 0, 0, pad), value=1.0)
    xf = F.pad(x.float(), (0, 0, 0, pad), value=0.0)
    aggs, incl, ys = [], [], []
    h = h0.float()
    for c in range(nc):
        ac, xc = af[:, c * chunk:(c + 1) * chunk], xf[:, c * chunk:(c + 1) * chunk]
        p, l_ = torch.ones_like(h), torch.zeros_like(h)
        for t in range(chunk):
            p = ac[:, t] * p
            l_ = ac[:, t] * l_ + xc[:, t]
        aggs.append((p, l_))
        d = 0 if depth is None else depth(c)
        acc, ap = torch.zeros_like(h), torch.ones_like(h)
        j = c - 1
        for _ in range(d):
            if j < 0:
                break
            acc = acc + ap * aggs[j][1]
            ap = ap * aggs[j][0]
            j -= 1
        carry = acc + ap * (incl[j] if j >= 0 else h0.float())
        incl.append(p * carry + l_)
        h = carry
        for t in range(chunk):
            h = ac[:, t] * h + xc[:, t]
            ys.append(h)
    return torch.stack(ys, 1)[:, :s].to(x.dtype), h


def reference_and_pallas(a, x, h0, dtype):
    """The reference's plain scan and its Pallas kernel (interpret mode,
    with a block of the reference tests' 16, 32 or 128 steps that divides
    S, else S itself)."""
    ja, jh0 = jnp.asarray(a), jnp.asarray(h0)
    jx = jnp.asarray(x).astype(JAX_DTYPE[dtype])
    s = x.shape[1]
    bs = next((n for n in (128, 32, 16) if s % n == 0), s)
    return (jref.ref_rglru(ja, jx, jh0),
            pallas.rglru_linear_scan(ja, jx, jh0, block_s=bs,
                                     block_w=x.shape[2], interpret=True))


def assert_matches(got_ys, got_h, want, dtype):
    for want_ys, want_h in want:
        np.testing.assert_allclose(got_ys.float().numpy(),
                                   np.asarray(want_ys, np.float32),
                                   **TOL[dtype])
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   rtol=1e-4, atol=1e-4)


T = rg.CHUNK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, T - 1, T, T + 1, 2 * T - 1, 2 * T,
                               2 * T + 1, 300])
def test_chunked_arithmetic_matches_reference_and_pallas(s, dtype):
    a, x, h0 = rglru_inputs(T + s, 2, s, 100)   # W 100: a ragged tile
    xt = torch.from_numpy(x).to(dtype)
    ys, h = chunked_rglru(torch.from_numpy(a), xt, torch.from_numpy(h0),
                          T, depth=lambda c: c)  # the longest look-back
    assert ys.shape == (2, s, 100) and ys.dtype == dtype
    assert_matches(ys, h, reference_and_pallas(a, xt.float().numpy(), h0,
                                               dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2 * T + 1, 300, 640])
def test_mild_decays_match_reference_and_pallas(s, dtype):
    """The reference tests' decays keep |h| large (a near 1), where the
    composed carries' rounding shows most; the longest look-back, over up
    to ten chunks."""
    a, x, h0 = rglru_inputs(s, 1, s, 33, strong=False)
    xt = torch.from_numpy(x).to(dtype)
    ys, h = chunked_rglru(torch.from_numpy(a), xt, torch.from_numpy(h0),
                          T, depth=lambda c: c)
    assert_matches(ys, h, reference_and_pallas(a, xt.float().numpy(), h0,
                                               dtype), dtype)


@pytest.mark.parametrize("strong", [True, False])
@pytest.mark.parametrize("s", [2 * T + 1, 300, 640])
def test_look_back_fold_equals_chunk_by_chunk(s, strong):
    """Whatever the look-back's depth (none, all the way to h0, or any mix),
    ys and h_final agree with the chunk-by-chunk pass within f32's 1e-5, so
    they do not depend on which blocks had published when a block looked
    back."""
    a, x, h0 = (torch.from_numpy(z) for z in
                rglru_inputs(7 + s, 2, s, 40, strong))
    want_ys, want_h = chunked_rglru(a, x, h0, T)
    rng = np.random.default_rng(s)
    for depth in (lambda c: c, lambda c: int(rng.integers(0, 5))):
        ys, h = chunked_rglru(a, x, h0, T, depth)
        torch.testing.assert_close(ys, want_ys, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [3, 4])
def test_zero_decay_restarts_exactly(seed):
    """Products only: where a is exactly 0, the state restarts at x
    (bit-exact), whatever the carry; h_final equals the last ys."""
    a, x, h0 = (torch.from_numpy(z) for z in rglru_inputs(seed, 1, 200, 40))
    ys, h = chunked_rglru(a, x, h0, T, depth=lambda c: c)
    zero = a == 0.0
    assert zero.any()
    assert torch.equal(ys[zero], x[zero])
    assert torch.equal(h, ys[:, -1])


def test_strong_draw_reaches_exact_zeros_and_ones():
    a = rglru_inputs(0, 1, 64, 128)[0]
    assert (a == 0.0).mean() > 1 / 16 and (a == 1.0).any()


def test_two_chunks_through_h0_equal_one_scan():
    """A prompt cut at a length that is not a multiple of the chunk: the
    second scan starts from the first one's h_final (1e-5, as one scan)."""
    a, x, h0 = (torch.from_numpy(z) for z in rglru_inputs(11, 1, 300, 40))
    y_all, h_all = chunked_rglru(a, x, h0, T, depth=lambda c: c)
    y1, h1 = chunked_rglru(a[:, :100], x[:, :100], h0, T)
    y2, h2 = chunked_rglru(a[:, 100:], x[:, 100:], h1, T)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, h_all, rtol=1e-5, atol=1e-5)
