"""The chunked WKV6 kernel's arithmetic (``csrc/wkv6.cu``), on the CPU.

The CUDA kernel cannot run here, so its arithmetic is written out below in
plain torch, step for step as the kernel orders it: chunks of 64 steps and
sub-chunks of 16; every decay factor a running product of ``w`` inside one
chunk (forward from the start of a chunk or sub-chunk on r's side, backward
to its end on k's side; no log, no division); in the 16 x 16 diagonal
blocks the two 8 x 8 halves summed directly; the chunk products (the
off-diagonal scores and the diagonal blocks' lower-left quarters, r~·S_c,
A·V and k~ᵀ·V) in 3xTF32, with the operands rounded to TF32 as the kernel
rounds them and the tensor cores read them (hi to nearest, lo truncated);
the state passed from chunk to chunk as ``S ← P⊙S + ΔS``, or folded from
the earlier chunks' aggregates as the kernel's look-back does. That mirror
is held against the reference's ``ref_wkv6`` and its Pallas ``wkv6`` in
interpret mode, with the inputs of the card tests
(``tests/test_torch_kernels_cuda.py``): strong decays
``exp(-exp(U(-8, 5)))`` with exact zeros and ones, lengths across the chunk
edges, K/V 64/64 and 48/40. Tolerances: y ``rtol = atol = 1e-4``, the final
state ``1e-3`` (the reference's f32 WKV6 tolerances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as pallas
from repro.kernels import ref as jref

C, SUB = 64, 16  # the kernel's chunk and sub-chunk
NSUB, HALF = C // SUB, SUB // 2


def strong_wkv6_inputs(seed, b, s, h, dk, dv, strong=True):
    """numpy r, k, v, w, u, s0 (f32); with ``strong`` the decays are
    ``exp(-exp(U(-8, 5)))`` (zero in f32 past about U 4.6) with about one
    entry in 16 set to exactly 0 and one in 16 to exactly 1, else
    ``U(0.8, 0.999)`` (the reference's test draw). The same function is in
    ``tests/test_torch_kernels_cuda.py``."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = normal(b, s, h, dk), normal(b, s, h, dk), normal(b, s, h, dv)
    if strong:
        w = np.exp(-np.exp(rng.uniform(-8.0, 5.0, (b, s, h, dk))))
        pick = rng.uniform(size=w.shape)
        w[pick < 1 / 16] = 0.0
        w[pick > 15 / 16] = 1.0
    else:
        w = rng.uniform(0.8, 0.999, (b, s, h, dk))
    u, s0 = normal(h, dk), normal(b, h, dk, dv)
    return r, k, v, w.astype(np.float32), u, s0


def _tf32(x):
    """Round f32 to TF32's 10 mantissa bits, to nearest with ties away from
    zero (``cvt.rna.tf32.f32``): add half an ulp to the magnitude's bits,
    then clear the 13 dropped ones."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _trunc_tf32(x):
    """What the tensor core reads of an f32 operand: its 13 low mantissa
    bits dropped (truncation toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm3(a, b, split=True):
    """``a @ b`` as the kernel's tensor cores compute it: 3xTF32,
    ``a_hi b_hi + (a_lo b_hi + a_hi b_lo)`` with ``hi`` rounded to TF32 and
    ``lo = x - hi`` truncated to TF32 by the tensor core; without ``split``
    one plain TF32 product of the rounded operands."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    al, bl = _trunc_tf32(a - ah), _trunc_tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)


def _chunked_wkv6(r, k, v, w, u, s0, split=True, look_back=False):
    """The kernel's chunked WKV6 on f32 tensors ``[B, S, H, K|V]``: returns
    ``(y [B, S, H, V], S_final [B, H, K, V])``. Each chunk's start state
    comes from the previous chunk's (``S ← P⊙S + ΔS``), or with
    ``look_back`` as the kernel finds it when no earlier chunk has published
    its state: every earlier chunk's aggregate folded in from ``s0``,
    ``S_c = ΔS_{c-1} + P_{c-1}⊙(ΔS_{c-2} + … + P_0⊙s0)``, newest first."""
    b, s, h, dk = r.shape
    nc = -(-s // C)
    pad = nc * C - s

    def prep(z, fill):  # [B, H, nc * C, *]; past S r, k, v are 0 and w 1
        return F.pad(z.float().permute(0, 2, 1, 3), (0, 0, 0, pad),
                     value=fill)

    rr, kk, vv, ww = prep(r, 0.0), prep(k, 0.0), prep(v, 0.0), prep(w, 1.0)
    uu = u.float()[None]
    state = s0.float().clone()
    ys, aggs = [], []
    for c in range(nc):
        if look_back and c:
            acc, ap = torch.zeros_like(state), torch.ones_like(state[..., :1])
            for p_j, ds_j in reversed(aggs):
                acc = acc + ap * ds_j
                ap = ap * p_j[..., None]
            state = ap * s0.float() + acc
        rc, kc, vc, wc = (z[:, :, c * C:(c + 1) * C] for z in (rr, kk, vv, ww))
        # running products inside each sub-chunk
        fwd, bwd = torch.empty_like(wc), torch.empty_like(wc)
        wsub = []
        for q in range(NSUB):
            f = torch.ones_like(wc[:, :, 0])
            for t in range(q * SUB, (q + 1) * SUB):
                fwd[:, :, t] = f
                f = f * wc[:, :, t]
            wsub.append(f)
            bw = torch.ones_like(f)
            for t in reversed(range(q * SUB, (q + 1) * SUB)):
                bwd[:, :, t] = bw
                bw = bw * wc[:, :, t]
        wpre, wpost = [None] * NSUB, [None] * NSUB
        p = torch.ones_like(wsub[0])
        for q in range(NSUB):
            wpre[q] = p
            p = p * wsub[q]
        p_end = p
        p = torch.ones_like(wsub[0])
        for q in reversed(range(NSUB)):
            wpost[q] = p
            p = p * wsub[q]

        # the diagonal 16 x 16 blocks: their 8 x 8 halves directly (the bonus
        # on the diagonal), the lower-left 8 x 8 quarter as the product
        # (r . decay from the halves' edge)(k . decay to the edge)^T
        a = torch.zeros(b, h, C, C)
        for q in range(NSUB):
            for t0 in (q * SUB, q * SUB + HALF):
                for cs in range(t0, t0 + HALF):
                    a[:, :, cs, cs] = (rc[:, :, cs] * (uu * kc[:, :, cs])
                                       ).sum(-1)
                    kd = kc[:, :, cs]  # k_s . prod_{s<j<t} w_j
                    for row in range(cs + 1, t0 + HALF):
                        a[:, :, row, cs] = (rc[:, :, row] * kd).sum(-1)
                        kd = kd * wc[:, :, row]
            edge = q * SUB + HALF
            rf8, kb8 = [], []
            e = torch.ones_like(wsub[0])
            for t in range(edge, edge + HALF):
                rf8.append(rc[:, :, t] * e)
                e = e * wc[:, :, t]
            e = torch.ones_like(wsub[0])
            for t in reversed(range(q * SUB, edge)):
                kb8.insert(0, kc[:, :, t] * e)
                e = e * wc[:, :, t]
            a[:, :, edge:edge + HALF, q * SUB:edge] = _mm3(
                torch.stack(rf8, 2), torch.stack(kb8, 2).transpose(-1, -2),
                split)
        rf, kb = rc * fwd, kc * bwd
        # the off-diagonal blocks: (r . fwd)(k . bwd . M)^T
        for tq in range(1, NSUB):
            for sp in range(tq):
                m = torch.ones_like(wsub[0])
                for q in range(sp + 1, tq):
                    m = m * wsub[q]
                rows = slice(tq * SUB, (tq + 1) * SUB)
                cols = slice(sp * SUB, (sp + 1) * SUB)
                kt = (kb[:, :, cols] * m[:, :, None]).transpose(-1, -2)
                a[:, :, rows, cols] = _mm3(rf[:, :, rows], kt, split)
        per_row = torch.stack(wpre, 2).repeat_interleave(SUB, 2)
        ys.append(_mm3(rf * per_row, state, split) + _mm3(a, vc, split))
        per_row = torch.stack(wpost, 2).repeat_interleave(SUB, 2)
        ds = _mm3((kb * per_row).transpose(-1, -2), vc, split)
        aggs.append((p_end, ds))
        state = p_end[..., None] * state + ds
    y = torch.cat(ys, 2)[:, :, :s] if ys else rr[:, :, :0, :0].new_zeros(
        b, h, 0, v.shape[-1])
    return y.permute(0, 2, 1, 3), state


def _reference_and_pallas(arrays, s):
    jargs = [jnp.asarray(a) for a in arrays]
    return (jref.ref_wkv6(*jargs),
            pallas.wkv6(*jargs, block_s=s, interpret=True))


@pytest.mark.parametrize("s,dk,dv,strong", [
    (1, 64, 64, True), (15, 64, 64, True), (16, 64, 64, True),
    (17, 64, 64, True), (63, 64, 64, True), (64, 64, 64, True),
    (65, 64, 64, True), (129, 64, 64, True), (200, 64, 64, True),
    (65, 48, 40, True), (200, 48, 40, True),
    (200, 64, 64, False), (129, 48, 40, False),  # mild decays, large |y|
])
def test_chunked_arithmetic_matches_reference_and_pallas(s, dk, dv, strong):
    arrays = strong_wkv6_inputs(s + dk + dv, 1, s, 2, dk, dv, strong)
    got_y, got_s = _chunked_wkv6(*(torch.from_numpy(a) for a in arrays))
    assert got_y.shape == (1, s, 2, dv) and got_s.shape == (1, 2, dk, dv)
    for want_y, want_s in _reference_and_pallas(arrays, s):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("strong", [True, False])
def test_look_back_fold_equals_chunk_by_chunk(strong):
    """The look-back's longest path (every earlier aggregate folded in from
    s0) gives the start states of the chunk-by-chunk pass, so y does not
    depend on which blocks had published when a block looked back (1e-4,
    the reference's tolerance for two chunks through s0)."""
    arrays = [torch.from_numpy(a) for a in
              strong_wkv6_inputs(31, 1, 300, 2, 64, 64, strong)]
    y1, s1 = _chunked_wkv6(*arrays)
    y2, s2 = _chunked_wkv6(*arrays, look_back=True)
    torch.testing.assert_close(y2, y1, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s2, s1, rtol=1e-4, atol=1e-4)


def test_strong_decays_reach_exact_zeros_and_ones():
    """The draw covers what the chunked form must survive: w exactly 0
    (where a log-space form takes log 0) and exactly 1."""
    w = strong_wkv6_inputs(0, 1, 64, 2, 64, 64)[3]
    assert (w == 0.0).mean() > 1 / 16 and (w == 1.0).any()


def test_single_tf32_misses_the_f32_tolerance():
    """One plain TF32 product per chunk product, on the same mild-decay
    input the 3xTF32 mirror passes, misses y's 1e-4: the split is what
    holds f32's tolerance."""
    arrays = strong_wkv6_inputs(200 + 128, 1, 200, 2, 64, 64, strong=False)
    want_y, _ = _reference_and_pallas(arrays, 200)[0]
    got_y, _ = _chunked_wkv6(*(torch.from_numpy(a) for a in arrays),
                             split=False)
    err = np.abs(got_y.numpy() - np.asarray(want_y))
    assert not np.all(err <= 1e-4 + 1e-4 * np.abs(np.asarray(want_y)))


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-11 + 2**-20, -(1.0 + 2**-11),
                      1.0 + 2**-12, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10), 1.0,
                         3.0])
    assert torch.equal(_tf32(x), want)
