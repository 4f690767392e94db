"""Neighborhood engine parity: every port impl (including the ``cuda``
impl's CPU plain path) is bit-exact against the reference's tables, built
by its Pallas kernel in interpret mode and by ``neighbor_info``; the port's
IDM oracle is held against the reference's Pallas IDM kernel. Worlds have
forced exact position ties, inactive slots, and several instances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.neighbors import build_tables as j_build_tables
from repro.core.neighbors import neighbor_info as j_neighbor_info
from repro.kernels.idm import idm_accel_kernel as j_idm_accel_kernel
from repro.kernels.idm import neighbor_kernel as j_neighbor_kernel
from repro_torch.core.neighbors import IMPLS, build_tables, query_lanes
from repro_torch.kernels import idm, ref

L = 4  # 3 main lanes + ramp
B = 3
FIELDS = ("lead_idx", "lead_gap", "has_lead", "foll_idx", "foll_gap",
          "has_foll")


def rand_worlds(seed, b, n, p_act=0.8):
    """``b`` numpy worlds with forced exact position ties and inactive
    slots (mirrors tests/test_neighbors.py)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 900.0, (b, n)).astype(np.float32)
    lane = rng.integers(0, L, (b, n)).astype(np.int32)
    if n > 4:
        pos[:, 1] = pos[:, 0]
        pos[:, 4] = pos[:, 0]
        lane[:, 1] = lane[:, 0]
        lane[:, 4] = lane[:, 0]
    active = rng.uniform(size=(b, n)) < p_act
    return pos, lane, active


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_same(ref_fields, got_fields, msg):
    for name, a, b in zip(FIELDS, ref_fields, got_fields):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, f"{msg} {name}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} field={name}")


@pytest.mark.parametrize("n", [8, 16, 48, 200])
@pytest.mark.parametrize("seed", [0, 1])
def test_tables_match_pallas_interpret_bitwise(n, seed):
    pos, lane, active = rand_worlds(seed * 1000 + n, B, n)
    want = [
        j_build_tables(pos[b], lane[b], active[b], 4.5, L, "pallas",
                       interpret=True)
        for b in range(B)
    ]
    want = [np.stack([np.asarray(w[f]) for w in want]) for f in range(6)]
    for impl in IMPLS:
        got = build_tables(t(pos), t(lane), t(active), 4.5, L, impl)
        assert_same(want, got, f"{impl} n={n}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [16, 64])
def test_query_lanes_match_neighbor_info_bitwise(impl, n):
    pos, lane, active = rand_worlds(77 + n, B, n)
    qv = np.random.default_rng(123 + n).integers(0, L, (B, n)).astype(np.int32)
    want = [j_neighbor_info(pos[b], lane[b], active[b], 4.5, qv[b])
            for b in range(B)]
    want = [np.stack([np.asarray(w[f]) for w in want]) for f in range(6)]
    got = query_lanes(t(pos), t(lane), t(active), 4.5, t(qv), impl,
                      n_lanes_total=L)
    assert_same(want, got, impl)


@pytest.mark.parametrize("n", [8, 48, 200])
def test_neighbor_kernel_plain_path_matches_pallas(n):
    """The wrapper's CPU path (the kernel's plain version) against the
    reference's multi-query Pallas kernel, Q = 2 arbitrary query rows."""
    pos, lane, active = rand_worlds(5 + n, B, n)
    ql = np.random.default_rng(9).integers(0, L, (B, 2, n)).astype(np.int32)
    want = [j_neighbor_kernel(pos[b], lane[b], active[b], ql[b], veh_len=4.5,
                              interpret=True) for b in range(B)]
    want = [np.stack([np.asarray(w[f]) for w in want]) for f in range(6)]
    before = dict(idm.launches)
    got = idm.neighbor_kernel(t(pos), t(lane), t(active), t(ql), veh_len=4.5)
    assert idm.launches == before  # the plain path is not a kernel launch
    assert_same(want, got, "neighbor_kernel")


def idm_inputs(seed, b, n):
    pos, lane, active = rand_worlds(seed, b, n)
    rng = np.random.default_rng(seed + 1)

    def u(lo, hi):
        return rng.uniform(lo, hi, (b, n)).astype(np.float32)

    return (pos, u(0.0, 35.0), lane, active, u(20.0, 35.0), u(0.8, 1.8),
            u(1.0, 2.5), u(1.5, 3.0), u(1.0, 2.5))


@pytest.mark.parametrize("n", [16, 48, 200])
def test_ref_idm_accel_matches_pallas(n):
    """rtol = atol = 1e-5 (the repo's own IDM kernel-vs-oracle tolerance):
    the reference's compiler fuses the epilogue's multiply-adds, the port's
    plain version rounds every operation separately."""
    args = idm_inputs(n, B, n)
    want = np.stack([
        np.asarray(j_idm_accel_kernel(*(a[b] for a in args), veh_len=4.5,
                                      interpret=True))
        for b in range(B)
    ])
    got = ref.ref_idm_accel(*(t(a) for a in args), 4.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cuda_wrappers_reject_other_devices():
    pos, lane, active = rand_worlds(0, 1, 8)
    with pytest.raises(ValueError):
        idm.neighbor_kernel(t(pos).to("meta"), t(lane), t(active),
                            t(lane)[:, None])


def test_reference_oracle_is_jax_neighbor_info():
    """Sanity: the interpret-mode Pallas tables equal the reference oracle
    on one world (so the parity above is against the contract itself)."""
    pos, lane, active = rand_worlds(42, 1, 48)
    tabs = j_build_tables(pos[0], lane[0], active[0], 4.5, L, "pallas",
                          interpret=True)
    for l in range(L):
        q = jnp.full((48,), l, jnp.int32)
        want = j_neighbor_info(pos[0], lane[0], active[0], 4.5, q)
        got = tabs.query(q)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
