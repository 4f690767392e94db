"""The IDM kernel's sort-and-search algorithm, on the CPU.

Up to 8192 slots the CUDA ``idm_accel_kernel`` (``csrc/idm.cu``,
``idm_accel_sort``) answers each ego's lead search as the neighbor kernel
does: the instance's 64-bit (lane, position) keys, sorted with their slots
by the same bitonic network, then one search per ego for its own key; the
lead is the first entry past the ego's tie group if it lies in the ego's
lane, and among the following entries of the lane whose rounded f32 gap
equals the first one's, the lowest slot. That slot's velocity enters the
IDM epilogue, which rounds every f32 operation on its own. The kernel
cannot run here, so the mirror below writes it out in numpy, reusing the
neighbor kernel's mirror (``tests/test_torch_neighbor_rows.py``: keys,
sort, search, tie walk).

The mirror's lead index is held bit for bit against the first-index argmin
of the masked all-pairs gaps (the all-pairs CUDA form, the reference's
``ref_idm_accel`` and its Pallas kernel all take it), and its accelerations
within rtol = atol = 1e-6 of the reference's Pallas ``idm_accel_kernel`` in
interpret mode, the reference's ``ref_idm_accel`` and the port's plain
version, on random worlds with forced position ties and inactive egos, on
gaps that round together, a lane with one vehicle, negative and signed-zero
positions, and N in {1, 31, 128, 200}.
"""

import numpy as np
import pytest
import torch

from repro.kernels.idm import idm_accel_kernel as j_idm_accel_kernel
from repro.kernels.ref import ref_idm_accel as j_ref_idm_accel
from repro_torch.kernels import idm, ref
from test_torch_neighbor_rows import (  # noqa: E402  (the neighbor mirror)
    INF,
    MAX_KEY,
    collapse_world,
    lower_bound,
    lowest_slot,
    rand_worlds,
    sort_key,
    sort_keys,
    t,
)

VEH_LEN = np.float32(4.5)
TOL = dict(rtol=1e-6, atol=1e-6)


def idm_params(seed, b, n):
    """Velocities and driver parameters ``[b, n]``, drawn as the sweep's
    ranges (``tests/test_torch_neighbors.py::idm_inputs``)."""
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, (b, n)).astype(np.float32)

    return (u(0.0, 35.0), u(20.0, 35.0), u(0.8, 1.8), u(1.0, 2.5),
            u(1.5, 3.0), u(1.0, 2.5))


def world(name):
    """``(pos, lane, active)`` of a named world."""
    if name.startswith("rand"):
        n = int(name.split("-")[1])
        return rand_worlds(7 * n + 1, 2, n)
    if name == "collapse":
        # lane 0: slots 1 (farther) and 2 (nearer) ahead of slot 0, their
        # gaps rounding to one f32 value: the lead is slot 1
        return collapse_world()
    if name == "signed":
        # below 0, and -0 beside +0 in one lane (one position to the key)
        pos, lane, active = rand_worlds(9, 2, 40)
        pos = (pos - 450.0).astype(np.float32)
        pos[:, 7], pos[:, 8], lane[:, 8] = -0.0, 0.0, lane[:, 7]
        active[:, 7:9] = True
        return pos, lane, active
    if name == "lone":
        # lane 3 holds one active vehicle (slot 5); inactive ones beside it
        pos, lane, active = rand_worlds(11, 2, 24, lanes=3)
        lane[:, 5], lane[:, 9], lane[:, 17] = 3, 3, 3
        active[:, 5], active[:, 9], active[:, 17] = True, False, False
        assert ((lane == 3) & active).sum(1).tolist() == [1, 1]
        return pos, lane, active
    raise ValueError(name)


def argmin_lead(pos, lane, active):
    """The first-index argmin of the masked all-pairs f32 gaps ahead:
    ``(lead_idx, has_lead)``, ``[B, N]`` (0 where there is no lead)."""
    d = pos[:, None, :] - pos[:, :, None]          # [B, ego, other], f32
    ok = ((lane[:, None, :] == lane[:, :, None]) & active[:, None, :]
          & active[:, :, None] & (d > 0))
    dm = np.where(ok, d, INF)
    has = ok.any(-1)
    return np.where(has, dm.argmin(-1), 0).astype(np.int32), has


def epilogue(v, v0, T, a_max, b_comf, s0, lg, vlead):
    """The kernel's ``idm_epilogue`` on f32 arrays, every operation rounded
    on its own; ``lg`` is INF where there is no lead."""
    f = np.float32
    has = lg < f(0.5) * INF
    gap = np.maximum(np.where(has, lg - VEH_LEN, INF), f(0.1))
    dv = np.where(has, v - vlead, f(0.0))
    denom = f(2.0) * np.sqrt(a_max * b_comf)
    push = v * T + (v * dv) / denom
    s_star = s0 + np.maximum(f(0.0), push)
    r = v / np.maximum(v0, f(0.1))
    r2 = r * r
    q = s_star / gap
    return a_max * ((f(1.0) - r2 * r2) - q * q)


def mirror(pos, vel, lane, active, v0, T, a_max, b_comf, s0):
    """The kernel's sort, own-key search and tie walk, then the epilogue:
    ``(lead_idx, has_lead, acc)``, each ``[B, N]``."""
    b, n = pos.shape
    size = 32
    while size < n:
        size *= 2
    lead = np.zeros((b, n), np.int32)
    has = np.zeros((b, n), bool)
    lg = np.full((b, n), INF, np.float32)
    vlead = np.zeros((b, n), np.float32)
    for bi in range(b):
        key = np.full(size, MAX_KEY, np.uint64)
        key[:n] = np.where(active[bi], sort_key(lane[bi], pos[bi]), MAX_KEY)
        keys, slots = sort_keys(key)
        m = int(active[bi].sum())
        for i in np.flatnonzero(active[bi]):
            tk = sort_key(lane[bi, i:i + 1], pos[bi, i:i + 1])[0]
            lane_b = tk >> np.uint64(32)
            c = lower_bound(keys, m, tk)
            while c < m and keys[c] == tk:     # pos_i's tie group
                c += 1
            if c < m and (keys[c] >> np.uint64(32)) == lane_b:
                li, d = lowest_slot(keys, slots, c, 1, m, lane_b, pos[bi, i])
                lead[bi, i], has[bi, i], lg[bi, i] = li, True, d
                vlead[bi, i] = vel[bi, li]     # s_vel, staged by slot
    return lead, has, epilogue(vel, v0, T, a_max, b_comf, s0, lg, vlead)


def inputs(name):
    pos, lane, active = world(name)
    vel, v0, T, a_max, b_comf, s0 = idm_params(len(name), *pos.shape)
    return pos, vel, lane, active, v0, T, a_max, b_comf, s0


@pytest.mark.parametrize("name", ["rand-1", "rand-31", "rand-128", "rand-200",
                                  "collapse", "signed", "lone"])
def test_sort_mirror_matches_argmin_and_pallas(name):
    """The lead index bit for bit against the all-pairs first-index argmin;
    the accelerations within 1e-6 of the reference's Pallas kernel
    (interpret mode), its ``ref_idm_accel`` and the port's plain version."""
    args = inputs(name)
    pos, vel, lane, active = args[:4]
    lead, has, acc = mirror(*args)
    want_lead, want_has = argmin_lead(pos, lane, active)
    np.testing.assert_array_equal(has, want_has)
    np.testing.assert_array_equal(lead, want_lead)
    pallas = np.stack([np.asarray(j_idm_accel_kernel(
        *(a[b] for a in args), veh_len=4.5, interpret=True))
        for b in range(pos.shape[0])])
    jref = np.stack([np.asarray(j_ref_idm_accel(*(a[b] for a in args),
                                                veh_len=4.5))
                     for b in range(pos.shape[0])])
    plain = ref.ref_idm_accel(*(t(a) for a in args), 4.5).numpy()
    assert np.isfinite(acc).all() and acc.dtype == np.float32
    np.testing.assert_allclose(acc, pallas, err_msg="pallas", **TOL)
    np.testing.assert_allclose(acc, jref, err_msg="jax ref", **TOL)
    np.testing.assert_allclose(acc, plain, err_msg="plain", **TOL)


def test_gaps_that_round_together_carry_the_lowest_slots_velocity():
    """Vehicle 0's gaps to slots 1 (farther) and 2 (nearer) round to one f32
    value: the lead is slot 1, and its velocity, not slot 2's, makes dv.
    With the nearer vehicle's velocity the acceleration would differ."""
    args = list(inputs("collapse"))
    vel = args[1]
    vel[0, :3] = np.float32([30.0, 5.0, 25.0])   # lead's dv differs by 20
    lead, has, acc = mirror(*args)
    assert has[0, 0] and lead[0, 0] == 1
    pallas = np.asarray(j_idm_accel_kernel(*(a[0] for a in args), veh_len=4.5,
                                           interpret=True))
    np.testing.assert_allclose(acc[0], pallas, **TOL)
    wrong = args[1].copy()
    wrong[0, 1] = wrong[0, 2]                    # the nearer one's velocity
    _, _, acc_wrong = mirror(args[0], wrong, *args[2:])
    assert abs(float(acc_wrong[0, 0]) - float(acc[0, 0])) > 1e-3


def test_wrapper_on_cpu_runs_the_plain_version_and_the_oracle_needs_cuda():
    """On CPU tensors ``idm_accel_kernel`` is the plain version (no launch
    counted); the all-pairs oracle takes CUDA tensors only."""
    args = [t(a) for a in inputs("rand-31")]
    before = dict(idm.launches)
    got = idm.idm_accel_kernel(*args, veh_len=4.5)
    assert torch.equal(got, ref.ref_idm_accel(*args, 4.5))
    assert idm.launches == before
    with pytest.raises(ValueError):
        idm._idm_accel_wide(*args, veh_len=4.5)
