"""The neighbor kernel's rows mode and its sort-and-search algorithm, on the
CPU.

Rows mode: ``neighbor_kernel(pos, lane, active, None, n_rows=L)`` asks row
q for every vehicle's neighbours in lane q (a per-lane table), without a
``[B, L, N]`` query-lane tensor. On CPU tensors it must equal explicit
rows and the reference's Pallas ``neighbor_kernel`` in interpret mode, bit
for bit.

The CUDA kernel (``csrc/idm.cu``) cannot run here, so its algorithm is
written out below in numpy, in the kernel's order: 64-bit keys (the lane's
bits with the sign flipped, above the position made order-preserving, -0
folded into +0), a bitonic sort of the keys (each with its slot) over the
next power of two P at or above max(N, 32) entries (up to 128, runs of 32
sorted by the network and merged by rank), per (row, ego) the number of
keys below its key by a branchless search, then from the first entry past
pos_i's tie group (lead) and from the last entry before it (follower) a
walk over the entries of the lane whose rounded f32 gap equals the first
one's, keeping the lowest slot. That mirror is held bit for bit against
the reference's ``neighbor_info`` (the masked all-pairs argmin), with
forced position ties, inactive slots, query lanes that no vehicle drives
in, and positions whose gaps to an ego round to one f32 value (where the
nearest position is not the nearest gap).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.neighbors import neighbor_info as j_neighbor_info
from repro.kernels.idm import neighbor_kernel as j_neighbor_kernel
from repro_torch.core.neighbors import build_tables
from repro_torch.kernels import idm

L = 4  # 3 main lanes + ramp
INF = np.float32(1e9)
FIELDS = ("lead_idx", "lead_gap", "has_lead", "foll_idx", "foll_gap",
          "has_foll")
MAX_KEY = np.uint64(2**64 - 1)


def rand_worlds(seed, b, n, p_act=0.8, lanes=L):
    """``b`` numpy worlds with forced exact position ties and inactive
    slots (as tests/test_torch_neighbors.py draws them)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 900.0, (b, n)).astype(np.float32)
    lane = rng.integers(0, lanes, (b, n)).astype(np.int32)
    if n > 4:
        pos[:, 1] = pos[:, 0]
        pos[:, 4] = pos[:, 0]
        lane[:, 1] = lane[:, 0]
        lane[:, 4] = lane[:, 0]
    active = rng.uniform(size=(b, n)) < p_act
    return pos, lane, active


def collapse_world():
    """Lane 0: two vehicles ahead of vehicle 0 whose gaps to it round to one
    f32 value, the farther in the lower slot (1); lane 1: two behind
    vehicle 3 alike (the farther in slot 4); lane 2: a tie pair. The
    all-pairs argmin answers the lower slot, a search for the nearest
    position the other one."""
    e = np.float32(2.0**-24)
    p1 = np.float32(1.0 + 2.0**-22)      # an even mantissa
    p2 = np.float32(1.0 + 3 * 2.0**-23)  # one ulp above
    g = np.float32(2.0**-20)             # the f32 grid just below 16
    q1, q2 = np.float32(1.5) * g, np.float32(2.5) * g
    assert p2 - e == p1 - e and np.float32(16.0) - q1 == np.float32(16.0) - q2
    pos = np.array([[e, p2, p1, 16.0, q1, q2, 5.0, 5.0]], np.float32)
    lane = np.array([[0, 0, 0, 1, 1, 1, 2, 2]], np.int32)
    active = np.ones((1, 8), bool)
    return pos, lane, active


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def reference(pos, lane, active, query_lanes):
    """The reference's ``neighbor_info`` per instance and row: six numpy
    ``[B, Q, N]`` arrays."""
    rows = [[j_neighbor_info(pos[b], lane[b], active[b], 4.5, query_lanes[b, q])
             for q in range(query_lanes.shape[1])]
            for b in range(pos.shape[0])]
    return [np.stack([np.stack([np.asarray(r[f]) for r in per_b])
                      for per_b in rows]) for f in range(6)]


def sort_key(lane, pos):
    """The kernel's ``sort_key`` on numpy int32 lanes and f32 positions."""
    bits = pos.astype(np.float32).view(np.uint32).copy()
    bits[bits == 0x80000000] = 0
    neg = (bits & 0x80000000) != 0
    order = np.where(neg, ~bits, bits | np.uint32(0x80000000))
    lane_b = lane.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    return (lane_b.astype(np.uint64) << np.uint64(32)) | order.astype(np.uint64)


def key_pos(key):
    order = (key & np.uint64(0xffffffff)).astype(np.uint32)
    neg = (order & 0x80000000) == 0
    return np.where(neg, ~order, order ^ np.uint32(0x80000000)).view(np.float32)


def bitonic(key, slot, run=None):
    """The kernel's bitonic network over keys with their slots; P a power
    of two. Each stage is the compare-exchange ``exchange`` of csrc/idm.cu
    applied to every element at once; it compares keys only, so equal keys
    may end in any slot order (the thread layout, E keys a thread, does not
    change the network). With ``run`` the network stops once every run of
    that many keys is sorted, each ascending."""
    p = np.arange(key.size)
    run = run or key.size
    k = 2
    while k <= run:
        direction = key.size if k == run else k
        j = k // 2
        while j >= 1:
            ko, so = key[p ^ j], slot[p ^ j]
            up, low = (p & direction) == 0, (p & j) == 0
            take = np.where(low == up, ko < key, key < ko)
            key, slot = np.where(take, ko, key), np.where(take, so, slot)
            j //= 2
        k *= 2
    return key, slot


def sort_keys(key):
    """The kernel's sort of P keys with their slots: up to 128 keys, runs
    of 32 sorted by the network and merged by rank (each key's place: its
    place in its run plus, in each other run, the keys below it, or at or
    below it in the runs before its own); else the whole network."""
    size = key.size
    if size > 128:
        return bitonic(key, np.arange(size))
    keys, slots = bitonic(key, np.arange(size), 32)
    place = np.arange(size) % 32
    for i in range(size):
        own = i // 32
        for u in range(size // 32):
            run = keys[u * 32:(u + 1) * 32]
            if u < own:
                place[i] += int(np.searchsorted(run, keys[i], "right"))
            elif u > own:
                place[i] += int(np.searchsorted(run, keys[i], "left"))
    assert sorted(place) == list(range(size))   # every place taken once
    out_k, out_s = np.empty_like(keys), np.empty_like(slots)
    out_k[place], out_s[place] = keys, slots
    return out_k, out_s


def lowest_slot(keys, slots, c, step, m, lane_b, pos_i):
    def gap(kc):
        pc = key_pos(np.array([kc], np.uint64))[0]
        return np.float32(pc - pos_i) if step > 0 else np.float32(pos_i - pc)

    d = gap(keys[c])
    best = slots[c]
    c += step
    while 0 <= c < m and (keys[c] >> np.uint64(32)) == lane_b \
            and gap(keys[c]) == d:
        best = min(best, slots[c])
        c += step
    return best, d


def lower_bound(keys, m, tk):
    """The kernel's branchless search of all P keys: the number of sorted
    keys below ``tk``."""
    size = keys.size
    lo, s = 0, size // 2
    while s > 0:   # the branchless search over all P keys
        if keys[lo + s - 1] < tk:
            lo += s
        s //= 2
    return min(lo + int(keys[lo] < tk), m)


def mirror(pos, lane, active, query_lanes, veh_len=np.float32(4.5)):
    """The kernel's sort and search on numpy worlds ``[B, N]`` and query
    lanes ``[B, Q, N]``: six ``[B, Q, N]`` arrays."""
    b, n = pos.shape
    q = query_lanes.shape[1]
    size = 32
    while size < n:
        size *= 2
    out = [np.zeros((b, q, n), dt) for dt in
           (np.int32, np.float32, bool, np.int32, np.float32, bool)]
    for bi in range(b):
        key = np.full(size, MAX_KEY, np.uint64)
        key[:n] = np.where(active[bi], sort_key(lane[bi], pos[bi]), MAX_KEY)
        keys, slots = sort_keys(key)
        m = int(active[bi].sum())
        for qi in range(q):
            for i in range(n):
                lg = fg = INF
                li = fi = 0
                hl = hf = False
                if active[bi, i]:
                    tk = sort_key(query_lanes[bi, qi, i:i + 1],
                                  pos[bi, i:i + 1])[0]
                    lane_b = tk >> np.uint64(32)
                    lo = lower_bound(keys, m, tk)
                    c = lo
                    while c < m and keys[c] == tk:
                        c += 1
                    if c < m and (keys[c] >> np.uint64(32)) == lane_b:
                        hl = True
                        li, lg = lowest_slot(keys, slots, c, 1, m, lane_b,
                                             pos[bi, i])
                    c = lo - 1
                    if c >= 0 and (keys[c] >> np.uint64(32)) == lane_b:
                        hf = True
                        fi, fg = lowest_slot(keys, slots, c, -1, m, lane_b,
                                             pos[bi, i])
                for arr, val in zip(out, (li, np.float32(lg - veh_len), hl, fi,
                                          np.float32(fg - veh_len), hf)):
                    arr[bi, qi, i] = val
    return out


def rows(b, q, n):
    return np.broadcast_to(np.arange(q, dtype=np.int32)[None, :, None],
                           (b, q, n)).copy()


def assert_same(want, got, msg):
    for name, a, b in zip(FIELDS, want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{msg} {name}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} field={name}")


@pytest.mark.parametrize("n", [1, 8, 48, 200])
@pytest.mark.parametrize("q", [1, L, 6])
def test_rows_mode_matches_explicit_rows_and_pallas(n, q):
    """Row q queries lane q: equal to passing those rows, and to the
    reference's Pallas kernel (interpret mode) on them; rows past the lanes
    in use find no neighbours."""
    pos, lane, active = rand_worlds(n + 10 * q, 3, n)
    got = idm.neighbor_kernel(t(pos), t(lane), t(active), None, n_rows=q)
    explicit = idm.neighbor_kernel(t(pos), t(lane), t(active),
                                   t(rows(3, q, n)))
    assert_same([x.numpy() for x in explicit], [x.numpy() for x in got],
                "rows vs explicit")
    want = [j_neighbor_kernel(pos[b], lane[b], active[b], rows(1, q, n)[0],
                              veh_len=4.5, interpret=True) for b in range(3)]
    want = [np.stack([np.asarray(w[f]) for w in want]) for f in range(6)]
    want[2], want[5] = want[2] != 0, want[5] != 0   # Pallas returns i32 flags
    assert_same(want, [x.numpy() for x in got], "rows vs pallas")


def test_rows_mode_tables_match_the_reference_impls():
    """``build_tables(..., "cuda")`` on CPU tensors goes through rows mode:
    equal to the plain all-pairs tables."""
    pos, lane, active = rand_worlds(5, 4, 64)
    a = build_tables(t(pos), t(lane), t(active), 4.5, L, "cuda")
    b = build_tables(t(pos), t(lane), t(active), 4.5, L, "reference")
    assert_same([x.numpy() for x in b], [x.numpy() for x in a], "tables")


def test_rows_and_query_lanes_are_exclusive():
    pos, lane, active = (t(z) for z in rand_worlds(0, 1, 8))
    with pytest.raises(ValueError):
        idm.neighbor_kernel(pos, lane, active, lane[:, None], n_rows=1)
    with pytest.raises(ValueError):
        idm.neighbor_kernel(pos, lane, active, None)


@pytest.mark.parametrize("n", [1, 5, 33, 200])
@pytest.mark.parametrize("mode", ["rows", "lanes"])
def test_sort_and_search_mirror_matches_neighbor_info(n, mode):
    """The kernel's algorithm, bit for bit against the all-pairs oracle:
    rows mode, and arbitrary query lanes (some lanes no vehicle drives in,
    negative ones)."""
    pos, lane, active = rand_worlds(3 * n, 2, n)
    if mode == "rows":
        ql = rows(2, L + 1, n)
    else:
        ql = np.random.default_rng(n).integers(-1, L + 1, (2, 3, n)).astype(
            np.int32)
    assert_same(reference(pos, lane, active, ql),
                mirror(pos, lane, active, ql), mode)


def test_mirror_with_negative_and_signed_zero_positions():
    """Positions below 0 and -0 (which the key folds into +0: a vehicle
    at -0 and one at +0 are at one position, neither ahead of the other)."""
    pos, lane, active = rand_worlds(9, 2, 40)
    pos = (pos - 450.0).astype(np.float32)
    pos[:, 7], pos[:, 8], lane[:, 8], active[:, 7:9] = -0.0, 0.0, lane[:, 7], True
    ql = rows(2, L, 40)
    assert_same(reference(pos, lane, active, ql),
                mirror(pos, lane, active, ql), "signed")


def test_gaps_that_round_together_take_the_lowest_slot():
    """Where two positions' gaps round to one f32 value, the oracle takes
    the lower slot, which is not the nearer position: the mirror and the
    wrapper's plain path agree with it, and so does the reference's Pallas
    kernel."""
    pos, lane, active = collapse_world()
    ql = lane[:, None]
    want = reference(pos, lane, active, ql)
    assert want[0][0, 0, 0] == 1 and want[3][0, 0, 3] == 4   # not 2, not 5
    assert_same(want, mirror(pos, lane, active, ql), "mirror")
    got = idm.neighbor_kernel(t(pos), t(lane), t(active), t(ql))
    assert_same(want, [x.numpy() for x in got], "plain path")
    pal = j_neighbor_kernel(pos[0], lane[0], active[0], ql[0], veh_len=4.5,
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(pal[0]), want[0][0])
    np.testing.assert_array_equal(np.asarray(pal[3]), want[3][0])


@pytest.mark.parametrize("size", [32, 64, 128, 256])
def test_sort_sorts(size):
    """The network (and, up to 128 keys, the merge of its runs) sorts,
    with each slot kept beside its key, also among many equal keys."""
    rng = np.random.default_rng(size)
    key = rng.integers(0, 6, size).astype(np.uint64)   # many equal keys
    got_k, got_s = sort_keys(key)
    np.testing.assert_array_equal(got_k, np.sort(key))
    np.testing.assert_array_equal(np.sort(got_s), np.arange(size))
    np.testing.assert_array_equal(key[got_s], got_k)   # slots stay with keys
