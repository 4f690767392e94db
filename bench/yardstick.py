"""The benchmark's yardstick: the card's peaks and the work a sweep step
needs, counted from the cell's shapes whatever implements the step.

Frozen copies, kept with the benchmark so that a change to the program
cannot move them: :func:`sort_search_ops` and :func:`neighbor_cost` are
the program's own neighbour-search costing as it stood when the benchmark
was written; the byte counts follow the dtypes of the simulator's state.
"""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA's data sheet, dense, at 700 W): HBM3
# bandwidth, and the float32 rate outside the tensor cores (the sweep has
# no matrix products)
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# bytes of one vehicle slot of the simulator's state: pos, vel, v0, T,
# a_max, b_comf, s0, politeness (f32), lane, cooldown (i32), active,
# is_cav (bool)
SLOT_BYTES = 8 * 4 + 2 * 4 + 2 * 1
# bytes of an instance's own state fields: the PRNG key (two int64 words)
# and the step counter (i32)
INSTANCE_STATE_BYTES = 2 * 8 + 4
# ten [B] accumulators, each 4 bytes (i32 or f32)
METRICS_BYTES = 10 * 4
# the IDM formula's operations, and the evaluations a step needs a slot:
# own lane before the moves, three for each of MOBIL's two candidate lanes
# (the ego, its new and its old follower), own lane after the moves
IDM_OPS = 16
IDM_EVALS = 8
# the integration's operations a slot: v + a dt, clamp, p + v dt
INTEGRATE_OPS = 4


def least_time_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes over the memory rate, or
    operations over the float32 rate, whichever is longer."""
    return max(nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S)


def sort_search_ops(b: int, n: int, searches: int) -> int:
    """Comparisons the lead/follower search needs at least: a comparison
    sort of each instance's n keys (n log2 n) and one binary search (log2
    n) for each of ``searches`` queries a slot."""
    lg = max(1, (n - 1).bit_length())
    return b * n * lg * (1 + searches)


def neighbor_cost(b: int, n: int, q: int,
                  query_lanes: bool) -> tuple[int, int]:
    """(ops, bytes) of one neighbour search: a sort and q searches a slot;
    pos, lane and active read, six [B, Q, N] outputs (18 bytes an entry)
    written, the query lanes read where given."""
    nbytes = b * n * (4 + 4 + 1) + b * q * n * 18 + (b * q * n * 4
                                                     if query_lanes else 0)
    return sort_search_ops(b, n, q), nbytes


def neighbor_ms(b: int, n: int, q: int, query_lanes: bool) -> float:
    """The least time of one neighbour search, in ms."""
    ops, nbytes = neighbor_cost(b, n, q, query_lanes)
    return least_time_s(nbytes, ops) * 1e3


def state_bytes(b: int, n: int) -> int:
    """Bytes of a simulator state of ``b`` instances of ``n`` slots."""
    return b * (n * SLOT_BYTES + INSTANCE_STATE_BYTES)


def params_bytes(b: int, n_lanes: int) -> int:
    """Bytes of ``b`` instances' draws: the per-lane arrival rates, five
    f32 scalars and the int64 instance seed."""
    return b * (n_lanes * 4 + 6 * 4 + 8)


def trace_row_bytes(n_fields: int, k_slots: int) -> int:
    """Bytes of one recorded row: the f32 channels, and each recorded
    slot's lane (i32), speed (f32) and active (bool)."""
    return n_fields * 4 + k_slots * (4 + 4 + 1)


def step_work(b: int, n: int, n_lanes: int, n_lanes_total: int,
              record=None) -> tuple[float, float]:
    """(ops, bytes) one step of ``b`` instances needs: the state and the
    accumulators read once and written once, the draws and the horizon
    read once, the step's share of the trace rows written (one row every
    ``record["every"]`` steps); the neighbour searches (a table of
    ``n_lanes_total`` lanes and one query), the IDM evaluations and the
    integration."""
    nbytes = (2 * state_bytes(b, n) + 2 * b * METRICS_BYTES
              + params_bytes(b, n_lanes) + b * 4)
    if record:
        nbytes += (b * trace_row_bytes(len(record["fields"]), record["k_slots"])
                   / record["every"])
    ops = (sort_search_ops(b, n, n_lanes_total) + sort_search_ops(b, n, 1)
           + b * n * (IDM_EVALS * IDM_OPS + INTEGRATE_OPS))
    return ops, nbytes
