"""The metric readers' arithmetic. Each metric of ``BENCHMARK.json`` has a
file of its own, ``bench/metrics/<name>.py``, whose ``read`` is one of
these: a quantity that two kinds of cell report under two names (their
end-to-end metrics differ) shares its code here. A reader returns None
where it finds nothing to read, and never 0 for a share of a roofline."""

from bench.trace import busy_ns
from bench.yardstick import least_time_s, neighbor_ms, step_work

NEIGHBOR_KERNEL = "neighbor_mq"


def instance_steps_per_s(run):
    """Instance-steps simulated within their horizons in the window, over
    all the time of the window (host clock)."""
    return run.instance_steps / run.window_s


def setup_s(run):
    """From the process's start to the window's (host clock): imports,
    CUDA context, the kernel build or load, the draws, the warm-up."""
    return run.setup_s


def supervisor_ms_per_chunk(run):
    """Host ms a chunk spends in the fleet supervisor (``run_supervised``)
    outside ``SweepRunner.run_chunk``, from the benchmark's spans around
    each ``run_chunk`` call; it includes the wait at the chunk's
    completion bitmap for the device to finish what the runner enqueued."""
    if not run.chunks:
        return None
    inside = sum(e - s for _, s, e in run.spans)
    return (run.window_end_ns - run.window_start_ns - inside) / run.chunks / 1e6


def kernels_per_step(run):
    """Device operations (kernels, copies, memsets) in the traced window
    per simulated step, from the profiler's trace."""
    if not run.device_events or not run.steps:
        return None
    return len(run.device_events) / run.steps


def device_idle_share(run):
    """The share of the traced window in which no device operation runs,
    in %."""
    if not run.device_events:
        return None
    busy = busy_ns(run.device_events, run.window_start_ns, run.window_end_ns)
    return 100.0 * (1.0 - busy / (run.window_end_ns - run.window_start_ns))


def device_ms_per_step(run):
    """Device ms a simulated step of the whole batch takes: the time in
    which some device operation ran in the window, over its steps, from
    the profiler's trace. It bounds the rate once the host keeps the card
    fed; where the host paces the cell it is steadier than the host clock's
    rate."""
    if not run.device_events or not run.steps:
        return None
    busy = busy_ns(run.device_events, run.window_start_ns, run.window_end_ns)
    return busy / run.steps / 1e6


def _least_step_s(run) -> float:
    """The least time one step needs (the larger of its bytes over the HBM
    rate and its operations over the float32 rate, counted from the cell's
    shapes by :func:`bench.yardstick.step_work`, whatever implements the
    step)."""
    ops = nbytes = 0.0
    for g in run.groups:
        o, b = step_work(g["rows"], g["n_slots"], g["n_lanes"],
                         g["n_lanes_total"], run.traffic["record"])
        ops, nbytes = ops + o, nbytes + b
    return least_time_s(nbytes, ops)


def roofline_mfu(run):
    """The whole sim step's share of the card's roofline, in %: the least
    time a step needs over the measured time per step (the traced window
    over its steps)."""
    if run.device_events is None or not run.steps:
        return None  # not on a card
    return 100.0 * _least_step_s(run) / (run.window_s / run.steps)


def roofline_mfu_device(run):
    """The whole sim step's share of the card's roofline, in %, where the
    host paces the cell: the least time a step needs over the device time
    a step takes (:func:`device_ms_per_step`), the share that metric
    bounds."""
    device_ms = device_ms_per_step(run)
    if device_ms is None:
        return None
    return 100.0 * _least_step_s(run) / (device_ms / 1e3)


def neighbor_kernel_roofline(run):
    """The neighbour kernel's share of its roofline, in %: the least time
    of the window's neighbour searches (a table build of every lane and one
    query, a step and a group call, each bounded by
    :func:`bench.yardstick.neighbor_ms` at its B, N and Q) over the
    kernel's device time in the trace. None when the kernel is not on the
    path, or its launches do not match the calls the cell makes."""
    if not run.device_events:
        return None
    hits = [(s, e) for name, s, e in run.device_events
            if NEIGHBOR_KERNEL in name]
    if not hits or len(hits) != 2 * len(run.groups) * run.steps:
        return None
    bound_ms = run.steps * sum(
        neighbor_ms(g["rows"], g["n_slots"], g["n_lanes_total"], False)
        + neighbor_ms(g["rows"], g["n_slots"], 1, True) for g in run.groups)
    return 100.0 * bound_ms / (sum(e - s for s, e in hits) / 1e6)
