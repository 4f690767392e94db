"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips without a GPU.

This file imports torch and the port only (no JAX), so it also runs on a
GPU machine without the reference installed::

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from repro_torch.core.neighbors import build_tables
from repro_torch.core.scenario import SimConfig
from repro_torch.core.sweep import SweepConfig, SweepRunner
from repro_torch.kernels import idm, ref

L = 4  # 3 main lanes + ramp
FIELDS = ("lead_idx", "lead_gap", "has_lead", "foll_idx", "foll_gap",
          "has_foll")


def rand_worlds(seed, b, n, p_act=0.8):
    """Random worlds with forced exact position ties and inactive slots."""
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,q", [(256, 128, 4), (256, 128, 3), (256, 128, 1),
                                   (48, 512, 4), (3, 200, 3), (2, 5, 2)])
def test_neighbor_kernel_matches_plain(cuda, b, n, q):
    pos, lane, active = rand_worlds(b + n + q, b, n)
    ql = np.random.default_rng(q).integers(0, L, (b, q, n)).astype(np.int32)
    args = on(cuda, pos, lane, active, ql)
    before = idm.launches["neighbor_kernel"]
    got = idm.neighbor_kernel(*args, veh_len=4.5)
    want = ref.ref_neighbor_mq(*args, 4.5)
    torch.cuda.synchronize()
    assert idm.launches["neighbor_kernel"] == before + 1
    for name, g, w in zip(FIELDS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(256, 128), (48, 512), (3, 200)])
def test_idm_accel_kernel_matches_plain(cuda, b, n):
    """rtol = atol = 1e-6: the epilogue's division, square root and sums
    may round in another order than PyTorch's element-wise kernels."""
    pos, lane, active = rand_worlds(b + n, b, n)
    rng = np.random.default_rng(b)

    def u(lo, hi):
        return rng.uniform(lo, hi, (b, n)).astype(np.float32)

    args = on(cuda, pos, u(0.0, 35.0), lane, active, u(20.0, 35.0),
              u(0.8, 1.8), u(1.0, 2.5), u(1.5, 3.0), u(1.0, 2.5))
    got = idm.idm_accel_kernel(*args, veh_len=4.5)
    want = ref.ref_idm_accel(*args, 4.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    pos, lane, active = on(cuda, *rand_worlds(0, 2, 16))
    with pytest.raises(TypeError):
        idm.neighbor_kernel(pos.double(), lane, active, lane[:, None])
    with pytest.raises(ValueError):
        idm.neighbor_kernel(pos, lane, active, lane[:, None].cpu())
    with pytest.raises(ValueError):
        idm.neighbor_kernel(pos[:, ::2], lane[:, ::2], active[:, ::2],
                            lane[:, None, ::2])


@pytest.mark.cuda
def test_cuda_impl_tables_match_sort(cuda):
    pos, lane, active = on(cuda, *rand_worlds(3, 64, 128))
    a = build_tables(pos, lane, active, 4.5, L, "cuda")
    b = build_tables(pos, lane, active, 4.5, L, "sort")
    for name, x, y in zip(FIELDS, a, b):
        assert torch.equal(x, y), name


@pytest.mark.cuda
def test_cuda_sweep_equals_sort_sweep(cuda):
    """Two neighbor constructions per step, each one kernel launch; the
    whole sweep bit-identical to the sort impl on the card."""
    states = {}
    for impl in ("cuda", "sort"):
        cfg = SweepConfig(n_instances=16, steps_per_instance=60, chunk_steps=30,
                          sim=SimConfig(n_slots=32, neighbor_impl=impl),
                          scenario_mix=("highway_merge", "stop_and_go"))
        runner = SweepRunner(cfg, device=cuda)
        idm.reset_launches()
        states[impl] = runner.run()
        if impl == "cuda":
            assert idm.launches["neighbor_kernel"] == 2 * 30 * runner.group_calls
    for a, b in zip(states["cuda"].sim + states["cuda"].metrics,
                    states["sort"].sim + states["sort"].metrics):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_switch_equals_grouped_on_card(cuda):
    """Every roster branch on every row, then a per-row select, gives the
    grouped result bit for bit on the card too."""
    states = []
    for dispatch in ("switch", "grouped"):
        cfg = SweepConfig(n_instances=8, steps_per_instance=40, chunk_steps=20,
                          sim=SimConfig(n_slots=16, neighbor_impl="cuda"),
                          scenario_mix=("highway_merge", "lane_drop",
                                        "stop_and_go", "speed_limit_zone"),
                          dispatch=dispatch, vary_horizon=True)
        states.append(SweepRunner(cfg, device=cuda).run())
    a, b = states
    for x, y in zip(a.sim + a.metrics, b.sim + b.metrics):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_kernels_run_on_the_tensors_card(cuda):
    """Each wrapper launches on the card its tensors lie on, whatever the
    current card is (a device guard around the launch)."""
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        current = (index + 1) % torch.cuda.device_count()
        with torch.cuda.device(current):
            args = on(dev, *rand_worlds(index, 4, 64))
            ql = args[1][:, None].contiguous()
            got = idm.neighbor_kernel(*args, ql, veh_len=4.5)
            torch.cuda.synchronize(dev)
        want = ref.ref_neighbor_mq(*args, ql, 4.5)
        for name, g, w in zip(FIELDS, got, want):
            assert g.device == dev and torch.equal(g, w), (index, name)


@pytest.mark.cuda
def test_runner_refuses_a_state_from_another_device(cuda):
    """A state built on the CPU is never stepped by a runner on the card,
    nor the other way round."""
    cfg = SweepConfig(n_instances=4, steps_per_instance=20, chunk_steps=10,
                      sim=SimConfig(n_slots=16, neighbor_impl="cuda"))
    cpu_state = SweepRunner(cfg, device="cpu").init()
    card = SweepRunner(cfg, device=cuda)
    assert card.device == torch.device("cuda", torch.cuda.current_device())
    with pytest.raises(ValueError, match="device"):
        card.run(cpu_state)
    with pytest.raises(ValueError, match="device"):
        SweepRunner(cfg, device="cpu").run_chunk(card.init())
