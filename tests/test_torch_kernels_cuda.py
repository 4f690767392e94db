"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, and the LM stack served through the flash attention, RG-LRU and WKV6
kernels (the MoE and MLA families included). Every test here carries the ``cuda`` marker and skips without a
GPU.

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
from repro_torch.config.base import ServeConfig, TrainConfig, get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import idm, ref
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import rwkv6 as rw
from repro_torch.models.attention import attention_impl, mla_attention
from repro_torch.models.common import f32_product
from repro_torch.models.recurrent import recurrence_impl
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import adamw_init, make_train_step

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
                                   (48, 512, 4), (3, 200, 3), (2, 5, 2),
                                   (1, 9000, 2)])  # 9000: the all-pairs kernel
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


def idm_args(dev, pos, lane, active, seed):
    """The nine IDM inputs on ``dev`` for a world, the rest drawn from
    ``seed`` in the sweep's ranges."""
    b, n = pos.shape
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, (b, n)).astype(np.float32)

    return on(dev, pos, u(0.0, 35.0), lane, active, u(20.0, 35.0),
              u(0.8, 1.8), u(1.0, 2.5), u(1.5, 3.0), u(1.0, 2.5))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(256, 128), (48, 512), (3, 200)])
def test_idm_accel_kernel_matches_plain(cuda, b, n):
    """rtol = atol = 1e-6: the epilogue's division, square root and sums
    may round in another order than PyTorch's element-wise kernels."""
    args = idm_args(cuda, *rand_worlds(b + n, b, n), b)
    got = idm.idm_accel_kernel(*args, veh_len=4.5)
    want = ref.ref_idm_accel(*args, 4.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def tie_world(seed, b, n):
    """Positions on a grid of 16 values in 3 lanes: most vehicles share
    their position with others of their lane."""
    rng = np.random.default_rng(seed)
    pos = (rng.integers(0, 16, (b, n)) * 7.5 - 30.0).astype(np.float32)
    pos[(pos == 0.0) & (rng.uniform(size=(b, n)) < 0.5)] = -0.0  # and +0
    lane = rng.integers(0, 3, (b, n)).astype(np.int32)
    return pos, lane, rng.uniform(size=(b, n)) < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,world", [
    (3, 1, "rand"), (5, 31, "rand"), (256, 128, "rand"), (48, 512, "rand"),
    (2, 2000, "rand"), (1, 8192, "rand"), (64, 128, "ties"), (4, 700, "ties"),
    (1, 8, "collapse"), (2, 8193, "rand"),
])
def test_idm_sort_form_equals_all_pairs_bitwise(cuda, b, n, world):
    """Up to 8192 slots ``idm_accel_kernel`` sorts and searches; its lead,
    so its result, is the all-pairs form's, bit for bit (2000, 8192: 2 and
    8 keys a thread); at 8193 the same entry launches the all-pairs form."""
    if world == "rand":
        pos, lane, active = rand_worlds(b + n, b, n)
    elif world == "ties":
        pos, lane, active = tie_world(n, b, n)
    else:
        pos, lane, active = collapse_world()
    args = idm_args(cuda, pos, lane, active, n)
    before = dict(idm.launches)
    got = idm.idm_accel_kernel(*args, veh_len=4.5)
    wide = idm._idm_accel_wide(*args, veh_len=4.5)
    want = ref.ref_idm_accel(*args, 4.5)
    torch.cuda.synchronize()
    assert idm.launches["idm_accel_kernel"] == before["idm_accel_kernel"] + 1
    assert idm.launches["idm_accel_wide"] == before["idm_accel_wide"] + 1
    assert torch.equal(got, wide), int((got != wide).sum())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,q", [
    (256, 128, 4), (256, 128, 3), (1024, 128, 4), (48, 512, 4), (3, 200, 6),
    (2, 5, 2), (2, 2000, 4), (1, 8192, 4),  # 2000, 8192: 2 and 8 keys a thread
    (2, 8193, 4),  # past the sort's 8192 slots: the all-pairs kernel
])
def test_neighbor_kernel_rows_mode_matches_plain(cuda, b, n, q):
    """Row q queries lane q (a table build, no query-lane tensor); rows past
    the lanes in use find nothing."""
    pos, lane, active = on(cuda, *rand_worlds(b + n + q + 1, b, n))
    before = idm.launches["neighbor_kernel"]
    got = idm.neighbor_kernel(pos, lane, active, None, n_rows=q)
    want = ref.ref_neighbor_mq(pos, lane, active, None, 4.5, n_rows=q)
    torch.cuda.synchronize()
    assert idm.launches["neighbor_kernel"] == before + 1
    for name, g, w in zip(FIELDS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def collapse_world():
    """Two vehicles ahead of vehicle 0 whose gaps to it round to one f32
    value, the farther in the lower slot; two behind vehicle 3 alike
    (``tests/test_torch_neighbor_rows.py`` holds the kernel's algorithm
    against the reference on the same world)."""
    e = np.float32(2.0**-24)
    g = np.float32(2.0**-20)
    pos = np.array([[e, 1.0 + 3 * 2.0**-23, 1.0 + 2.0**-22, 16.0, 1.5 * g,
                     2.5 * g, 5.0, 5.0]], np.float32)
    lane = np.array([[0, 0, 0, 1, 1, 1, 2, 2]], np.int32)
    return pos, lane, np.ones((1, 8), bool)


@pytest.mark.cuda
def test_neighbor_kernel_takes_the_lowest_slot_where_gaps_round_together(
        cuda):
    pos, lane, active = on(cuda, *collapse_world())
    ql = lane[:, None].contiguous()
    got = idm.neighbor_kernel(pos, lane, active, ql)
    want = ref.ref_neighbor_mq(pos, lane, active, ql, 4.5)
    torch.cuda.synchronize()
    assert int(want[0][0, 0, 0]) == 1 and int(want[3][0, 0, 3]) == 4
    for name, g, w in zip(FIELDS, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
def test_kernels_take_more_than_65535_instances(cuda):
    """B runs along gridDim.x: 65536 instances and more, in one launch each
    (the rows mode, the own-lane query and the IDM kernel)."""
    b, n = 65536 + 7, 12
    pos, lane, active = on(cuda, *rand_worlds(11, b, n))
    for ql, q in ((None, L), (lane[:, None].contiguous(), None)):
        got = idm.neighbor_kernel(pos, lane, active, ql, n_rows=q)
        want = ref.ref_neighbor_mq(pos, lane, active, ql, 4.5, n_rows=q)
        torch.cuda.synchronize()
        for name, g, w in zip(FIELDS, got, want):
            assert torch.equal(g, w), (q, name)
    rng = np.random.default_rng(12)

    def u(lo, hi):
        return rng.uniform(lo, hi, (b, n)).astype(np.float32)

    args = (pos, *on(cuda, u(0.0, 35.0)), lane, active,
            *on(cuda, u(20.0, 35.0), u(0.8, 1.8), u(1.0, 2.5), u(1.5, 3.0),
                u(1.0, 2.5)))
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
    args = idm_args(cuda, *rand_worlds(0, 2, 16), 0)
    for wrapper in (idm.idm_accel_kernel, idm._idm_accel_wide):
        with pytest.raises(TypeError):
            wrapper(args[0].double(), *args[1:])
        with pytest.raises(ValueError):
            wrapper(*args[:2], args[2][:, :8], *args[3:])


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


# flash attention: the reference's kernel tolerances (tests/test_kernels.py)
FLASH_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=8e-3),
             torch.float32: dict(rtol=2e-3, atol=2e-4)}


def rand_qkv(seed, dev, dtype, b, sq, sk, h, kh, d, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))
    return [torch.from_numpy(x).to(dev, dtype) for x in (q * q_scale, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,window,cap", [
    (1, 37, 37, 8, 4, 256, True, 0, 50.0),      # gemma2 global, ragged
    (1, 300, 300, 8, 4, 256, True, 128, 50.0),  # gemma2 local, window < S
    (2, 130, 130, 16, 16, 64, True, 0, 0.0),    # qwen MHA
    (1, 64, 200, 4, 1, 128, True, 50, 0.0),     # end-aligned queries, MQA
    (1, 77, 77, 4, 2, 128, False, 0, 0.0),      # non-causal
    (1, 100, 100, 2, 2, 64, False, 30, 0.0),    # window without causality
    # the bf16 kernel's edges: 128 query rows and 64 keys a tile
    (2, 129, 129, 4, 2, 128, True, 0, 0.0),     # ragged rows and keys, B 2
    (2, 1000, 1000, 8, 4, 256, True, 0, 50.0),  # B 2: no key of row 1 leaks
    (1, 2100, 2100, 10, 1, 256, True, 2048, 0.0),  # window edge off the grid
    (1, 129, 4000, 8, 4, 256, True, 0, 50.0),   # end-aligned, Sq << Sk
    (1, 300, 300, 4, 2, 64, True, 96, 0.0),     # D 64, window and causal
    (1, 300, 300, 4, 2, 128, True, 96, 0.0),    # D 128, window and causal
    # the encoder-decoder's and qwen2-vl's shapes
    (1, 1500, 1500, 20, 20, 64, False, 0, 0.0),  # whisper encoder
    (4, 224, 1500, 20, 20, 64, False, 0, 0.0),  # cross attention, Sq != Sk
    (4, 1, 1500, 20, 20, 64, False, 0, 0.0),    # decode cross: one query row
    (1, 600, 600, 12, 2, 128, True, 0, 0.0),    # qwen2-vl GQA 6:1, D 128
    # the reduced configs' D 16 and the Pallas kernel's tests' D 32: the
    # 32- and 64-byte swizzles of the bf16 kernel
    (1, 9, 9, 4, 4, 16, True, 16, 50.0),        # reduced gemma2 prompt
    (1, 37, 37, 4, 4, 16, True, 0, 50.0),       # D 16 ragged, softcap
    (2, 300, 300, 4, 2, 16, True, 96, 50.0),    # D 16 window, GQA, B 2
    (1, 64, 200, 4, 1, 16, True, 50, 0.0),      # D 16 end-aligned, MQA
    (1, 129, 129, 4, 2, 32, True, 0, 0.0),      # D 32 ragged rows and keys
    (2, 300, 300, 8, 2, 32, True, 96, 50.0),    # D 32 window, GQA 4:1
    (1, 77, 200, 4, 4, 32, False, 0, 0.0),      # D 32 non-causal, Sq != Sk
])
def test_flash_attention_matches_plain(cuda, b, sq, sk, h, kh, d, causal,
                                       window, cap, dtype):
    q, k, v = rand_qkv(sq + d, cuda, dtype, b, sq, sk, h, kh, d)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    want = ref.ref_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_scale,cap,window", [
    (20.0, 50.0, 0),    # gemma2's cap, scores of about N(0, 20^2)
    (20.0, 50.0, 128),  # the same on a local layer
    (1.0, 2.0, 0),      # unit scores against a small cap
])
def test_flash_attention_softcap_at_the_cap(cuda, q_scale, cap, window,
                                            dtype):
    """Scores that reach the cap, so that the tanh changes the output by
    far more than the tolerance: a kernel without its softcap fails here
    (at unit scores and cap 50 it moves the output by about 1e-4)."""
    q, k, v = rand_qkv(7, cuda, dtype, 1, 300, 300, 8, 4, 256, q_scale)
    got = fa.flash_attention(q, k, v, causal=True, window=window, softcap=cap)
    want = ref.ref_attention(q, k, v, True, window, cap)
    uncapped = ref.ref_attention(q, k, v, True, window, 0.0)
    torch.cuda.synchronize()
    assert float((want.float() - uncapped.float()).abs().max()) > \
        50 * FLASH_TOL[dtype]["atol"]
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32])
def test_flash_attention_small_head_dims_at_the_cap(cuda, d, dtype):
    """D 16 and 32 with scores that reach gemma2's cap of 50 (q x 20),
    causal and on a window: the softcap path of the small-row kernels."""
    q, k, v = rand_qkv(d, cuda, dtype, 2, 300, 300, 8, 4, d, 20.0)
    for window in (0, 64):
        got = fa.flash_attention(q, k, v, causal=True, window=window,
                                 softcap=50.0)
        want = ref.ref_attention(q, k, v, True, window, 50.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_bf16_never_crosses_on_large_scores(cuda):
    """32 seeded q x 20 draws at gemma2-2b's global shape (S 512, softcap
    50): the bf16 kernel forms P V from p at about f32 precision (p_hi +
    p_lo), so none crosses the unchanged bf16 tolerance against
    ``ref_attention``. Rounding p to bf16 before normalising, as the first
    build did, crossed on 2 of 64 such draws."""
    for seed in range(32):
        q, k, v = rand_qkv(100 + seed, cuda, torch.bfloat16, 1, 512, 512, 8,
                           4, 256, 20.0)
        got = fa.flash_attention(q, k, v, causal=True, softcap=50.0)
        want = ref.ref_attention(q, k, v, True, 0, 50.0)
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[torch.bfloat16],
                                   msg=lambda m: f"draw {seed}: {m}")


@pytest.mark.cuda
def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    """A CUDA tensor the kernel cannot take raises; it never runs the plain
    version instead. The bf16 kernel's TMA loads need 16-byte-aligned
    rows, so a bf16 q that starts one element past an aligned address is
    refused; so is a head dim outside ``HEAD_DIMS`` (48)."""
    q, k, v = rand_qkv(0, cuda, torch.bfloat16, 1, 32, 32, 4, 2, 64)
    before = fa.launches["flash_attention"]
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    shifted = shifted.view(q.shape).copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(shifted, k, v)
    assert fa.launches["flash_attention"] == before


@pytest.mark.cuda
def test_model_attention_goes_through_the_kernel(cuda):
    """A reduced gemma2 forward on the card launches the kernel once per
    layer by default and matches the plain path (f32: the kernel and the
    plain path sum in other orders). Head dim 64; the reduced configs' 16
    is ``test_reduced_model_serves_through_the_kernel``'s."""
    cfg = get_arch("gemma2-2b").reduced(dtype="float32", head_dim=64)
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 40)))
    fa.reset_launches()
    got, _ = model.apply(params, {"tokens": toks.to(cuda)})
    assert fa.launches["flash_attention"] == cfg.n_layers
    with attention_impl("xla"):
        want, _ = model.apply(params, {"tokens": toks.to(cuda)})
    assert fa.launches["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_model_serves_through_the_kernel(cuda, dtype):
    """The reduced gemma2 as ``reduced()`` makes it (head dim 16, window
    16, softcap 50) prefills through the kernel once per layer and matches
    the plain path: the default serve launcher's size, which the kernel
    refused before it took D 16."""
    cfg = get_arch("gemma2-2b").reduced(dtype=dtype)
    assert cfg.head_dim == 16
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 40)))
    fa.reset_launches()
    with torch.inference_mode():
        got, _ = model.apply(params, {"tokens": toks.to(cuda)})
        assert fa.launches["flash_attention"] == cfg.n_layers
        with attention_impl("xla"):
            want, _ = model.apply(params, {"tokens": toks.to(cuda)})
    # f32: the two paths sum in other orders; bf16: the kernel's tolerance
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
           else FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_engine_on_the_card_matches_per_request_greedy(cuda):
    cfg = get_arch("gemma2-2b").reduced(dtype="float32", head_dim=64)
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 21, 3)]
    refs = []
    with torch.inference_mode():
        for pr in prompts:
            cache = model.init_cache(1, 48)
            logits, cache = model.prefill(
                params, cache, {"tokens": torch.from_numpy(pr[None]).to(cuda)})
            toks = [int(logits.argmax(-1)[0])]
            for t in range(3):
                pos = torch.tensor([len(pr) + t], dtype=torch.int32,
                                   device=cuda)
                logits, cache = model.decode(
                    params, cache, torch.tensor([toks[-1]], device=cuda), pos)
                toks.append(int(logits.argmax(-1)[0]))
            refs.append(toks)
    fa.reset_launches()
    eng = ServeEngine(model, params, ServeConfig(max_batch=2, max_seq=48))
    rids = [eng.submit(pr, max_new=4) for pr in prompts]
    results = eng.run()
    assert [results[r] for r in rids] == refs
    assert fa.launches["flash_attention"] == cfg.n_layers * len(prompts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,dqk,dv", [(8, 96, 64), (4, 192, 128)])
def test_mla_route_pads_to_the_kernel_head_dim(cuda, h, dqk, dv, dtype):
    """MLA's unequal head dims (minicpm3-4b's q/k 96 and v 64, deepseek-
    v2's 192 and 128) go through one kernel launch, zero-padded to 128 and
    256, and the sliced context equals the plain version on the unpadded
    tensors at the kernel tolerances."""
    gen = torch.Generator(device=cuda).manual_seed(dqk)
    q, k = (torch.randn(1, 300, h, dqk, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    v = torch.randn(1, 300, h, dv, generator=gen, device=cuda).to(dtype)
    before = fa.launches["flash_attention"]
    got = mla_attention(q, k, v, scale=dqk**-0.5)
    want = ref.ref_attention(q, k, v, True, 0, 0.0, dqk**-0.5)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    assert got.shape == (1, 300, h, dv) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,overrides", [
    ("olmoe-1b-7b", dict(head_dim=64)), ("minicpm3-4b", {}),
    ("deepseek-v2-236b", {})])
def test_moe_and_mla_prefill_goes_through_the_kernel(cuda, arch, overrides):
    """A reduced MoE or MLA model's prefill launches the flash kernel once
    per layer (MLA's q/k 16 and v 16 padded to 64) and matches the plain
    path in f32; the engine's tokens equal per-request greedy decoding."""
    cfg = get_arch(arch).reduced(dtype="float32", **overrides)
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 40))).to(cuda)
    fa.reset_launches()
    with torch.inference_mode():
        got, _ = model.prefill(params, model.init_cache(2, 48),
                               {"tokens": toks})
        assert fa.launches["flash_attention"] == cfg.n_layers
        with attention_impl("xla"):
            want, _ = model.prefill(params, model.init_cache(2, 48),
                                    {"tokens": toks})
    assert fa.launches["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    prompts = [np.random.default_rng(1).integers(0, 256, size=n)
               for n in (5, 21, 3)]
    refs = []
    with torch.inference_mode():
        for pr in prompts:
            cache = model.init_cache(1, 48)
            logits, cache = model.prefill(
                params, cache, {"tokens": torch.from_numpy(pr[None]).to(cuda)})
            toks = [int(logits.argmax(-1)[0])]
            for t in range(3):
                pos = torch.tensor([len(pr) + t], dtype=torch.int32,
                                   device=cuda)
                logits, cache = model.decode(
                    params, cache, torch.tensor([toks[-1]], device=cuda), pos)
                toks.append(int(logits.argmax(-1)[0]))
            refs.append(toks)
    eng = ServeEngine(model, params, ServeConfig(max_batch=2, max_seq=48))
    rids = [eng.submit(pr, max_new=4) for pr in prompts]
    results = eng.run()
    assert [results[r] for r in rids] == refs


# RG-LRU and WKV6: the reference's kernel tolerances (tests/test_kernels.py)
RGLRU_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-3),
             torch.float32: dict(rtol=1e-5, atol=1e-5)}
WKV6_TOL = {torch.bfloat16: dict(rtol=5e-2, atol=5e-2),
            torch.float32: dict(rtol=1e-4, atol=1e-4)}


def rglru_inputs(seed, dev, dtype, b, s, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return (torch.from_numpy(a).to(dev), torch.from_numpy(x).to(dev, dtype),
            torch.from_numpy(h0).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,w", [
    (2, 64, 128), (1, 128, 256), (1, 96, 128),   # the reference's shapes
    (1, 37, 2560), (4, 77, 100), (3, 5, 33),    # ragged S and W
])
def test_rglru_kernel_matches_plain(cuda, b, s, w, dtype):
    a, x, h0 = rglru_inputs(s + w, cuda, dtype, b, s, w)
    before = rg.launches["rglru_linear_scan"]
    ys, hf = rg.rglru_linear_scan(a, x, h0)
    want_ys, want_h = ref.ref_rglru(a, x, h0)
    torch.cuda.synchronize()
    assert rg.launches["rglru_linear_scan"] == before + 1
    assert ys.dtype == dtype and hf.dtype == torch.float32
    torch.testing.assert_close(ys.float(), want_ys, **RGLRU_TOL[dtype])
    torch.testing.assert_close(hf, want_h, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [32, 1, 37])
def test_rglru_kernel_chunked_equals_whole(cuda, split):
    a, x, _ = rglru_inputs(3, cuda, torch.float32, 1, 64, 2560)
    h0 = torch.zeros((1, 2560), device=cuda)
    y_all, h_all = rg.rglru_linear_scan(a, x, h0)
    y1, h1 = rg.rglru_linear_scan(a[:, :split].contiguous(),
                                  x[:, :split].contiguous(), h0)
    y2, h2 = rg.rglru_linear_scan(a[:, split:].contiguous(),
                                  x[:, split:].contiguous(), h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, h_all, rtol=1e-5, atol=1e-5)


def strong_rglru_inputs(seed, b, s, w, strong=True):
    """numpy a, x, h0 (f32); with ``strong`` the decays are
    ``exp(-exp(U(-8, 5)))`` with about one entry in 16 exactly 0 and one in
    16 exactly 1, else ``U(0.7, 0.999)``. The same function is in
    ``tests/test_torch_rglru_chunked.py``, which holds the kernel's chunked
    arithmetic against the reference on the CPU with these inputs."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("edge", ["0", "1", "T-1", "T", "T+1", "2T-1", "2T",
                                  "2T+1", "300"])
def test_rglru_kernel_strong_decays_at_chunk_edges(cuda, edge, dtype):
    """Strong decays with exact zeros and ones, S at the edges of the
    kernel's chunks of T steps, W a ragged lane tile (100) and whole ones
    (256): the composed carries hold the sequential recurrence's
    tolerances; where a is 0 the state restarts at x exactly."""
    t = rg.CHUNK
    s = {"0": 0, "1": 1, "T-1": t - 1, "T": t, "T+1": t + 1, "2T-1": 2 * t - 1,
         "2T": 2 * t, "2T+1": 2 * t + 1, "300": 300}[edge]
    for w in (100, 256):
        a, x, h0 = (torch.from_numpy(z).to(cuda) for z in
                    strong_rglru_inputs(s + w + t, 2, s, w))
        x = x.to(dtype)
        before = rg.launches["rglru_linear_scan"]
        ys, hf = rg.rglru_linear_scan(a, x, h0)
        want_ys, want_h = ref.ref_rglru(a, x, h0)
        torch.cuda.synchronize()
        assert rg.launches["rglru_linear_scan"] == before + 1
        assert ys.shape == (2, s, w) and ys.dtype == dtype
        torch.testing.assert_close(ys.float(), want_ys, **RGLRU_TOL[dtype])
        torch.testing.assert_close(hf, want_h, rtol=1e-4, atol=1e-4)
        if dtype == torch.float32:
            assert torch.equal(ys[a == 0.0], x[a == 0.0])
        if s == 0:
            assert torch.equal(hf, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("strong", [True, False])
@pytest.mark.parametrize("split", [100, 1, 65])
def test_rglru_kernel_two_chunks_through_h0(cuda, split, strong):
    """S 300 cut at a length that is not a multiple of the chunk: the second
    call starts from the first one's h_final (1e-5, as one scan)."""
    a, x, _ = (torch.from_numpy(z).to(cuda) for z in
               strong_rglru_inputs(8, 1, 300, 2560, strong))
    h0 = torch.zeros((1, 2560), device=cuda)
    y_all, h_all = rg.rglru_linear_scan(a, x, h0)
    y1, h1 = rg.rglru_linear_scan(a[:, :split].contiguous(),
                                  x[:, :split].contiguous(), h0)
    y2, h2 = rg.rglru_linear_scan(a[:, split:].contiguous(),
                                  x[:, split:].contiguous(), h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, h_all, rtol=1e-5, atol=1e-5)


def wkv6_inputs(seed, dev, dtype, b, s, h, dk, dv):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    r, k, v = normal(b, s, h, dk), normal(b, s, h, dk), normal(b, s, h, dv)
    w = torch.from_numpy(rng.uniform(0.8, 0.999, (b, s, h, dk)).astype(
        np.float32))
    u, s0 = normal(h, dk), normal(b, h, dk, dv)
    return ([z.to(dev, dtype) for z in (r, k, v)]
            + [z.to(dev) for z in (w, u, s0)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,dk,dv", [
    (1, 32, 2, 16, 16), (2, 64, 2, 64, 64), (1, 48, 1, 32, 16),  # reference
    (1, 37, 40, 64, 64),   # rwkv6-3b's heads, ragged S
    (2, 21, 3, 48, 40),    # K and V not multiples of 16
    (1, 3, 2, 7, 5),
])
def test_wkv6_kernel_matches_plain(cuda, b, s, h, dk, dv, dtype):
    args = wkv6_inputs(s + dk + dv, cuda, dtype, b, s, h, dk, dv)
    before = rw.launches["wkv6"]
    y, sf = rw.wkv6(*args)
    want_y, want_s = ref.ref_wkv6(*args)
    torch.cuda.synchronize()
    assert rw.launches["wkv6"] == before + 1
    assert y.dtype == dtype and sf.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y, **WKV6_TOL[dtype])
    torch.testing.assert_close(sf, want_s, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [32, 13])
def test_wkv6_kernel_chunked_equals_whole(cuda, split):
    r, k, v, w, u, _ = wkv6_inputs(5, cuda, torch.float32, 1, 64, 40, 64, 64)
    s0 = torch.zeros((1, 40, 64, 64), device=cuda)
    y_all, s_all = rw.wkv6(r, k, v, w, u, s0)
    cut = [z[:, :split].contiguous() for z in (r, k, v, w)]
    rest = [z[:, split:].contiguous() for z in (r, k, v, w)]
    y1, s1 = rw.wkv6(*cut, u, s0)
    y2, s2 = rw.wkv6(*rest, u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s2, s_all, rtol=1e-4, atol=1e-4)


def strong_wkv6_inputs(seed, b, s, h, dk, dv, strong=True):
    """numpy r, k, v, w, u, s0 (f32); with ``strong`` the decays are
    ``exp(-exp(U(-8, 5)))`` (zero in f32 past about U 4.6) with about one
    entry in 16 set to exactly 0 and one in 16 to exactly 1, else
    ``U(0.8, 0.999)`` (the reference's test draw). The same function is in
    ``tests/test_torch_wkv6_chunked.py``, which holds the kernel's chunked
    arithmetic against the reference on the CPU with these inputs."""
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


def wkv6_on(dev, dtype, arrays):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in arrays)
    return ([z.to(dev, dtype) for z in (r, k, v)]
            + [z.to(dev) for z in (w, u, s0)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,dk,dv", [
    # S at the chunk (64) and sub-chunk (16) edges, and S 0
    *((1, s, 2, 64, 64) for s in (0, 1, 15, 16, 17, 63, 64, 65, 127, 128,
                                  129, 200)),
    (1, 65, 3, 48, 40), (1, 200, 3, 48, 40),   # K and V below 64
    (2, 129, 40, 64, 64),                      # B 2 with rwkv6-3b's heads
])
def test_wkv6_kernel_strong_decays_at_chunk_edges(cuda, b, s, h, dk, dv,
                                                  dtype):
    """Strong decays with exact zeros and ones: the chunked kernel's
    running products must give the recurrence's exact 0 where w is 0."""
    args = wkv6_on(cuda, dtype, strong_wkv6_inputs(s + dk + dv + b, b, s, h,
                                                   dk, dv))
    before = rw.launches["wkv6"]
    y, sf = rw.wkv6(*args)
    want_y, want_s = ref.ref_wkv6(*args)
    torch.cuda.synchronize()
    assert rw.launches["wkv6"] == before + 1
    assert y.shape == (b, s, h, dv) and y.dtype == dtype
    assert torch.isfinite(y.float()).all() and torch.isfinite(sf).all()
    torch.testing.assert_close(y.float(), want_y, **WKV6_TOL[dtype])
    torch.testing.assert_close(sf, want_s, rtol=1e-3, atol=1e-3)
    if s == 0:
        assert torch.equal(sf, args[5])


@pytest.mark.cuda
@pytest.mark.parametrize("strong", [True, False])
@pytest.mark.parametrize("split", [100, 1, 65])
def test_wkv6_kernel_two_chunks_through_s0(cuda, split, strong):
    """S 300 cut at a length that is not a multiple of the chunk: the second
    call starts from the first one's state (1e-4, as one scan)."""
    r, k, v, w, u, _ = wkv6_on(cuda, torch.float32, strong_wkv6_inputs(
        7, 1, 300, 40, 64, 64, strong))
    s0 = torch.zeros((1, 40, 64, 64), device=cuda)
    y_all, s_all = rw.wkv6(r, k, v, w, u, s0)
    cut = [z[:, :split].contiguous() for z in (r, k, v, w)]
    rest = [z[:, split:].contiguous() for z in (r, k, v, w)]
    y1, s1 = rw.wkv6(*cut, u, s0)
    y2, s2 = rw.wkv6(*rest, u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s2, s_all, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_recurrence_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a, x, h0 = rglru_inputs(0, cuda, torch.float32, 1, 8, 64)
    r, k, v, w, u, s0 = wkv6_inputs(0, cuda, torch.float32, 1, 8, 2, 16, 16)
    before = (rg.launches["rglru_linear_scan"], rw.launches["wkv6"])
    with pytest.raises(TypeError):
        rg.rglru_linear_scan(a.half(), x, h0)
    with pytest.raises(TypeError):
        rg.rglru_linear_scan(a, x.half(), h0)
    with pytest.raises(ValueError, match="contiguous"):
        rg.rglru_linear_scan(a, x.transpose(1, 2).contiguous().transpose(1, 2),
                             h0)
    with pytest.raises(ValueError):
        rg.rglru_linear_scan(a, x, h0.cpu())
    with pytest.raises(TypeError):
        rw.wkv6(r.bfloat16(), k, v, w, u, s0)
    with pytest.raises(TypeError):
        rw.wkv6(r, k, v, w.double(), u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        rw.wkv6(r, k, v, w, u, s0.transpose(2, 3).contiguous().transpose(2, 3))
    r2, k2, v2, w2, u2, s2 = wkv6_inputs(0, cuda, torch.float32, 1, 8, 1, 80,
                                         16)
    with pytest.raises(ValueError, match="64"):
        rw.wkv6(r2, k2, v2, w2, u2, s2)
    assert (rg.launches["rglru_linear_scan"], rw.launches["wkv6"]) == before


@pytest.mark.cuda
def test_cuda_wrappers_refuse_inputs_that_need_a_gradient(cuda):
    """No kernel has a backward: under autograd each CUDA wrapper raises
    (launching nothing) instead of returning an output without a
    ``grad_fn``; under ``torch.no_grad()`` it launches."""
    q, k, v = rand_qkv(0, cuda, torch.float32, 1, 16, 16, 2, 2, 64)
    a, x, h0 = rglru_inputs(0, cuda, torch.float32, 1, 8, 64)
    wargs = wkv6_inputs(0, cuda, torch.float32, 1, 8, 2, 16, 16)
    calls = (
        ("flash_attention", fa, lambda *z: fa.flash_attention(*z), [q, k, v]),
        ("rglru_linear_scan", rg, lambda *z: rg.rglru_linear_scan(*z),
         [a, x, h0]),
        ("wkv6", rw, lambda *z: rw.wkv6(*z), wargs),
    )
    for name, mod, call, args in calls:
        for i in range(len(args)):
            grad_args = [t.clone().requires_grad_(j == i)
                         for j, t in enumerate(args)]
            before = mod.launches[name]
            with pytest.raises(RuntimeError, match="no backward"):
                call(*grad_args)
            assert mod.launches[name] == before, (name, i)
        with torch.no_grad():
            call(*grad_args)
        torch.cuda.synchronize()
        assert mod.launches[name] == before + 1, name


def recurrent_card_model(cuda, arch, seed):
    """A reduced f32 ``arch`` whose prefill launches all its kernels: head
    dims 64 (the flash kernel takes 64, 128 and 256)."""
    cfg = get_arch(arch).reduced(dtype="float32", head_dim=64,
                                 rwkv_head_dim=64)
    model = build_model(cfg, cuda)
    return model, model.init(torch.Generator(device=cuda).manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,counts", [
    ("recurrentgemma-2b", {"rglru_linear_scan": 4, "wkv6": 0,
                           "flash_attention": 2}),
    ("rwkv6-3b", {"rglru_linear_scan": 0, "wkv6": 2, "flash_attention": 0}),
])
def test_recurrent_model_prefill_goes_through_the_kernels(cuda, arch, counts):
    """One prefill launches each recurrence kernel once per layer of its
    kind (recurrentgemma's reduced stack: R, R, L, R, R, L) and matches
    the plain path (f32: the kernels and the plain versions sum in other
    orders)."""
    model, params = recurrent_card_model(cuda, arch, 0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 40))).to(cuda)
    for mod in (fa, rg, rw):
        mod.reset_launches()
    with torch.inference_mode():
        got, _ = model.prefill(params, model.init_cache(2, 48),
                               {"tokens": toks})
        assert {**rg.launches, **rw.launches,
                **fa.launches} == counts
        with attention_impl("xla"), recurrence_impl("plain"):
            want, _ = model.prefill(params, model.init_cache(2, 48),
                                    {"tokens": toks})
    assert {**rg.launches, **rw.launches, **fa.launches} == counts
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_recurrent_engine_on_the_card_matches_per_request_greedy(cuda, arch):
    model, params = recurrent_card_model(cuda, arch, 1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 21, 3)]
    refs = []
    with torch.inference_mode():
        for pr in prompts:
            cache = model.init_cache(1, 48)
            logits, cache = model.prefill(
                params, cache, {"tokens": torch.from_numpy(pr[None]).to(cuda)})
            toks = [int(logits.argmax(-1)[0])]
            for t in range(3):
                pos = torch.tensor([len(pr) + t], dtype=torch.int32,
                                   device=cuda)
                logits, cache = model.decode(
                    params, cache, torch.tensor([toks[-1]], device=cuda), pos)
                toks.append(int(logits.argmax(-1)[0]))
            refs.append(toks)
    eng = ServeEngine(model, params, ServeConfig(max_batch=2, max_seq=48))
    rids = [eng.submit(pr, max_new=4) for pr in prompts]
    results = eng.run()
    assert [results[r] for r in rids] == refs


@pytest.mark.cuda
def test_f32_product_passes_the_gradient_to_both_operands(cuda):
    """The card's bf16 ``f32_product`` (one GEMM with an f32 output, which
    has no autograd formula of its own) gives both operands the gradient
    of the f32 product, rounded to bf16."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn((3, 7, 256), generator=gen, device=cuda).bfloat16()
    w = torch.randn((1000, 256), generator=gen, device=cuda).bfloat16()
    dy = torch.randn((3, 7, 1000), generator=gen, device=cuda)
    x.requires_grad_(True)
    w.requires_grad_(True)
    out = f32_product(x, w)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.float() @ w.float().t(), rtol=1e-5,
                               atol=1e-5)
    gx, gw = torch.autograd.grad((out * dy).sum(), [x, w])
    assert gx.dtype == gw.dtype == torch.bfloat16
    want_gx = dy @ w.detach().float()
    want_gw = dy.reshape(-1, 1000).t() @ x.detach().float().reshape(-1, 256)
    torch.testing.assert_close(gx.float(), want_gx, rtol=2**-8, atol=1e-5)
    torch.testing.assert_close(gw.float(), want_gw, rtol=2**-8, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-2b",
                                  "recurrentgemma-2b", "rwkv6-3b"])
def test_train_step_on_the_card_reaches_every_parameter(cuda, arch):
    """A bf16 train step on the card launches no hand kernel, and every
    parameter moves (its gradient came through the card's f32_product)."""
    model = build_model(get_arch(arch).reduced(), cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = model.init(gen)
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    toks = torch.randint(0, model.cfg.vocab_size, (2, 33), generator=gen,
                         device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=0, weight_decay=0.0)
    for mod in (fa, idm, rg, rw):
        mod.reset_launches()
    step = make_train_step(model, tc)
    params, _, metrics = step(params, adamw_init(before), batch)
    torch.cuda.synchronize()
    assert all(n == 0 for mod in (fa, idm, rg, rw)
               for n in mod.launches.values())
    assert torch.isfinite(metrics["loss"])
    for name, p in params.named_parameters():
        assert not torch.equal(p.detach(), before[name]), name

