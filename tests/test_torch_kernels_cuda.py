"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, and the LM stack served through the flash attention kernel. Every
test here carries the ``cuda`` marker and skips without a GPU.

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
from repro_torch.config.base import ServeConfig, get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import idm, ref
from repro_torch.models.attention import attention_impl
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine

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
def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    """A CUDA tensor the kernel cannot take raises; it never runs the plain
    version instead."""
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
        fa.flash_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                           v[..., :16].contiguous())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    assert fa.launches["flash_attention"] == before


@pytest.mark.cuda
def test_model_attention_goes_through_the_kernel(cuda):
    """A reduced gemma2 forward on the card launches the kernel once per
    layer by default and matches the plain path (f32: the kernel and the
    plain path sum in other orders). Head dim 64: the kernel takes the
    Pallas kernel's head dims, 64, 128 and 256."""
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
