"""The port's serving engine on the CPU: the cases of ``tests/test_serve.py``
on the port, and the port's engine against the reference's engine for the
same f32 weights (carried across by ``lm_params_from_numpy``) and prompts.
Tokens are compared exactly: both greedy decodes run in f32 from the same
weights, and every step's top-2 logit margin is far above the f32 error
of the logits (below 1e-6, ``tests/test_torch_models.py``)."""

import jax
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_arch as jax_arch
from repro.models import build_model as jax_build
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.config.base import ServeConfig, get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine, greedy_generate

SMALL = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             d_ff=64, vocab_size=64, dtype="float32")
PROMPTS = [np.asarray([5, 9, 12, 3]), np.asarray([40, 2, 61, 17, 8]),
           np.asarray([1, 1, 2])]


def _model(seed=0):
    model = build_model(get_arch("qwen1.5-0.5b").reduced(**SMALL), "cpu")
    return model, model.init(torch.Generator().manual_seed(seed))


def test_greedy_generate_shapes_and_determinism():
    model, params = _model()
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 8)))
    out1 = greedy_generate(model, params, prompt, steps=6)
    out2 = greedy_generate(model, params, prompt, steps=6)
    assert out1.shape == (2, 6)
    assert torch.equal(out1, out2)


def _greedy_per_request(model, params, prompts, n_new):
    """Each prompt alone: prefill on a 1-row cache, then decode."""
    refs = []
    with torch.inference_mode():
        for pr in prompts:
            cache = model.init_cache(1, 64)
            logits, cache = model.prefill(params, cache,
                                          {"tokens": torch.from_numpy(pr[None])})
            toks = [int(logits.argmax(-1)[0])]
            for t in range(n_new - 1):
                pos = torch.tensor([pr.shape[0] + t], dtype=torch.int32)
                logits, cache = model.decode(params, cache,
                                             torch.tensor([toks[-1]]), pos)
                toks.append(int(logits.argmax(-1)[0]))
            refs.append(toks)
    return refs


def test_engine_matches_greedy_reference():
    """Continuous batching gives the tokens of per-request greedy decoding
    (3 requests through 2 slots force recycling)."""
    model, params = _model()
    refs = _greedy_per_request(model, params, PROMPTS, 5)
    eng = ServeEngine(model, params, ServeConfig(max_batch=2, max_seq=64))
    rids = [eng.submit(pr, max_new=5) for pr in PROMPTS]
    results = eng.run()
    assert set(results) == set(rids)
    for rid, ref in zip(rids, refs):
        assert results[rid] == ref, (rid, results[rid], ref)
    assert eng.stats["prefills"] == 3
    assert eng.stats["prefill_tokens"] == sum(len(p) for p in PROMPTS)
    assert set(eng.stats["first_token_s"]) == set(rids)


def test_engine_more_requests_than_slots():
    model, params = _model()
    eng = ServeEngine(model, params, ServeConfig(max_batch=2, max_seq=32))
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, 64, size=rng.integers(2, 6)), max_new=3)
            for _ in range(5)]
    results = eng.run()
    assert sorted(results) == rids
    assert all(len(v) == 3 for v in results.values())


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-2b",
                                  "recurrentgemma-2b", "rwkv6-3b",
                                  "olmoe-1b-7b", "minicpm3-4b",
                                  "deepseek-v2-236b"])
def test_engine_tokens_match_reference_engine(arch):
    """Same f32 weights, same prompts (one longer than the reduced window of
    16), 4 requests through 2 slots: the port's engine emits the reference
    engine's tokens. The reference decodes once more before it checks a
    request's budget, so ``max_new=1`` returns two tokens; the port keeps
    that behaviour (ROADMAP queue 3). Slots are recycled after a longer
    request, so a recurrent state left behind would show. In the MoE archs
    a decode step's capacity counts both slots, idle or not, and a prefill's
    the prompt's tokens, in both engines."""
    overrides = dict(SMALL, vocab_size=256) if arch == "qwen1.5-0.5b" else \
        dict(dtype="float32")
    jm = jax_build(jax_arch(arch).reduced(**overrides))
    jp = jm.init(jax.random.key(3))
    model = build_model(get_arch(arch).reduced(**overrides), "cpu")
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), model.cfg,
                                  "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 21, 3, 9)]
    jeng = JaxServeEngine(jm, jp, JaxServeConfig(max_batch=2, max_seq=48))
    eng = ServeEngine(model, params, ServeConfig(max_batch=2, max_seq=48))
    for pr, max_new in zip(prompts, (6, 1, 6, 3)):
        jeng.submit(pr, max_new=max_new)
        eng.submit(pr, max_new=max_new)
    results = eng.run()
    assert results == jeng.run()
    assert [len(results[r]) for r in range(4)] == [6, 2, 6, 3]


def test_serve_launcher_on_cpu(capsys):
    res = launcher.main(["--device", "cpu", "--arch", "gemma2-2b",
                         "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert sorted(res["results"]) == [0, 1, 2]
    assert all(len(v) == 4 for v in res["results"].values())
    assert res["model"].cfg.name == "gemma2-2b-smoke"
    out = capsys.readouterr().out
    assert "[serve] completed 3/3 requests" in out
    assert "tokens/s" in out


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_serve_launcher_serves_recurrent_archs_on_cpu(arch, capsys):
    res = launcher.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                         "--slots", "2", "--max-new", "4"])
    assert sorted(res["results"]) == [0, 1, 2]
    assert all(len(v) == 4 for v in res["results"].values())
    assert res["model"].cfg.name == f"{arch}-smoke"
    assert "[serve] completed 3/3 requests" in capsys.readouterr().out


def test_recycled_mla_slot_keeps_nothing():
    """An MLA slot recycled after a long request holds exactly the latent
    cache a fresh prefill of the next prompt gives: its ``pos`` entries past
    the new prompt are -1 again, so no old latent is attended to."""
    cfg = get_arch("minicpm3-4b").reduced(dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(2))
    eng = ServeEngine(model, params, ServeConfig(max_batch=1, max_seq=64))
    rng = np.random.default_rng(5)
    eng.submit(rng.integers(0, 256, size=30), max_new=3)
    eng.run()
    short = rng.integers(0, 256, size=4)
    eng.submit(short, max_new=1)
    with torch.inference_mode():
        eng._admit()
        fresh = model.init_cache(1, 64)
        model.prefill(params, fresh, {"tokens": torch.from_numpy(short[None])})
    for pool, one in zip(eng.cache, fresh):
        assert set(pool) == {"c", "k_rope", "pos"}
        assert pool["pos"][0].tolist() == [0, 1, 2, 3] + [-1] * 60
        for name in pool:
            assert torch.equal(pool[name], one[name]), name


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "minicpm3-4b",
                                  "deepseek-v2-236b"])
def test_serve_launcher_serves_moe_and_mla_archs_on_cpu(arch, capsys):
    res = launcher.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                         "--slots", "2", "--max-new", "4"])
    assert sorted(res["results"]) == [0, 1, 2]
    assert all(len(v) == 4 for v in res["results"].values())
    assert res["model"].cfg.name == f"{arch}-smoke"
    assert "[serve] completed 3/3 requests" in capsys.readouterr().out


def test_recycled_slot_keeps_no_recurrent_state():
    """After a long request leaves its slot, every recurrent cache row of
    that slot holds exactly what a fresh prefill of the next prompt gives."""
    cfg = get_arch("rwkv6-3b").reduced(dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(2))
    eng = ServeEngine(model, params, ServeConfig(max_batch=1, max_seq=64))
    rng = np.random.default_rng(5)
    eng.submit(rng.integers(0, 256, size=30), max_new=3)
    eng.run()
    short = rng.integers(0, 256, size=4)
    eng.submit(short, max_new=1)
    with torch.inference_mode():
        eng._admit()
        fresh = model.init_cache(1, 64)
        model.prefill(params, fresh, {"tokens": torch.from_numpy(short[None])})
    for pool, one in zip(eng.cache, fresh):
        assert set(pool) == {"S", "x_prev_tm", "x_prev_cm"}
        for name in pool:
            assert torch.equal(pool[name], one[name]), name
