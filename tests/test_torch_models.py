"""The port's LM stack against the reference's, on the CPU.

Reduced ``gemma2-2b`` (local/global layers, window 16, softcaps, post
norms, gelu, tied embeddings scaled by sqrt(d)), ``qwen1.5-0.5b`` (MHA,
QKV bias, silu), ``recurrentgemma-2b`` (two Griffin blocks then one local
MQA layer), ``rwkv6-3b`` (time mix + channel mix, layer norms),
``olmoe-1b-7b`` (MoE with QK-norm), ``minicpm3-4b`` (MLA, tied embeddings
scaled by 12) and ``deepseek-v2-236b`` (MLA, a dense first layer, then MoE
with a shared expert), ``gemma2-9b`` (as gemma2-2b, GQA 16:8 at full
width) and ``qwen2-vl-2b`` as text (no ``mrope_pos``: plain RoPE, as the
reference falls back to it; M-RoPE is ``test_torch_mrope.py``): the
reference's seeded parameters, with every norm
scale and bias redrawn with numpy so that none is the identity, are
carried across by ``repro_torch.convert.lm_params_from_numpy``; the same
numpy tokens then go through ``Model.apply`` (logits and the MoE aux
loss), ``prefill`` and ``decode`` of both.

Tolerances on logits: f32 ``rtol=1e-5, atol=2e-5`` (same f32 arithmetic,
sums in another order; measured errors are below 1e-5); bf16
``rtol=atol=3e-2``, the reference's own bound for a whole-model forward
through another attention path (``tests/test_kernels_integration.py``).
With the norms at their identity init the bf16 rwkv6 logits drift further
apart than that, so ``test_bf16_as_close_to_f32_as_reference`` holds the
recurrent archs' bf16 forward by distance to the f32 logits instead.

In bf16 the MoE archs' logits are held at the bf16 tolerance in all but
one row in 16 (:func:`_close_moe_bf16`): the two packages round the
activations at other places (one bf16 ulp a layer), and where that ulp
moves a token's router probabilities across a near tie, the token takes
another expert and its logits, and the later positions' that attend to
it, differ by far more than the tolerance (3 of 88 rows at these draws,
up to 0.97). That each layer is right, routing included, is held from the
same state, layer by layer, by ``test_bf16_moe_layers_match_reference``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_arch
from repro.models import build_model as jax_build
from repro.models.blocks import block_apply as jax_block_apply
from repro.models.common import embed_tokens as jax_embed_tokens
from repro_torch.config.base import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.attention import attn_apply, mla_apply
from repro_torch.models.blocks import block_apply
from repro_torch.models.common import norm
from repro_torch.models.ffn import moe_route
from repro_torch.models.lm import layer_plan, stack_plan
from repro_torch.models.registry import build_model
from test_torch_moe import _jax_routing

TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
VOCAB = 256  # the reduced configs' vocabulary


def _perturb(tree, rng):
    """Redraw norm scales and attention biases (zero-initialised in the
    reference), keeping each leaf's dtype."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _perturb(val, rng)
        elif isinstance(val, list):
            out[key] = [_perturb(v, rng) for v in val]
        elif key in ("scale", "bq", "bk", "bv"):
            new = rng.normal(0.0, 0.1, val.shape).astype(np.float32)
            out[key] = jnp.asarray(new, val.dtype)
        else:
            out[key] = val
    return out


def _pair(arch, dtype, **overrides):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(**overrides),
                               dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch).reduced(**overrides),
                              dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = jax_build(jcfg)
    jp = _perturb(jm.init(jax.random.key(0)), np.random.default_rng(1))
    tm = build_model(cfg, "cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _close_moe_bf16(pairs):
    """All logit rows of ``pairs`` [(port, reference)] within the bf16
    tolerance but at most one in 16 (see the module docstring); the aux
    losses within it too."""
    rows = out = 0
    for got, want in pairs:
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        if got.ndim == 0:
            np.testing.assert_allclose(got, want, **TOL["bfloat16"])
            continue
        bad = np.abs(got - want) > (TOL["bfloat16"]["atol"]
                                    + TOL["bfloat16"]["rtol"] * np.abs(want))
        bad = bad.reshape(-1, got.shape[-1]).any(axis=-1)
        rows += bad.size
        out += int(bad.sum())
    assert out * 16 <= rows, f"{out} of {rows} logit rows outside the tolerance"


CASES = [("gemma2-2b", "float32", {}), ("gemma2-2b", "bfloat16", {}),
         ("gemma2-2b", "float32", {"n_kv_heads": 2}),
         ("qwen1.5-0.5b", "float32", {}), ("qwen1.5-0.5b", "bfloat16", {}),
         ("recurrentgemma-2b", "float32", {}),
         ("recurrentgemma-2b", "bfloat16", {}),
         ("rwkv6-3b", "float32", {}), ("rwkv6-3b", "bfloat16", {}),
         ("olmoe-1b-7b", "float32", {}), ("olmoe-1b-7b", "bfloat16", {}),
         ("minicpm3-4b", "float32", {}), ("minicpm3-4b", "bfloat16", {}),
         ("deepseek-v2-236b", "float32", {}),
         ("deepseek-v2-236b", "bfloat16", {}),
         ("gemma2-9b", "float32", {}), ("gemma2-9b", "bfloat16", {}),
         ("qwen2-vl-2b", "float32", {}), ("qwen2-vl-2b", "bfloat16", {})]


@pytest.mark.parametrize("arch,dtype,overrides", CASES)
def test_apply_prefill_decode_match_reference(arch, dtype, overrides):
    """Prompt of 40 tokens: longer than the reduced window (16), so local
    layers ring-roll their caches; then 3 decode steps."""
    jm, jp, tm, tp = _pair(arch, dtype, **overrides)
    pairs = _logits_both(jm, jp, tm, tp)
    if dtype == "bfloat16" and tm.cfg.n_experts:
        _close_moe_bf16(pairs)
        return
    for got, want in pairs:
        _close(got, want, dtype)


def _logits_both(jm, jp, tm, tp):
    """(port, reference) logits of ``apply``, ``prefill`` and 3 decode
    steps on the same 40-token prompts."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, VOCAB, (2, 40))
    out = []
    jl, jaux = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, 40, VOCAB)
    assert aux.dtype == torch.float32
    if tm.cfg.n_experts == 0:
        assert float(aux) == 0.0
    out.append((tl, jl))
    out.append((aux, jaux))

    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64)
    jl, jc = jm.prefill(jp, jc, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, tc, {"tokens": torch.from_numpy(toks)})
    out.append((tl, jl))
    for step in range(3):
        tok = rng.integers(0, VOCAB, (2,))
        pos = np.full((2,), 40 + step, np.int32)
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok),
                           torch.from_numpy(pos))
        out.append((tl, jl))
    return out


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_bf16_as_close_to_f32_as_reference(arch):
    """The reference's own seeded weights (norms at their identity init):
    there the bf16 rwkv6 logits of the reference lie 0.13 from its f32
    logits, and two bf16 paths that round at other places differ by more
    than 3e-2 although every layer agrees to one bf16 ulp. So the forward's
    bf16 logits [2, 40, V] are held by distance: the port's to the
    reference's f32 logits (the same weights, widened exactly) is at most
    1.25x the reference's own bf16 distance to them."""
    cfg = get_arch(arch).reduced()
    jm = jax_build(jax_arch(arch).reduced())
    jp = jm.init(jax.random.key(0))
    jm32 = jax_build(dataclasses.replace(jm.cfg, dtype="float32"))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(2).integers(0, VOCAB, (2, 40))
    got, _ = build_model(cfg, "cpu").apply(tp, {"tokens": torch.from_numpy(toks)})
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    f32, _ = jm32.apply(jp32, {"tokens": jnp.asarray(toks)})
    f32 = np.asarray(f32, np.float32)
    port = float(np.abs(got.float().numpy() - f32).max())
    ref = float(np.abs(np.asarray(want, np.float32) - f32).max())
    assert port <= 1.25 * ref, (port, ref)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
@pytest.mark.parametrize("prompt", [0, 2])
def test_decode_matches_full_forward(arch, prompt):
    """Token-by-token decode after a ``prompt``-token prefill (0: decode
    from the first token) reproduces the teacher-forced forward, in bf16
    within ``rtol = atol = 2e-2`` (``tests/test_configs_smoke.py``). A
    2-token prompt is shorter than the Griffin conv history (3)."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, VOCAB, (1, 12)))
    full, _ = model.apply(params, {"tokens": tokens})
    cache = model.init_cache(1, 16)
    steps = []
    if prompt:
        logits, cache = model.prefill(params, cache,
                                      {"tokens": tokens[:, :prompt]})
        steps.append(logits)
    for t in range(prompt, 12):
        logits, cache = model.decode(params, cache, tokens[:, t],
                                     torch.tensor([t], dtype=torch.int32))
        steps.append(logits)
    start = prompt - 1 if prompt else 0
    torch.testing.assert_close(torch.stack(steps, dim=1), full[:, start:],
                               rtol=2e-2, atol=2e-2)


def test_ring_rolled_cache_matches_reference():
    """After a prompt longer than the window, each local layer's cache holds
    the last ``window`` entries at slot ``pos % window``, as the
    reference's; the global layers hold the whole prompt."""
    jm, jp, tm, tp = _pair("gemma2-2b", "float32")
    cfg = tm.cfg
    toks = np.random.default_rng(3).integers(0, VOCAB, (1, 37))
    _, jc = jm.prefill(jp, jm.init_cache(1, 48), {"tokens": jnp.asarray(toks)})
    _, tc = tm.prefill(tp, tm.init_cache(1, 48),
                       {"tokens": torch.from_numpy(toks)})
    plan = stack_plan(cfg)
    for i in range(plan.n_blocks):
        for j, (kind, _) in enumerate(plan.pattern):
            want = jax.tree.map(lambda a: np.asarray(a[i], np.float32),
                                jc["blocks"][f"l{j}"])
            got = tc[i * len(plan.pattern) + j]
            assert got["k"].shape[1] == (cfg.window if kind == "local" else 48)
            np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])
            for name in ("k", "v"):
                np.testing.assert_allclose(got[name].numpy(), want[name],
                                           **TOL["float32"])
    local = tc[0]["pos"][0].tolist()
    assert sorted(local) == list(range(37 - cfg.window, 37))
    assert all(p % cfg.window == slot for slot, p in enumerate(local))


def test_layer_plans_of_the_recurrent_archs():
    """recurrentgemma-2b: 26 layers, 8 x (R, R, L) then a tail of R, R (18
    Griffin blocks, 8 local layers); rwkv6-3b: 32 rwkv layers. Only the
    attention and Griffin layers have an ``ffn``."""
    kinds = [kind for kind, _, _ in layer_plan(get_arch("recurrentgemma-2b"))]
    assert kinds == ["recurrent", "recurrent", "local"] * 8 + ["recurrent"] * 2
    assert [kind for kind, _, _ in layer_plan(get_arch("rwkv6-3b"))] == \
        ["rwkv"] * 32
    for arch in ("recurrentgemma-2b", "rwkv6-3b"):
        params = build_model(get_arch(arch).reduced(), "cpu").init(
            torch.Generator().manual_seed(0))
        for layer in params.layers:
            assert hasattr(layer, "ffn") == (layer.kind != "rwkv")
            assert hasattr(layer, "time_mix") == (layer.kind == "rwkv")


def test_converter_checks_names_and_shapes():
    cfg = get_arch("qwen1.5-0.5b").reduced(dtype="float32")
    jm = jax_build(jax_arch("qwen1.5-0.5b").reduced(dtype="float32"))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    params = lm_params_from_numpy(tree, cfg, "cpu")
    assert len(params.layers) == cfg.n_layers
    np.testing.assert_array_equal(params.layers[1].mixer.wq.numpy(),
                                  tree["blocks"]["l0"]["mixer"]["wq"][1])
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_numpy(tree, cfg, "cpu")


def test_bf16_weights_carry_across_bit_for_bit():
    """JAX hands bf16 leaves out as ml_dtypes arrays; they arrive unchanged."""
    cfg = get_arch("gemma2-2b").reduced()
    jm = jax_build(jax_arch("gemma2-2b").reduced())
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    assert tree["embed"]["table"].dtype.name == "bfloat16"
    params = lm_params_from_numpy(tree, cfg, "cpu")
    assert params.embed.table.dtype == torch.bfloat16
    np.testing.assert_array_equal(params.embed.table.float().numpy(),
                                  tree["embed"]["table"].astype(np.float32))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "minicpm3-4b",
                                  "deepseek-v2-236b"])
def test_moe_and_mla_leaves_carry_across_bit_for_bit(arch):
    """Parameters (bf16, the router f32) and an AdamW state in the
    reference's layout, ``head_layers`` included, go into the port and
    back unchanged."""
    from repro.train.optim import AdamWState as JaxAdamWState
    from repro_torch.convert import (adamw_state_from_numpy,
                                     adamw_state_to_numpy,
                                     lm_params_to_numpy)

    cfg = get_arch(arch).reduced()
    jm = jax_build(jax_arch(arch).reduced())
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    assert ("head_layers" in tree) == (arch == "deepseek-v2-236b")
    params = lm_params_from_numpy(tree, cfg, "cpu")
    back = lm_params_to_numpy(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, want), (_, got) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(got, want.astype(np.float32),
                                      err_msg=jax.tree_util.keystr(path))
    rng = np.random.default_rng(0)
    moments = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), tree) for _ in range(2)]
    state = JaxAdamWState(step=np.asarray(7, np.int32), m=moments[0],
                          v=moments[1])
    got = adamw_state_to_numpy(adamw_state_from_numpy(state, cfg, "cpu"), cfg)
    assert int(got.step) == 7
    for a, b in zip(jax.tree.leaves(tuple(got)[1:]),
                    jax.tree.leaves(tuple(state)[1:])):
        np.testing.assert_array_equal(a, b)


def test_port_init_is_seeded_and_in_the_configured_type():
    cfg = get_arch("gemma2-2b").reduced()
    model = build_model(cfg, "cpu")
    a = model.init(torch.Generator().manual_seed(5))
    b = model.init(torch.Generator().manual_seed(5))
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y), name
        assert not x.requires_grad
    # the fan-in truncated normal of the reference: |w| <= 2 / sqrt(fan_in)
    wq = a.layers[0].mixer.wq.float()
    assert float(wq.abs().max()) <= 2 * cfg.d_model**-0.5 * 1.01
    assert float(a.layers[0].norm1.scale.abs().max()) == 0.0
    # MLA and MoE layers build (they raised before they were ported)
    mla_moe = build_model(get_arch("gemma2-2b").reduced(
        use_mla=True, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=16,
        kv_lora_rank=16, n_experts=4, top_k=2, moe_d_ff=32),
        "cpu").init(torch.Generator().manual_seed(5))
    for layer in mla_moe.layers:
        assert type(layer.mixer).__name__ == "MLA"
        assert type(layer.ffn).__name__ == "MoE"
        assert layer.ffn.router.dtype == torch.float32


def test_layer_plans_of_the_moe_and_mla_archs():
    """deepseek-v2-236b: a dense first layer of width dense_d_ff (12288),
    then 59 MoE layers (160 experts, 2 shared); olmoe-1b-7b: 16 MoE layers;
    minicpm3-4b: 62 dense MLA layers. Shapes only (meta tensors)."""
    from repro_torch.models.lm import LM

    deep = get_arch("deepseek-v2-236b")
    assert layer_plan(deep) == [("global", False, 12288)] + \
        [("global", True, None)] * 59
    assert [moe for _, moe, _ in layer_plan(get_arch("olmoe-1b-7b"))] == \
        [True] * 16
    assert [moe for _, moe, _ in layer_plan(get_arch("minicpm3-4b"))] == \
        [False] * 62
    params = LM(dataclasses.replace(deep, n_layers=2), torch.device("meta"))
    assert tuple(params.layers[0].ffn.wi_gate.shape) == (5120, 12288)
    assert tuple(params.layers[1].ffn.wi_gate.shape) == (160, 5120, 1536)
    assert tuple(params.layers[1].ffn.shared.wi_gate.shape) == (5120, 3072)
    assert tuple(params.layers[1].mixer.q_b.shape) == (1536, 128, 192)
    assert tuple(params.layers[1].mixer.kv_b.shape) == (512, 128, 256)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_bf16_moe_layers_match_reference(arch):
    """The bf16 MoE archs from the same state, layer by layer: each of the
    reference's layers (its own ``block_apply``, its parameters unstacked)
    and the port's take the reference's hidden state entering that layer;
    the port's output and aux loss within the bf16 tolerance, and the
    routing of the MoE's input (experts, ranks, keep) exactly the
    reference's."""
    jm, jp, tm, tp = _pair(arch, "bfloat16")
    cfg, jcfg = tm.cfg, jm.cfg
    plan = stack_plan(cfg)
    toks = np.random.default_rng(2).integers(0, VOCAB, (2, 40))
    x = jax_embed_tokens(jcfg, jp["embed"], jnp.asarray(toks))
    pos = np.broadcast_to(np.arange(40), (2, 40))
    layers = list(jp.get("head_layers", [])) + [
        jax.tree.map(lambda a, i=i: a[i], jp["blocks"]["l0"])
        for i in range(plan.n_blocks)]
    moe_layers = 0
    for (kind, moe, _), jl, layer in zip(layer_plan(cfg), layers, tp.layers):
        jy, jaux = jax_block_apply(jcfg, jl, kind, moe, x, jnp.asarray(pos))
        tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
        ty, taux = block_apply(cfg, layer, tx, torch.from_numpy(pos.copy()))
        _close(ty, jy, "bfloat16")
        _close(taux, jaux, "bfloat16")
        if moe:
            moe_layers += 1
            # the MoE's input, the port's own, given to both routers
            tpos = torch.from_numpy(pos.copy())
            h = norm(cfg, layer.norm1, tx)
            sub = (mla_apply(cfg, layer.mixer, h, tpos) if cfg.use_mla
                   else attn_apply(cfg, layer.mixer, h, tpos, kind))
            h = norm(cfg, layer.norm2, tx + sub)
            _, _, expert, ranks, keep, _ = moe_route(cfg, layer.ffn,
                                                     h.reshape(80, -1))
            want = _jax_routing(cfg, jl["ffn"],
                                jnp.asarray(h.float().numpy(), jnp.bfloat16))
            for got, ref in zip((expert, ranks, keep), want):
                np.testing.assert_array_equal(got.numpy(), ref)
        x = jy
    assert moe_layers == sum(moe for _, moe, _ in layer_plan(cfg))
