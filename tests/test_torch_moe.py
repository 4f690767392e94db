"""The port's mixture of experts (``repro_torch.models.ffn``) against the
reference's (``repro/models/ffn.py``) on the CPU.

The reference's seeded ``moe_init`` parameters are carried into a port
``MoE`` and the same numpy activations go through both ``moe_apply``.
The routing (expert ids, ranks within each expert's buffer, keep masks)
is compared exactly against the reference's routing steps run in JAX on
the same inputs (:func:`_jax_routing`, the lines of ``moe_apply`` that
the reference does not return); the outputs and the aux loss in f32
within ``tests/test_moe.py``'s rtol 1e-4, atol 1e-5, and in bf16 within
the models' rtol = atol = 3e-2 (``tests/test_torch_models.py``). Shapes
are ``tests/test_moe.py``'s: d_model 32, 4 experts, top 2, expert width
16, 2 x 16 tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_arch
from repro.models.ffn import moe_apply as jax_moe_apply
from repro.models.ffn import moe_capacity as jax_moe_capacity
from repro.models.ffn import moe_init
from repro_torch.config.base import get_arch
from repro_torch.models.ffn import MoE, moe_apply, moe_capacity, moe_route

TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SMALL = dict(d_model=32, n_experts=4, top_k=2, moe_d_ff=16, d_ff=16)


def _pair(dtype="float32", **kw):
    over = dict(SMALL, dtype=dtype, **kw)
    jcfg = jax_arch("olmoe-1b-7b").reduced(**over)
    cfg = get_arch("olmoe-1b-7b").reduced(**over)
    jp = moe_init(jax.random.key(0), jcfg)
    tp = MoE(cfg, "cpu")
    with torch.no_grad():
        for name, t in tp.named_parameters():
            leaf = jp
            for part in name.split("."):
                leaf = leaf[part]
            t.copy_(torch.from_numpy(np.asarray(leaf, np.float32)))
    assert tp.router.dtype == torch.float32
    return jcfg, jp, cfg, tp


def _x(dtype, shape=(2, 16, 32), seed=1):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (jnp.asarray(x, dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _jax_routing(cfg, p, x):
    """The reference's routing steps (``repro/models/ffn.py:93-120``) on
    ``x [B, S, D]``: (expert, ranks, keep) as numpy."""
    t = x.shape[0] * x.shape[1]
    k = cfg.top_k
    cap = jax_moe_capacity(cfg, t)
    logits = jnp.einsum("td,de->te", x.reshape(t, -1).astype(jnp.float32),
                        p["router"])
    _, expert = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat_e = expert.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = jnp.arange(t * k, dtype=jnp.int32)
    run_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_e[1:] != sorted_e[:-1]])
    start_idx = jax.lax.cummax(jnp.where(run_start, idx, 0))
    ranks = jnp.zeros((t * k,), jnp.int32).at[order].set(
        idx - start_idx).reshape(t, k)
    return np.asarray(expert), np.asarray(ranks), np.asarray(ranks < cap)


def _routing_equal(cfg, jp, tp, jx, tx):
    _, _, expert, ranks, keep, cap = moe_route(cfg, tp, tx.reshape(-1, 32))
    want = _jax_routing(cfg, jp, jx)
    assert cap == jax_moe_capacity(cfg, tx.shape[0] * tx.shape[1])
    for got, ref in zip((expert, ranks, keep), want):
        np.testing.assert_array_equal(got.numpy(), ref)
    return keep


CASES = {"ample": dict(capacity_factor=8.0), "default": {},
         "brutal drops": dict(capacity_factor=0.1),
         "shared experts": dict(n_shared_experts=1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_matches_reference(case, dtype):
    """Routing exactly, outputs and aux within TOL; at capacity_factor 0.1
    most choices are dropped and at 8.0 none."""
    jcfg, jp, cfg, tp = _pair(dtype, **CASES[case])
    jx, tx = _x(dtype)
    keep = _routing_equal(cfg, jp, tp, jx, tx)
    dropped = int((~keep).sum())
    if case == "brutal drops":
        assert dropped > keep.numel() // 2
    elif case == "ample":
        assert dropped == 0
    jy, jaux = jax_moe_apply(jcfg, jp, jx)
    ty, taux = moe_apply(cfg, tp, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), **TOL["float32"])


def test_tied_router_probabilities_take_the_lower_expert_first():
    """A zero router ties every probability at 1/E: ``jax.lax.top_k`` then
    takes experts 0 and 1 for every token, so the port must too (the
    stable descending sort), and with the default capacity the later
    tokens overflow experts 0 and 1 and are dropped in token order."""
    jcfg, jp, cfg, tp = _pair(capacity_factor=1.0)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    with torch.no_grad():
        tp.router.zero_()
    jx, tx = _x("float32")
    keep = _routing_equal(cfg, jp, tp, jx, tx)
    _, _, expert, ranks, _, cap = moe_route(cfg, tp, tx.reshape(-1, 32))
    assert expert.tolist() == [[0, 1]] * 32
    assert ranks[:, 0].tolist() == list(range(32))
    assert keep[:, 0].tolist() == [i < cap for i in range(32)]
    jy, _ = jax_moe_apply(jcfg, jp, jx)
    ty, _ = moe_apply(cfg, tp, tx)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL["float32"])
    # a dropped token gathers zero rows back: its output is exactly 0
    assert torch.all(ty.reshape(32, -1)[~keep.any(-1)] == 0)


def test_aux_loss_and_its_gradient_match_reference():
    """loss = Σ y² + 0.01 · aux: its value and its gradient with respect to
    every parameter (the router's through both the gates and the aux loss)
    and to the input, in f32, at the default capacity (some choices
    dropped)."""
    jcfg, jp, cfg, tp = _pair(n_shared_experts=1)
    jx, tx = _x("float32")

    def jloss(p, x):
        y, aux = jax_moe_apply(jcfg, p, x)
        return jnp.sum(y * y) + 0.01 * aux

    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jx)
    tp.requires_grad_(True)
    tx.requires_grad_(True)
    y, aux = moe_apply(cfg, tp, tx)
    loss = torch.sum(y * y) + 0.01 * aux
    named = dict(tp.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()) + [tx])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-5)
    for (name, _), g in zip(named.items(), grads):
        want = jg
        for part in name.split("."):
            want = want[part]
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_aux_loss_alone_matches_reference():
    """e · Σ mean(probs) · mean(one_hot(top-1)), f32, and its gradient with
    respect to the router."""
    jcfg, jp, cfg, tp = _pair()
    jx, tx = _x("float32", seed=4)
    ja, jg = jax.value_and_grad(
        lambda r: jax_moe_apply(jcfg, dict(jp, router=r), jx)[1])(jp["router"])
    tp.router.requires_grad_(True)
    _, aux = moe_apply(cfg, tp, tx)
    (g,) = torch.autograd.grad(aux, [tp.router])
    np.testing.assert_allclose(aux.item(), float(ja), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("n_tokens", [1, 4, 64, 80, 2048])
def test_capacity_formula_matches_reference(n_tokens):
    for arch in ("olmoe-1b-7b", "deepseek-v2-236b"):
        for factor in (0.1, 1.25, 8.0):
            cfg = dataclasses.replace(get_arch(arch), capacity_factor=factor)
            jcfg = dataclasses.replace(jax_arch(arch),
                                       capacity_factor=factor)
            assert moe_capacity(cfg, n_tokens) == jax_moe_capacity(jcfg,
                                                                   n_tokens)


def test_tokens_of_one_call_compete_for_capacity():
    """Capacity counts the tokens of one call: with drops, a token's output
    depends on the other tokens of the call, as the reference's does (a
    decode step batches every slot, idle ones too). Token 0 alone keeps
    both its choices; after 15 copies of it, in one call, the later copies
    overflow its experts."""
    jcfg, jp, cfg, tp = _pair(capacity_factor=1.0)
    jx, tx = _x("float32", shape=(1, 1, 32))
    alone, _ = moe_apply(cfg, tp, tx)
    many = tx.expand(1, 16, 32).contiguous()
    jmany = jnp.broadcast_to(jx, (1, 16, 32))
    keep = _routing_equal(cfg, jp, tp, jmany, many)
    assert keep[0].all() and not keep[-1].any()
    ty, _ = moe_apply(cfg, tp, many)
    jy, _ = jax_moe_apply(jcfg, jp, jmany)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL["float32"])
    torch.testing.assert_close(ty[:, 0], alone[:, 0], rtol=1e-5, atol=1e-6)
    assert torch.all(ty[0, -1] == 0)
