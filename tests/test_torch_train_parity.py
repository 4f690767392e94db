"""The port's training against the reference's, on the CPU.

The same numpy inputs from a seed go through both packages, weights carried
across by ``repro_torch.convert.lm_params_from_numpy`` (the reference's
seeded parameters with every norm scale and bias and the QKV biases
redrawn with numpy, so none is at its identity init) and compared leaf by
leaf in the reference's layout through ``lm_params_to_numpy`` and
``adamw_state_to_numpy``.

Tolerances:

* loss: rtol 1e-5 (f32);
* gradients (f32): every leaf within rtol 1e-4, atol 1e-6, except the
  embedding table, whose atol is 1e-4 of each row's largest entry. Its
  gradient is the gradient at the input of the first layer norm, of rows
  with a 0.02 spread, which scales f32 rounding by the inverse spread and
  spreads it over the whole row: at rwkv6-3b's reduced size, where rows
  whose largest entry is about 3 hold entries of a few 1e-3, the
  reference's f32 gradient of the table lay up to 1.9e-5 from its float64
  value and the port's up to 1.1e-5 (one draw of these shapes), so atol
  1e-6 would ask for less than either package's own error;
* train steps (f32): AdamW's first step moves an element by
  lr·g/(|g| + eps), about ±lr, so where the two packages' gradients
  disagree in sign, or in size near eps (a sum that cancels to its
  rounding noise), the element moves differently in each, and later
  steps carry that on to other elements' gradients. After the first step
  an element whose two gradients agree within 1e-3 of their size is held
  to rtol 1e-4, atol 1e-6 and every other (the noise set, at most 1 % of
  the elements) to 2·lr; after k steps every element to 2·k·lr. The
  moments after the last step within rtol 1e-3 and 1e-4 of their leaf's
  largest entry;
* bf16: one step; the loss within rtol 1e-2, the gradient norm within
  rtol 2^-6, and the gradient through
  the first moment m = (1−β1)·g: every element within rtol 2^-6 plus
  2^-5 of its leaf's largest entry, and each leaf's relative L2 error
  within 2^-5 (qwen1.5-0.5b reduced, one draw: at most 1.5 % of the
  leaf's largest entry and 1.6 % L2, the two packages rounding to bf16 at
  other points). A negated or zeroed leaf fails this. The parameters are
  not compared: AdamW's first step moves every element by about ±lr
  whatever its gradient, so they would not test the gradient.

The loss function's and full_attention's gradients alone are held in
``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_arch
from repro.models import build_model as jax_build
from repro.train import adamw_init as jax_adamw_init
from repro.train import adamw_update as jax_adamw_update
from repro.train import make_train_step as jax_make_train_step
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro_torch.config.base import TrainConfig, get_arch
from repro_torch.convert import (
    adamw_state_from_numpy,
    adamw_state_to_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.models.attention import attention_impl
from repro_torch.models.lm import reference_ranks
from repro_torch.models.recurrent import recurrence_impl
from repro_torch.models.registry import build_model
from repro_torch.train import adamw_init, adamw_update, make_train_step
from repro_torch.train.step import make_loss_fn

ARCHS = ["qwen1.5-0.5b", "gemma2-2b", "recurrentgemma-2b", "rwkv6-3b",
         "olmoe-1b-7b", "minicpm3-4b", "deepseek-v2-236b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: torch's intra-op threads only contend
    with the other test workers (up to 14x slower under a loaded
    machine), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    """Redraw norm scales and biases and the attention biases, keeping each
    leaf's dtype."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _perturb(val, rng)
        elif isinstance(val, list):
            out[key] = [_perturb(v, rng) for v in val]
        elif key in ("scale", "bias", "bq", "bk", "bv"):
            new = (np.asarray(val, np.float32)
                   + rng.normal(0.0, 0.1, val.shape).astype(np.float32))
            out[key] = jnp.asarray(new, val.dtype)
        else:
            out[key] = val
    return out


def _pair(arch, dtype="float32", **overrides):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(**overrides),
                               dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch).reduced(**overrides), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = jax_build(jcfg)
    jp = _perturb(jm.init(jax.random.key(0)), np.random.default_rng(1))
    tm = build_model(cfg, "cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp


def _batches(n, batch, seq, vocab, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
        out.append((toks[:, :-1], toks[:, 1:]))
    return out


def _jax_batch(b):
    return {"tokens": jnp.asarray(b[0]), "labels": jnp.asarray(b[1])}


def _torch_batch(b):
    return {"tokens": torch.from_numpy(b[0]), "labels": torch.from_numpy(b[1])}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    tc, jtc = TrainConfig(), JaxTrainConfig()   # remat "full" on both sides
    (b,) = _batches(1, 2, 32, tm.cfg.vocab_size)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm, jtc), has_aux=True))(jp, _jax_batch(b))
    tp.requires_grad_(True)
    named = dict(tp.named_parameters())
    with attention_impl("xla"), recurrence_impl("plain"):
        loss, metrics = make_loss_fn(tm, tc)(tp, _torch_batch(b))
        grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    if tm.cfg.n_experts:   # the aux term, which the loss includes
        np.testing.assert_allclose(metrics["moe_aux"].item(),
                                   float(jmetrics["moe_aux"]), rtol=1e-5)
    got = lm_params_to_numpy(dict(zip(named, grads)), tm.cfg)
    assert jax.tree.structure(got) == jax.tree.structure(jgrads)
    for (path, want), (_, g) in zip(_leaves(jgrads), _leaves(got)):
        want = np.asarray(want)
        atol = 1e-6
        if jax.tree_util.keystr(path) == "['embed']['table']":
            atol = 1e-6 + 1e-4 * np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(g - want) <= atol + 1e-4 * np.abs(want)), (
            jax.tree_util.keystr(path), float(np.abs(g - want).max()))


def _held_within_noise(got, want, steps, lr, m_got=None, m_want=None):
    """AdamW's first-step noise: the first step moves an element by
    lr·g/(|g| + eps), about ±lr, so where the two packages' gradients
    disagree in sign, or in size near eps (a sum that cancels to its
    rounding noise), the element moves differently in each, and later
    steps carry that on to the other elements' gradients. After the first step (``m_got``, ``m_want``: the
    first moments, (1−β1)·g, of each package) an element whose two
    gradients agree within 1e-3 of their size must lie within rtol 1e-4,
    atol 1e-6, and every other (the noise set) within 2·lr; after
    ``steps`` steps every element within 2·steps·lr. Returns (all held,
    the largest difference, the size of the noise set)."""
    diff = np.abs(got - want)
    if m_got is None:
        return bool(np.all(diff <= 2 * steps * lr)), float(diff.max()), 0
    noise = np.abs(m_got - m_want) > 1e-3 * np.abs(m_want)
    ok = np.where(noise, diff <= 2 * lr, diff <= 1e-6 + 1e-4 * np.abs(want))
    return bool(ok.all()), float(diff.max()), int(noise.sum())


def assert_train_step_matches(jm, jp, tm, tp, batches):
    """The loss and every gradient leaf at ``batches[0]`` (a dict of numpy
    arrays: tokens, labels and the family's extras) as
    :func:`test_loss_and_every_gradient_leaf_match_reference` holds them,
    then one step per batch in 2 microbatches at weight decay 0.1: each
    step's loss and gradient norm, and the parameters after the first step
    within the first-step noise (:func:`_held_within_noise`)."""

    def jb(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    def tb(b):
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm, JaxTrainConfig()), has_aux=True))(
            jp, jb(batches[0]))
    tp.requires_grad_(True)
    named = dict(tp.named_parameters())
    with attention_impl("xla"), recurrence_impl("plain"):
        loss, _ = make_loss_fn(tm, TrainConfig())(tp, tb(batches[0]))
        grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = lm_params_to_numpy(dict(zip(named, grads)), tm.cfg)
    assert jax.tree.structure(got) == jax.tree.structure(jgrads)
    for (path, want), (_, g) in zip(_leaves(jgrads), _leaves(got)):
        want = np.asarray(want)
        atol = 1e-6
        if jax.tree_util.keystr(path) == "['embed']['table']":
            atol = 1e-6 + 1e-4 * np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(g - want) <= atol + 1e-4 * np.abs(want)), (
            jax.tree_util.keystr(path), float(np.abs(g - want).max()))
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              weight_decay=0.1, microbatches=2)
    jstep = jax.jit(jax_make_train_step(jm, JaxTrainConfig(**kw)))
    step = make_train_step(tm, TrainConfig(**kw))
    jstate = jax_adamw_init(jp)
    state = adamw_init(dict(tp.named_parameters()))
    for i, b in enumerate(batches):
        jp, jstate, jmetrics = jstep(jp, jstate, jb(b))
        tp, state, metrics = step(tp, state, tb(b))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-4)
        if i:
            continue
        moments = zip(jax.tree.leaves(lm_params_to_numpy(state.m, tm.cfg)),
                      jax.tree.leaves(jstate.m))
        for (path, want), (_, g), (m_got, m_want) in zip(
                _leaves(jp), _leaves(lm_params_to_numpy(tp, tm.cfg)),
                moments):
            ok, worst, _ = _held_within_noise(
                g, np.asarray(want), 1, 1e-3, m_got, np.asarray(m_want))
            assert ok, (jax.tree_util.keystr(path), worst)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(microbatches):
    """3 steps of make_train_step at weight_decay 0.1, with a cosine
    schedule after one warm-up step: the metrics of each step, the
    parameters after the first step and after the third
    (:func:`_held_within_noise`), and the moments after the third (within
    rtol 1e-3 and 1e-4 of their leaf's largest entry)."""
    jm, jp, tm, tp = _pair("qwen1.5-0.5b")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              weight_decay=0.1, microbatches=microbatches)
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    jstep = jax.jit(jax_make_train_step(jm, jtc))
    step = make_train_step(tm, tc)
    jstate = jax_adamw_init(jp)
    state = adamw_init(dict(tp.named_parameters()))
    for i, b in enumerate(_batches(3, 4, 16, tm.cfg.vocab_size)):
        jp, jstate, jmetrics = jstep(jp, jstate, _jax_batch(b))
        tp, state, metrics = step(tp, state, _torch_batch(b))
        assert sorted(metrics) == sorted(jmetrics)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-4)
        assert float(metrics["lr"]) == float(jmetrics["lr"])
        if i == 1:
            continue
        moments = zip(jax.tree.leaves(lm_params_to_numpy(state.m, tm.cfg)),
                      jax.tree.leaves(jstate.m))
        got_p = lm_params_to_numpy(tp, tm.cfg)
        n_noise = 0
        for (path, want), (_, got), (m_got, m_want) in zip(
                _leaves(jp), _leaves(got_p), moments):
            if i == 0:
                ok, worst, n = _held_within_noise(
                    got, np.asarray(want), 1, 1e-3, m_got, np.asarray(m_want))
                n_noise += n
            else:
                ok, worst, _ = _held_within_noise(got, np.asarray(want), 3,
                                                  1e-3)
            assert ok, (i + 1, jax.tree_util.keystr(path), worst)
        assert n_noise <= 1e-2 * sum(x.size for x in jax.tree.leaves(jp))
    got_s = adamw_state_to_numpy(state, tm.cfg)
    assert int(got_s.step) == int(jstate.step) == 3
    # the reference's state carried across and back is the same, bit for bit
    ref_s = jax.tree.map(np.asarray, jstate)
    back = adamw_state_to_numpy(
        adamw_state_from_numpy(ref_s, tm.cfg, "cpu"), tm.cfg)
    assert jax.tree.structure(tuple(back)) == jax.tree.structure(tuple(ref_s))
    for a, b in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(tuple(ref_s))):
        np.testing.assert_array_equal(a, b)
    for name in ("m", "v"):
        for (path, want), (_, got) in zip(_leaves(getattr(jstate, name)),
                                          _leaves(getattr(got_s, name))):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max(),
                err_msg=f"{name}{jax.tree_util.keystr(path)}")


def test_weight_decay_follows_the_reference_leaf_rank():
    """With zero gradients an AdamW step is the decay alone. The reference
    decays a leaf of rank ≥ 2 of its tree, so the norms of the layers in
    stack_plan's blocks (stacked [n_blocks, d]) are decayed, and the tail
    layers' norms and final_norm ([d]) are not; the port must decay the
    same leaves."""
    jm, jp, tm, tp = _pair("recurrentgemma-2b", n_layers=5)  # 3 + 2 tail
    kw = dict(learning_rate=0.1, warmup_steps=0, schedule="constant",
              weight_decay=0.5)
    named = dict(tp.named_parameters())
    zeros = {k: torch.zeros_like(p) for k, p in named.items()}
    before = {k: p.detach().clone() for k, p in named.items()}
    adamw_update(zeros, adamw_init(named), named, TrainConfig(**kw),
                 reference_ranks(tp, tm.cfg))
    jp2, _, _ = jax.jit(jax_adamw_update, static_argnums=3)(
        jax.tree.map(jnp.zeros_like, jp), jax_adamw_init(jp), jp,
        JaxTrainConfig(**kw))
    got = lm_params_to_numpy(tp, tm.cfg)
    for (path, want), (_, g) in zip(_leaves(jp2), _leaves(got)):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-6, atol=0,
                                   err_msg=jax.tree_util.keystr(path))
    shrink = 1.0 - 0.1 * 0.5
    for name, decayed in (("layers.0.norm1.scale", True),
                          ("layers.2.norm2.scale", True),
                          ("layers.3.norm1.scale", False),
                          ("final_norm.scale", False)):
        want = before[name] * shrink if decayed else before[name]
        torch.testing.assert_close(named[name].detach(), want, rtol=1e-6,
                                   atol=0)


def test_weight_decay_ranks_of_the_moe_and_mla_leaves():
    """deepseek-v2-236b reduced to 3 layers: the dense head layer is not
    stacked in the reference (its MLA norm scales are rank 1, not
    decayed), the two scanned MoE layers are (their norm scales rank 2,
    decayed; the f32 router rank 3). A zero-gradient AdamW step decays
    exactly the reference's leaves."""
    jm, jp, tm, tp = _pair("deepseek-v2-236b", n_layers=3)
    kw = dict(learning_rate=0.1, warmup_steps=0, schedule="constant",
              weight_decay=0.5)
    named = dict(tp.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    adamw_update({k: torch.zeros_like(p) for k, p in named.items()},
                 adamw_init(named), named, TrainConfig(**kw),
                 reference_ranks(tp, tm.cfg))
    jp2, _, _ = jax.jit(jax_adamw_update, static_argnums=3)(
        jax.tree.map(jnp.zeros_like, jp), jax_adamw_init(jp), jp,
        JaxTrainConfig(**kw))
    got = lm_params_to_numpy(tp, tm.cfg)
    for (path, want), (_, g) in zip(_leaves(jp2), _leaves(got)):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-6, atol=0,
                                   err_msg=jax.tree_util.keystr(path))
    shrink = 1.0 - 0.1 * 0.5
    for name, decayed in (("layers.0.mixer.q_a_norm.scale", False),
                          ("layers.0.ffn.wi_gate", True),
                          ("layers.1.mixer.kv_a_norm.scale", True),
                          ("layers.2.ffn.router", True),
                          ("layers.2.ffn.shared.wo", True)):
        want = before[name] * shrink if decayed else before[name]
        torch.testing.assert_close(named[name].detach(), want, rtol=1e-6,
                                   atol=0)


def _bf16_close(got, want) -> bool:
    """The bf16 tolerance of the module docstring, for one leaf."""
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    return bool(np.all(diff <= 2.0**-6 * np.abs(want) + 2.0**-5 * scale)
                and np.linalg.norm(got - want) <= 2.0**-5 * np.linalg.norm(want))


def test_bf16_train_step_matches_reference():
    """One bf16 step with one microbatch: the gradients stay bf16 on both
    sides (clipping casts them back) and enter the f32 first moment as
    0.1·g, which is held leaf by leaf against the reference's."""
    jm, jp, tm, tp = _pair("qwen1.5-0.5b", "bfloat16")
    kw = dict(learning_rate=1e-3, warmup_steps=0, schedule="constant")
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    (b,) = _batches(1, 4, 16, tm.cfg.vocab_size)
    _, jstate, jmetrics = jax.jit(jax_make_train_step(jm, jtc))(
        jp, jax_adamw_init(jp), _jax_batch(b))
    _, state, metrics = make_train_step(tm, tc)(
        tp, adamw_init(dict(tp.named_parameters())), _torch_batch(b))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-2)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=2.0**-6)
    got_m = lm_params_to_numpy(state.m, tm.cfg)
    for (path, want), (_, got) in zip(_leaves(jstate.m), _leaves(got_m)):
        want = np.asarray(want, np.float32)
        assert _bf16_close(got, want), (
            jax.tree_util.keystr(path), float(np.abs(got - want).max()),
            float(np.abs(want).max()))
        # the tolerance tells a wrong gradient of this leaf from a right one
        assert not _bf16_close(-got, want), jax.tree_util.keystr(path)
        assert not _bf16_close(np.zeros_like(got), want), \
            jax.tree_util.keystr(path)
