"""The port's training substrate on the CPU: optimizer, schedules, clipping,
int8 compression, microbatching, remat and the trainer's restart.

The tests that hold only the port's own behaviour mirror
``tests/test_train.py`` case for case; the schedules and the int8
functions are also held against the reference's on the same inputs, and
so are the loss function and ``full_attention``'s gradient at S 4096 (two
``flash_xla`` tiles a side), within rtol 1e-6 (loss) and 1e-5 (its
gradient), and rtol 1e-4, atol 1e-6 (attention), in f32. The models'
gradients and the train steps against the reference's are in
``tests/test_torch_train_parity.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypcompat import given, settings, st

from repro.config import TrainConfig as JaxTrainConfig
from repro.models.attention import full_attention as jax_full_attention
from repro.train import cross_entropy_loss as jax_cross_entropy_loss
from repro.train import lr_schedule as jax_lr_schedule
from repro.train.optim import compress_int8 as jax_compress_int8
from repro.train.optim import (
    compressed_grads_with_feedback as jax_compressed_grads_with_feedback,
)
from repro_torch.config.base import TrainConfig, get_arch
from repro_torch.data.synthetic import synthetic_batches
from repro_torch.models.attention import attention_impl, full_attention
from repro_torch.models.recurrent import recurrence_impl
from repro_torch.models.registry import build_model
from repro_torch.train import (
    adamw_init,
    adamw_update,
    cross_entropy_loss,
    lr_schedule,
    make_train_step,
)
from repro_torch.train.optim import (
    clip_by_global_norm,
    compress_int8,
    compressed_grads_with_feedback,
    decompress_int8,
    global_norm,
)
from repro_torch.train.step import _split_microbatches, make_loss_fn
from repro_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: torch's intra-op threads only contend
    with the other test workers (up to 14x slower under a loaded
    machine), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_model():
    return build_model(get_arch("qwen1.5-0.5b").reduced(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=64,
    ), "cpu")


def _init(model, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return model.init(gen)


def test_adamw_converges_on_quadratic():
    tc = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=200,
                     schedule="constant", weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2.0 * params["w"]}  # d/dw of w²
        params, state, _ = adamw_update(grads, state, params, tc)
    assert float(params["w"].abs().max()) < 1e-2


def test_lr_schedule_shapes():
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(tc, torch.tensor(s))) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9          # warmup peak
    assert lrs[100] < 1e-5                      # cosine decayed
    assert all(b <= a + 1e-12 for a, b in zip(lrs[10:], lrs[11:]))  # monotone


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_lr_schedule_matches_reference(schedule):
    kw = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100,
              schedule=schedule)
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    for s in range(101):
        got = float(lr_schedule(tc, torch.tensor(s, dtype=torch.int32)))
        want = float(jax_lr_schedule(jtc, jnp.asarray(s, jnp.int32)))
        assert abs(got - want) <= 1e-7, (s, got, want)


def test_grad_clip():
    g = {"a": torch.ones(4) * 100.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) == pytest.approx(200.0)


def test_cross_entropy_perfect_prediction():
    logits = torch.full((1, 4, 8), -30.0)
    logits[0, :, 2] = 30.0
    labels = torch.full((1, 4), 2, dtype=torch.int32)
    loss, _ = cross_entropy_loss(logits, labels)
    assert float(loss) < 1e-4


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 8, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(
        lambda x: jax_cross_entropy_loss(x, jnp.asarray(labels), z_loss),
        has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss, metrics = cross_entropy_loss(x, torch.from_numpy(labels), z_loss)
    (g,) = torch.autograd.grad(loss, [x])
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (1000, 30.0)])
def test_full_attention_gradient_at_4096_matches_reference(window, cap):
    """S 4096: two flash_xla tiles of 2048 on each axis on both sides."""
    rng = np.random.default_rng(5)
    b, s, h, d = 1, 4096, 2, 16
    q, k, v, dy = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                   for _ in range(4))
    kw = dict(causal=True, window=window, scale=d**-0.5, cap=cap)

    def jax_loss(q, k, v):
        return jnp.sum(jax_full_attention(q, k, v, **kw) * dy)

    jgrads = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    with attention_impl("xla"):
        out = full_attention(*ts, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), ts)
    for name, g, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=f"d{name}")


def test_microbatching_matches_full_batch():
    """Gradient accumulation must be semantically identical to full batch."""
    model = _tiny_model()
    gen = torch.Generator()
    gen.manual_seed(1)
    tokens = torch.randint(0, 64, (4, 16), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}

    tc1 = TrainConfig(microbatches=1, warmup_steps=0, schedule="constant")
    tc4 = TrainConfig(microbatches=4, warmup_steps=0, schedule="constant")
    p1, p4 = _init(model), _init(model)
    s1 = adamw_init(dict(p1.named_parameters()))
    s4 = adamw_init(dict(p4.named_parameters()))
    p1, _, m1 = make_train_step(model, tc1)(p1, s1, batch)
    p4, _, m4 = make_train_step(model, tc4)(p4, s4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for a, b in zip(p1.parameters(), p4.parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   rtol=2e-2, atol=2e-3)


def test_trainer_loss_decreases_and_restarts(tmp_path):
    model = _tiny_model()
    tc = TrainConfig(
        learning_rate=3e-3, warmup_steps=5, total_steps=30,
        schedule="cosine", seed=0,
    )
    data = synthetic_batches(model.cfg, batch=4, seq=16, seed=1, device="cpu")
    tr = Trainer(model, tc, data, ckpt_dir=str(tmp_path / "ck"),
                 ckpt_every=10, log_every=10, log_fn=lambda s: None)
    tr.run(steps=20)
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0]

    # restart resumes from step 20 (fresh data iterator seeks via history)
    data2 = synthetic_batches(model.cfg, batch=4, seq=16, seed=1,
                              start_step=20, device="cpu")
    tr2 = Trainer(model, tc, data2, ckpt_dir=str(tmp_path / "ck"),
                  ckpt_every=10, log_every=10, log_fn=lambda s: None)
    tr2.run(steps=30)
    assert tr2.history[0]["step"] == 30


def test_trainer_resume_is_bit_exact(tmp_path):
    """4 steps straight equal 2 steps, a checkpoint, a new trainer that
    restores it and 2 more steps, bit for bit: parameters, moments, step
    and the losses of steps 3 and 4."""
    model = _tiny_model()
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=4)

    def trainer(ckpt, start):
        data = synthetic_batches(model.cfg, batch=4, seq=16, seed=1,
                                 start_step=start, device="cpu")
        return Trainer(model, tc, data, ckpt_dir=ckpt, log_every=1,
                       log_fn=lambda s: None)

    straight = trainer(None, 0)
    p_a, s_a = straight.run(steps=4)
    trainer(str(tmp_path / "ck"), 0).run(steps=2)
    resumed = trainer(str(tmp_path / "ck"), 2)
    p_b, s_b = resumed.run(steps=4)
    assert [h["step"] for h in resumed.history] == [3, 4]
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in straight.history[2:]]
    for (name, a), b in zip(p_a.named_parameters(), p_b.parameters()):
        assert torch.equal(a, b), name
    assert int(s_a.step) == int(s_b.step) == 4
    for k in s_a.m:
        assert torch.equal(s_a.m[k], s_b.m[k]) and torch.equal(
            s_a.v[k], s_b.v[k]), k


@pytest.mark.parametrize("arch,overrides", [
    ("qwen1.5-0.5b", {}), ("gemma2-2b", {}),
    ("recurrentgemma-2b", {"n_layers": 5}),  # a block of 3 and 2 tail layers
    ("rwkv6-3b", {}),
])
def test_remat_settings_give_bit_equal_gradients(arch, overrides):
    cfg = dataclasses.replace(get_arch(arch).reduced(**overrides),
                              dtype="float32")
    model = build_model(cfg, "cpu")
    params = _init(model, 3).requires_grad_(True)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 25)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = list(params.parameters())
    grads = {}
    for remat in ("none", "full", "dots"):
        loss_fn = make_loss_fn(model, TrainConfig(remat=remat))
        with attention_impl("xla"), recurrence_impl("plain"):
            loss, _ = loss_fn(params, batch)
            grads[remat] = torch.autograd.grad(loss, leaves)
    for remat in ("full", "dots"):
        for (name, _), a, b in zip(params.named_parameters(), grads["none"],
                                   grads[remat]):
            assert torch.equal(a, b), (remat, name)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recomputes_the_plain_paths_on_another_thread(
        monkeypatch, arch, remat):
    """On the card the autograd engine runs the backward, and so the
    checkpoints' recomputation, on a thread of its own, where the caller's
    attention_impl and recurrence_impl are unset. A backward run from
    another thread does that on the CPU: the recomputation must still take
    the plain paths, never the kernel wrappers."""
    import threading

    from repro_torch.models import attention, recurrent

    calls = []
    for mod, name in ((attention, "flash_attention"),
                      (recurrent, "rglru_linear_scan"), (recurrent, "wkv6")):
        wrapped = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _w=wrapped, _n=name, **k:
                            calls.append(_n) or _w(*a, **k))
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, "cpu")
    params = _init(model).requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 17))
    with attention_impl("xla"), recurrence_impl("plain"):
        loss, _ = make_loss_fn(model, TrainConfig(remat=remat))(
            params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    grads = []
    worker = threading.Thread(target=lambda: grads.extend(
        torch.autograd.grad(loss, list(params.parameters()))))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and len(grads) == len(list(params.parameters()))
    assert calls == []


def test_unported_batches_and_losses_raise():
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32),
             "labels": torch.zeros((4, 8), dtype=torch.int32)}
    parts = _split_microbatches(batch, 2)
    assert [p["tokens"].shape for p in parts] == [(2, 8), (2, 8)]
    with pytest.raises(ValueError, match="3 microbatches"):
        _split_microbatches(batch, 3)
    # M-RoPE positions [3, B, S] split on their batch axis (they raised
    # before the qwen2-vl family was ported)
    mrope = torch.arange(3 * 4 * 8).reshape(3, 4, 8)
    parts = _split_microbatches(dict(batch, mrope_pos=mrope), 2)
    assert [p["mrope_pos"].shape for p in parts] == [(3, 2, 8), (3, 2, 8)]
    assert torch.equal(parts[1]["mrope_pos"], mrope[:, 2:])
    # the MoE loss adds moe_aux_weight times the layers' aux loss (it
    # raised before the MoE families were ported)
    moe = build_model(get_arch("olmoe-1b-7b").reduced(dtype="float32"), "cpu")
    params = _init(moe)
    toks = torch.randint(0, moe.cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    mb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    logits, aux = moe.apply(params, mb)
    ce, _ = cross_entropy_loss(logits, mb["labels"])
    loss, metrics = make_loss_fn(moe, TrainConfig(moe_aux_weight=0.5))(
        params, mb)
    assert float(aux) > 0 and sorted(metrics) == ["ce", "loss", "moe_aux"]
    assert float(metrics["moe_aux"]) == float(aux)
    torch.testing.assert_close(loss, ce + 0.5 * aux, rtol=1e-6, atol=0)


@settings(max_examples=10, deadline=None)
@given(scale=st.floats(1e-4, 1e3))
def test_property_int8_compression_bounded_error(scale):
    g = np.asarray(np.random.default_rng(0).normal(size=(64,)) * scale,
                   np.float32)
    q, s = compress_int8(torch.from_numpy(g))
    err = (decompress_int8(q, s) - torch.from_numpy(g)).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-9
    jq, js = jax_compress_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_error_feedback_accumulates():
    """With error feedback, the mean of compressed grads tracks the truth;
    every step's output and carried error equal the reference's."""
    rng = np.random.default_rng(1)
    g = np.asarray(rng.normal(size=(32,)) * 1e-3, np.float32)
    g_true = {"w": torch.from_numpy(g)}
    err = {"w": torch.zeros(32)}
    jerr = {"w": jnp.zeros((32,), jnp.float32)}
    acc = torch.zeros(32)
    for _ in range(64):
        sent, err = compressed_grads_with_feedback(g_true, err)
        jsent, jerr = jax_compressed_grads_with_feedback(
            {"w": jnp.asarray(g)}, jerr)
        np.testing.assert_array_equal(sent["w"].numpy(),
                                      np.asarray(jsent["w"]))
        np.testing.assert_array_equal(err["w"].numpy(), np.asarray(jerr["w"]))
        acc = acc + sent["w"].float()
    np.testing.assert_allclose((acc / 64.0).numpy(), g, atol=5e-5)
