"""The port's multi-head latent attention (``repro_torch.models.attention``)
against the reference's (``repro/models/attention.py``) on the CPU.

The reference's seeded ``mla_init`` parameters, with the two norm scales
redrawn with numpy (zero at init, which would hide a missing norm), are
carried into a port ``MLA``; the same numpy activations and positions go
through the full-sequence layer, the prefill (its output and the latent
cache it writes) and the absorbed decode over several steps. Shapes are
the reduced configs' (d_model 64, 4 heads, q/k head dim 8 + 8, v 16,
latent 16, q LoRA 32), with the minicpm3-4b (q LoRA), deepseek-v2-236b and
no-q-LoRA (``q_proj``) variants. Tolerances: f32 rtol 1e-5, atol 2e-5 and
bf16 rtol = atol = 3e-2, the models' (``tests/test_torch_models.py``).

The default full-sequence route pads q, k and v to one kernel head dim and
calls the flash attention wrapper, which runs its plain version on a CPU
tensor; it must equal the unpadded plain route (``attention_impl("xla")``)
within f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_arch
from repro.models import attention as jatt
from repro_torch.config.base import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as att
from repro_torch.models.attention import (
    MLA,
    attention_impl,
    full_attention,
    mla_apply,
    mla_attention,
    mla_cache_init,
    mla_decode,
    mla_head_dim,
    mla_prefill,
)

TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
VARIANTS = {"minicpm3-4b": ("minicpm3-4b", {}),
            "deepseek-v2-236b": ("deepseek-v2-236b", {}),
            "q_proj": ("deepseek-v2-236b", dict(q_lora_rank=0))}


def _pair(variant, dtype="float32"):
    arch, over = VARIANTS[variant]
    jcfg = jax_arch(arch).reduced(dtype=dtype, **over)
    cfg = get_arch(arch).reduced(dtype=dtype, **over)
    jp = jatt.mla_init(jax.random.key(0), jcfg)
    rng = np.random.default_rng(1)
    for name in ("q_a_norm", "kv_a_norm"):
        if name in jp:
            scale = jp[name]["scale"]
            jp[name] = {"scale": jnp.asarray(
                rng.normal(0.0, 0.1, scale.shape), scale.dtype)}
    tp = MLA(cfg, "cpu")
    with torch.no_grad():
        for name, t in tp.named_parameters():
            leaf = jp
            for part in name.split("."):
                leaf = leaf[part]
            t.copy_(torch.from_numpy(np.asarray(leaf, np.float32)))
    assert hasattr(tp, "q_a") == (cfg.q_lora_rank > 0)
    return jcfg, jp, cfg, tp


def _inputs(dtype, b=2, s=12, seed=2):
    x = np.random.default_rng(seed).normal(size=(b, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    return (jnp.asarray(x, dtype), jnp.asarray(pos),
            torch.from_numpy(x).to(getattr(torch, dtype)),
            torch.from_numpy(pos.copy()))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_apply_matches_reference(variant, dtype):
    jcfg, jp, cfg, tp = _pair(variant, dtype)
    jx, jpos, tx, tpos = _inputs(dtype)
    want = jatt.mla_apply(jcfg, jp, jx, jpos)
    got = mla_apply(cfg, tp, tx, tpos)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)
    with attention_impl("xla"):
        _close(mla_apply(cfg, tp, tx, tpos), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["minicpm3-4b", "deepseek-v2-236b"])
def test_mla_prefill_and_absorbed_decode_match_reference(variant, dtype):
    """A 12-token prefill into a 20-entry cache (its output, latents, rope
    keys and positions), then 4 absorbed decode steps, each step's output
    and the whole cache after it; positions differ by row."""
    jcfg, jp, cfg, tp = _pair(variant, dtype)
    jx, jpos, tx, tpos = _inputs(dtype)
    jc = jatt.mla_cache_init(jcfg, 2, 20)
    tc = mla_cache_init(cfg, 2, 20, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    jy, jc = jatt.mla_prefill(jcfg, jp, jx, jpos, jc)
    ty, tc2 = mla_prefill(cfg, tp, tx, tpos, tc)
    assert tc2 is tc  # written in place
    _close(ty, jy, dtype)
    rng = np.random.default_rng(3)
    for step in range(5):
        if step:
            x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
            pos = np.asarray([12 + step, 10 + 2 * step], np.int32)
            jy, jc = jatt.mla_decode(jcfg, jp, jnp.asarray(x1, dtype),
                                     jnp.asarray(pos), jc)
            ty, tc = mla_decode(cfg, tp,
                                torch.from_numpy(x1).to(tx.dtype),
                                torch.from_numpy(pos), tc)
            _close(ty, jy, dtype)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for name in ("c", "k_rope"):
            _close(tc[name], jc[name], dtype)


def test_mla_decode_drops_a_write_past_the_cache():
    """At ``pos >= max_seq`` the reference's scatter drops the cache write
    (and the step attends over the cache as it is); the port must match,
    not raise, for that row, while the other row writes as usual."""
    jcfg, jp, cfg, tp = _pair("minicpm3-4b")
    jx, jpos, tx, tpos = _inputs("float32", s=8)
    jc = jatt.mla_cache_init(jcfg, 2, 8)
    tc = mla_cache_init(cfg, 2, 8, "cpu")
    _, jc = jatt.mla_prefill(jcfg, jp, jx[:, :6], jpos[:, :6], jc)
    mla_prefill(cfg, tp, tx[:, :6], tpos[:, :6], tc)
    before = {k: v.clone() for k, v in tc.items()}
    x1 = np.random.default_rng(4).normal(size=(2, 1, 64)).astype(np.float32)
    pos = np.asarray([8, 6], np.int32)   # row 0 past the 8-entry cache
    jy, jc = jatt.mla_decode(jcfg, jp, jnp.asarray(x1), jnp.asarray(pos), jc)
    ty, tc = mla_decode(cfg, tp, torch.from_numpy(x1), torch.from_numpy(pos),
                        tc)
    _close(ty, jy, "float32")
    for name in ("c", "k_rope", "pos"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL["float32"])
        assert torch.equal(tc[name][0], before[name][0]), name
        assert not torch.equal(tc[name][1], before[name][1]), name
    assert tc["pos"][1].tolist() == [0, 1, 2, 3, 4, 5, 6, -1]


def test_padded_kernel_route_equals_the_unpadded_plain_route(monkeypatch):
    """The kernel route hands the flash attention wrapper q, k and v zero-
    padded to one kernel head dim (24 → 32 here), and its
    output, sliced to v's 16 columns, equals the plain route on the
    unpadded tensors; the layer's output does too."""
    calls = []
    wrapped = fa.flash_attention
    monkeypatch.setattr(att, "flash_attention", lambda q, k, v, **kw: (
        calls.append((q.shape, k.shape, v.shape, kw)) or wrapped(q, k, v,
                                                                  **kw)))
    gen = torch.Generator().manual_seed(5)
    q, k = (torch.randn(2, 24, 4, 24, generator=gen) for _ in range(2))
    v = torch.randn(2, 24, 4, 16, generator=gen)
    got = mla_attention(q, k, v, scale=24 ** -0.5)
    assert calls == [((2, 24, 4, 32),) * 3 + (
        dict(causal=True, window=0, softcap=0.0, scale=24 ** -0.5,
             work_dims=(24, 16)),)]
    with attention_impl("xla"):
        want = full_attention(q, k, v, causal=True, window=0,
                              scale=24 ** -0.5)
        torch.testing.assert_close(mla_attention(q, k, v, scale=24 ** -0.5),
                                   want, rtol=0, atol=0)
    assert got.shape == (2, 24, 4, 16)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert len(calls) == 1

    _, _, cfg, tp = _pair("deepseek-v2-236b")
    _, _, tx, tpos = _inputs("float32")
    y = mla_apply(cfg, tp, tx, tpos)
    with attention_impl("xla"):
        torch.testing.assert_close(y, mla_apply(cfg, tp, tx, tpos),
                                   rtol=1e-6, atol=1e-6)
    assert len(calls) == 2


def test_mla_head_dims_of_the_published_configs():
    """minicpm3-4b's q/k 96 pad to 128 and deepseek-v2's 192 to 256 (v 64
    and 128 with them); a head dim past the kernel's largest raises."""
    for arch, want in (("minicpm3-4b", 128), ("deepseek-v2-236b", 256)):
        cfg = get_arch(arch)
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        assert mla_head_dim(max(qk, cfg.v_head_dim)) == want
    assert mla_head_dim(16) == 16
    assert mla_head_dim(24) == 32
    assert mla_head_dim(33) == 64
    with pytest.raises(ValueError, match="256"):
        mla_head_dim(257)
