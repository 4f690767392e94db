"""Every attention head dim of every registered architecture, reduced and
published, reaches the flash attention kernel: it is one of
``kernels/flash_attention.py::HEAD_DIMS``, or the MLA route pads it into
one (``models/attention.py::mla_head_dim``).

``ModelConfig.reduced()`` gives every arch head dim 16, and the serve
launcher serves the reduced config by default, so a kernel without D 16
refuses the launcher's defaults on the card. The wrapper's plain version
runs on a CPU tensor whatever D is, so these tests read the configs, and
for the reduced ones record the head dim of every kernel call of a
forward pass on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.config.base import get_arch, list_archs
from repro_torch.core import prng
from repro_torch.data.sim_dataset import lm_extras
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import attention as att
from repro_torch.models.registry import build_model


def kernel_head_dims(cfg) -> set[int]:
    """The head dims the kernel route hands the flash kernel for ``cfg``:
    MLA's q/k and v widths padded to one kernel head dim, else the
    config's head dim wherever a layer attends over a sequence."""
    if cfg.use_mla:
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return {att.mla_head_dim(max(qk, cfg.v_head_dim))}
    if cfg.is_encdec or {"global", "local"} & set(cfg.layer_pattern):
        return {cfg.head_dim}
    return set()


@pytest.mark.parametrize("reduced", [True, False],
                         ids=["reduced", "published"])
@pytest.mark.parametrize("arch", list_archs())
def test_every_attention_head_dim_is_a_kernel_head_dim(arch, reduced):
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    dims = kernel_head_dims(cfg)
    assert dims <= set(HEAD_DIMS), (cfg.name, dims, HEAD_DIMS)
    if arch != "rwkv6-3b":   # the one family with no attention layer
        assert dims


@pytest.mark.parametrize("arch", list_archs())
def test_reduced_forward_calls_the_kernel_at_its_head_dims(arch,
                                                           monkeypatch):
    """A reduced forward on the CPU: every call of the kernel wrapper has a
    head dim in ``HEAD_DIMS``, and attention archs make at least one."""
    calls = []
    wrapped = att.flash_attention

    def record(q, k, v, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return wrapped(q, k, v, **kw)

    monkeypatch.setattr(att, "flash_attention", record)
    cfg = get_arch(arch).reduced(dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12)))
    batch = {"tokens": tokens,
             **lm_extras(cfg, 1, 12, prng.key(0, "cpu"))}
    with torch.inference_mode():
        model.apply(params, batch)
    assert {d for call in calls for d in call} <= set(HEAD_DIMS), calls
    if kernel_head_dims(cfg):
        assert calls and {c[0] for c in calls} == kernel_head_dims(cfg)
    else:
        assert not calls
