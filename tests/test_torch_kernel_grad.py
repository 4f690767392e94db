"""The CUDA kernels have no backward: a wrapper must refuse a CUDA input that
needs a gradient instead of returning an output without a ``grad_fn``
(``kernels/build.py::refuse_grad``, called first in the CUDA branch of
``flash_attention``, ``rglru_linear_scan`` and ``wkv6``). On the CPU the
wrappers run their plain versions, whose outputs keep their autograd: that
is the path training takes. The CUDA side of the refusal is held by
``tests/test_torch_kernels_cuda.py::test_cuda_wrappers_refuse_inputs_that_need_a_gradient``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import rwkv6 as rw
from repro_torch.kernels.build import refuse_grad


def test_refuse_grad_raises_on_an_input_that_requires_grad():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError) as info:
        refuse_grad("flash_attention", torch.ones(2), x)
    msg = str(info.value)
    for part in ("flash_attention", "no backward", 'attention_impl("xla")',
                 'recurrence_impl("plain")'):
        assert part in msg


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input"])
def test_refuse_grad_lets_what_needs_no_gradient_pass(mode):
    x = torch.ones(3, requires_grad=mode != "no_input")
    if mode == "no_grad":
        with torch.no_grad():
            refuse_grad("wkv6", x)
    elif mode == "inference_mode":
        with torch.inference_mode():
            refuse_grad("wkv6", x)
    else:
        refuse_grad("wkv6", x, torch.zeros(2))


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, lo=None):
        a = (rng.uniform(lo, 0.999, shape) if lo is not None
             else rng.standard_normal(shape))
        return torch.from_numpy(a.astype(np.float32)).requires_grad_()

    if name == "flash_attention":
        return fa.flash_attention, [t(1, 6, 2, 8), t(1, 6, 1, 8), t(1, 6, 1, 8)]
    if name == "rglru_linear_scan":
        return rg.rglru_linear_scan, [t(2, 5, 4, lo=0.7), t(2, 5, 4), t(2, 4)]
    return rw.wkv6, [t(1, 5, 2, 4), t(1, 5, 2, 4), t(1, 5, 2, 3),
                     t(1, 5, 2, 4, lo=0.8), t(2, 4), t(1, 2, 4, 3)]


@pytest.mark.parametrize("name", ["flash_attention", "rglru_linear_scan",
                                  "wkv6"])
def test_cpu_wrappers_keep_autograd(name):
    """On CPU tensors the wrapper runs its plain version: every output that
    depends on the inputs carries a ``grad_fn``, and a backward gives every
    input a finite gradient."""
    fn, args = _inputs(name)
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.grad_fn is not None for o in outs)
    sum(o.float().square().sum() for o in outs).backward()
    for a in args:
        assert a.grad is not None and torch.isfinite(a.grad).all()
        assert a.grad.abs().sum() > 0
