"""The port's dry-run tooling against the reference's: parameter counts and
model FLOPs, ``meta`` parameters, optimizer states and caches, input
specs, the roofline report; the costing's ``meta`` count against
``FlopCounterMode`` on real CPU tensors and against a hand count; and one
reduced dry-run cell end to end.

Every port tree is compared by the reference's leaf paths
(``repro_torch.utils.tree``): the leaves of a layer the reference stacks
are rows of its stacked leaf, so they are stacked here before comparing
shapes."""

import json

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro.config import SHAPES as REF_SHAPES
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.launch import roofline as ref_roofline
from repro.launch.specs import cell_is_applicable as ref_applicable
from repro.launch.specs import input_specs as ref_input_specs
from repro.models import build_model as ref_build_model
from repro.train.step import abstract_train_state as ref_abstract_train_state
from repro.utils.tree import tree_bytes as ref_tree_bytes
from repro_torch.config import SHAPES, ShapeConfig, TrainConfig, get_arch
from repro_torch.config import list_archs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import costing, dryrun, roofline
from repro_torch.launch.specs import cell_is_applicable, input_specs
from repro_torch.models.registry import Model
from repro_torch.train.step import abstract_train_state
from repro_torch.utils.tree import is_stacked, tree_bytes
from repro_torch.utils.tree import tree_flatten_with_paths

ARCHS = list_archs()
META = torch.device("meta")


def _ref_leaves(tree) -> dict:
    """{path: (shape, dtype name)} of a reference tree of shape structs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path).lstrip("."):
            (tuple(x.shape), np.dtype(x.dtype).name) for path, x in flat}


def _port_leaves(tree, cfg) -> dict:
    """{reference path: (shape, dtype name)} of a port tree: a stacked
    path's rows are counted into its leading axis."""
    out: dict = {}
    for path, t in tree_flatten_with_paths(tree, cfg):
        dt = str(t.dtype).removeprefix("torch.")
        if is_stacked(path):
            n = out[path][0][0] + 1 if path in out else 1
            assert path not in out or out[path][0][1:] == tuple(t.shape)
            out[path] = ((n, *t.shape), dt)
        else:
            assert path not in out, path
            out[path] = (tuple(t.shape), dt)
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_match_reference(arch, shape):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    assert roofline.param_counts(cfg) == ref_roofline.param_counts(ref_cfg)
    assert roofline.model_flops(cfg, SHAPES[shape]) == \
        ref_roofline.model_flops(ref_cfg, REF_SHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trees_match_reference(arch):
    """Parameters, AdamW state and a decode_32k cache on ``meta``, at full
    width: the reference's paths, shapes, types and bytes, with no
    storage."""
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    ref_model = ref_build_model(ref_cfg)
    ref_params, ref_opt = ref_abstract_train_state(ref_model, RefTrainConfig())
    params, opt = abstract_train_state(Model(cfg, torch.device("cpu")),
                                       TrainConfig())
    assert all(p.is_meta for p in params.parameters())
    assert _port_leaves(params, cfg) == _ref_leaves(ref_params)
    assert tree_bytes(params) == ref_tree_bytes(ref_params)
    assert _port_leaves(opt, cfg) == _ref_leaves(ref_opt)
    assert tree_bytes(opt) == ref_tree_bytes(ref_opt)
    s = SHAPES["decode_32k"]
    cache = Model(cfg, META).abstract_cache(s.global_batch, s.seq_len)
    ref_cache = ref_model.abstract_cache(s.global_batch, s.seq_len)
    assert _port_leaves(cache, cfg) == _ref_leaves(ref_cache)
    assert tree_bytes(cache) == ref_tree_bytes(ref_cache)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    assert cell_is_applicable(cfg, SHAPES[shape]) == ref_applicable(
        ref_cfg, REF_SHAPES[shape])
    got = input_specs(cfg, SHAPES[shape])
    want = ref_input_specs(ref_cfg, REF_SHAPES[shape])
    assert sorted(got) == sorted(want)
    if "cache" in got:
        assert _port_leaves(got.pop("cache"), cfg) == _ref_leaves(
            want.pop("cache"))
    assert _port_leaves(got, None) == _ref_leaves(want)
    assert all(t.is_meta for t in got.values())


@pytest.mark.parametrize("flops,nbytes,wire,n,mf", [
    (1.2e15, 3.4e12, 5.6e9, 256, 2.0e17),
    (2.0e12, 9.0e12, 0.0, 1, 1.0e12),
    (0.0, 0.0, 1.0e9, 4, 0.0),
])
def test_roofline_report_matches_reference_at_its_rates(flops, nbytes, wire,
                                                         n, mf):
    kw = dict(flops_per_device=flops, bytes_per_device=nbytes,
              wire_bytes_per_device=wire, n_devices=n, model_flops_global=mf)
    got = roofline.roofline_report(**kw, peak_flops=ref_roofline.PEAK_FLOPS,
                                   hbm_bw=ref_roofline.HBM_BW,
                                   link_bw=ref_roofline.ICI_BW)
    assert got == ref_roofline.roofline_report(**kw)


# --------------------------------------------------------------------------
# the costing
# --------------------------------------------------------------------------

SMALL_PREFILL = ShapeConfig("prefill", 96, 2, "prefill")
SMALL_TRAIN = ShapeConfig("train", 64, 4, "train")
SMALL_TC = TrainConfig(microbatches=2, remat="full")


def _cpu_count(cfg, shape, tc, monkeypatch) -> tuple[int, int]:
    """FlopCounterMode's count of the cell on real CPU tensors, with the
    flash wrapper's plain version hidden from it as the card's kernel is
    (it runs outside the dispatcher there): (aten FLOPs, kernel FLOPs by
    the kernel's formula for each call)."""
    kernel = []
    plain = fa.ref_attention

    def hidden(q, k, v, causal, window, softcap, scale):
        b, sq, h, d = q.shape
        kernel.append(costing.flash_cost(b, sq, k.shape[1], h, k.shape[2], d,
                                         causal, window,
                                         q.element_size())[0])
        with _disable_current_modes():
            return plain(q, k, v, causal, window, softcap, scale)

    monkeypatch.setattr(fa, "ref_attention", hidden)
    with FlopCounterMode(display=False) as counter:
        costing.run_cell(cfg, shape, tc, device="cpu")
    return counter.get_total_flops(), sum(kernel)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-2b"])
def test_meta_prefill_count_equals_real_cpu_count(arch, monkeypatch):
    """A reduced prefill through the kernel route: the ``meta`` count
    equals FlopCounterMode on real CPU tensors plus the kernel's formula
    for each call, exactly; so does each part."""
    cfg = get_arch(arch).reduced()
    meta = costing.cell_costs(cfg, SMALL_PREFILL)
    aten, kernel = _cpu_count(cfg, SMALL_PREFILL, None, monkeypatch)
    assert meta["aten_flops"] == aten > 0
    assert meta["kernel_flops"] == kernel > 0
    assert meta["kernel_calls"] == {"flash_attention": cfg.n_layers}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b",
                                  "whisper-large-v3"])
def test_meta_train_step_count_equals_real_cpu_count(arch, monkeypatch):
    """A reduced train step (2 microbatches, remat full, plain attention):
    the ``meta`` count equals FlopCounterMode on real CPU tensors."""
    cfg = get_arch(arch).reduced()
    meta = costing.cell_costs(cfg, SMALL_TRAIN, SMALL_TC)
    aten, kernel = _cpu_count(cfg, SMALL_TRAIN, SMALL_TC, monkeypatch)
    assert meta["flops_per_device"] == meta["aten_flops"] == aten > 0
    assert kernel == meta["kernel_flops"] == 0


def test_meta_prefill_count_equals_a_hand_count():
    """The reduced qwen1.5-0.5b prefill: the projections, the FFN and the
    last position's logits as matmul FLOPs; the flash kernel's 4·D a live
    pair."""
    cfg = get_arch("qwen1.5-0.5b").reduced()
    b, s = SMALL_PREFILL.global_batch, SMALL_PREFILL.seq_len
    t, d, hd = b * s, cfg.d_model, cfg.head_dim
    h, kh, m, v = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    per_layer = 2 * t * d * hd * (2 * h + 2 * kh) + 3 * 2 * t * d * m
    aten = cfg.n_layers * per_layer + 2 * b * d * v
    kernel = cfg.n_layers * 4 * hd * h * b * s * (s + 1) // 2
    got = costing.cell_costs(cfg, SMALL_PREFILL)
    assert (got["aten_flops"], got["kernel_flops"]) == (aten, kernel)


def test_meta_kernel_input_without_counting_raises():
    q = torch.empty((1, 8, 2, 64), device=META)
    with pytest.raises(ValueError, match="costing"):
        fa.flash_attention(q, q, q)


def test_reduced_dryrun_cell_writes_its_json(tmp_path, monkeypatch):
    """One cell end to end in-process (a reduced qwen1.5-0.5b at train_4k's
    shape, on meta): the plan, the costing and the roofline in the JSON."""
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda arch: get_arch(arch).reduced())
    result = dryrun.run_cell("qwen1.5-0.5b", "train_4k", "1x1")
    saved = json.loads((tmp_path / "qwen1.5-0.5b__train_4k__1x1.json")
                       .read_text())
    assert saved == json.loads(json.dumps(result))
    assert saved["status"] == "ok" and saved["n_devices"] == 1
    plan = saved["memory_per_device"]
    assert set(plan) == {"params", "opt_state", "batch", "total",
                         "fits_80GB"}
    assert plan["total"] == plan["params"] + plan["opt_state"] + plan["batch"]
    assert saved["costs"]["flops_per_device"] > 0
    assert saved["model_flops_global"] > 0
    assert saved["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
    assert saved["train_overrides"] == {"microbatches": 2, "remat": "full"}
    wide = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "4x2", save=False)
    assert wide["costs"]["flops_per_device"] is None
    assert "SPMD" in wide["costs"]["reason"] and wide["roofline"] is None
