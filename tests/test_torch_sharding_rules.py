"""The port's sharding rules (``repro_torch.sharding``) against the
reference's, at full width for every architecture and five meshes; the
per-device plan against DTensor's shards on a fake process group; and the
activation context (``constrain``, the vocab-parallel logits pad).

Specs: the reference stacks the layers it scans and gives their leaves a
leading ``None``; the port's per-layer leaf lacks it, and
``reference_spec`` adds it back (``repro_torch.utils.tree`` maps the
paths)."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.config import SHAPES as REF_SHAPES
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.launch.specs import input_specs as ref_input_specs
from repro.models import build_model as ref_build_model
from repro.models.common import logits_from_hidden as ref_logits
from repro.sharding import batch_specs as ref_batch_specs
from repro.sharding import cache_specs as ref_cache_specs
from repro.sharding import opt_state_shardings as ref_opt_state_shardings
from repro.sharding import param_specs as ref_param_specs
from repro.train.step import abstract_train_state as ref_abstract_train_state
from repro_torch.config import SHAPES, TrainConfig, get_arch, list_archs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.common import logits_from_hidden
from repro_torch.models.registry import Model, params_module
from repro_torch.sharding import (
    batch_specs,
    cache_shardings,
    cache_specs,
    local_shape,
    opt_state_specs,
    param_shardings,
    param_specs,
    placements,
    plan_bytes,
)
from repro_torch.sharding.axes import reference_spec
from repro_torch.sharding.ctx import activation_sharding, constrain, tp_size
from repro_torch.train.step import abstract_train_state
from repro_torch.utils.tree import tree_flatten_with_paths

META = torch.device("meta")
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((1, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2), ("data", "model"))]
# the cache specs' shapes: decode_32k (a batch the data axes divide) and
# long_500k (a batch of 1, which they do not)
CACHE_SHAPES = ("decode_32k", "long_500k")


def _ref_path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _ref_specs(tree) -> dict:
    """{path: spec tuple} of a reference tree of PartitionSpecs (or of
    NamedShardings, by their specs)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, jax.sharding.NamedSharding)))
    return {_ref_path(p): tuple(getattr(x, "spec", x)) for p, x in flat}


def _held(port_tree, cfg, ref: dict, what: str) -> None:
    """Every port leaf's spec, mapped to the reference's layout, equals the
    reference's spec at that path, and every reference path is covered."""
    seen = set()
    for path, spec in tree_flatten_with_paths(port_tree, cfg):
        assert path in ref, f"{what}: {path} is not a reference leaf"
        assert reference_spec(path, spec) == ref[path], (
            what, path, spec, ref[path])
        seen.add(path)
    assert seen == set(ref), (what, sorted(set(ref) - seen))


@functools.lru_cache(maxsize=None)
def _ref_trees(arch: str):
    model = ref_build_model(ref_get_arch(arch))
    params, opt = ref_abstract_train_state(model, RefTrainConfig())
    caches = {s: model.abstract_cache(REF_SHAPES[s].global_batch,
                                      REF_SHAPES[s].seq_len)
              for s in CACHE_SHAPES}
    return params, opt, caches


@pytest.mark.parametrize("mesh_shape,axes", MESHES,
                         ids=["x".join(map(str, m)) for m, _ in MESHES])
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_reference(arch, mesh_shape, axes):
    """Param, opt-state, batch and cache specs equal the reference's under
    the same abstract mesh, at full width."""
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    mesh = make_abstract_mesh(mesh_shape, axes)
    ref_mesh = ref_abstract_mesh(mesh_shape, axes)
    ref_params, ref_opt, ref_caches = _ref_trees(arch)
    model = Model(cfg, META)
    params, opt = abstract_train_state(model, TrainConfig())

    ref_p = _ref_specs(ref_param_specs(ref_cfg, ref_params, ref_mesh))
    _held(param_specs(cfg, params, mesh), cfg, ref_p, "params")

    ref_o = _ref_specs(ref_opt_state_shardings(ref_cfg, ref_opt, ref_params,
                                               ref_mesh))
    ref_o = {k.lstrip("."): v for k, v in ref_o.items()}
    o_specs = opt_state_specs(cfg, opt, params, mesh)
    assert o_specs.step == ref_o.pop("step") == ()
    _held(o_specs._replace(step=None), cfg, ref_o, "opt state")

    for name in SHAPES:
        if SHAPES[name].kind == "decode":
            continue
        ref_b = _ref_specs(ref_batch_specs(
            ref_mesh, ref_input_specs(ref_cfg, REF_SHAPES[name])))
        _held(batch_specs(mesh, input_specs(cfg, SHAPES[name])), None,
              ref_b, f"batch {name}")

    for name in CACHE_SHAPES:
        b = SHAPES[name].global_batch
        ref_c = _ref_specs(ref_cache_specs(ref_mesh, ref_caches[name], b))
        cache = model.abstract_cache(b, SHAPES[name].seq_len)
        _held(cache_specs(mesh, cache, b), cfg, ref_c, f"cache {name}")


@pytest.fixture
def fake_mesh():
    """A (2, 4) ``DeviceMesh`` over a fake process group of 8 ranks (this
    process is rank 0; collectives do nothing), destroyed afterwards: the
    workers run other files after this one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-236b",
                                  "recurrentgemma-2b", "whisper-large-v3"])
def test_dtensor_local_shapes_equal_the_plan(fake_mesh, arch):
    """``param_shardings`` and ``cache_shardings`` distribute each leaf by
    its placements; rank 0 holds ``local_shape`` of it, and the plan's
    bytes are the shards' sum."""
    cfg = get_arch(arch).reduced(n_heads=8, vocab_size=512)
    model = Model(cfg, torch.device("cpu"))
    params = params_module(cfg, torch.device("cpu"))
    specs = param_specs(cfg, params, fake_mesh)
    shards = param_shardings(cfg, params, fake_mesh)
    cache = model.init_cache(8, 16)
    cache_spec = cache_specs(fake_mesh, cache, 8)
    cache_shards = cache_shardings(fake_mesh, cache, 8)
    total = {"params": 0, "cache": 0}
    for what, tree, spec_tree, dist_tree in (
            ("params", params, specs, shards),
            ("cache", cache, cache_spec, cache_shards)):
        spec_of = dict(tree_flatten_with_paths(spec_tree))
        local = dict(tree_flatten_with_paths(dist_tree))
        for path, t in tree_flatten_with_paths(tree):
            want = local_shape(spec_of[path], t.shape, fake_mesh)
            assert local[path].placements == tuple(
                placements(spec_of[path], fake_mesh))
            assert tuple(local[path].to_local().shape) == want, (path, want)
            total[what] += int(np.prod(want)) * t.element_size()
        assert plan_bytes(tree, spec_tree, fake_mesh) == total[what]
    assert any(any(s) for s in specs.values())
    assert total["params"] < sum(p.numel() * p.element_size()
                                 for p in params.parameters())


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.randn(4, 8, 16)
    assert tp_size() == 1
    assert constrain(x, "dp", None, "tp") is x
    with activation_sharding(make_abstract_mesh((2, 4), ("data", "model"))):
        assert tp_size() == 4
        assert constrain(x, "dp", None, "tp") is x   # a plain tensor


@pytest.mark.parametrize("tie", [True, False])
def test_vocab_parallel_logits_pad(tie):
    """With tp = 4 the vocabulary (250) pads to 252: the first 250 columns
    equal the reference's unpadded logits and the pad is -2^30; with no
    mesh nothing is padded."""
    cfg = get_arch("gemma2-2b").reduced(vocab_size=250, dtype="float32",
                                        tie_embeddings=tie)
    ref_cfg = ref_get_arch("gemma2-2b").reduced(vocab_size=250,
                                                dtype="float32",
                                                tie_embeddings=tie)
    ref_params = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(
        jax.random.key(0)))
    params = lm_params_from_numpy(ref_params, cfg, "cpu")
    x = np.random.default_rng(0).standard_normal((2, 3, 64)).astype(
        np.float32)
    want = np.asarray(ref_logits(ref_cfg, ref_params["embed"],
                                 ref_params.get("lm_head"), x))
    head = getattr(params, "lm_head", None)
    plain = logits_from_hidden(cfg, params.embed, head, torch.from_numpy(x))
    assert plain.shape == (2, 3, 250)
    with activation_sharding(make_abstract_mesh((1, 4), ("data", "model"))):
        got = logits_from_hidden(cfg, params.embed, head,
                                 torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 252)
    np.testing.assert_allclose(got[..., :250], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., 250:], -2.0**30)
    np.testing.assert_array_equal(got[..., :250], plain.numpy())
