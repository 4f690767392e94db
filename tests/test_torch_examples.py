"""The port's examples (``examples_torch/``) against the reference's
(``examples/``), on the CPU.

Each reference example is loaded from its path with ``importlib`` and run
as its ``main`` runs it (``sys.argv`` set, stdout captured); its module
constants are set with ``monkeypatch``, never by editing the file. The
port's example runs with ``--device cpu``. One run of each side is shared
by the tests of that example (module-scoped fixtures).

Levels:

* merge_study: ``run_point`` at two CAV shares, 2 seeds, 400 steps (merges
  and throughput non-zero), against the port's one batched call over both
  points (``run_points``) and its ``run_point`` at the first: counters
  exact, mean speed within rtol
  1e-5 (``test_torch_simulator.py::test_rollout_counters_match``);
* scenario_zoo (2 instances x 100 steps) and quickstart's sweep: every
  digest as ``test_torch_sweep.py::test_aggregate_matches_reference``
  holds an aggregate (integers exact, floats within rtol 1e-5);
* phase3_dataset (``--quick --instances 4``): the manifest, the series and
  the token corpus as ``test_torch_shards.py`` holds a dataset;
* serve_lm: the reference's initial weights (carried across by
  ``convert.lm_params_from_numpy``) in f32 (bf16 rounds at other points
  in the two packages, ``test_torch_serve.py``): the printed
  ``greedy_generate`` and engine tokens equal;
* the training stages (quickstart, phase3_dataset, train_lm; in
  ``tests/test_torch_examples_train.py``): the
  reference's initial weights (``Trainer.init_state`` patched), every step
  logged and the first ``N_TRAIN`` steps run (the examples' ``Trainer``
  replaced by a subclass); ``ce`` of each within rtol 1e-2, the bf16 loss
  tolerance of ``test_torch_train_parity.py`` (the examples train in the
  configs' bf16).
"""

import contextlib
import dataclasses
import importlib.util
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.config import get_arch as jax_arch
from repro.models import build_model as jax_build
from repro_torch.config.base import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.registry import Model
from repro_torch.train import adamw_init
from repro_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
N_TRAIN = 3          # training steps run and compared in each stage
CE_RTOL = 1e-2       # bf16 loss, tests/test_torch_train_parity.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models and sweeps: torch's intra-op threads only contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(package: str, name: str):
    """``<package>/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"_{package}_{name}", ROOT / package / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(mod, argv: list[str]) -> str:
    """The reference example's ``main`` under ``sys.argv``; its stdout."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(sys, "argv", [mod.__file__, *argv])
        mod.main()
    return buf.getvalue()


def run_port(mod, argv: list[str]):
    """The port example's ``main`` on the CPU; (its result, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main([*argv, "--device", "cpu"])
    return out, buf.getvalue()


def reference_init(cfg, seed: int, device="cpu"):
    """The reference's ``init(key(seed))`` of ``cfg`` as port parameters."""
    jp = jax_build(JModelConfig(**dataclasses.asdict(cfg))).init(
        jax.random.key(seed))
    return lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device)


def port_init_state(self):
    """``Trainer.init_state`` from the reference trainer's weights
    (``init(key(tc.seed))``)."""
    params = reference_init(self.model.cfg, self.tc.seed, self.model.device)
    return (params, adamw_init(dict(params.named_parameters()),
                               self.tc.opt_state_dtype), 0)


def short(trainer_cls):
    """The example's trainer logging every step and running the first
    ``N_TRAIN`` of its steps."""
    class Short(trainer_cls):
        def __init__(self, *args, **kw):
            kw["log_every"] = 1
            super().__init__(*args, **kw)

        def run(self, steps=None):
            return super().run(steps=min(steps or self.tc.total_steps,
                                         N_TRAIN))
    return Short


@contextlib.contextmanager
def training_patched(ref_mod, port_mod):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_mod, "Trainer", short(ref_mod.Trainer))
        mp.setattr(port_mod, "Trainer", short(port_mod.Trainer))
        mp.setattr(Trainer, "init_state", port_init_state)
        yield


def ces(history):
    return [h["ce"] for h in history]


def reference_ces(stdout: str) -> list[float]:
    return [float(line.split("ce=")[1].split()[0])
            for line in stdout.splitlines() if line.startswith("[trainer]")]


def assert_ces_close(got: list[float], want: list[float]):
    assert len(got) == len(want) == N_TRAIN
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=CE_RTOL)


def flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def assert_digest_close(got: dict, want: dict):
    fg, fw = flat(got), flat(want)
    assert list(fg) == list(fw)
    for k in fw:
        if isinstance(fw[k], int):
            assert fg[k] == fw[k], k
        else:
            np.testing.assert_allclose(fg[k], fw[k], rtol=1e-5, err_msg=k)


# ------------------------------------------------------------ merge_study

P_CAVS, SEEDS, STEPS = (0.0, 1.0), 2, 400


def test_merge_study_run_point_matches_reference():
    ref, port = load("examples", "merge_study"), load("examples_torch",
                                                      "merge_study")
    want = [ref.run_point(p, n_seeds=SEEDS, steps=STEPS) for p in P_CAVS]
    batched = port.run_points(P_CAVS, n_seeds=SEEDS, steps=STEPS,
                              device="cpu")
    one = [port.run_point(P_CAVS[0], n_seeds=SEEDS, steps=STEPS,
                          device="cpu")]
    assert all(w[0] > 0 and w[1] > 0 for w in want)
    for got in (batched, one):
        for (tp, merges, blocked, speed), w in zip(got, want):
            assert (tp, merges, blocked) == tuple(w[:3])
            np.testing.assert_allclose(speed, w[3], rtol=1e-5)


# ----------------------------------------------------------- scenario_zoo

@pytest.fixture(scope="module")
def zoo():
    ref, port = load("examples", "scenario_zoo"), load("examples_torch",
                                                       "scenario_zoo")
    summaries = []
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ref, port):
            mp.setattr(mod, "INSTANCES", 2)
            mp.setattr(mod, "STEPS", 100)
        agg = ref.aggregate_metrics
        mp.setattr(ref, "aggregate_metrics",
                   lambda *a, **kw: summaries.append(agg(*a, **kw))
                   or summaries[-1])
        ref_out = run_reference(ref, [])
        got, port_out = run_port(port, [])
    return dict(want_zoo=[s["per_scenario"] for s in summaries[:-1]],
                want_mixed=summaries[-1]["per_scenario"], got=got,
                ref_out=ref_out, port_out=port_out)


def test_scenario_zoo_digests_match_reference(zoo):
    got = zoo["got"]
    assert len(zoo["want_zoo"]) == len(got["zoo"]) == 4
    for want, (name, digest) in zip(zoo["want_zoo"], got["zoo"].items()):
        assert_digest_close(digest, want[name])


def test_scenario_zoo_mixed_sweep_matches_reference(zoo):
    assert zoo["got"]["completion"] == 1.0
    assert_digest_close(zoo["got"]["mixed"], zoo["want_mixed"])
    # the printed lines but the mixed sweep's header (no compile here)
    ref_lines = [x for x in zoo["ref_out"].splitlines() if "ONE" not in x]
    port_lines = [x for x in zoo["port_out"].splitlines() if "ONE" not in x]
    assert len(port_lines) == len(ref_lines)
    assert port_lines[0] == ref_lines[0]
    assert [x.split(":")[0] for x in port_lines] == [
        x.split(":")[0] for x in ref_lines]


# --------------------------------------------------------------- serve_lm

@pytest.fixture(scope="module")
def serve_lm():
    ref, port = load("examples", "serve_lm"), load("examples_torch",
                                                   "serve_lm")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "get_arch", lambda name: dataclasses.replace(
            jax_arch(name), dtype="float32"))
        mp.setattr(port, "get_arch", lambda name: dataclasses.replace(
            get_arch(name), dtype="float32"))
        mp.setattr(Model, "init",
                   lambda self, gen: reference_init(self.cfg, 0, self.device))
        ref_out = run_reference(ref, [])
        got, port_out = run_port(port, [])
    return dict(got=got, ref_out=ref_out, port_out=port_out)


def test_serve_lm_tokens_match_reference(serve_lm):
    def token_lines(out):
        return [x for x in out.splitlines()
                if x.startswith(("[serve_lm] greedy", "[serve_lm] request"))]

    got = serve_lm["got"]
    lines = token_lines(serve_lm["port_out"])
    assert lines == token_lines(serve_lm["ref_out"])
    assert len(lines) == 7 and got["model"].cfg.head_dim == 16
    assert got["greedy"].shape == (2, 8)
    assert [len(got["results"][r]) for r in got["rids"]] == [12] * 6
