"""The port stands alone: importing every ``repro_torch`` module and running
its sweep launcher (plain; recording with checkpoints, a dataset and
injected faults; two blocks pipelined), its LM batches from that dataset
and synthetic ones, its train launcher on both (and on the
encoder-decoder's and M-RoPE family's synthetic batches), its process
controller, its serve launcher on the CPU (every served family, the MoE,
MLA and M-RoPE ones included) and ``greedy_generate`` of the
encoder-decoder with its stub frames never loads ``jax`` or ``repro``;
asking for ``cuda`` without a card raises instead of falling back to the
CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
EXAMPLES = SRC.parent / "examples_torch"
EXAMPLE_NAMES = ("serve_lm", "quickstart", "scenario_zoo", "merge_study",
                 "phase3_dataset", "train_lm")

PROBE = r"""
import json, pkgutil, importlib, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.argv = ["repro_torch.launch.sweep", "--device", "cpu", "--instances", "4",
            "--steps", "20", "--chunk-steps", "10", "--slots", "8",
            "--scenario-mix", "all", "--neighbor-impl", "cuda",
            "--out", sys.argv[1]]
runpy.run_module("repro_torch.launch.sweep", run_name="__main__")
sys.argv = ["repro_torch.launch.sweep", "--device", "cpu", "--instances", "4",
            "--steps", "20", "--chunk-steps", "10", "--slots", "8",
            "--scenario-mix", "all", "--record-every", "5",
            "--dataset-dir", "ds", "--ckpt-dir", "ck", "--fail-prob", "0.3",
            "--workers", "2", "--record-slots", "2", "--shard-size", "2"]
runpy.run_module("repro_torch.launch.sweep", run_name="__main__")
sys.argv = ["repro_torch.launch.sweep", "--device", "cpu", "--devices", "2",
            "--pipeline", "--instances", "4", "--steps", "20",
            "--chunk-steps", "10", "--slots", "8", "--record-every", "5",
            "--dataset-dir", "ds2", "--ckpt-dir", "ck2", "--record-slots", "2",
            "--shard-size", "2"]
runpy.run_module("repro_torch.launch.sweep", run_name="__main__")
from repro_torch.config.base import get_arch
from repro_torch.core.scenario import SimConfig
from repro_torch.data.sim_dataset import sim_token_batches
from repro_torch.data.synthetic import synthetic_batches
cfg = get_arch("gemma2-2b").reduced()
next(sim_token_batches(cfg, SimConfig(n_slots=8), 2, 16, shard_dir="ds2",
                       device="cpu"))
next(synthetic_batches(cfg, 2, 16, device="cpu"))
for data in (["--data", "synthetic"], ["--data", "sim", "--shard-dir", "ds2"]):
    sys.argv = ["repro_torch.launch.train", "--device", "cpu", "--steps", "3",
                "--batch", "2", "--seq", "16", "--log-every", "1",
                "--microbatches", "2", "--remat", "full",
                "--ckpt-dir", "train_ck_" + data[1]] + data
    runpy.run_module("repro_torch.launch.train", run_name="__main__")
sys.argv = ["repro_torch.launch.controller", "--ckpt-dir", "ctl",
            "--poll", "0.1", "--", "--device", "cpu", "--instances", "2",
            "--steps", "10", "--chunk-steps", "10", "--slots", "8"]
runpy.run_module("repro_torch.launch.controller", run_name="__main__")
for arch in ("gemma2-2b", "recurrentgemma-2b", "rwkv6-3b", "olmoe-1b-7b",
             "minicpm3-4b", "deepseek-v2-236b", "qwen2-vl-2b"):
    sys.argv = ["repro_torch.launch.serve", "--device", "cpu", "--arch",
                arch, "--requests", "2", "--max-new", "3"]
    runpy.run_module("repro_torch.launch.serve", run_name="__main__")
for arch in ("whisper-large-v3", "qwen2-vl-2b"):
    sys.argv = ["repro_torch.launch.train", "--device", "cpu", "--arch", arch,
                "--steps", "1", "--batch", "2", "--seq", "8",
                "--log-every", "1", "--data", "synthetic"]
    runpy.run_module("repro_torch.launch.train", run_name="__main__")
import torch
from repro_torch.core import prng
from repro_torch.models.frontends import audio_frames_stub
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import greedy_generate
wcfg = get_arch("whisper-large-v3").reduced()
wm = build_model(wcfg, "cpu")
toks = greedy_generate(wm, wm.init(torch.Generator().manual_seed(0)),
                       torch.zeros((2, 3), dtype=torch.int64), 3, extras={
                           "frames": audio_frames_stub(prng.key(0, "cpu"),
                                                       wcfg, 2, 8)})
print("[whisper] generated", list(toks.shape))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_no_jax_or_reference_imports(tmp_path):
    out = tmp_path / "sweep.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", PROBE, str(out)], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["leaked"] == []
    assert "repro_torch.launch.sweep" in result["modules"]
    for name in ("repro_torch.core.record", "repro_torch.core.tokens",
                 "repro_torch.core.fault", "repro_torch.core.fleet",
                 "repro_torch.ckpt.io", "repro_torch.ckpt.manager",
                 "repro_torch.data.shards", "repro_torch.launch.controller",
                 "repro_torch.kernels.idm", "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.rglru", "repro_torch.kernels.rwkv6",
                 "repro_torch.models.lm", "repro_torch.models.recurrent",
                 "repro_torch.configs.recurrentgemma_2b",
                 "repro_torch.configs.rwkv6_3b",
                 "repro_torch.configs.olmoe_1b_7b",
                 "repro_torch.configs.minicpm3_4b",
                 "repro_torch.configs.deepseek_v2_236b",
                 "repro_torch.models.ffn", "repro_torch.serve.engine",
                 "repro_torch.launch.serve", "repro_torch.launch.mesh",
                 "repro_torch.data.sim_dataset", "repro_torch.data.synthetic",
                 "repro_torch.train.optim", "repro_torch.train.step",
                 "repro_torch.train.trainer", "repro_torch.launch.train",
                 "repro_torch.models.encdec", "repro_torch.models.frontends",
                 "repro_torch.core.xmath",
                 "repro_torch.configs.whisper_large_v3",
                 "repro_torch.configs.qwen2_vl_2b",
                 "repro_torch.configs.gemma2_9b",
                 "repro_torch.sharding.axes", "repro_torch.sharding.ctx",
                 "repro_torch.launch.specs", "repro_torch.launch.costing",
                 "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
                 "repro_torch.utils.tree", "repro_torch.utils.timing",
                 "repro_torch.core.metrics"):
        assert name in result["modules"]
    assert proc.stdout.count("[trainer] step 3/3") == 2
    for data in ("synthetic", "sim"):
        assert (tmp_path / f"train_ck_{data}" / "step_000000003"
                / "manifest.json").exists()
    assert proc.stdout.count("[serve] completed 2/2 requests") == 7
    assert proc.stdout.count("[trainer] step 1/1") == 2
    assert "[whisper] generated [2, 3]" in proc.stdout
    records = json.loads(out.read_text())["records"]
    assert len(records) == 4 and all(r["steps"] == 20 for r in records)
    manifest = json.loads((tmp_path / "ds" / "manifest.json").read_text())
    assert manifest["n_instances_written"] == 4
    assert "2 device(s) x 1 worker(s)" in proc.stdout
    assert "pipelined I/O" in proc.stdout
    manifest = json.loads((tmp_path / "ds2" / "manifest.json").read_text())
    assert manifest["n_instances_written"] == 4
    assert (tmp_path / "ck" / "journal.jsonl").exists()
    assert "[controller] run complete after 1 attempt(s)" in proc.stdout
    assert json.loads((tmp_path / "ctl" / "result.json").read_text())[
        "fault_info"]["eligible_completion_rate"] == 1.0


def test_sources_never_name_jax_or_reference():
    for path in sorted((SRC / "repro_torch").rglob("*.py")) + sorted(
        EXAMPLES.glob("*.py")
    ) + [SRC.parent / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "repro"), (path, line)


def test_cuda_request_without_card_raises(monkeypatch):
    from repro_torch.convert import sweep_state_from_numpy
    from repro_torch.core.sweep import SweepConfig, SweepRunner
    from repro_torch.device import resolve_device
    from repro_torch.config.base import get_arch
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import sweep as launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.models.registry import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        SweepRunner(SweepConfig(n_instances=2))
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--instances", "2", "--steps", "10"])
    with pytest.raises(RuntimeError, match="cuda"):
        sweep_state_from_numpy(SimpleNamespace(trace=None), None)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_launcher.main(["--requests", "1"])
    for arch in ("gemma2-2b", "recurrentgemma-2b", "rwkv6-3b", "olmoe-1b-7b",
                 "minicpm3-4b", "deepseek-v2-236b", "whisper-large-v3",
                 "qwen2-vl-2b", "gemma2-9b"):
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(get_arch(arch).reduced())
        if arch != "whisper-large-v3":   # refused before any device
            with pytest.raises(RuntimeError, match="cuda"):
                serve_launcher.main(["--arch", arch, "--requests", "1"])
        with pytest.raises(RuntimeError, match="cuda"):
            train_launcher.main(["--arch", arch, "--steps", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


EXAMPLE_PROBE = r"""
import importlib.util, json, sys
for name in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(name, f"{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"leaked": leaked}))
"""


def test_examples_import_no_jax_or_reference():
    """Importing every ``examples_torch`` example loads no ``jax``,
    ``jaxlib`` or ``repro``."""
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(
        EXAMPLE_NAMES)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", EXAMPLE_PROBE,
                           *EXAMPLE_NAMES], env=env, capture_output=True,
                          text=True, timeout=300, cwd=EXAMPLES)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["leaked"] == []


@pytest.mark.parametrize("name", EXAMPLE_NAMES)
def test_example_default_device_raises_without_card(name, monkeypatch):
    """``--device`` left at its default (``cuda``) raises without a card,
    before any work; nothing falls back to the CPU."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])
