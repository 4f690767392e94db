"""Dry run: plan and cost every (arch x shape x mesh) cell without a device
(port of ``repro/launch/dryrun.py``).

For each cell: whether it applies (:func:`~repro_torch.launch.specs.cell_is_applicable`);
each device's bytes of parameters, optimizer state, cache and batch under
the sharding plan (:mod:`repro_torch.sharding`) and whether they fit an
H100's 80 GB; the FLOPs and bytes of one device's step, counted on the
``meta`` device at full depth (:mod:`repro_torch.launch.costing`; a
one-card mesh only); ``model_flops`` and the roofline at H100 rates
(:mod:`repro_torch.launch.roofline`). Each cell's JSON goes to
``build/dryrun/``. It sets no XLA flags and touches no device: every
tensor is on ``meta``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 4x1
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.config.base import SHAPES, TrainConfig, get_arch, list_archs
from repro_torch.launch.costing import cell_costs
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.launch.roofline import model_flops, roofline_report
from repro_torch.launch.specs import cell_is_applicable, input_specs
from repro_torch.models.registry import Model
from repro_torch.sharding import (
    batch_specs,
    cache_specs,
    opt_state_specs,
    param_specs,
    plan_bytes,
)
from repro_torch.train.step import abstract_train_state

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
#: one H100's device memory
DEVICE_BYTES = 80e9

# per-arch training knobs of the big cells (the reference's: memory-driven;
# microbatches at most global_batch / dp = 256 / 16 = 16)
TRAIN_OVERRIDES: dict[str, dict] = {
    "deepseek-v2-236b": {"microbatches": 16, "remat": "full"},
    "gemma2-9b": {"microbatches": 4, "remat": "full"},
    "minicpm3-4b": {"microbatches": 16, "remat": "full"},
    "whisper-large-v3": {"microbatches": 16, "remat": "full"},
    "qwen2-vl-2b": {"microbatches": 4, "remat": "full"},
    "gemma2-2b": {"microbatches": 4, "remat": "full"},
    "recurrentgemma-2b": {"microbatches": 4, "remat": "full"},
    "rwkv6-3b": {"microbatches": 4, "remat": "full"},
    "olmoe-1b-7b": {"microbatches": 2, "remat": "full"},
    "qwen1.5-0.5b": {"microbatches": 2, "remat": "full"},
}


def parse_mesh(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"4x1"`` → ((4, 1), ("data", "model")); three sizes add ``pod``."""
    shape = tuple(int(x) for x in text.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None or min(shape) < 1:
        raise ValueError(f"mesh {text!r}: give DATAxMODEL or PODxDATAxMODEL")
    return shape, axes


def train_config(arch: str, overrides: dict | None = None) -> TrainConfig:
    over = dict(TRAIN_OVERRIDES.get(arch, {}))
    over.update(overrides or {})
    return TrainConfig(**over)


def memory_plan(cfg, shape, mesh, tc: TrainConfig | None) -> dict:
    """Each device's bytes of the cell's state under the sharding plan."""
    model = Model(cfg, torch.device("meta"))
    specs = input_specs(cfg, shape)
    plan: dict = {}
    if shape.kind == "train":
        params, opt = abstract_train_state(model, tc)
        plan["params"] = plan_bytes(params, param_specs(cfg, params, mesh),
                                    mesh)
        plan["opt_state"] = plan_bytes(
            opt, opt_state_specs(cfg, opt, params, mesh), mesh)
        plan["batch"] = plan_bytes(specs, batch_specs(mesh, specs), mesh)
    else:
        params = model.abstract_params()
        plan["params"] = plan_bytes(params, param_specs(cfg, params, mesh),
                                    mesh)
        if shape.kind == "prefill":
            cache = model.abstract_cache(shape.global_batch, shape.seq_len)
            batch = specs
        else:
            cache = specs["cache"]
            batch = {k: v for k, v in specs.items() if k != "cache"}
        plan["cache"] = plan_bytes(
            cache, cache_specs(mesh, cache, shape.global_batch), mesh)
        plan["batch"] = plan_bytes(batch, batch_specs(mesh, batch), mesh)
    plan["total"] = sum(plan.values())
    plan["fits_80GB"] = plan["total"] <= DEVICE_BYTES
    return plan


def run_cell(arch: str, shape_name: str, mesh_text: str = "1x1",
             save: bool = True, tc_overrides: dict | None = None) -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh_shape, axes = parse_mesh(mesh_text)
    mesh = make_abstract_mesh(mesh_shape, axes)
    n_dev = math.prod(mesh_shape)
    cell_id = f"{arch}__{shape_name}__{mesh_text}"
    ok, why = cell_is_applicable(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_text,
              "cell": cell_id, "status": "skip", "reason": why}
    if not ok:
        print(f"[dryrun] SKIP {cell_id}: {why}")
        if save:
            _save(cell_id, result)
        return result
    tc = train_config(arch, tc_overrides) if shape.kind == "train" else None
    t0 = time.perf_counter()
    plan = memory_plan(cfg, shape, mesh, tc)
    costs = cell_costs(cfg, shape, tc, n_devices=n_dev)
    mf = model_flops(cfg, shape)
    report = None
    if costs["flops_per_device"] is not None:
        report = roofline_report(
            flops_per_device=costs["flops_per_device"],
            bytes_per_device=costs["bytes_per_device"],
            wire_bytes_per_device=costs["wire_bytes_per_device"],
            n_devices=n_dev, model_flops_global=mf)
    result.update(
        status="ok", n_devices=n_dev, seconds=time.perf_counter() - t0,
        memory_per_device=plan, costs=costs, model_flops_global=mf,
        roofline=report,
        train_overrides=({"microbatches": tc.microbatches, "remat": tc.remat}
                         if tc is not None else None))
    gib = plan["total"] / 2**30
    cost_txt = ("flops/dev n/a (" + costs["reason"] + ")"
                if report is None else
                f"flops/dev={costs['flops_per_device']:.3e} "
                f"bytes/dev={costs['bytes_per_device']:.3e} "
                f"dominant={report['dominant']} "
                f"roofline_frac={report['roofline_fraction']:.3f}")
    print(f"[dryrun] OK {cell_id}: memory/dev {gib:.2f} GiB "
          f"({'fits' if plan['fits_80GB'] else 'does not fit'} 80 GB); "
          f"{cost_txt}")
    if save:
        _save(cell_id, result)
    return result


def _save(cell_id: str, result: dict) -> None:
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    with open(ARTIFACT_DIR / f"{cell_id}.json", "w") as f:
        json.dump(result, f, indent=1)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL or PODxDATAxMODEL (default 1x1)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None,
                    choices=["none", "full", "dots"])
    args = ap.parse_args(argv)

    overrides = {}
    if args.microbatches is not None:
        overrides["microbatches"] = args.microbatches
    if args.remat is not None:
        overrides["remat"] = args.remat

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            try:
                results.append(run_cell(arch, shape, args.mesh,
                                        tc_overrides=overrides or None))
            except Exception as e:  # noqa: BLE001 (a cell's failure is reported; the sweep goes on)
                failures.append((arch, shape, repr(e)))
                print(f"[dryrun] FAIL {arch}/{shape}: {e}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    return results


if __name__ == "__main__":
    main()
