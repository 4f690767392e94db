"""Phase III end-to-end: sweep → sharded dataset → LM training (the
PyTorch port of ``examples/phase3_dataset.py``).

The paper's pipeline exists so that "researchers can generate massive
datasets from their simulations" (§2.10) and feed them to ML. This example
runs the whole chain on one machine:

1. a fault-tolerant *recording* sweep (mixed scenarios, grouped dispatch,
   injected node failure) streams per-instance time series + token streams
   into npz/jsonl shards via ``repro_torch.data.shards.DatasetWriter``;
2. the sharded dataset is reloaded and inspected;
3. a small LM trains a few steps on the shard-backed token corpus
   (``sim_token_batches(shard_dir=...)``).

Run:  PYTHONPATH=src python examples_torch/phase3_dataset.py
      (on the card; ``--device cpu`` runs it on the CPU; ``--quick`` at
      CI-grade sizes)
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.config.base import TrainConfig, get_arch
from repro_torch.core.aggregate import aggregate_metrics
from repro_torch.core.fault import FailureInjector, run_with_failures
from repro_torch.core.record import RecordConfig
from repro_torch.core.scenario import SimConfig
from repro_torch.core.sweep import SweepConfig, SweepRunner
from repro_torch.core.tokens import vocab_size
from repro_torch.data.shards import DatasetWriter, ShardedDataset
from repro_torch.data.sim_dataset import sim_token_batches
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import Trainer


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns ``{"root", "state", "info", "manifest",
    "dataset", "fields", "series", "corpus", "trainer"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--chunk-steps", type=int, default=80)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--record-every", type=int, default=10)
    ap.add_argument("--record-slots", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--dataset-dir", default=None,
                    help="default: a fresh temp directory")
    ap.add_argument("--quick", action="store_true",
                    help="CI-grade sizes (fewer steps everywhere)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    if args.quick:
        args.steps, args.chunk_steps, args.train_steps = 120, 60, 5
    device = resolve_device(args.device)

    root = args.dataset_dir or tempfile.mkdtemp(prefix="phase3_")

    # ---- 1. recording sweep → shards (with an injected node failure) ----
    sim = SimConfig(n_slots=args.slots)
    cfg = SweepConfig(
        n_instances=args.instances,
        steps_per_instance=args.steps,
        chunk_steps=args.chunk_steps,
        sim=sim,
        scenario_mix=("highway_merge", "lane_drop"),
        dispatch="grouped",
        record=RecordConfig(record_every=args.record_every,
                            k_slots=args.record_slots),
    )
    runner = SweepRunner(cfg, device=device)
    writer = DatasetWriter(root, cfg, shard_size=4)
    injector = FailureInjector(n_workers=4, plan={0: [1]})
    state, info = run_with_failures(runner, injector, writer=writer)
    summary = aggregate_metrics(state.metrics, state.scenario_id,
                                cfg.scenarios)
    manifest = writer.finalize(summary=summary, fault_info=info)
    print(f"[phase3] sweep complete: {info['completion_rate']*100:.0f}% "
          f"({len(info['failure_events'])} failure events survived)")
    print(f"[phase3] dataset: {manifest}")

    # ---- 2. reload + inspect the sharded dataset ----
    ds = ShardedDataset.load(root)
    fields, series, valid = ds.series()
    corpus = ds.token_corpus()
    assert ds.n_instances == args.instances, "dataset must cover every instance"
    print(f"[phase3] {ds.n_instances} instances in "
          f"{len(ds.manifest['shards'])} shards | series {series.shape} "
          f"({', '.join(fields)}) | corpus {corpus.shape[0]} tokens")

    # ---- 3. train a small LM on the shard-backed corpus ----
    model_cfg = get_arch("qwen1.5-0.5b").reduced(
        d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=512,
        n_layers=2, vocab_size=max(vocab_size(sim), 128),
    )
    model = build_model(model_cfg, device)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                     total_steps=args.train_steps, schedule="cosine")
    data = sim_token_batches(model_cfg, sim, batch=4, seq=64, shard_dir=root,
                             device=device)
    trainer = Trainer(model, tc, data, log_every=max(args.train_steps // 2, 1))
    trainer.run(steps=args.train_steps)
    ce0, ce1 = trainer.history[0]["ce"], trainer.history[-1]["ce"]
    print(f"[phase3] trained {args.train_steps} steps on sweep shards: "
          f"ce {ce0:.3f} -> {ce1:.3f}")
    return dict(root=root, state=state, info=info, manifest=manifest,
                dataset=ds, fields=fields, series=series, valid=valid,
                corpus=corpus, trainer=trainer)


if __name__ == "__main__":
    main()
