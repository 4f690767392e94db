"""Quickstart: the Webots.HPC pipeline end-to-end in one minute (the
PyTorch port of ``examples/quickstart.py``).

1. Run a randomized simulation sweep (the paper's highway-merge workload —
   swap ``scenario=`` for any registry name: lane_drop, stop_and_go,
   speed_limit_zone, or your own; see repro_torch.core.scenarios).
2. Aggregate the output dataset (paper §2.10 "big data" phase).
3. Tokenize trajectories and train a small LM on them (Phase III).

Run:  PYTHONPATH=src python examples_torch/quickstart.py
      (on the card; ``--device cpu`` runs it on the CPU)
"""

import argparse

from repro_torch.config.base import TrainConfig, get_arch
from repro_torch.core.aggregate import aggregate_metrics
from repro_torch.core.scenario import SimConfig
from repro_torch.core.sweep import SweepConfig, SweepRunner, completion_rate
from repro_torch.data.sim_dataset import sim_token_batches
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import Trainer


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns ``{"state", "summary", "completion",
    "trainer"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    device = resolve_device(ap.parse_args(argv).device)

    # ---- 1. simulation sweep (a small paper-style job array) -------------
    sim = SimConfig(n_slots=32, scenario="highway_merge")
    sweep = SweepConfig(
        n_instances=8, steps_per_instance=600, chunk_steps=200, sim=sim,
        seed=42,
    )
    print("== sweep: 8 randomized merge simulations, 60 sim-seconds each ==")
    runner = SweepRunner(sweep, device=device)
    state = runner.run()
    completion = completion_rate(state)
    print(f"completion rate: {completion*100:.0f}%")

    # ---- 2. aggregate the output dataset ---------------------------------
    summary = aggregate_metrics(
        state.metrics, scenario_ids=state.scenario_id,
        scenario_names=sweep.scenarios,
    )
    print("== aggregated dataset ==")
    for k, v in summary.items():
        print(f"  {k}: {v}")

    # ---- 3. train a reduced LM on simulation tokens (Phase III) ---------
    print("== training qwen1.5-0.5b (reduced) on sim tokens ==")
    cfg = get_arch("qwen1.5-0.5b").reduced(vocab_size=256)
    model = build_model(cfg, device)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                     schedule="cosine")
    data = sim_token_batches(cfg, sim, batch=8, seq=64, n_instances=4,
                             device=device)
    trainer = Trainer(model, tc, data, log_every=20)
    trainer.run(steps=60)
    first, last = trainer.history[0]["ce"], trainer.history[-1]["ce"]
    print(f"ce: {first:.3f} -> {last:.3f} (model is learning sim structure)")
    return dict(state=state, summary=summary, completion=completion,
                trainer=trainer)


if __name__ == "__main__":
    main()
