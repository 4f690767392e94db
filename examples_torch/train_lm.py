"""End-to-end training: train a ~100M-param LM for a few hundred steps (the
PyTorch port of ``examples/train_lm.py``).

Default config is a ~100M-param qwen-family model on learnable synthetic
sequences; pass ``--data sim`` to train on simulation-derived tokens
instead (Phase III), or pick any of the 10 assigned architectures with
``--arch``.

Run:  PYTHONPATH=src python examples_torch/train_lm.py --steps 300
      (on the card; ``--device cpu`` runs it on the CPU)
"""

import argparse

from repro_torch.config.base import TrainConfig, get_arch
from repro_torch.core.scenario import SimConfig
from repro_torch.data.sim_dataset import sim_token_batches
from repro_torch.data.synthetic import synthetic_batches
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import param_counts
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import Trainer


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns ``{"cfg", "params_count", "trainer"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--data", choices=["synthetic", "sim"],
                    default="synthetic")
    ap.add_argument("--shard-dir", default=None,
                    help="train on a sharded Phase-III dataset directory "
                         "(written by repro_torch.launch.sweep --dataset-dir; "
                         "implies --data sim)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    if args.shard_dir:
        args.data = "sim"
    device = resolve_device(args.device)

    base = get_arch(args.arch)
    pat = len(base.layer_pattern)
    cfg = base.reduced(
        d_model=args.d_model,
        n_heads=max(args.d_model // 64, 1),
        n_kv_heads=max(args.d_model // 64, 1),
        head_dim=64,
        d_ff=args.d_model * 4,
        lru_width=args.d_model,
        n_layers=max(args.n_layers // pat, 1) * pat,
        vocab_size=8192,
    )
    model = build_model(cfg, device)
    n = param_counts(cfg)
    print(f"[train_lm] {cfg.name}: ~{n['total_with_emb']/1e6:.1f}M params "
          f"({n['total']/1e6:.1f}M non-embedding)")

    tc = TrainConfig(
        learning_rate=1e-3, warmup_steps=20, total_steps=args.steps,
        schedule="cosine",
    )
    if args.data == "sim":
        data = sim_token_batches(
            cfg, SimConfig(n_slots=32), batch=args.batch, seq=args.seq,
            shard_dir=args.shard_dir, device=device,
        )
    else:
        data = synthetic_batches(cfg, batch=args.batch, seq=args.seq,
                                 device=device)
    trainer = Trainer(model, tc, data, ckpt_dir=args.ckpt_dir, log_every=20)
    trainer.run(steps=args.steps)
    print(f"[train_lm] final ce={trainer.history[-1]['ce']:.4f} "
          f"({trainer.history[-1]['steps_per_s']:.2f} it/s)")
    return dict(cfg=cfg, params_count=n, trainer=trainer)


if __name__ == "__main__":
    main()
