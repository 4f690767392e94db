"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains an LM on the card (``--device cpu`` on the CPU) through the
:class:`~repro_torch.train.trainer.Trainer`: the train step, checkpoints
and restart, on sim-token or synthetic data. As the reference launcher it
trains the architecture's reduced variant unless ``--full-size``. Flags:

``--arch --reduced --full-size --steps --batch --seq --lr --data sim|synthetic
--shard-dir --ckpt-dir --microbatches --remat --d-model --n-layers``
    as the reference launcher;
``--device``
    the torch device (default ``cuda``);
``--log-every``
    log (and record in the trainer's history) every this many steps.

``--data sim --shard-dir DIR`` trains on a dataset written by
``python -m repro_torch.launch.sweep --dataset-dir DIR``; without
``--shard-dir`` a small recording sweep runs in-process first.
"""

from __future__ import annotations

import argparse

from repro_torch.config.base import TrainConfig, get_arch, list_archs
from repro_torch.core.scenario import SimConfig
from repro_torch.data.sim_dataset import sim_token_batches
from repro_torch.data.synthetic import synthetic_batches
from repro_torch.models.lm import REMAT
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import Trainer


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 allow_abbrev=False)
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="train the reduced() variant (the default)")
    ap.add_argument("--full-size", dest="reduced", action="store_false",
                    help="train the published configuration, not reduced()")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data", choices=["sim", "synthetic"], default="sim")
    ap.add_argument("--shard-dir", default=None,
                    help="train on a sharded Phase-III dataset directory "
                         "(written by repro_torch.launch.sweep --dataset-dir)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=REMAT)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override reduced d_model (e.g. ~100M params)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns ``{"trainer", "params", "opt_state", "model"}``."""
    args = _parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        over = {}
        if args.d_model:
            over = dict(
                d_model=args.d_model, n_heads=max(args.d_model // 64, 1),
                n_kv_heads=max(args.d_model // 64, 1), head_dim=64,
                d_ff=args.d_model * 4, lru_width=args.d_model,
                vocab_size=2048,
            )
        if args.n_layers:
            pat = len(cfg.layer_pattern)
            over["n_layers"] = (args.n_layers // pat) * pat or pat
        cfg = cfg.reduced(**over)
    model = build_model(cfg, args.device)

    tc = TrainConfig(
        learning_rate=args.lr,
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        microbatches=args.microbatches,
        remat=args.remat,
    )
    if args.data == "sim":
        data = sim_token_batches(
            cfg, SimConfig(n_slots=32), batch=args.batch, seq=args.seq,
            shard_dir=args.shard_dir, device=model.device,
        )
    else:
        data = synthetic_batches(cfg, batch=args.batch, seq=args.seq,
                                 device=model.device)

    print(f"[train] arch={cfg.name} device={model.device}")
    trainer = Trainer(model, tc, data, ckpt_dir=args.ckpt_dir,
                      log_every=args.log_every)
    params, opt_state = trainer.run(steps=args.steps)
    return dict(trainer=trainer, params=params, opt_state=opt_state,
                model=model)


if __name__ == "__main__":
    main()
