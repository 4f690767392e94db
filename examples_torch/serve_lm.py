"""Batched serving example: continuous batching over a fixed slot pool
(the PyTorch port of ``examples/serve_lm.py``).

The reduced ``--arch`` (gemma2-2b: head dim 16, a window of 16, logit
softcap 50) with seeded random weights: ``greedy_generate`` on a 2 x 8
prompt, then ``--requests`` random prompts through ``--slots`` slots of
the ``ServeEngine``. On the card every prefill runs the flash attention
kernel.

Run:  PYTHONPATH=src python examples_torch/serve_lm.py --requests 6 --slots 2
      (on the card; ``--device cpu`` runs it on the CPU)
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.config.base import ServeConfig, get_arch
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine, greedy_generate


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns ``{"model", "params", "prompt", "greedy",
    "results", "rids", "stats", "seconds"}`` (``stats``: the engine's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    # simple batched greedy first
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    ).to(device)
    out = greedy_generate(model, params, prompt, steps=8)
    print(f"[serve_lm] greedy_generate -> {out.tolist()}")

    # continuous batching: more requests than slots
    eng = ServeEngine(
        model, params, ServeConfig(max_batch=args.slots, max_seq=128)
    )
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    rids = [
        eng.submit(rng.integers(0, cfg.vocab_size, size=rng.integers(3, 10)),
                   max_new=args.max_new)
        for _ in range(args.requests)
    ]
    results = eng.run()
    dt = time.perf_counter() - t0
    for rid in rids:
        print(f"[serve_lm] request {rid}: {results[rid]}")
    total_tokens = sum(len(v) for v in results.values())
    print(f"[serve_lm] {len(results)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s on {device}, host "
          "clock)")
    return dict(model=model, params=params, prompt=prompt, greedy=out,
                results=results, rids=rids, stats=eng.stats, seconds=dt)


if __name__ == "__main__":
    main()
