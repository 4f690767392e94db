"""Serving launcher: batched request serving with continuous batching.

``python -m repro_torch.launch.serve --arch <id> --requests 8`` serves
random prompts with seeded random weights on the card; ``--device cpu``
serves on the CPU. As the reference launcher it serves the architecture's
reduced variant (``ModelConfig.reduced()``); ``--full-width`` serves the
published configuration instead. Flags:

``--arch --requests --slots --max-new --max-seq --seed``
    as the reference launcher;
``--min-prompt --max-prompt``
    prompt lengths are drawn uniformly from ``[min, max)`` (default
    ``[4, 16)``, the reference's);
``--device --full-width``.

It prints each request's tokens, the completion line and one line of
timings (time to first token, prefill and decode tokens/s, host clock).
An encoder-decoder (whisper) raises ``NotImplementedError``: the engine
serves token requests only (:func:`repro_torch.serve.engine.check_servable`;
the reference launcher fails on it with ``KeyError: 'frames'``); qwen2-vl
is served as text, with plain RoPE, as the reference's engine serves it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config.base import ServeConfig, get_arch, list_archs
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine, check_servable


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 allow_abbrev=False)
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=16)
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published configuration, not reduced()")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns ``{"results", "prompts", "stats", "seconds",
    "model", "params"}``."""
    args = _parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if not args.full_width:
        cfg = cfg.reduced()
    check_servable(cfg)   # before the weights are drawn
    model = build_model(cfg, args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    eng = ServeEngine(model, params,
                      ServeConfig(max_batch=args.slots, max_seq=args.max_seq))
    rng = np.random.default_rng(args.seed)
    prompts, rids = [], []
    for _ in range(args.requests):
        n = rng.integers(args.min_prompt, args.max_prompt)
        prompts.append(rng.integers(0, cfg.vocab_size, size=n))
        rids.append(eng.submit(prompts[-1], max_new=args.max_new))
    t0 = time.perf_counter()
    results = eng.run()
    seconds = time.perf_counter() - t0
    for rid in rids:
        print(f"[serve] request {rid}: {results[rid]}")
    print(f"[serve] completed {len(results)}/{args.requests} requests")
    st = eng.stats
    ttft = sorted(st["first_token_s"].values())
    print(f"[serve] {cfg.name} on {model.device}: wall {seconds:.3f} s; "
          f"time to first token median {ttft[len(ttft) // 2]:.4f} s, max "
          f"{ttft[-1]:.4f} s; prefill {st['prefill_tokens']} tokens in "
          f"{st['prefill_s']:.4f} s = "
          f"{st['prefill_tokens'] / st['prefill_s']:.1f} tokens/s; decode "
          f"{st['decode_tokens']} tokens in {st['decode_steps']} steps, "
          f"{st['decode_s']:.4f} s = "
          f"{st['decode_tokens'] / st['decode_s']:.1f} tokens/s (host clock)")
    return dict(results=results, prompts=prompts, stats=st, seconds=seconds,
                model=model, params=params)


if __name__ == "__main__":
    main()
