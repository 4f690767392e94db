"""Serving engine: prefill/decode + slot-based continuous batching (port of
``repro/serve/engine.py``). An encoder-decoder is served through
:func:`greedy_generate` with ``extras={"frames": ...}``; the engine, whose
requests are tokens alone, refuses it (the reference's fails on it).

``ServeEngine`` keeps a fixed pool of decode slots. Requests join free
slots through a per-slot prefill on a 1-row cache that is then spliced
into the pool; finished slots are recycled at once (continuous batching);
dead slots emit 0. Decoding is greedy. Everything runs under
``torch.inference_mode()``.

The engine also keeps host-clock timings of its own work in
:attr:`ServeEngine.stats` (each prefill and each decode step ends in a
device-to-host copy of its tokens, which synchronises): time to first
token per request from the start of :meth:`ServeEngine.run`, prefill
tokens and seconds, decode tokens and seconds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.config.base import ServeConfig
from repro_torch.models.registry import Model


@torch.inference_mode()
def greedy_generate(model: Model, params: Any, prompt: torch.Tensor,
                    steps: int, max_seq: int | None = None,
                    extras: dict | None = None) -> torch.Tensor:
    """Batched greedy generation (one prefill + a decode loop); returns
    ``[B, steps]`` tokens, the prefill's token first. ``extras`` join the
    prefill's batch only, as in the reference: an encoder-decoder's
    ``frames``, a VLM's ``mrope_pos`` (decode then takes plain RoPE
    positions, as the reference's decode is called without M-RoPE)."""
    b, s0 = prompt.shape
    max_seq = max_seq or (s0 + steps)
    cache = model.init_cache(b, max_seq)
    logits, cache = model.prefill(params, cache,
                                  {"tokens": prompt, **(extras or {})})
    tok = logits.argmax(dim=-1)
    toks = []
    for i in range(steps):
        toks.append(tok)
        pos = torch.full((b,), s0 + i, dtype=torch.int32, device=tok.device)
        logits, cache = model.decode(params, cache, tok, pos)
        tok = logits.argmax(dim=-1)
    return torch.stack(toks, dim=1)


def check_servable(cfg) -> None:
    """Raise for a config the engine cannot serve: an encoder-decoder,
    whose prefill needs ``frames`` where the engine's requests are tokens
    alone. The reference's engine takes it and fails at its first prefill
    with ``KeyError: 'frames'``; the port keeps that limit and says so."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the serving engine takes token requests only, and "
            "an encoder-decoder's prefill needs 'frames' (the reference's "
            "engine fails there with KeyError: 'frames'); serve it through "
            "greedy_generate(..., extras={'frames': ...})")


@dataclasses.dataclass
class _Slot:
    request_id: int | None = None
    pos: int = 0
    out: list[int] = dataclasses.field(default_factory=list)
    remaining: int = 0


class ServeEngine:
    """Continuous batching over a fixed slot pool.

    Usage::

        eng = ServeEngine(model, params, ServeConfig(max_batch=4, max_seq=256))
        eng.submit(tokens, max_new=32)   # any number of requests
        results = eng.run()              # {request_id: [token, ...]}
    """

    def __init__(self, model: Model, params: Any, sc: ServeConfig) -> None:
        check_servable(model.cfg)
        self.model = model
        self.params = params
        self.sc = sc
        with torch.inference_mode():
            self.cache = model.init_cache(sc.max_batch, sc.max_seq)
            self._tok = torch.zeros((sc.max_batch,), dtype=torch.int64,
                                    device=model.device)
        self.slots = [_Slot() for _ in range(sc.max_batch)]
        self.queue: list[tuple[int, np.ndarray, int]] = []
        self.results: dict[int, list[int]] = {}
        self._next_id = 0
        self.stats = dict(first_token_s={}, prefills=0, prefill_tokens=0,
                          prefill_s=0.0, decode_steps=0, decode_tokens=0,
                          decode_s=0.0)
        self._t0 = 0.0

    def submit(self, tokens: np.ndarray, max_new: int) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, np.asarray(tokens), max_new))
        return rid

    def _decode_step(self, tok, pos, live):
        logits, self.cache = self.model.decode(self.params, self.cache, tok,
                                               pos)
        # dead slots keep emitting 0 and don't advance their cache pos —
        # their writes land at pos 0 repeatedly and are masked on read
        return torch.where(live, logits.argmax(dim=-1), 0)

    def _admit(self) -> None:
        dev = self.model.device
        for i, slot in enumerate(self.slots):
            if slot.request_id is not None or not self.queue:
                continue
            rid, tokens, max_new = self.queue.pop(0)
            t0 = time.perf_counter()
            # per-slot prefill on a 1-row cache, then splice into the pool
            one_cache = self.model.init_cache(1, self.sc.max_seq)
            prompt = torch.as_tensor(tokens[None], dtype=torch.int64,
                                     device=dev)
            logits, one_cache = self.model.prefill(self.params, one_cache,
                                                   {"tokens": prompt})
            tok = logits.argmax(dim=-1)
            for pool, one in zip(self.cache, one_cache):
                for name in pool:
                    _splice_row(pool[name], one[name], i)
            self._tok[i] = tok[0]
            first = int(tok[0])
            t1 = time.perf_counter()
            self.stats["first_token_s"][rid] = t1 - self._t0
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += int(tokens.shape[0])
            self.stats["prefill_s"] += t1 - t0
            self.slots[i] = _Slot(request_id=rid, pos=int(tokens.shape[0]),
                                  out=[first], remaining=max_new - 1)

    @torch.inference_mode()
    def run(self) -> dict[int, list[int]]:
        dev = self.model.device
        self._t0 = time.perf_counter()
        while self.queue or any(s.request_id is not None for s in self.slots):
            self._admit()
            t0 = time.perf_counter()
            live = torch.tensor([s.request_id is not None for s in self.slots],
                                device=dev)
            pos = torch.tensor(
                [s.pos if s.request_id is not None else 0 for s in self.slots],
                dtype=torch.int32, device=dev)
            nxt = self._decode_step(self._tok, pos, live)
            self._tok = nxt
            host = nxt.tolist()
            n_live = 0
            for i, slot in enumerate(self.slots):
                if slot.request_id is None:
                    continue
                n_live += 1
                slot.out.append(int(host[i]))
                slot.pos += 1
                slot.remaining -= 1
                if slot.remaining <= 0 or slot.pos >= self.sc.max_seq - 1:
                    self.results[slot.request_id] = slot.out
                    self.slots[i] = _Slot()
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += n_live
            self.stats["decode_s"] += time.perf_counter() - t0
        return self.results


def _splice_row(pool: torch.Tensor, one: torch.Tensor, i: int) -> None:
    """Copy row 0 of ``one`` into row ``i`` of ``pool``'s batch axis (the
    first: the port's caches are one ``[B, ...]`` dict per layer)."""
    pool[i].copy_(one[0])
