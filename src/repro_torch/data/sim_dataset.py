"""Phase-III data: LM training batches drawn from simulation sweeps.

Port of ``repro/data/sim_dataset.py``. Token streams come from the sweep
path itself: a sharded dataset directory written by
:class:`repro_torch.data.shards.DatasetWriter` (``shard_dir=...``: sweep
once, train many times), or an in-process recording sweep through the same
:class:`~repro_torch.core.sweep.SweepRunner` the launcher uses. Either way
the batcher packs one flat token corpus into fixed-shape next-token
windows, as tensors on the requested device (``cuda`` unless ``cpu``).

A batch carries its family's extras as the reference's does
(:func:`lm_extras`): an encoder-decoder's audio-stub ``frames`` (a normal
draw from ``fold_in(key(seed), step)`` in the model's type; the sim stream
conditions the decoder only) and an M-RoPE model's ``mrope_pos`` (three
equal streams of the positions).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.record import RecordConfig
from repro_torch.core.scenario import SimConfig
from repro_torch.core.sweep import SweepConfig, SweepRunner
from repro_torch.core.tokens import PAD, trace_token_streams, vocab_size
from repro_torch.device import resolve_device
from repro_torch.models.common import cdtype


def lm_extras(cfg, batch: int, seq: int, frames_key: torch.Tensor) -> dict:
    """The batch extras of ``cfg``'s family, on ``frames_key``'s device:
    ``frames [batch, enc_ctx, d_model]`` = ``prng.normal(frames_key)`` in
    the model's type for an encoder-decoder, ``mrope_pos [3, batch, seq]``
    int32 (each stream ``0..seq-1``) for an M-RoPE config."""
    out = {}
    if cfg.is_encdec:
        out["frames"] = prng.normal(frames_key,
                                    (batch, cfg.enc_ctx, cfg.d_model),
                                    cdtype(cfg))
    if cfg.mrope_sections:
        pos = torch.arange(seq, dtype=torch.int32, device=frames_key.device)
        out["mrope_pos"] = pos.expand(3, batch, seq).contiguous()
    return out


def sim_token_corpus(
    sim: SimConfig,
    n_instances: int,
    seed: int = 0,
    n_steps: int = 400,
    record_every: int = 10,
    k_slots: int = 8,
    scenario_mix: tuple[str, ...] = (),
    dispatch: str = "auto",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Run a recording sweep in-process (on ``device``, ``cuda`` unless
    ``cpu``) and concatenate every instance's token stream, PAD tails
    stripped: the streams a launched sweep's shards hold for the same
    config."""
    cfg = SweepConfig(
        n_instances=n_instances,
        steps_per_instance=n_steps,
        chunk_steps=n_steps,
        sim=sim,
        seed=seed,
        scenario_mix=scenario_mix,
        dispatch=dispatch,
        # token channels only: scalar series would be dead weight here
        record=RecordConfig(record_every=record_every, fields=(),
                            k_slots=k_slots),
    )
    state = SweepRunner(cfg, device=device).run()
    lane, speed, active = (x.cpu().numpy() for x in state.trace[1:])
    streams, lengths = trace_token_streams(
        lane, speed, active, state.horizon.cpu().numpy() // record_every, sim
    )
    return np.concatenate([s[:n] for s, n in zip(streams, lengths)])


def shard_token_corpus(shard_dir: str) -> tuple[np.ndarray, int]:
    """(flat token corpus, token vocabulary size) of a written dataset
    directory; the vocabulary comes from its manifest, which may have been
    written with another ``SimConfig`` or bucket count than the caller's."""
    from repro_torch.data.shards import ShardedDataset

    ds = ShardedDataset.load(shard_dir)
    return ds.token_corpus(), int(ds.manifest["vocab_size"])


def sim_token_batches(
    cfg,
    sim: SimConfig,
    batch: int,
    seq: int,
    n_instances: int = 8,
    seed: int = 0,
    start_step: int = 0,
    shard_dir: str | None = None,
    device: str | torch.device | None = None,
) -> Iterator[dict]:
    """Fixed-shape ``{"tokens", "labels"}`` batches (i32 ``[batch, seq]``
    on ``device``), with the family's extras (:func:`lm_extras`), over the
    sim corpus, wrapping around it forever.

    ``shard_dir`` reads a :class:`~repro_torch.data.shards.DatasetWriter`
    directory; without it a small recording sweep runs in-process on
    ``device``. The model's vocabulary must cover the corpus's.
    """
    dev = resolve_device(device)
    if shard_dir is not None:
        corpus, need_vocab = shard_token_corpus(shard_dir)
    else:
        corpus = sim_token_corpus(sim, n_instances, seed, device=dev)
        need_vocab = vocab_size(sim)
    if cfg.vocab_size < need_vocab:
        raise ValueError(
            f"model vocab {cfg.vocab_size} < sim token vocab {need_vocab}")
    return _windows(cfg, corpus, batch, seq, start_step,
                    prng.key(seed, dev))


def _windows(cfg, corpus: np.ndarray, batch: int, seq: int, step: int,
             base: torch.Tensor) -> Iterator[dict]:
    dev = base.device
    span = batch * (seq + 1)
    n = corpus.shape[0]
    while True:
        off = (step * span) % max(n - span, 1)
        window = corpus[off : off + span]
        if window.shape[0] < span:
            window = np.pad(window, (0, span - window.shape[0]),
                            constant_values=PAD)
        arr = torch.from_numpy(
            window.reshape(batch, seq + 1).astype(np.int32)).to(dev)
        yield {"tokens": arr[:, :-1], "labels": arr[:, 1:],
               **lm_extras(cfg, batch, seq, prng.fold_in(base, step))}
        step += 1
