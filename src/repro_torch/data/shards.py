"""Sharded Phase-III dataset: streaming writer + reader.

Port of ``repro/data/shards.py``, writing the same files, so either
package's :class:`ShardedDataset` reads the other's datasets:

    root/
      shard_00000.npz       # columnar arrays (see _write_shard)
      records_00000.jsonl   # one aliased dict record per instance
      ...
      manifest.json         # roster, configs, aliases, shard index,
                            # fault events, summary

:class:`DatasetWriter` drains, at each chunk boundary, the instances that
just finished: their trace rows, terminal metrics and parameter draws. Only
those rows are gathered on the device and copied to the host, once per
chunk. An instance is drained only once ``done``, after the chunk's fault
handling can no longer revert it, and the writer re-scans the shards on
disk when it is made, so a killed and resumed sweep appends exactly the
instances not yet persisted. With the recorder's absolute-step rows the
pipeline never drops or duplicates a row.

Commit order of a shard: the records jsonl first, then the npz, whose
rename is the single commit point the resume scan keys on; temp names
start with ``.``, so the scan never matches them.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.ckpt.io import fsync_dir, fsync_file
from repro_torch.core.aggregate import (
    _PARAM_COLUMNS,
    metrics_to_columns,
    records_from_columns,
)
from repro_torch.core.record import valid_rows as _valid_rows
from repro_torch.core.scenarios import get_scenario
from repro_torch.core.tokens import trace_token_streams, vocab_size

MANIFEST = "manifest.json"
FORMAT = "webots-hpc-phase3/v1"


def _shard_paths(root: str, idx: int) -> tuple[str, str]:
    return (
        os.path.join(root, f"shard_{idx:05d}.npz"),
        os.path.join(root, f"records_{idx:05d}.jsonl"),
    )


def _host(tree):
    """A NamedTuple of tensors → the same NamedTuple of numpy arrays."""
    return type(tree)(*(x.cpu().numpy() for x in tree))


def _row(tree, j: int):
    return type(tree)(*(x[j] for x in tree))


def _stack(rows: list):
    return type(rows[0])(*(np.stack(xs) for xs in zip(*rows)))


class DatasetWriter:
    """Streams a recording sweep into npz/jsonl shards + a manifest.

    Call :meth:`drain` at chunk boundaries and :meth:`finalize` once the
    sweep completes. ``shard_size`` bounds instances per shard; the last
    shard may be smaller. Instances are drained in logical-id order.
    :meth:`begin_drain` (the device-side gather) and :meth:`finish_drain`
    (the host copy and the file writes) are the two halves of
    :meth:`drain`.
    """

    def __init__(self, root: str, cfg, shard_size: int = 16,
                 n_buckets: int = 16, v_max: float = 40.0) -> None:
        if cfg.record is None:
            raise ValueError(
                "DatasetWriter needs a recording sweep: set "
                "SweepConfig.record (repro_torch.core.record.RecordConfig)"
            )
        if shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        self.root = root
        self.cfg = cfg
        self.shard_size = shard_size
        self.n_buckets = n_buckets
        self.v_max = v_max
        os.makedirs(root, exist_ok=True)
        # resume: instances a previous (killed) run persisted. The npz is a
        # shard's commit point, so shard_*.npz matches complete shards only;
        # one that is truncated or unreadable is removed and its instances
        # forgotten, so the resumed sweep drains them again
        self._shards: list[dict[str, Any]] = []
        self._written: set[int] = set()
        self.repaired: list[int] = []  # shard indices dropped as corrupt
        for path in sorted(glob.glob(os.path.join(root, "shard_*.npz"))):
            stem = os.path.basename(path)[len("shard_"):-len(".npz")]
            if not stem.isdigit():
                continue  # not a committed shard of this layout
            ids = self._read_shard_ids(path)
            if ids is None:
                self._discard_shard_files(int(stem))
                self.repaired.append(int(stem))
                continue
            self._shards.append(self._shard_entry(int(stem), ids))
            self._written.update(ids)
        self._next_shard = max(
            [s["index"] for s in self._shards] + self.repaired, default=-1
        ) + 1
        self._pending: dict[int, dict[str, Any]] = {}
        # ids a begin_drain gathered whose finish_drain has not run yet:
        # reserved, so that overlapping handles never drain an instance twice
        self._inflight: set[int] = set()

    def _read_shard_ids(self, path: str) -> list[int] | None:
        """Instance ids of a shard npz, or None when the file is truncated
        or otherwise unreadable."""
        try:
            with np.load(path, allow_pickle=False) as z:
                if "instance" not in z.files:
                    return None
                return [int(i) for i in z["instance"]]
        except Exception:  # a torn npz raises BadZipFile, zlib.error, ...
            return None

    def _discard_shard_files(self, idx: int) -> None:
        for p in _shard_paths(self.root, idx):
            try:
                os.remove(p)
            except OSError:
                pass

    def verify_shards(self) -> list[int]:
        """Audit every committed shard against disk; drop the broken ones.

        A shard whose npz no longer loads, or holds other instances than
        its entry says, is deleted with its records jsonl and its instances
        leave the written set, so the next :meth:`drain` persists them
        again from the sweep state. Returns the repaired shard indices.
        """
        bad: list[int] = []
        for entry in list(self._shards):
            npz_path, _ = _shard_paths(self.root, entry["index"])
            if self._read_shard_ids(npz_path) != entry["instances"]:
                bad.append(entry["index"])
                self._shards.remove(entry)
                self._written.difference_update(entry["instances"])
                self._discard_shard_files(entry["index"])
        self.repaired.extend(bad)
        return bad

    @staticmethod
    def _shard_entry(idx: int, ids: list[int]) -> dict[str, Any]:
        npz, jsonl = _shard_paths("", idx)
        return {
            "index": idx,
            "file": os.path.basename(npz),
            "records": os.path.basename(jsonl),
            "n_instances": len(ids),
            "instances": [int(i) for i in ids],
        }

    @property
    def written(self) -> set[int]:
        return set(self._written)

    # ---------------- streaming drain ----------------

    def begin_drain(self, state, done: np.ndarray | None = None):
        """Gather, on the device, the rows of every newly finished instance
        (``done`` on the host, read from ``state`` when not given). Returns
        a handle for :meth:`finish_drain`, or None when nothing new
        finished. The handle's ids are reserved until it is finished, so a
        second ``begin_drain`` before that skips them."""
        if done is None:
            done = state.done.cpu().numpy()
        new = [
            int(i) for i in np.flatnonzero(done)
            if int(i) not in self._written and int(i) not in self._pending
            and int(i) not in self._inflight
        ]
        if not new:
            return None
        self._inflight.update(new)
        idx = torch.as_tensor(new, device=state.done.device)

        def take(tree):
            return type(tree)(*(x.index_select(0, idx) for x in tree))

        sub = (take(state.metrics), take(state.params),
               state.horizon.index_select(0, idx),
               state.scenario_id.index_select(0, idx), take(state.trace))
        return new, sub

    def finish_drain(self, handle) -> int:
        """Copy a :meth:`begin_drain` gather to the host, buffer it and
        write every full shard. Returns how many instances were drained."""
        if handle is None:
            return 0
        new, (metrics, params, horizon, sids, trace) = handle
        self._inflight.difference_update(new)
        metrics, params, trace = _host(metrics), _host(params), _host(trace)
        horizon, sids = horizon.cpu().numpy(), sids.cpu().numpy()
        for j, i in enumerate(new):
            self._pending[i] = {
                "metrics": _row(metrics, j),
                "params": _row(params, j),
                "horizon": horizon[j],
                "scenario_id": sids[j],
                "trace": _row(trace, j),
            }
        while len(self._pending) >= self.shard_size:
            self._flush_one_shard()
        return len(new)

    def drain(self, state, done: np.ndarray | None = None) -> int:
        """Gather and persist every newly finished instance in one call.
        Call after the chunk's fault handling. Returns how many instances
        were drained."""
        return self.finish_drain(self.begin_drain(state, done))

    def _flush_one_shard(self) -> None:
        ids = sorted(self._pending)[: self.shard_size]
        rows = [self._pending.pop(i) for i in ids]
        self._write_shard(ids, rows)

    def _write_shard(self, ids: list[int], rows: list[dict]) -> None:
        idx = self._next_shard
        self._next_shard += 1
        cfg, rec = self.cfg, self.cfg.record
        metrics = _stack([r["metrics"] for r in rows])
        params = _stack([r["params"] for r in rows])
        trace = _stack([r["trace"] for r in rows])
        horizon = np.asarray([r["horizon"] for r in rows])
        sids = np.asarray([r["scenario_id"] for r in rows])
        valid = np.asarray(_valid_rows(horizon, rec.record_every))

        cols = metrics_to_columns(
            metrics, params, scenario_ids=sids, scenario_names=cfg.scenarios
        )
        records = records_from_columns(cols)
        arrays: dict[str, np.ndarray] = {
            "instance": np.asarray(ids, np.int64),
            "scenario_id": sids.astype(np.int64),
            "horizon": horizon.astype(np.int64),
            "valid_rows": valid.astype(np.int64),
            "series": trace.series,
        }
        for k, v in cols.items():
            if k in ("instance", "scenario_id", "scenario"):
                continue  # stored above / derivable from the roster
            prefix = "p" if k in _PARAM_COLUMNS else "m"
            arrays[f"{prefix}_{k}"] = v
        if rec.k_slots:
            arrays.update(lane=trace.lane, speed=trace.speed,
                          active=trace.active)
            tokens, lengths = trace_token_streams(
                trace.lane, trace.speed, trace.active, valid, cfg.sim,
                n_buckets=self.n_buckets, v_max=self.v_max,
            )
            arrays.update(tokens=tokens, stream_len=lengths.astype(np.int64))

        npz_path, jsonl_path = _shard_paths(self.root, idx)
        tmp = os.path.join(self.root, f".tmp_records_{idx:05d}.jsonl")
        with open(tmp, "w") as f:
            for logical_id, record in zip(ids, records):
                record["instance"] = int(logical_id)  # logical, not row
                f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, jsonl_path)

        tmp = os.path.join(self.root, f".tmp_shard_{idx:05d}.npz")
        np.savez_compressed(tmp, **arrays)
        fsync_file(tmp)
        os.replace(tmp, npz_path)
        fsync_dir(self.root)

        self._shards.append(self._shard_entry(idx, ids))
        self._written.update(ids)

    # ---------------- finalize ----------------

    def finalize(self, summary: dict | None = None,
                 fault_info: dict | None = None) -> str:
        """Flush the partial tail shard and write the manifest."""
        while self._pending:
            self._flush_one_shard()
        cfg, rec = self.cfg, self.cfg.record
        manifest = {
            "format": FORMAT,
            "sweep": dataclasses.asdict(cfg),
            "scenarios": list(cfg.scenarios),
            "record": dataclasses.asdict(rec),
            "n_buckets": self.n_buckets,
            "v_max": self.v_max,
            "vocab_size": vocab_size(cfg.sim, self.n_buckets),
            "metric_aliases": {
                name: dict(get_scenario(name).metric_aliases)
                for name in dict.fromkeys(cfg.scenarios)
            },
            "n_instances_written": len(self._written),
            "shards": sorted(self._shards, key=lambda s: s["index"]),
            "summary": summary,
            "fault_events": (fault_info or {}).get("failure_events", []),
            "fault_info": fault_info,
            "repaired_shards": sorted(self.repaired),
        }
        path = os.path.join(self.root, MANIFEST)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(self.root)
        return path


def write_dataset(root: str, state, cfg, shard_size: int = 16,
                  summary: dict | None = None,
                  fault_info: dict | None = None, **writer_kw) -> str:
    """One-shot: shard out a finished recording sweep's state."""
    w = DatasetWriter(root, cfg, shard_size=shard_size, **writer_kw)
    w.drain(state)
    return w.finalize(summary=summary, fault_info=fault_info)


class ShardedDataset:
    """Reader for a :class:`DatasetWriter` directory (of either package)."""

    def __init__(self, root: str, manifest: dict) -> None:
        self.root = root
        self.manifest = manifest

    @classmethod
    def load(cls, root: str) -> "ShardedDataset":
        with open(os.path.join(root, MANIFEST)) as f:
            return cls(root, json.load(f))

    @property
    def n_instances(self) -> int:
        return int(self.manifest["n_instances_written"])

    @property
    def fields(self) -> list[str]:
        return list(self.manifest["record"]["fields"])

    def _shard_files(self) -> list[str]:
        return [os.path.join(self.root, s["file"])
                for s in self.manifest["shards"]]

    def iter_shards(self) -> Iterator[dict[str, np.ndarray]]:
        for path in self._shard_files():
            with np.load(path, allow_pickle=False) as z:
                yield dict(z)

    def _concat(self, *keys: str) -> list[np.ndarray]:
        """One decompression pass per shard, however many keys are read."""
        parts: dict[str, list[np.ndarray]] = {k: [] for k in keys}
        for path in self._shard_files():
            with np.load(path, allow_pickle=False) as z:
                for k in keys:
                    parts[k].append(z[k])
        if not parts[keys[0]]:
            raise ValueError(f"dataset at {self.root} has no shards")
        return [np.concatenate(parts[k], axis=0) for k in keys]

    def records(self) -> list[dict[str, Any]]:
        out: list[dict[str, Any]] = []
        for s in self.manifest["shards"]:
            with open(os.path.join(self.root, s["records"])) as f:
                out.extend(json.loads(line) for line in f if line.strip())
        return out

    def series(self) -> tuple[list[str], np.ndarray, np.ndarray]:
        """(field names, [n, R, F] series, [n] valid-row counts)."""
        series, valid = self._concat("series", "valid_rows")
        return self.fields, series, valid

    def token_streams(self) -> tuple[np.ndarray, np.ndarray]:
        """([n, L] padded streams, [n] true lengths)."""
        streams, lengths = self._concat("tokens", "stream_len")
        return streams, lengths

    def token_corpus(self) -> np.ndarray:
        """1-D concatenation of every stream with its PAD tail stripped."""
        streams, lengths = self.token_streams()
        return np.concatenate([s[:n] for s, n in zip(streams, lengths)])
