"""Checkpoint I/O for the port's state: numpy payloads + JSON manifest.

Port of ``repro/ckpt/io.py``, with the same files and commit protocol, so
either package's :func:`verify_checkpoint` accepts the other's checkpoints:

    <step dir>/
      arrays.npz      # arr_0 .. arr_{n-1}, one per leaf, flatten order
      manifest.json   # leaves [{path, shape, dtype}], meta, payload_sha256,
                      # n_leaves

The payload is written to a temp name, fsynced and renamed into place; the
manifest, which embeds the payload's SHA-256, follows the same way and is
the commit point. A kill at any moment leaves either no manifest (the
checkpoint is invisible) or a manifest whose digest vouches for a fully
written payload.

A tree is any nesting of NamedTuples (the port's ``SweepState``,
``SimState``, ...), dicts, lists and tuples with tensor leaves; ``None``
subtrees (a sweep without a trace) hold no leaf. Paths read like the
reference's (``.sim/.pos``). bf16 leaves are stored raw as uint16 words
and named ``bfloat16``, as the reference stores them.

PRNG keys: the reference stores its typed keys as their uint32 key data
plus a ``prng_impl`` tag and wraps them again on load. The port's keys are
already raw data, ``[..., 2]`` int64 tensors holding the two uint32 words
(:mod:`repro_torch.core.prng`), so they are stored as the int64 arrays they
are, untagged, and come back as the same int64 tensors on the device of
the ``like`` tree's leaf.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

MANIFEST = "manifest.json"
PAYLOAD = "arrays.npz"



def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Flush a directory entry (the rename itself) to disk; best-effort on
    filesystems that reject directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _children(node) -> list[tuple[str, Any]] | None:
    """``(path part, child)`` pairs of an inner node; None for a leaf."""
    if hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in flatten order; ``None`` holds no leaf."""
    out: list[tuple[str, Any]] = []

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for part, child in kids:
            walk(child, f"{prefix}/{part}" if prefix else part)

    walk(tree, "")
    return out


def unflatten(like: Any, leaves: list) -> Any:
    """The structure of ``like`` with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        vals = [build(child) for _, child in kids]
        if hasattr(node, "_fields"):
            return type(node)(*vals)
        if isinstance(node, dict):
            return dict(zip(sorted(node), vals))
        return type(node)(vals)

    return build(like)


def to_host(tree: Any) -> list[tuple[str, np.ndarray, str]]:
    """Every tensor leaf copied to a host numpy array in one pass (bf16 as
    its raw uint16 words): ``(path, array, logical dtype name)`` per leaf."""
    def host(x: torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        a = x.cpu().numpy()
        return a, str(a.dtype)

    return [(p, *host(x)) for p, x in flatten_with_paths(tree)]


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    """Crash-atomically save every leaf of ``tree`` under ``path``: payload
    first, the manifest with the payload's SHA-256 last."""
    save_host(path, to_host(tree), meta)


def save_host(path: str, entries: list, meta: dict | None = None) -> None:
    """:func:`save_pytree` of a tree already copied to the host by
    :func:`to_host` (the checkpoint manager's writer thread)."""
    os.makedirs(path, exist_ok=True)
    arrays, index = {}, []
    for i, (p, arr, dtype) in enumerate(entries):
        arrays[f"arr_{i}"] = arr
        index.append({"path": p, "shape": list(arr.shape), "dtype": dtype})

    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    fsync_file(tmp)
    os.replace(tmp, os.path.join(path, PAYLOAD))

    manifest = {
        "leaves": index,
        "meta": meta or {},
        "payload_sha256": _sha256_file(os.path.join(path, PAYLOAD)),
        "n_leaves": len(index),
    }
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, MANIFEST))
    fsync_dir(path)


def verify_checkpoint(path: str) -> bool:
    """True iff the checkpoint at ``path`` is complete and intact: manifest
    present and parseable, payload present, its SHA-256 the manifest's,
    and every indexed leaf in the npz."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        payload = os.path.join(path, PAYLOAD)
        if not os.path.exists(payload):
            return False
        digest = manifest.get("payload_sha256")
        if digest is not None and _sha256_file(payload) != digest:
            return False
        with np.load(payload) as z:
            names = set(z.files)
        return all(f"arr_{i}" in names
                   for i in range(len(manifest["leaves"])))
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return False


def _leaf_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, order="C"))  # keeps 0-d arrays 0-d
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def load_pytree(path: str, like: Any) -> Any:
    """Load a checkpoint into the structure of ``like``: each leaf takes the
    dtype and the device of ``like``'s leaf."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    refs = [x for _, x in flatten_with_paths(like)]
    n = len(manifest["leaves"])
    if n != len(refs):
        raise ValueError(f"checkpoint has {n} leaves but target structure "
                         f"has {len(refs)}")
    out = []
    with np.load(os.path.join(path, PAYLOAD)) as payload:
        for i, ref in enumerate(refs):
            entry = manifest["leaves"][i]
            t = _leaf_tensor(payload[f"arr_{i}"], entry["dtype"])
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {entry['path']}: shape "
                                 f"{tuple(t.shape)}, target {tuple(ref.shape)}")
            out.append(t.to(device=ref.device, dtype=ref.dtype))
    return unflatten(like, out)


def load_meta(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)["meta"]


def list_steps(root: str) -> list[int]:
    """All step indices with a committed manifest under ``root``,
    ascending (no payload verification; see :func:`valid_steps`)."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            if os.path.exists(os.path.join(root, name, MANIFEST)):
                try:
                    steps.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
    return sorted(steps)


def latest_step(root: str) -> int | None:
    """Highest step among ``root/step_*`` checkpoint dirs, or None."""
    steps = list_steps(root)
    return steps[-1] if steps else None


def valid_steps(root: str) -> list[int]:
    """Steps whose checkpoint passes :func:`verify_checkpoint`, ascending."""
    return [
        s for s in list_steps(root)
        if verify_checkpoint(os.path.join(root, f"step_{s:09d}"))
    ]
