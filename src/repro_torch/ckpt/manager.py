"""Checkpoint manager: step-indexed directories, retention, async writes.

Port of ``repro/ckpt/manager.py``. A save copies the tree to the host in the
caller's thread (so the caller may step its device tensors at once) and
writes it on a background thread; at most one write is in flight, and the
next save or a restore waits for it.

Crash safety: each save is staged into a hidden ``.tmp-step_*`` directory,
fsynced, and renamed into place in one directory move, so a SIGKILL at any
instant leaves either the previous checkpoints untouched or the new step
fully committed. Restore considers only checkpoints that pass
:func:`repro_torch.ckpt.io.verify_checkpoint` and falls back past a corrupt
or torn newest checkpoint to the newest valid one, recording what it
skipped in :attr:`CheckpointManager.last_skipped`. Stale staging
directories of a killed writer are removed after each commit.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any

from repro_torch.ckpt.io import (
    fsync_dir,
    list_steps,
    load_meta,
    load_pytree,
    save_host,
    to_host,
    verify_checkpoint,
)

_TMP_PREFIX = ".tmp-step_"


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3) -> None:
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # steps the last restore() walk rejected (corrupt or torn), newest
        # first
        self.last_skipped: list[int] = []
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def wait(self) -> None:
        """Wait for the write in flight; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, meta: dict | None = None) -> None:
        self.wait()
        entries = to_host(tree)   # on the host before the thread starts
        meta = dict(meta or {}, step=step)

        def _write() -> None:
            final = self._dir(step)
            tmp = os.path.join(self.root,
                               f"{_TMP_PREFIX}{step:09d}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            save_host(tmp, entries, meta)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            fsync_dir(self.root)
            self._gc()

        def _guarded() -> None:
            try:
                _write()
            except Exception as e:  # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=_guarded, daemon=True)
        self._thread.start()

    def restore(self, like: Any, step: int | None = None) -> tuple[Any, dict]:
        """Load the newest *valid* checkpoint (or ``step`` exactly) into
        the structure of ``like``, on ``like``'s devices. With
        ``step=None`` corrupt or unloadable steps are
        skipped (newest first, into :attr:`last_skipped`); an explicit
        ``step`` that fails verification raises."""
        self.wait()
        self.last_skipped = []
        if step is not None:
            path = self._dir(step)
            if not verify_checkpoint(path):
                raise FileNotFoundError(
                    f"checkpoint step {step} at {path} is missing or fails "
                    "integrity verification"
                )
            return load_pytree(path, like), load_meta(path)
        for s in sorted(list_steps(self.root), reverse=True):
            path = self._dir(s)
            if not verify_checkpoint(path):
                self.last_skipped.append(s)
                continue
            try:
                return load_pytree(path, like), load_meta(path)
            except (OSError, ValueError, KeyError):
                # intact by its digest, but not this structure
                self.last_skipped.append(s)
        raise FileNotFoundError(
            f"no valid checkpoints under {self.root}"
            + (f" (skipped corrupt steps {self.last_skipped})"
               if self.last_skipped else "")
        )

    def has_checkpoint(self) -> bool:
        """True iff at least one checkpoint passes integrity verification."""
        self.wait()
        return any(
            verify_checkpoint(self._dir(s)) for s in list_steps(self.root)
        )

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_", 1)[1])
            for n in os.listdir(self.root)
            if n.startswith("step_")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
        # staging dirs of a killed writer (this process's own was renamed)
        for n in os.listdir(self.root):
            if n.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.root, n), ignore_errors=True)
