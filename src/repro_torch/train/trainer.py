"""Trainer loop: data feed, train step, checkpointing, restart (port of
``repro/train/trainer.py``).

Restart resumes from the latest valid checkpoint, whose tree is
``{"params": {name: tensor}, "opt": AdamWState}`` and whose meta holds the
step; a data iterator started at that step then continues the run as if it
had not stopped. A save copies the tree to the host before it returns, so
the next step may update the parameters in place while the write goes on.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.config.base import TrainConfig
from repro_torch.models.registry import Model
from repro_torch.train.optim import AdamWState, adamw_init
from repro_torch.train.step import make_train_step


def _tree(params, opt_state: AdamWState) -> dict:
    return {"params": dict(params.named_parameters()), "opt": opt_state}


class Trainer:
    def __init__(
        self,
        model: Model,
        tc: TrainConfig,
        data: Iterator[dict],
        ckpt_dir: str | None = None,
        ckpt_every: int = 50,
        log_every: int = 10,
        log_fn: Callable[[str], None] = print,
    ) -> None:
        self.model = model
        self.tc = tc
        self.data = data
        self.step_fn = make_train_step(model, tc)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log_fn
        self.history: list[dict] = []
        # host seconds of each checkpoint save: the copy to the host, and
        # for the last save the wait for its write
        self.saves: list[dict] = []

    def init_state(self):
        """Weights drawn on the model's device from a generator seeded with
        ``tc.seed``; zero moments in ``tc.opt_state_dtype``."""
        gen = torch.Generator(device=self.model.device)
        gen.manual_seed(self.tc.seed)
        params = self.model.init(gen)
        opt_state = adamw_init(dict(params.named_parameters()),
                               self.tc.opt_state_dtype)
        return params, opt_state, 0

    def restore_or_init(self):
        params, opt_state, start = self.init_state()
        if self.ckpt is not None and self.ckpt.has_checkpoint():
            tree, meta = self.ckpt.restore(like=_tree(params, opt_state))
            with torch.no_grad():
                for name, p in params.named_parameters():
                    p.copy_(tree["params"][name])
            opt_state = tree["opt"]
            start = int(meta["step"])
            self.log(f"[trainer] restored checkpoint at step {start}")
        return params, opt_state, start

    def _save(self, step: int, params, opt_state: AdamWState) -> None:
        t0 = time.perf_counter()
        self.ckpt.save(step, _tree(params, opt_state))
        self.saves.append({"step": step, "copy_s": time.perf_counter() - t0})

    def run(self, steps: int | None = None):
        params, opt_state, start = self.restore_or_init()
        total = steps if steps is not None else self.tc.total_steps
        t0 = time.perf_counter()
        for step in range(start, total):
            batch = next(self.data)
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            if (step + 1) % self.log_every == 0 or step + 1 == total:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                m["steps_per_s"] = (step + 1 - start) / dt
                self.history.append({"step": step + 1, **m})
                self.log(
                    f"[trainer] step {step + 1}/{total} "
                    f"loss={m['loss']:.4f} ce={m['ce']:.4f} "
                    f"gnorm={m['grad_norm']:.3f} "
                    f"({m['steps_per_s']:.2f} it/s)"
                )
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self._save(step + 1, params, opt_state)
        if self.ckpt is not None:
            self._save(total, params, opt_state)
            t1 = time.perf_counter()
            self.ckpt.wait()
            self.saves[-1]["wait_s"] = time.perf_counter() - t1
        return params, opt_state
