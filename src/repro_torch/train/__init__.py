"""Training of the port's LMs: AdamW, schedules, clipping, the train step
with microbatching and remat, and the checkpointed trainer loop (port of
``repro/train``)."""

from repro_torch.train.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    lr_schedule,
)
from repro_torch.train.step import (
    abstract_train_state,
    cross_entropy_loss,
    make_train_step,
)

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "lr_schedule",
    "make_train_step",
    "abstract_train_state",
    "cross_entropy_loss",
]
