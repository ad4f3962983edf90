"""Optimizers of the port, written from their formulas on tensor trees, and
the learning-rate schedules."""

from repro_torch.optim.adam import (
    AdamConfig,
    adam_init,
    adam_update,
    adam_update_,
    global_norm,
    sparse_adam_rows,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = [
    "AdamConfig",
    "adam_init",
    "adam_update",
    "adam_update_",
    "sparse_adam_rows",
    "global_norm",
    "cosine_schedule",
    "linear_warmup",
]
