"""Optimizers of the port, written from their formulas on tensor trees."""

from repro_torch.optim.adam import (
    AdamConfig,
    adam_init,
    adam_update,
    global_norm,
    sparse_adam_rows,
)

__all__ = ["AdamConfig", "adam_init", "adam_update", "sparse_adam_rows", "global_norm"]
