"""Plain PyTorch version of the row-gather kernel: ``out[i] = table[idx[i]]``."""

from __future__ import annotations

import torch

__all__ = ["gather_rows_ref"]


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``table[idx]``."""
    return table[idx.to(device=table.device, dtype=torch.long)]
