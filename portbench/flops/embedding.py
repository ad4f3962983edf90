"""A token embedding is a row lookup: no product."""

from __future__ import annotations


def flops(cfg: dict, b: int, s: int, mode: str) -> float:
    return 0.0
