"""Dense gated MLP blocks: three products of D x F a token."""

from __future__ import annotations


def flops(cfg: dict, b: int, s: int, mode: str) -> float:
    L, D, F = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    fwd = L * 2.0 * b * s * 3 * D * F
    return 3 * fwd if mode == "train" else fwd
