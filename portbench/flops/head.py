"""The output head: D x vocab a scored position.  Training scores every
position; a decoder's prefill computes the last position's logits only, an
encoder's every position's."""

from __future__ import annotations


def flops(cfg: dict, b: int, s: int, mode: str) -> float:
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    if mode == "train":
        return 3 * 2.0 * b * s * D * V
    positions = b if cfg["run_as"]["decoder"] else b * s
    return 2.0 * positions * D * V
