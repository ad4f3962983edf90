"""The stub frontend's projection of each frame (``conv_dim_last`` wide) to
the model's width.  In training the frames take no gradient: the forward
and the weight's gradient only."""

from __future__ import annotations


def flops(cfg: dict, b: int, s: int, mode: str) -> float:
    fwd = 2.0 * b * s * cfg["conv_dim_last"] * cfg["hidden_size"]
    return 2 * fwd if mode == "train" else fwd
