"""Sparse MoE blocks: the router's product and, for each token, its
``num_experts_per_tok`` experts' three products of D x F.  Capacity slots
left empty and picks dropped past capacity are not counted: the count is of
the routed work, not of the padded batches an implementation may run."""

from __future__ import annotations


def flops(cfg: dict, b: int, s: int, mode: str) -> float:
    L, D, F = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    T = b * s
    fwd = L * (2.0 * T * D * E + 2.0 * T * K * 3 * D * F)
    return 3 * fwd if mode == "train" else fwd
