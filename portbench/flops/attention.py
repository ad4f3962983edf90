"""Attention blocks: the q, k, v and output projections, and attention's
two products (q k^T and p v), halved when causal."""

from __future__ import annotations


def dims(cfg: dict):
    return (cfg["num_hidden_layers"], cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"])


def causal(cfg: dict) -> bool:
    return bool(cfg["run_as"]["causal"])


def core(cfg: dict, b: int, s: int) -> float:
    """Forward operations of attention's two products over every layer:
    4 b h s s d, halved when causal."""
    L, _, H, _, hd = dims(cfg)
    ops = 4.0 * b * H * s * s * hd
    return L * (ops / 2 if causal(cfg) else ops)


def core_bytes(cfg: dict, b: int, s: int, width: int = 2) -> float:
    """Bytes attention's core must move over every layer: q, k, v read and
    the output written once each."""
    L, _, H, KV, hd = dims(cfg)
    return float(L * b * s * (2 * H + 2 * KV) * hd * width)


def flops(cfg: dict, b: int, s: int, mode: str) -> float:
    L, D, H, KV, hd = dims(cfg)
    T = b * s
    proj = 2.0 * T * D * (H + 2 * KV) * hd + 2.0 * T * H * hd * D
    fwd = L * proj + core(cfg, b, s)
    return 3 * fwd if mode == "train" else fwd
