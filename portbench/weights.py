"""Weights drawn from ``--seed`` on the device, one leaf a call, in the type
they are served in, in a layout of the benchmark's own: each block leaf
stacked over the layers (``attn.wq`` is ``[layers, D, H * hd]``).  The
scales follow the usual fan-in rule (N(0, 1/fan_in); the token embedding
N(0, 0.02^2); norms 1).  The same seed on the same device gives the same
weights: the reference draws them again after the window."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """``(name, shape, kind, std)`` of every leaf in draw order; kind is
    ``"param"`` (the configuration's type), ``"router"`` (float32) or
    ``"ones"``."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    F, V = cfg["intermediate_size"], cfg["vocab_size"]
    run = cfg["run_as"]
    out = []
    if run["frontend"] == "audio":
        fd = cfg["conv_dim_last"]
        out.append(("frontend_proj", (fd, D), "param", fd ** -0.5))
    else:
        out.append(("embed", (V, D), "param", 0.02))
    out += [("attn.norm", (L, D), "ones", 1.0),
            ("attn.wq", (L, D, H * hd), "param", D ** -0.5),
            ("attn.wk", (L, D, KV * hd), "param", D ** -0.5),
            ("attn.wv", (L, D, KV * hd), "param", D ** -0.5),
            ("attn.wo", (L, H * hd, D), "param", (H * hd) ** -0.5)]
    if run["ffn"] == "moe":
        E = cfg["num_local_experts"]
        out += [("moe.norm", (L, D), "ones", 1.0),
                ("moe.router", (L, D, E), "router", D ** -0.5),
                ("moe.w1", (L, E, D, F), "param", D ** -0.5),
                ("moe.w3", (L, E, D, F), "param", D ** -0.5),
                ("moe.w2", (L, E, F, D), "param", F ** -0.5)]
    else:
        out += [("mlp.norm", (L, D), "ones", 1.0),
                ("mlp.w1", (L, D, F), "param", D ** -0.5),
                ("mlp.w3", (L, D, F), "param", D ** -0.5),
                ("mlp.w2", (L, F, D), "param", F ** -0.5)]
    out += [("final_norm", (D,), "ones", 1.0), ("head", (D, V), "param", D ** -0.5)]
    return out


def param_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["run_as"]["params_dtype"])


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf, drawn from one generator on ``device`` seeded with
    ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dtype = param_dtype(cfg)
    out = {}
    for name, shape, kind, std in leaf_specs(cfg):
        if kind == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        dt = torch.float32 if kind == "router" else dtype
        out[name] = torch.randn(shape, generator=gen, dtype=dt, device=device).mul_(std)
    return out
