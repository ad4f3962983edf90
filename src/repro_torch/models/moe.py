"""Dense gated-SiLU MLP block of the dense decoders.

The port's copy of ``mlp_params`` and ``mlp_block`` from
``repro/models/moe.py``.  The mixture-of-experts blocks of that module
(routing, capacity dispatch, expert parallelism) wait for a later slice
(ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import he_init, rms_norm

__all__ = ["mlp_params", "mlp_block"]


def mlp_params(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
               stack: Tuple[int, ...] = ()) -> Dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w1": he_init(gen, stack + (D, Fd), dtype, fan_in=D),
        "w3": he_init(gen, stack + (D, Fd), dtype, fan_in=D),
        "w2": he_init(gen, stack + (Fd, D), dtype, fan_in=Fd),
        "norm": torch.ones(stack + (D,), dtype=dtype, device=gen.device),
    }


def mlp_block(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    return x + (F.silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]
