"""Abstract input specs for every (architecture × input shape) pair.

The port's copy of ``repro/launch/specs.py``.  ``input_specs`` returns
tensors on the ``meta`` device (shape and dtype, no storage: the
counterpart of ``jax.ShapeDtypeStruct``); the dry run runs against these.
``abstract_params``, ``abstract_state`` and ``abstract_cache`` call the
port's ``init_*`` with ``device="meta"``: every leaf allocated there and
nothing drawn (the counterpart of ``jax.eval_shape``).  The train state's
step counter is the one tensor left on the CPU, as ``init_train_state``
keeps it (a 4-byte scalar).

Shape semantics (assignment brief):
  * train_4k / prefill_32k run ``train_step`` / ``prefill_step`` on the
    full sequence;
  * decode_32k / long_500k run ``serve_step`` — ONE token against a cache
    of ``seq_len`` context;
  * encoder-only archs (hubert) have no decode step → decode shapes are
    SKIPPED (reported, not silent);
  * long_500k requires sub-quadratic attention: SSM/hybrid run natively;
    pure-attention archs run the sliding-window variant (window 8192), the
    permitted dense path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape

__all__ = ["StepPlan", "plan_step", "input_specs", "abstract_params", "abstract_state",
           "abstract_cache", "DENSE_WINDOW"]

DENSE_WINDOW = 8192  # sliding window for pure-attention archs at 500k context


@dataclasses.dataclass(frozen=True)
class StepPlan:
    kind: str  # train | prefill | decode | skip
    window: Optional[int] = None
    cache_len: int = 0
    skip_reason: str = ""


def plan_step(cfg: ArchConfig, shape: InputShape) -> StepPlan:
    if shape.kind in ("decode",) and not cfg.is_decoder:
        return StepPlan(
            "skip",
            skip_reason=f"{cfg.name} is encoder-only: no decode step (DESIGN.md §4)",
        )
    if shape.kind == "decode":
        window = None
        cache_len = shape.seq_len
        if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
            window = DENSE_WINDOW  # sub-quadratic requirement: sliding window
            cache_len = DENSE_WINDOW
        return StepPlan("decode", window=window, cache_len=cache_len)
    return StepPlan(shape.kind)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict:
    """Batch meta tensors for train/prefill; (token, pos) for decode."""
    B, S = shape.global_batch, shape.seq_len
    plan = plan_step(cfg, shape)
    dtype = getattr(torch, cfg.dtype)
    if plan.kind == "skip":
        return {}
    if plan.kind == "decode":
        return {"token": _meta((B, 1), torch.int32), "pos": _meta((), torch.int32)}
    if cfg.frontend == "audio":
        return {
            "frames": _meta((B, S, cfg.frontend_dim), dtype),
            "labels": _meta((B, S), torch.int32),
        }
    if cfg.frontend == "vision":
        Pt = cfg.frontend_tokens
        return {
            "tokens": _meta((B, S - Pt), torch.int32),
            "patch_embeds": _meta((B, Pt, cfg.frontend_dim), dtype),
            "labels": _meta((B, S - Pt), torch.int32),
        }
    return {
        "tokens": _meta((B, S), torch.int32),
        "labels": _meta((B, S), torch.int32),
    }


def abstract_state(cfg: ArchConfig) -> Dict:
    """Shape-only train state (params + Adam moments) — no storage."""
    from repro_torch.models.transformer import init_train_state

    return init_train_state(cfg, 0, device="meta")


def abstract_params(cfg: ArchConfig) -> Dict:
    from repro_torch.models.transformer import init_params

    return init_params(cfg, 0, device="meta")


def abstract_cache(cfg: ArchConfig, shape: InputShape) -> Dict:
    from repro_torch.models.transformer import init_decode_cache

    plan = plan_step(cfg, shape)
    return init_decode_cache(cfg, shape.global_batch, plan.cache_len, device="meta")
