"""Plain PyTorch oracle for blocked attention (causal / sliding-window /
offset): the port's copy of ``repro/kernels/flash_attention/ref.py``.

It materializes the whole ``[sq, sk]`` score matrix in the inputs' type,
as the reference does, and gives 0 for a query row that sees no key.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["attention_ref", "attention_mask"]


def attention_mask(
    sq: int, sk: int, causal: bool, window: Optional[int], q_offset: int
) -> np.ndarray:
    """[sq, sk] bool mask.  Query i sits at global position q_offset + i;
    causal allows keys ≤ that position; a window additionally restricts keys
    to the last ``window`` positions (sliding-window attention)."""
    qpos = np.arange(sq)[:, None] + q_offset
    kpos = np.arange(sk)[None, :]
    m = np.ones((sq, sk), bool)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def attention_ref(
    q: torch.Tensor,  # [b, h, sq, d]
    k: torch.Tensor,  # [b, hk, sk, d]
    v: torch.Tensor,  # [b, hk, sk, d]
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, h, sq, d = q.shape
    hk = k.shape[1]
    if h != hk:  # GQA: repeat kv heads
        k = torch.repeat_interleave(k, h // hk, dim=1)
        v = torch.repeat_interleave(v, h // hk, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    mask = torch.from_numpy(attention_mask(sq, k.shape[2], causal, window, q_offset)).to(
        q.device)
    logits = torch.where(mask[None, None], logits, torch.finfo(logits.dtype).min)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p * mask[None, None]
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
