"""Shared transformer layers: RMSNorm, RoPE variants, init helpers.

The port's copy of ``repro/models/layers.py``.  The bf16 rounding sites are
the reference's: ``rms_norm`` normalizes in fp32 and rounds to x's type
before ``* scale``; ``apply_rope`` rounds cos and sin to x's type before the
rotation.  The initializers draw from an explicit ``torch.Generator``
(seeded by the caller), in fp32, and cast to the parameter type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rms_norm", "apply_rope", "rope_frequencies", "he_init", "embed_init"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_frequencies(head_dim: int, fraction: float, theta: float) -> int:
    """Number of head dims that get rotated (even).  ``fraction=0.5`` is the
    ChatGLM '2d RoPE': only the first half of each head rotates."""
    rot = int(head_dim * fraction)
    return rot - (rot % 2)


def apply_rope(
    x: torch.Tensor,  # [b, s, h, hd]
    positions: torch.Tensor,  # [b, s] or [s]
    fraction: float = 1.0,
    theta: float = 500_000.0,
) -> torch.Tensor:
    b, s, h, hd = x.shape
    rot = rope_frequencies(hd, fraction, theta)
    if rot == 0:
        return x
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, s)
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # [b, s, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :half], xr[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, xp], dim=-1)


def he_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
            fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan) on ``gen``'s device.  The fan keeps the reference's
    operator precedence: ``(fan_in or shape[-2]) if len(shape) >= 2 else
    shape[-1]``."""
    fan = fan_in or shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / float(fan) ** 0.5
    draw = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (draw * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    draw = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (draw * 0.02).to(dtype)
