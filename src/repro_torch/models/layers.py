"""Shared transformer layers: RMSNorm, RoPE variants, init helpers.

The port's copy of ``repro/models/layers.py``.  The bf16 rounding sites are
the reference's: ``rms_norm`` normalizes in fp32 and rounds to x's type
before ``* scale``; ``apply_rope`` rounds cos and sin to x's type before the
rotation.  The initializers draw from an explicit ``torch.Generator``
(seeded by the caller), in fp32, and cast to the parameter type, one entry
of the leaf's ``stack`` (its period and slot axes) at a time into a
preallocated tensor of that type: the fp32 transient is one entry's size,
never the whole leaf's (qwen3-moe-30b-a3b's stacked ``w1`` is 19 GB in
bf16 and would be 39 GB in fp32).
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


def _draw(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype, std: float,
          stack: Tuple[int, ...]) -> torch.Tensor:
    """N(0, std^2) of shape ``stack + shape`` in ``dtype`` on ``gen``'s
    device, drawn in fp32 one stack entry at a time (a leaf with no stack is
    one entry)."""
    out = torch.empty(stack + shape, dtype=dtype, device=gen.device)
    for entry in out.view((-1,) + shape):
        draw = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        entry.copy_(draw * std)
    return out


def he_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
            fan_in: Optional[int] = None, stack: Tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, 1/fan) of shape ``stack + shape``.  The fan is ``shape``'s and
    keeps the reference's operator precedence: ``(fan_in or shape[-2]) if
    len(shape) >= 2 else shape[-1]``."""
    fan = fan_in or shape[-2] if len(shape) >= 2 else shape[-1]
    return _draw(gen, shape, dtype, 1.0 / float(fan) ** 0.5, stack)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return _draw(gen, shape, dtype, 0.02, ())
