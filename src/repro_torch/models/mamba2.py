"""Mamba-2 block: chunked SSD (state-space duality) + recurrent decode.

The port's copy of ``repro/models/mamba2.py``.  Prefill splits the sequence
into chunks; within a chunk the recurrence is evaluated as a masked,
decay-weighted quadratic form, and the state that crosses chunks is carried
by a short loop over the chunks:

    h_t = exp(dt_t A) h_{t-1} + dt_t · x_t ⊗ B_t          (per head, [hp, N])
    y_t = C_t · h_t + D ⊙ x_t

Decode is the O(1) recurrence on a cached state.  The reference's
simplifications hold here too: ngroups = 1 (B and C shared across heads),
the depthwise conv applied to x only, no bias on the projections.

Where the port differs: the inter-chunk recurrence is a Python loop over the
chunks in place of ``lax.scan``, in the same order of work; the decay
exponents are segment sums, not differences of prefix sums (the same
function, rounded far less: see ``_ssd_chunked``);
``decode_mamba_block`` writes the new conv and SSM states into the caller's
tensors (the reference returns new arrays); a sequence the SSD chunk does
not divide raises ``ValueError`` (the reference asserts).  Under the dry
run (DTensor operands) the SSD runs on each rank's own shard, placed as
the reference's GSPMD plan places it (``_ssd_sharded``); the causal conv
concatenates its zero history where the reference pads.  The reference has
no Pallas kernel here: the scan and the recurrent step are plain tensor ops
on both sides.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (batch_axes, he_init, local_map, mesh_axes,
                                      reduce_partial, rms_norm)

__all__ = ["mamba_params", "mamba_block", "decode_mamba_block"]


def mamba_params(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                 stack: Tuple[int, ...] = ()) -> Dict:
    """One Mamba-2 block's parameters in the reference's leaf order;
    ``dt_bias``, ``A_log`` and ``D_skip`` stay float32."""
    D, di, nh, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    dev = gen.device
    return {
        "wz": he_init(gen, (D, di), dtype, fan_in=D, stack=stack),
        "wx": he_init(gen, (D, di), dtype, fan_in=D, stack=stack),
        "wB": he_init(gen, (D, N), dtype, fan_in=D, stack=stack),
        "wC": he_init(gen, (D, N), dtype, fan_in=D, stack=stack),
        "wdt": he_init(gen, (D, nh), dtype, fan_in=D, stack=stack),
        "dt_bias": torch.zeros(stack + (nh,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros(stack + (nh,), dtype=torch.float32, device=dev),
        "D_skip": torch.ones(stack + (nh,), dtype=torch.float32, device=dev),
        "conv_w": he_init(gen, (cfg.ssm_conv, di), dtype, fan_in=cfg.ssm_conv, stack=stack),
        "conv_b": torch.zeros(stack + (di,), dtype=dtype, device=dev),
        "gnorm": torch.ones(stack + (di,), dtype=dtype, device=dev),
        "norm": torch.ones(stack + (D,), dtype=dtype, device=dev),
        "wo": he_init(gen, (di, D), dtype, fan_in=di, stack=stack),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  x [b, s, di], w [k, di].  The k - 1
    zero steps before the first token are concatenated in front (the values
    ``F.pad`` gives), made from x's first step so that a DTensor keeps x's
    placements: the card's torch (2.11) has no working sharding rule for a
    pad of a sharded tensor."""
    k = w.shape[0]
    xp = torch.cat([torch.zeros_like(x[:, :1])] * (k - 1) + [x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out + b


def _ssd_chunked(
    x: torch.Tensor,  # [b, s, nh, hp]
    dt: torch.Tensor,  # [b, s, nh] (post-softplus)
    A: torch.Tensor,  # [nh] negative
    B_: torch.Tensor,  # [b, s, N]
    C_: torch.Tensor,  # [b, s, N]
    chunk: int = 128,
    return_state: bool = False,
    compute_dtype: torch.dtype = torch.float32,
):
    """The chunked SSD: ``y`` [b, s, nh, hp] (and the final state [b, nh,
    hp, N] with ``return_state``).  DTensor operands go to
    :func:`_ssd_sharded`; plain ones to :func:`_ssd_plain`."""
    fn = _ssd_sharded if isinstance(x, DTensor) else _ssd_plain
    return fn(x, dt, A, B_, C_, chunk, return_state, compute_dtype)


def _ssd_sharded(x, dt, A, B_, C_, chunk, return_state, compute_dtype):
    """The SSD of DTensor operands, on each rank's own shard.  The SSD
    mixes neither batch rows nor heads (B and C are shared by every head),
    so the operands are placed as the reference's GSPMD plan places them,
    batch over the data axes and heads over ``"model"`` (where they divide;
    else replicated), B and C replicated over ``"model"`` with any pending
    sums reduced, and :func:`_ssd_plain` runs on the local tensors: no
    collective inside.  DTensor's own rules would flatten a head dim sharded
    behind the batch for the einsums' products, which the card's torch
    (2.11) refuses, and 2.13 took only until a view met it."""
    bax = batch_axes(x.device_mesh, x.shape[0])
    mp = mesh_axes(x.device_mesh).get("model")
    hax = "model" if mp and x.shape[2] % mp == 0 else None
    ys, hs, bs = (bax, None, hax, None), (bax, hax, None, None), (bax, None, None)
    return local_map(
        lambda *a: _ssd_plain(*a, chunk, return_state, compute_dtype), x,
        (x, dt, A, B_, C_), (ys, (bax, None, hax), (hax,), bs, bs),
        (ys, hs) if return_state else ys)


def _ssd_plain(
    x: torch.Tensor,  # [b, s, nh, hp]
    dt: torch.Tensor,  # [b, s, nh] (post-softplus)
    A: torch.Tensor,  # [nh] negative
    B_: torch.Tensor,  # [b, s, N]
    C_: torch.Tensor,  # [b, s, N]
    chunk: int = 128,
    return_state: bool = False,
    compute_dtype: torch.dtype = torch.float32,
):
    b, s, nh, hp = x.shape
    N = B_.shape[-1]
    Q = min(chunk, s)
    if s % Q:
        raise ValueError(f"sequence must divide the SSD chunk: {s} tokens, chunk {Q}")
    nc = s // Q
    cd = compute_dtype
    # decay/cumsum math stays f32 (exp of sums); the large tensors follow
    # compute_dtype, as in the reference
    xb = x.reshape(b, nc, Q, nh, hp).to(cd)
    dtb = dt.reshape(b, nc, Q, nh)
    Bb = B_.reshape(b, nc, Q, N).to(cd)
    Cb = C_.reshape(b, nc, Q, N).to(cd)

    dA = dtb * A  # [b, nc, Q, nh]
    cum = torch.cumsum(dA, dim=2)

    # intra-chunk: y_i += Σ_{j≤i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j.
    # The exponent cum_i - cum_j is formed as the segment sum Σ_{j<k≤i} dA_k
    # (a cumsum over i of the terms below the diagonal), not as the
    # difference of two prefix sums: that difference keeps the rounding of
    # |cum|, up to ~100 at the end of a chunk, so a decay near 1 lost five
    # digits and the card (whose cumsum adds in another order) left the
    # CPU by 1e-5 in every decay.  Masked before exp, as in the reference:
    # the upper triangle must not reach exp() as anything but -inf.
    below = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device), -1)
    seg = torch.cumsum(torch.where(below[None, None, :, :, None], dA[:, :, :, None, :], 0.0),
                       dim=2)  # [b, nc, Q, Q, nh]: seg[i, j] = Σ_{j<k≤i} dA_k
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(tri, seg, float("-inf"))).to(cd)
    cb = torch.einsum("bcin,bcjn->bcij", Cb, Bb)[..., None]  # [b,nc,Q,Q,1]
    scores = cb * decay * dtb[:, :, None, :, :].to(cd)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xb)

    # chunk-final states S_c = Σ_j exp(cum_last - cum_j) dt_j x_j ⊗ B_j;
    # cum_last - cum_j is the segment sum's last row
    last = cum[:, :, -1:, :]  # [b, nc, 1, nh]
    w = (torch.exp(seg[:, :, -1]) * dtb).to(cd)  # [b, nc, Q, nh]
    Sc = torch.einsum("bcjh,bcjhp,bcjn->bchpn", w, xb, Bb)  # [b,nc,nh,hp,N]

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(last[:, :, 0, :])  # [b, nc, nh]
    H = torch.zeros((b, nh, hp, N), dtype=cd, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(H)
        H = (chunk_decay[:, c, :, None, None].to(H.dtype) * H + Sc[:, c]).to(H.dtype)
    Hprev = torch.stack(entering, dim=1)  # [b, nc, nh, hp, N]

    y = y + torch.einsum("bcin,bchpn->bcihp", Cb, Hprev) * torch.exp(cum)[..., None].to(cd)
    y = y.reshape(b, s, nh, hp).to(x.dtype)
    if return_state:
        return y, H
    return y


def mamba_block(p: Dict, cfg: ArchConfig, x: torch.Tensor, chunk: int = 128,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pre-norm Mamba-2 block with residual (prefill)."""
    b, s, D = x.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    z = h @ p["wz"]
    xin = F.silu(_causal_conv(h @ p["wx"], p["conv_w"], p["conv_b"]))
    B_ = h @ p["wB"]
    C_ = h @ p["wC"]
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(b, s, nh, hp)
    y = _ssd_chunked(xh, dt, A, B_, C_, chunk, compute_dtype=compute_dtype)
    y = y + (p["D_skip"][:, None].to(compute_dtype) * xh.to(compute_dtype)).to(y.dtype)
    y = y.reshape(b, s, di)
    y = rms_norm(y, p["gnorm"], cfg.norm_eps) * F.silu(z)
    return x + reduce_partial(y @ p["wo"])


def decode_mamba_block(
    p: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # [b, 1, D]
    conv_state: torch.Tensor,  # [b, k-1, di]
    ssm_state: torch.Tensor,  # [b, nh, hp, N] float32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) recurrent decode step.  Returns ``(y, conv_state, ssm_state)``;
    the states are the caller's tensors, updated in place."""
    b, _, D = x.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)[:, 0]  # [b, D]
    z = h @ p["wz"]
    xproj = h @ p["wx"]  # [b, di]
    window = torch.cat([conv_state, xproj[:, None, :]], dim=1)  # [b, k, di]
    conv = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xin = F.silu(conv)
    B_ = (h @ p["wB"]).float()
    C_ = (h @ p["wC"]).float()
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"])  # [b, nh]
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(b, nh, hp).float()
    decay = torch.exp(dt * A)  # [b, nh]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, B_)
    new_ssm = decay[..., None, None] * ssm_state + upd
    y = torch.einsum("bn,bhpn->bhp", C_, new_ssm) + p["D_skip"][:, None] * xh
    y = y.reshape(b, di).to(x.dtype)
    y = rms_norm(y, p["gnorm"], cfg.norm_eps) * F.silu(z)
    conv_state.copy_(window[:, 1:])
    ssm_state.copy_(new_ssm)
    return x + reduce_partial(y @ p["wo"])[:, None], conv_state, ssm_state
