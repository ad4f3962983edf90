"""GQA attention: prefill (full-sequence) and cached decode.

The port's copy of ``repro/models/attention.py``.
Two execution paths for the full sequence:

  * ``use_kernel=True`` — :func:`repro_torch.kernels.flash_attention`: the
    hand-written CUDA kernel for CUDA tensors, its plain version on the CPU;
  * ``use_kernel=False`` — :func:`_einsum_attention`, the counterpart of the
    reference's ``_xla_attention`` (einsums in the activations' type, fp32
    logits and softmax), the same function.

Decode attends one new token against a KV cache laid out ``[B, S, KV, hd]``
in plain torch ops, as the reference does: its per-batch validity mask
never reaches the kernel.  The cache is updated IN PLACE (a slice
assignment into the caller's tensors), where the reference returns new
arrays.  Sequence-parallel attention, the chunked einsum and ``pctx``
belong to the reference's dry-run and sharding tooling and are not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, he_init, rms_norm

__all__ = ["attn_params", "attention_block", "decode_attention_block", "CacheOverflowError"]


class CacheOverflowError(IndexError):
    """A decode position past the end of a KV cache that has no window."""


def attn_params(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                stack: Tuple[int, ...] = ()) -> Dict:
    """One attention block's parameters, each leaf with the leading
    ``stack`` dims (the period stacking), drawn from ``gen`` in the
    reference's leaf order."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dev = gen.device
    p = {
        "wq": he_init(gen, (D, H * hd), dtype, fan_in=D, stack=stack),
        "wk": he_init(gen, (D, KV * hd), dtype, fan_in=D, stack=stack),
        "wv": he_init(gen, (D, KV * hd), dtype, fan_in=D, stack=stack),
        "wo": he_init(gen, (H * hd, D), dtype, fan_in=H * hd, stack=stack),
        "norm": torch.ones(stack + (D,), dtype=dtype, device=dev),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(stack + (H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(stack + (KV * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(stack + (KV * hd,), dtype=dtype, device=dev)
    return p


def _qkv(p: Dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor) -> Tuple:
    b, s, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, H, hd)
    k = k.reshape(b, s, KV, hd)
    v = v.reshape(b, s, KV, hd)
    if cfg.causal or cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def _einsum_attention(
    q, k, v, causal: bool, window: Optional[int], q_offset: int = 0,
    kv_len_mask: Optional[torch.Tensor] = None,
):
    """einsum attention; ``[b, s, h, hd]`` layout, GQA via head grouping."""
    b, sq, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(b, sq, KV, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    logits = logits * (1.0 / math.sqrt(hd))
    sk = k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if kv_len_mask is not None:  # [b, sk] valid-cache mask for decode
        mask = mask[None] & kv_len_mask[:, None, :]
        mask = mask[:, None, None]
    else:
        mask = mask[None, None, None]
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, H, hd)


def attention_block(
    p: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # [b, s, D]
    positions: torch.Tensor,
    window: Optional[int] = None,
    use_kernel: bool = True,
    return_kv: bool = False,
    pctx=None,
):
    """Pre-norm attention block with residual (prefill).  With
    ``return_kv`` also returns this block's ``(k, v)``, ``[b, s, KV, hd]``
    after RoPE, for the decode cache."""
    if pctx is not None:
        raise NotImplementedError(
            "pctx (sequence-parallel / chunked attention) belongs to the reference's "
            "dry-run and sharding tooling, not ported (ROADMAP.md §1)")
    b, s, D = x.shape
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
    if use_kernel:
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=cfg.causal, window=window,
        ).transpose(1, 2)
    else:
        out = _einsum_attention(q, k, v, cfg.causal, window)
    out = out.reshape(b, s, cfg.num_heads * cfg.hd) @ p["wo"]
    y = x + out
    if return_kv:
        return y, (k, v)
    return y


def decode_attention_block(
    p: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # [b, 1, D]
    k_cache: torch.Tensor,  # [b, S, KV, hd]
    v_cache: torch.Tensor,  # [b, S, KV, hd]
    pos: int,  # index of the new token
    window: Optional[int] = None,
):
    """One-token cached decode.  Returns ``(y, k_cache, v_cache)``; the
    caches are the caller's tensors, updated in place at slot ``pos`` (or
    ``pos % S`` with a window).

    With a sliding window the cache is a ring buffer of ``S`` slots; without
    one it holds the whole sequence, and ``pos >= S`` raises
    :class:`CacheOverflowError` (the reference's ``dynamic_update_slice``
    would clamp it onto the last slot).
    """
    b, _, D = x.shape
    S = k_cache.shape[1]
    pos = int(pos)
    if pos < 0 or (not window and pos >= S):
        raise CacheOverflowError(
            f"decode position {pos} outside a KV cache of {S} slots (no window)")
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, h, positions)
    slot = (pos % S) if window else pos
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    kpos = torch.arange(S, device=x.device)[None, :]
    if window:
        # ring buffer: slot i currently holds position p_i ≡ i (mod S), the
        # latest such position ≤ pos
        offset = pos - slot
        real_pos = torch.where(kpos <= slot, kpos + offset, kpos + offset - S)
        valid = (real_pos >= 0) & (real_pos <= pos) & (real_pos > pos - window)
    else:
        valid = kpos <= pos
    valid = valid.expand(b, S)
    out = _einsum_attention(q, k_cache, v_cache, False, None, kv_len_mask=valid)
    out = out.reshape(b, 1, cfg.num_heads * cfg.hd) @ p["wo"]
    return x + out, k_cache, v_cache
