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
arrays.

Under a ``ParallelCtx`` (``repro_torch.models.transformer``), as in the
reference:

  * ``attn_chunk > 0`` runs :func:`_einsum_attention_chunked`, the
    counterpart of ``_xla_attention_chunked``: an online softmax over key
    chunks, so the ``[sq, sk]`` logits never exist whole.  A chunk that does
    not divide ``sk`` runs the whole :func:`_einsum_attention`: that is the
    reference's own rule, not a fallback of the port's.  ``use_kernel``
    takes precedence over it, as ``use_pallas`` does there.
  * ``sp_attention`` places q sharded along the sequence over the model
    axis and k, v replicated across it (both batch-sharded over the data
    axes): DTensor redistributions where the activations are DTensors (the
    dry run), the identity for plain tensors on a one-device mesh, refused
    for plain tensors on a larger one.  A DTensor never reaches kernel 8:
    ``use_kernel=True`` with DTensor activations raises.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, batch_axes, constrain, grad_like, he_init,
                                      local_map, mesh_axes, reduce_partial, replicate_like,
                                      rms_norm, split_dim)

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
    q = split_dim(q, -1, (H, hd))
    k = split_dim(k, -1, (KV, hd))
    v = split_dim(v, -1, (KV, hd))
    if cfg.causal or cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def _einsum_attention(
    q, k, v, causal: bool, window: Optional[int], q_offset: int = 0,
    kv_len_mask: Optional[torch.Tensor] = None,
):
    """einsum attention; ``[b, s, h, hd]`` layout, GQA via head grouping.
    DTensor operands whose head counts the model axis divides run on each
    rank's own shard (:func:`_attention_sharded`)."""
    if isinstance(q, DTensor) and kv_len_mask is None:
        spec = _head_shard_spec(q, k, v)
        if spec is not None:
            return _attention_sharded(q, k, v, causal, window, q_offset, spec)
    return _attention_plain(q, k, v, causal, window, q_offset, kv_len_mask)


def _head_shard_spec(q, k, v) -> Optional[tuple]:
    """``(batch axes, None, "model", None)`` when the model axis divides
    both head counts and no operand shards its sequence; else None."""
    mp = mesh_axes(q.device_mesh).get("model")
    if not mp or q.shape[2] % mp or k.shape[2] % mp:
        return None
    if any(isinstance(t, DTensor) and any(p.is_shard(1) for p in t.placements)
           for t in (q, k, v)):
        return None
    return (batch_axes(q.device_mesh, q.shape[0]), None, "model", None)


def _attention_sharded(q, k, v, causal, window, q_offset, spec):
    """Attention mixes neither batch rows nor head groups, so q, k and v
    are placed by ``spec`` (batch over the data axes, heads over
    ``"model"``, as GSPMD places them) and :func:`_attention_plain` runs on
    the local tensors: no collective inside.  DTensor's own rules flatten
    the batch and a head dim sharded behind it into one strided-sharded dim
    for the einsums' products, and plan each candidate's redistribution on
    a 3-axis mesh for seconds (hubert-xlarge's train step on pod2x16x16 ran
    past 600 s)."""
    return local_map(lambda *a: _attention_plain(*a, causal, window, q_offset), q,
                     (q, k, v), (spec,) * 3, spec)


def _attention_plain(
    q, k, v, causal: bool, window: Optional[int], q_offset: int = 0,
    kv_len_mask: Optional[torch.Tensor] = None,
):
    b, sq, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = split_dim(q, 2, (KV, g))
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
    logits = torch.where(replicate_like(mask, logits), logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, H, hd)


def _einsum_attention_chunked(q, k, v, causal: bool, window: Optional[int],
                              chunk: int = 4096):
    """Flash attention in torch ops: a loop over key chunks of ``chunk``
    with an online softmax, so the ``[sq, sk]`` logits never exist whole
    (the reference's ``_xla_attention_chunked``: the same masks, -1e30 for a
    masked logit and as the running max's start, the same order of work).
    A chunk that does not divide ``sk`` runs :func:`_einsum_attention`, as
    there."""
    b, sq, H, hd = q.shape
    KV, sk = k.shape[2], k.shape[1]
    g = H // KV
    ck = min(chunk, sk)
    if sk % ck:
        return _einsum_attention(q, k, v, causal, window)
    qg = split_dim(q, 2, (KV, g))
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = l = acc = None
    for j in range(sk // ck):
        kb, vb = k[:, j * ck:(j + 1) * ck], v[:, j * ck:(j + 1) * ck]
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kb).float() * scale
        kpos = j * ck + torch.arange(ck, device=q.device)[None, :]
        mask = torch.ones((sq, ck), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = torch.where(replicate_like(mask[None, None, None], logits), logits, -1e30)
        if m is None:  # the running max starts at -1e30, the sums at 0
            m = torch.full_like(logits[..., 0], -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        palpha = torch.exp(m - m_new)
        probs = torch.exp(logits - m_new[..., None])
        l = probs.sum(-1) if l is None else palpha * l + probs.sum(-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", probs.to(vb.dtype), vb)
        acc = pv if acc is None else acc * palpha[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, H, hd)


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
    after RoPE, for the decode cache.  ``pctx`` (a ``ParallelCtx``): see the
    module note."""
    b, s, D = x.shape
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
    if pctx is not None and pctx.sp_attention:
        dp, ma = pctx.dp_axes, pctx.model_axis
        q = constrain(q, pctx.mesh, (dp, ma, None, None))
        k = constrain(k, pctx.mesh, (dp, None, None, None))
        v = constrain(v, pctx.mesh, (dp, None, None, None))
    if use_kernel:
        if isinstance(q, DTensor):
            raise TypeError("flash_attention takes plain tensors; DTensor activations "
                            "(the dry run) run the einsum path: use_kernel=False")
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=cfg.causal, window=window,
        ).transpose(1, 2)
    elif pctx is not None and pctx.attn_chunk:
        out = _einsum_attention_chunked(q, k, v, cfg.causal, window, chunk=pctx.attn_chunk)
    else:
        out = _einsum_attention(q, k, v, cfg.causal, window)
    out = reduce_partial(grad_like(out.reshape(b, s, cfg.num_heads * cfg.hd)) @ p["wo"])
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
    out = reduce_partial(out.reshape(b, 1, cfg.num_heads * cfg.hd) @ p["wo"])
    return x + out, k_cache, v_cache
