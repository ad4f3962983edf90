"""Dense gated-SiLU MLP and Mixture-of-Experts MLP: top-k routing with
capacity-based dispatch.

The port's copy of ``repro/models/moe.py``.  Tokens rank themselves into
per-expert capacity slots via a cumulative sum over the top-k assignment
mask, are gathered into ``[E, C, D]`` expert batches, run the gated-SiLU
expert FFN as three batched products, and are combined back with their
router weights.  The reference has no Pallas kernel here: routing, dispatch
and the expert products are plain tensor ops on both sides.

Where the port differs:

  * **The combine is a gather, not a scatter-add.**  The reference
    scatter-adds each slot's weighted output into ``[T, D]``; on CUDA
    ``index_add_`` sums with atomics, so the order of a token's
    contributions, and so the bf16 result, would change from run to run.
    The port computes the same function as a gather: each token sums its
    kept picks ``w[t, k] · ye[idx[t, k], pos[t, k]]`` over ``k`` in order, in
    ``ye``'s type; a token with no kept pick gets 0.
  * ``moe_block_ep`` (expert parallelism over a device mesh) belongs to the
    reference's multi-device tooling and is not ported (ROADMAP.md §A.5).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import he_init, rms_norm

__all__ = ["moe_params", "moe_block", "mlp_params", "mlp_block", "router_stats"]


def mlp_params(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
               stack: Tuple[int, ...] = ()) -> Dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w1": he_init(gen, (D, Fd), dtype, fan_in=D, stack=stack),
        "w3": he_init(gen, (D, Fd), dtype, fan_in=D, stack=stack),
        "w2": he_init(gen, (Fd, D), dtype, fan_in=Fd, stack=stack),
        "norm": torch.ones(stack + (D,), dtype=dtype, device=gen.device),
    }


def mlp_block(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    return x + (F.silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]


def moe_params(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
               stack: Tuple[int, ...] = ()) -> Dict:
    """One MoE block's parameters in the reference's leaf order; the router
    stays float32 whatever ``dtype`` is."""
    D, E, Fd = cfg.d_model, cfg.moe_experts, cfg.expert_ff
    return {
        "router": he_init(gen, (D, E), torch.float32, fan_in=D, stack=stack),
        "w1": he_init(gen, (E, D, Fd), dtype, fan_in=D, stack=stack),
        "w3": he_init(gen, (E, D, Fd), dtype, fan_in=D, stack=stack),
        "w2": he_init(gen, (E, Fd, D), dtype, fan_in=Fd, stack=stack),
        "norm": torch.ones(stack + (D,), dtype=dtype, device=gen.device),
    }


def _route(cfg: ArchConfig, h: torch.Tensor, router: torch.Tensor):
    """Top-k routing.  h [T, D] -> (expert_idx [T, k], weights [T, k],
    probs [T, E]); ``torch.topk`` returns each row sorted descending, as
    ``jax.lax.top_k`` does."""
    logits = h.float() @ router
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.moe_topk, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return idx, weights, probs


def _capacity(cfg: ArchConfig, T: int) -> int:
    c = int(T * cfg.moe_topk * cfg.capacity_factor / cfg.moe_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def moe_block(p: Dict, cfg: ArchConfig, x: torch.Tensor, return_aux: bool = False):
    """x [b, s, D] -> [b, s, D] with top-k expert FFNs (dropping at
    capacity).  With ``return_aux`` also ``{"aux_loss", "dropped"}``."""
    b, s, D = x.shape
    T = b * s
    E, K = cfg.moe_experts, cfg.moe_topk
    C = _capacity(cfg, T)
    h = rms_norm(x, p["norm"], cfg.norm_eps).reshape(T, D)

    idx, weights, probs = _route(cfg, h, p["router"])  # [T, K]

    # rank of each (token, k) pick among the picks of its expert, in the
    # flattened [T·K] row-major order: this order decides which picks drop.
    # The exclusive cumsum runs along the last dim of an [E, T·K] one-hot:
    # the same integers as the reference's scan of [T·K, E] along dim 0,
    # which CUDA runs as a slow outer-dimension scan (it took most of an
    # MoE prefill on the card)
    flat = F.one_hot(idx.reshape(-1), E).t().contiguous()  # [E, T·K]
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(0).reshape(T, K)
    keep = pos < C

    # token ids into [E, C] slots; dropped picks land in the overflow
    # column C, which is sliced off
    slot_e = idx.reshape(-1)
    slot_c = torch.where(keep, pos, C).reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    gather_idx = torch.zeros((E, C + 1), dtype=torch.long, device=x.device)
    gather_idx[slot_e, slot_c] = tok
    slot_used = torch.zeros((E, C + 1), dtype=torch.bool, device=x.device)
    slot_used[slot_e, slot_c] = keep.reshape(-1)
    gather_idx, slot_used = gather_idx[:, :C], slot_used[:, :C]

    xe = h[gather_idx] * slot_used[..., None].to(h.dtype)  # [E, C, D]
    act = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    ye = torch.bmm(act, p["w2"])  # [E, C, D]

    # combine: each token gathers its kept picks, summed over k in order
    w = torch.where(keep, weights, 0.0).to(ye.dtype)
    picked = ye[idx, torch.where(keep, pos, 0)]  # [T, K, D]
    out = picked[:, 0] * w[:, 0, None]
    for k in range(1, K):
        out = out + picked[:, k] * w[:, k, None]
    y = x + out.reshape(b, s, D)
    if return_aux:
        # load-balance auxiliaries (Switch-style): fraction per expert
        me = probs.mean(0)
        ce = F.one_hot(idx[:, 0], E).float().mean(0)
        aux = E * torch.sum(me * ce)
        return y, {"aux_loss": aux, "dropped": 1.0 - slot_used.float().mean()}
    return y


def router_stats(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> Dict:
    b, s, D = x.shape
    h = rms_norm(x, p["norm"], cfg.norm_eps).reshape(b * s, D)
    idx, _, probs = _route(cfg, h, p["router"])
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe_experts).float()
    return {"expert_load": counts / counts.sum(),
            "entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean()}
