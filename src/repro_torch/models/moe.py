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
    ``ye``'s type; a token with no kept pick gets 0.  ``moe_block_ep`` combines
    the same way, so on one rank it is ``moe_block`` bit for bit.
  * **A DTensor combine runs on each rank's own experts**
    (:func:`_combine_sharded`): with the experts split over the model axis,
    each rank sums the picks of its own experts for its own tokens and the
    per-rank sums are reduced into x's placements, about ``T·D`` a layer,
    where gathering the expert outputs whole would move ``E·C·D`` (about
    ``k·1.25`` times as much).  The reference's scatter-add leaves the same
    partial sums to GSPMD.
  * **``moe_block_ep``** is the body of the reference's ``shard_map`` run on
    each rank's own shard: x ``[b/dp, s/mp, D]`` and the experts ``[E/mp,
    D, F]``, routed locally with the local capacity ``_capacity(cfg,
    T_local)``.  The reference's two tiled ``all_to_all`` are
    ``all_to_all_single`` over the model axis's process group, through
    ``torch.distributed._functional_collectives.all_to_all_single_autograd``,
    which carries gradients (``torch.distributed.nn.functional``'s is
    deprecated in favour of it), or its plain form where no gradient is
    taken (the autograd op has no kernel under ``inference_mode``).  It
    takes DTensors (the counterpart of the reference's global arrays: each
    rank's shard is taken with ``to_local`` after placing x as ``(dp,
    model, None)`` and the experts as ``(model, None, None)``, and the
    result is returned in x's own placements, the sequence gathered where
    x did not shard it), or plain tensors on a mesh of one device, where
    the exchange runs over a group of one (the identity) or, on a mesh with
    no process group, is left out.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (batch_axes, constrain, full_local, grad_like, he_init,
                                      match_placements, mesh_axes, reduce_partial,
                                      replicate_like, rms_norm, spec_placements)

__all__ = ["moe_params", "moe_block", "moe_block_ep", "mlp_params", "mlp_block",
           "router_stats"]


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
    return x + reduce_partial((F.silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"])


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
    # topk's values through gather (the same floats, the same gradients):
    # gather's backward has a DTensor rule on the card's torch (2.11),
    # topk's builds a plain zero tensor there
    idx = torch.topk(probs.detach(), cfg.moe_topk, dim=-1).indices
    weights = probs.gather(-1, idx)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return idx, weights, probs


def _capacity(cfg: ArchConfig, T: int) -> int:
    c = int(T * cfg.moe_topk * cfg.capacity_factor / cfg.moe_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _dispatch(cfg: ArchConfig, h: torch.Tensor, router: torch.Tensor, C: int):
    """Route ``h`` [T, D] and lay the picks into ``[E, C]`` capacity slots:
    ``(xe [E, C, D], idx, weights, probs, pos, keep, slot_used)``."""
    T = h.shape[0]
    E, K = cfg.moe_experts, cfg.moe_topk
    idx, weights, probs = _route(cfg, h, router)  # [T, K]

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
    # column C, which is sliced off.  Slots and rows are written and
    # gathered on plain tensors: a DTensor's operands are gathered whole on
    # every rank first, and the rows lifted back replicated (the card's
    # torch, 2.11, has no sharding rule for index_put_, the indexing's
    # backward included)
    slot_e = full_local(idx.reshape(-1))
    slot_c = full_local(torch.where(keep, pos, C).reshape(-1))
    tok = torch.arange(T, device=slot_e.device).repeat_interleave(K)
    gather_idx = torch.zeros((E, C + 1), dtype=torch.long, device=slot_e.device)
    gather_idx[slot_e, slot_c] = tok
    slot_used = torch.zeros((E, C + 1), dtype=torch.bool, device=slot_e.device)
    slot_used[slot_e, slot_c] = full_local(keep.reshape(-1))
    gather_idx, slot_used = gather_idx[:, :C], replicate_like(slot_used[:, :C], h)

    xe = replicate_like(full_local(h)[gather_idx], h) * slot_used[..., None].to(h.dtype)  # [E, C, D]
    return xe, idx, weights, probs, pos, keep, slot_used


def _experts(xe: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    act = F.silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
    return torch.bmm(act, w2)


def _combine(ye: torch.Tensor, idx, weights, pos, keep) -> torch.Tensor:
    """Each token gathers its kept picks from ``ye`` [E, C, D], weighted,
    summed over k in order."""
    w = torch.where(keep, weights, 0.0).to(ye.dtype)
    picked = ye[idx, torch.where(keep, pos, 0)]  # [T, K, D]
    out = picked[:, 0] * w[:, 0, None]
    for k in range(1, idx.shape[1]):
        out = out + picked[:, k] * w[:, k, None]
    return out


def _combine_sharded(ye: DTensor, idx, weights, pos, keep) -> torch.Tensor:
    """:func:`_combine` of a DTensor ``ye`` whose experts the mesh's model
    axis splits: ``ye`` is placed as (model, -, -) and the routing as
    (data axes, -); each rank sums, in ``k`` order, the kept picks of its own
    experts for its own tokens, and the result is those per-rank sums
    pending over the model axis (``Partial``), tokens split as the routing.
    Gradients come back as the placements imply: ``ye``'s summed over the
    data axes, the weights' over the model axis.  Where the model axis does
    not split the experts, :func:`_combine` on DTensor's own rules."""
    mesh = ye.device_mesh
    mp, E = mesh_axes(mesh).get("model", 1), ye.shape[0]
    if mp == 1 or E % mp:
        return _combine(ye, idx, weights, pos, keep)
    T, D = idx.shape[0], ye.shape[-1]
    names = mesh.mesh_dim_names
    tok = spec_placements(mesh, (batch_axes(mesh, T), None))  # tokens as x splits them
    # each rank's slice, and where its gradient goes: summed over the mesh
    # dims that hold copies of the slice but computed other parts of it
    ye_l = ye.redistribute(mesh, spec_placements(mesh, ("model", None, None))).to_local(
        grad_placements=[Shard(0) if n == "model" else Partial() if t.is_shard() else t
                         for n, t in zip(names, tok)])
    partial = [Partial() if n == "model" else t for n, t in zip(names, tok)]
    w_l = weights.redistribute(mesh, tok).to_local(grad_placements=partial)
    idx_l, pos_l, keep_l = (t.redistribute(mesh, tok).to_local() for t in (idx, pos, keep))
    el = E // mp
    local_e = idx_l - mesh.get_local_rank("model") * el
    mine = keep_l & (local_e >= 0) & (local_e < el)
    out = _combine(ye_l, local_e.clamp(0, el - 1), w_l, pos_l, mine)
    return DTensor.from_local(out, mesh, partial, run_check=False, shape=(T, D), stride=(D, 1))


def moe_block(p: Dict, cfg: ArchConfig, x: torch.Tensor, return_aux: bool = False):
    """x [b, s, D] -> [b, s, D] with top-k expert FFNs (dropping at
    capacity).  With ``return_aux`` also ``{"aux_loss", "dropped"}``."""
    b, s, D = x.shape
    T = b * s
    E = cfg.moe_experts
    C = _capacity(cfg, T)
    # a DTensor's gradient reaches the reshape back in h's own placements:
    # the routing's may split the tokens over the model axis as well, which
    # no [b, s, D] view of a batch over the data axes can take
    h = grad_like(rms_norm(x, p["norm"], cfg.norm_eps).reshape(T, D))
    xe, idx, weights, probs, pos, keep, slot_used = _dispatch(cfg, h, p["router"], C)
    ye = _experts(xe, p["w1"], p["w3"], p["w2"])  # [E, C, D]
    combine = _combine_sharded if isinstance(ye, DTensor) else _combine
    # the residual stream keeps x's placements (pending sums reduced)
    y = x + match_placements(combine(ye, idx, weights, pos, keep).reshape(b, s, D), x)
    if return_aux:
        # load-balance auxiliaries (Switch-style): fraction per expert
        me = probs.mean(0)
        ce = F.one_hot(idx[:, 0], E).float().mean(0)
        aux = E * torch.sum(me * ce)
        return y, {"aux_loss": aux, "dropped": 1.0 - slot_used.float().mean()}
    return y


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s dim 0 in equal chunks, chunk i to group rank i; the chunks
    received, in source order, along dim 0.  With grad, the collective that
    carries gradients; without (serving runs under ``inference_mode``, where
    that one has no kernel), the plain functional one."""
    if group is None:
        return t
    from torch.distributed import _functional_collectives as funcol

    if torch.is_grad_enabled():
        return funcol.all_to_all_single_autograd(t.contiguous(), None, None, group)
    return funcol.wait_tensor(funcol.all_to_all_single(t.contiguous(), None, None, group))


def moe_block_ep(p: Dict, cfg: ArchConfig, x: torch.Tensor, mesh, dp_axes,
                 model_axis: str = "model") -> torch.Tensor:
    """Expert-parallel MoE — Heta's RAF paradigm applied to experts
    (DESIGN.md §4): each model shard owns E/mp experts' parameters, tokens
    are routed locally per shard (capacity from the local token count),
    dispatched expert-major by one all-to-all, transformed where their
    expert's weights live, and returned by a second.  See the module note
    for what it takes and returns."""
    E = cfg.moe_experts
    mp = mesh_axes(mesh)[model_axis]
    if E % mp:
        raise ValueError(f"moe_block_ep: {E} experts do not split over a model axis of {mp}")
    spec_x, spec_w = (dp_axes, model_axis, None), (model_axis, None, None)
    if isinstance(x, DTensor):
        dm = x.device_mesh
        xs = constrain(x, dm, spec_x)
        placements = xs.placements
        xs = xs.to_local()
        w1, w3, w2 = (constrain(p[k], dm, spec_w).to_local() for k in ("w1", "w3", "w2"))
        router, norm_w = (constrain(p[k], dm, (None,) * p[k].dim()).to_local()
                          for k in ("router", "norm"))
        group = dm.get_group(model_axis)
    else:
        n = math.prod(mesh_axes(mesh).values())
        if n > 1:
            raise ValueError(f"moe_block_ep over a mesh of {n} devices takes DTensors; "
                             "got plain tensors")
        xs, w1, w3, w2, router, norm_w = x, p["w1"], p["w3"], p["w2"], p["router"], p["norm"]
        group = mesh.get_group(model_axis) if hasattr(mesh, "get_group") else None

    b, s, D = xs.shape
    T = b * s
    C = _capacity(cfg, T)
    h = rms_norm(xs, norm_w, cfg.norm_eps).reshape(T, D)
    xe, idx, weights, _, pos, keep, _ = _dispatch(cfg, h, router, C)
    # dispatch: expert-major exchange (RAF: compute where the params live);
    # [mp (source), E/mp, C, D] -> [E/mp, mp·C, D]
    xe = _all_to_all(xe, group).reshape(mp, E // mp, C, D).transpose(0, 1)
    ye = _experts(xe.reshape(E // mp, mp * C, D), w1, w3, w2)
    # return the partial results to the token owners: [E, C, D]
    ye = ye.reshape(E // mp, mp, C, D).transpose(0, 1)
    ye = _all_to_all(ye, group).reshape(E, C, D)
    y = xs + _combine(ye, idx, weights, pos, keep).reshape(b, s, D)
    if isinstance(x, DTensor):
        # back in x's own placements (gathering the sequence, where GSPMD
        # re-gathers it for the next block)
        y = DTensor.from_local(y, x.device_mesh, placements, run_check=False,
                               shape=x.shape, stride=x.stride())
        return y.redistribute(x.device_mesh, x.placements)
    return y


def router_stats(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> Dict:
    b, s, D = x.shape
    h = rms_norm(x, p["norm"], cfg.norm_eps).reshape(b * s, D)
    idx, _, probs = _route(cfg, h, p["router"])
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe_experts).float()
    return {"expert_load": counts / counts.sum(),
            "entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean()}
