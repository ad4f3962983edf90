"""HGNN configuration and parameter initialization over the metatree.

An HGNN layer (paper Eq. 1) is

    h_v^(l) = AGG_all( { AGG_r( {h_u^(l-1) : u ∈ N_r(v)} ) : r ∈ R } )

The sampler (``repro_torch.graph.sampler``) materializes the metatree as
*branches*; a branch at depth d feeds HGNN layer k-d+1.  Everything
model-specific lives in the relation-module IR (``repro_torch.core.relmod``):
this module walks the metatree to initialize whatever the declaration asks
for (:func:`init_hgnn_params`) and, in the dict form the ``vanilla`` and
``raf`` executors train, evaluates it bottom-up (:func:`hgnn_forward`),
calling the module's aggregate per branch.  The stacked SPMD forward of the
``raf_spmd`` executor lives in ``repro_torch.core.raf_spmd``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.relmod import (
    RelContext,
    ShapeCtx,
    _generator,
    available_models,
    get_relation_module,
    glorot,
    init_module_params,
    resolve_params,
)
from repro_torch.graph.hetgraph import Relation
from repro_torch.graph.sampler import BranchSpec, SampleSpec, SampledBatch

__all__ = [
    "HGNNConfig",
    "init_hgnn_params",
    "init_embed_tables",
    "hgnn_forward",
    "hgnn_loss",
    "BatchArrays",
    "batch_to_arrays",
    "branch_layer",
    "rel_context",
    "agg_relation",
]

Params = Dict


@dataclasses.dataclass(frozen=True)
class HGNNConfig:
    model: str = "rgcn"  # any name registered in repro_torch.core.relmod
    hidden: int = 64
    num_layers: int = 2
    num_heads: int = 4
    num_classes: int = 2
    learnable_dim: int = 64  # dim of learnable features for featureless types
    dtype: str = "float32"

    def __post_init__(self):
        if self.model not in available_models():
            raise ValueError(
                f"unknown HGNN model {self.model!r}; registered relation "
                f"modules: {available_models()}"
            )
        if self.hidden % self.num_heads:
            raise ValueError("hidden must be divisible by num_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def module(self):
        """The relation module (IR declaration) this config names."""
        return get_relation_module(self.model)

    def shape_ctx(self, d_src: int, d_dst: int) -> ShapeCtx:
        return ShapeCtx(self.hidden, self.num_heads, self.head_dim, d_src, d_dst)


def branch_layer(spec: SampleSpec, depth: int) -> int:
    """HGNN layer index (1-based) a branch at ``depth`` feeds: layer k-d+1."""
    return spec.num_layers - depth + 1


def rel_context(rel: Relation, dst_type: str, layer: int) -> RelContext:
    """The :class:`RelContext` of one relation occurrence (scope keys derive
    from it)."""
    return RelContext(
        rel_key=rel.key,
        etype=rel.etype,
        src_type=rel.src,
        dst_type=dst_type,
        layer=layer,
    )


def _rel_param_specs(
    cfg: HGNNConfig, spec: SampleSpec, feat_dims: Dict[str, int]
) -> Dict[Tuple[str, int], Tuple[Relation, str, int, int]]:
    """Unique (relation-key, layer) -> (relation, dst_type, d_src, d_dst)."""
    dims = lambda t: feat_dims.get(t, cfg.learnable_dim)
    out: Dict[Tuple[str, int], Tuple[Relation, str, int, int]] = {}
    parents: List[str] = [spec.target_type]
    for d, branches in enumerate(spec.levels, start=1):
        layer = branch_layer(spec, d)
        nxt = []
        for b in branches:
            dst_t = parents[b.parent]
            d_src = dims(b.rel.src) if layer == 1 else cfg.hidden
            d_dst = dims(dst_t)  # queries always come from input features
            out.setdefault((b.rel.key, layer), (b.rel, dst_t, d_src, d_dst))
            nxt.append(b.rel.src)
        parents = nxt
    return out


def init_hgnn_params(
    seed: int,
    cfg: HGNNConfig,
    spec: SampleSpec,
    feat_dims: Dict[str, int],
    restrict_rels: Optional[List[str]] = None,
) -> Params:
    """Initialize the relation module's scoped parameters plus the classifier
    head on the CPU, walking every relation occurrence of the metatree.

    ``restrict_rels``: only materialize params for these relation keys (RAF
    partitions hold only the parameters of their local relations, paper §4).
    Each leaf's generator derives from ``seed`` and its name, so a
    restricted init is bit-identical to the full one."""
    dt = cfg.tdtype
    module = cfg.module
    occurrences = _rel_param_specs(cfg, spec, feat_dims)
    params: Params = {"rel": {}, "ntype": {}, "etype": {}}
    for (rk, layer), (rel, dst_t, d_src, d_dst) in sorted(occurrences.items()):
        if restrict_rels is not None and rk not in restrict_rels:
            continue
        ctx = rel_context(rel, dst_t, layer)
        init_module_params(seed, module, params, ctx, cfg.shape_ctx(d_src, d_dst), dt)

    params["head"] = {
        "w": glorot(_generator(seed, "head/w"), (cfg.hidden, cfg.num_classes), dt),
        "b": torch.zeros((cfg.num_classes,), dtype=dt),
    }
    return params


def init_embed_tables(
    seed: int,
    cfg: HGNNConfig,
    num_nodes: Dict[str, int],
    featured: Dict[str, int],
) -> Dict[str, torch.Tensor]:
    """Learnable feature tables for featureless node types (paper §2.1),
    normal with std 0.1, each from a generator seeded by the run seed and
    the type's name (the executors start from the cache engine's rows
    instead, as the reference's do)."""
    return {
        t: torch.randn((num_nodes[t], cfg.learnable_dim), generator=_generator(seed, f"embed/{t}"),
                       dtype=cfg.tdtype) * 0.1
        for t in sorted(num_nodes) if t not in featured
    }


# --------------------------------------------------------------------------
# relation-specific aggregation (AGG_r) — resolve + delegate to the module
# --------------------------------------------------------------------------


def agg_relation(
    cfg: HGNNConfig, params: Params, ctx: RelContext, h_src, q_feats, mask,
    kernels=None,
):
    """AGG_r: [n, f, d_src] x [n, d_dst_feat] x [n, f] -> [n, hidden].

    ``kernels`` routes ``mean_linear``-family modules through
    :func:`~repro_torch.kernels.relation_agg.relation_agg` (the hand-written
    kernel ``csrc/relation_agg.cu`` on CUDA tensors, its autograd ``Function``
    keeps it trainable) when the ``relation_agg`` toggle is on; other
    modules, and ``kernels=None``, use the module's own ``aggregate``.  The
    stacked variant of the SPMD executor lives in
    ``repro_torch.core.raf_spmd``."""
    module = cfg.module
    p = resolve_params(module, params, ctx)
    if kernels is not None and module.fused == "mean_linear":
        from repro_torch.kernels.ops import kernel_choice
        from repro_torch.kernels.relation_agg import relation_agg

        if kernel_choice(kernels, "relation_agg"):
            return relation_agg(h_src.contiguous(), mask, p["w"], p["b"])
    return module.aggregate(p, h_src, q_feats, mask)


# --------------------------------------------------------------------------
# batch arrays + full forward (the vanilla execution model's compute)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BatchArrays:
    """Device-side view of a :class:`SampledBatch`: index arrays only.  The
    feature gathers happen inside the forward, on the device, so learnable
    tables stay differentiable."""

    seeds: torch.Tensor  # [B] int64
    labels: torch.Tensor  # [B] int64
    nids: Tuple[torch.Tensor, ...]  # per level: [R_d, N_d] int64
    masks: Tuple[torch.Tensor, ...]  # per level: [R_d, N_d] bool


def batch_to_arrays(batch: SampledBatch, device) -> BatchArrays:
    """Copy a batch's index arrays (and nothing else) to ``device``."""
    def put(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return BatchArrays(
        seeds=put(batch.seeds, torch.long),
        labels=put(batch.labels, torch.long),
        nids=tuple(put(lv.nids, torch.long) for lv in batch.levels),
        masks=tuple(put(lv.mask, torch.bool) for lv in batch.levels),
    )


def _branch_io(spec: SampleSpec) -> List[List[Tuple[BranchSpec, str]]]:
    """Per level: (branch, dst_type) — dst type is the parent's src type."""
    out: List[List[Tuple[BranchSpec, str]]] = []
    parents = [spec.target_type]
    for branches in spec.levels:
        out.append([(b, parents[b.parent]) for b in branches])
        parents = [b.rel.src for b in branches]
    return out


def hgnn_forward(
    cfg: HGNNConfig,
    params: Params,
    tables: Dict[str, torch.Tensor],
    batch: BatchArrays,
    spec: SampleSpec,
    branch_mask: Optional[Dict[Tuple[int, int], bool]] = None,
    return_partial: bool = False,
    kernels=None,
) -> torch.Tensor:
    """Evaluate the full metatree bottom-up; returns logits [B, classes].

    ``tables`` maps node type -> feature table ([num_nodes, d]); learnable
    tables in ``params['embed']`` win over them and are gathered the same
    way (``F.embedding``, whose CUDA backward sums duplicate rows in a fixed
    order).  ``branch_mask`` drops branches (the RAF executors evaluate only
    a partition's sub-metatrees).  ``kernels`` (see :func:`agg_relation`)
    opts the per-relation aggregations into the kernel path — the vanilla
    oracle never passes it.

    ``return_partial=True`` returns the root's *partial aggregation* — the
    pre-AGG_all accumulation [B, hidden] — which is exactly what RAF workers
    exchange (paper Alg. 1 line 6); the caller sums partials across
    partitions, applies the nonlinearity and the classifier head."""
    k = spec.num_layers
    io = _branch_io(spec)
    embed = params.get("embed", {})

    def lookup(t: str) -> torch.Tensor:
        return embed[t] if t in embed else tables[t]

    def feats_of(depth: int, b: int) -> torch.Tensor:
        if depth == 0:
            return F.embedding(batch.seeds, lookup(spec.target_type))
        sp = spec.levels[depth - 1][b]
        return F.embedding(batch.nids[depth - 1][b], lookup(sp.rel.src))

    def included(depth: int, b: int) -> bool:
        return branch_mask is None or branch_mask.get((depth, b), False)

    # bottom-up: child_sum[b] accumulates AGG_r outputs into parent embeddings
    child_sum: List[Optional[torch.Tensor]] = [None]
    for depth in range(k, 0, -1):
        branches = io[depth - 1]
        f = spec.fanouts[depth - 1]
        sums: List[Optional[torch.Tensor]] = [None] * (len(io[depth - 2]) if depth > 1 else 1)
        for b, (bs, dst_t) in enumerate(branches):
            if not included(depth, b):
                continue
            # embeddings of this branch's nodes at layer (k - depth)
            if depth == k:
                h_nodes = feats_of(depth, b)
            else:
                acc = child_sum[b]
                if acc is None:
                    # leaf-at-intermediate-depth: type had no in-relations
                    h_nodes = torch.zeros((batch.nids[depth - 1][b].shape[0], cfg.hidden),
                                          dtype=cfg.tdtype, device=batch.seeds.device)
                else:
                    h_nodes = torch.relu(acc)
            n = h_nodes.shape[0] // f
            h_src = h_nodes.reshape(n, f, -1)
            mask = batch.masks[depth - 1][b].reshape(n, f)
            q_feats = feats_of(depth - 1, bs.parent)
            ctx = rel_context(bs.rel, dst_t, branch_layer(spec, depth))
            out = agg_relation(cfg, params, ctx, h_src, q_feats, mask, kernels)
            sums[bs.parent] = out if sums[bs.parent] is None else sums[bs.parent] + out
        child_sum = sums

    root = child_sum[0]
    if root is None:
        root = torch.zeros((batch.seeds.shape[0], cfg.hidden), dtype=cfg.tdtype,
                           device=batch.seeds.device)
    if return_partial:
        return root
    h = torch.relu(root)
    return h @ params["head"]["w"] + params["head"]["b"]


def nll_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under fp32 ``logits``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def hgnn_loss(
    cfg: HGNNConfig,
    params: Params,
    tables: Dict[str, torch.Tensor],
    batch: BatchArrays,
    spec: SampleSpec,
) -> torch.Tensor:
    return nll_loss(hgnn_forward(cfg, params, tables, batch, spec), batch.labels)
