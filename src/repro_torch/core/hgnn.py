"""HGNN configuration and parameter initialization over the metatree.

An HGNN layer (paper Eq. 1) is

    h_v^(l) = AGG_all( { AGG_r( {h_u^(l-1) : u ∈ N_r(v)} ) : r ∈ R } )

The sampler (``repro_torch.graph.sampler``) materializes the metatree as
*branches*; a branch at depth d feeds HGNN layer k-d+1.  Everything
model-specific lives in the relation-module IR (``repro_torch.core.relmod``):
this module walks the metatree to initialize whatever the declaration asks
for.  The dict-form forward and loss (the ``vanilla``/``raf`` executors) are
a later slice of the port: training runs on the stacked SPMD forward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.relmod import (
    RelContext,
    ShapeCtx,
    _generator,
    available_models,
    get_relation_module,
    glorot,
    init_module_params,
)
from repro_torch.graph.hetgraph import Relation
from repro_torch.graph.sampler import SampleSpec

__all__ = [
    "HGNNConfig",
    "init_hgnn_params",
    "branch_layer",
    "rel_context",
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
