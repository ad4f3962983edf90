"""Relation-module IR — HGNN variants as pure declarations (DESIGN.md §3).

Heta's core factorization (paper Eq. 1) says *any* HGNN layer is a set of
independent relation-specific aggregations (AGG_r) followed by one
cross-relation aggregation (AGG_all).  Everything model-specific therefore
fits in a small declarative unit, the **relation module**:

  * a tuple of :class:`ParamSpec` — each parameter leaf named, shaped, and
    *scoped*: does one copy exist per (relation, layer), per (source
    node-type, layer), per (destination node-type, layer) or per
    (edge-type, layer)?
  * one pure ``aggregate(params, h_src, q_feats, mask)`` — AGG_r for a
    single relation occurrence, written for unbatched ``[n, f, d]`` tensors.

The SPMD plan stacks each scope's parameters into per-shard slabs and the
stacked aggregation (``repro_torch.kernels.stacked_relation_agg``) either
launches the module's fused kernel or ``vmap``s the *same* ``aggregate``
over the branch axis.

Scope -> storage layout inside the parameter dict (``init_hgnn_params``):

  ================  =============  =============================
  scope             container      storage key
  ================  =============  =============================
  ``relation``      ``rel``        ``{rel_key}@{layer}``
  ``src_type``      ``ntype``      ``{src_type}@{layer}``
  ``dst_type``      ``ntype``      ``{dst_type}@{layer}:q``
  ``etype``         ``etype``      ``{etype}@{layer}``
  ================  =============  =============================

Initialization draws each leaf from its own ``torch.Generator`` seeded by
the run seed and ``crc32(f"{storage key}/{leaf}")``, so creation order
never changes values and a partition-restricted init reproduces the full
one.  The numbers differ from the reference package's (jax threefry);
parity runs carry the reference's weights over (``repro_torch.convert``).

Only R-GCN is declared so far; R-GAT and HGT arrive with their attention
kernels, and asking for them raises the registry's named error.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Tuple, Type

import numpy as np
import torch

__all__ = [
    "SCOPES",
    "SCOPE_CONTAINER",
    "ShapeCtx",
    "ParamSpec",
    "RelContext",
    "RelationModule",
    "register_relation_module",
    "get_relation_module",
    "available_models",
    "storage_key",
    "resolve_params",
    "init_module_params",
    "init_leaf",
    "glorot",
    "masked_mean",
]

SCOPES = ("relation", "src_type", "dst_type", "etype")

# scope -> top-level container inside the parameter dict
SCOPE_CONTAINER = {
    "relation": "rel",
    "src_type": "ntype",
    "dst_type": "ntype",
    "etype": "etype",
}


# --------------------------------------------------------------------------
# masked reductions
# --------------------------------------------------------------------------


def masked_mean(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """h [..., f, d], mask [..., f] -> [..., d]; empty groups give zeros."""
    w = mask.to(h.dtype)
    s = torch.einsum("...fd,...f->...d", h, w)
    return s / torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)


# --------------------------------------------------------------------------
# the IR
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCtx:
    """Dims a :class:`ParamSpec` shape function may depend on.

    ``d_src`` is the aggregation-input dim of the relation's source nodes at
    this layer (their feature dim at layer 1, ``hidden`` above); ``d_dst``
    is the destination nodes' *input-feature* dim.
    """

    hidden: int
    num_heads: int
    head_dim: int
    d_src: int
    d_dst: int


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One named parameter leaf of a relation module.

    ``shape`` maps a :class:`ShapeCtx` to the leaf's shape; dims derived
    from ``d_src``/``d_dst`` are the ones the SPMD plan zero-pads when
    stacking heterogeneous feature dims to a common ``d_pad``.
    """

    name: str
    scope: str  # one of SCOPES
    shape: Callable[[ShapeCtx], Tuple[int, ...]]
    init: str = "glorot"  # glorot | zeros
    scale: float = 1.0

    def __post_init__(self):
        if self.scope not in SCOPES:
            raise ValueError(f"unknown param scope {self.scope!r}; scopes: {SCOPES}")
        if self.init not in ("glorot", "zeros"):
            raise ValueError(f"unknown init {self.init!r}")


@dataclasses.dataclass(frozen=True)
class RelContext:
    """One relation occurrence: everything scope keys may derive from."""

    rel_key: str
    etype: str
    src_type: str
    dst_type: str
    layer: int


def storage_key(scope: str, ctx: RelContext) -> str:
    """Storage key of a ``scope``-scoped parameter group for ``ctx``."""
    if scope == "relation":
        return f"{ctx.rel_key}@{ctx.layer}"
    if scope == "src_type":
        return f"{ctx.src_type}@{ctx.layer}"
    if scope == "dst_type":
        return f"{ctx.dst_type}@{ctx.layer}:q"
    if scope == "etype":
        return f"{ctx.etype}@{ctx.layer}"
    raise ValueError(f"unknown param scope {scope!r}")


class RelationModule:
    """Base relation module: declared parameter specs + one pure AGG_r.

    ``aggregate`` takes the *resolved* flat leaf dict (``{spec.name:
    tensor}``) and unbatched inputs:

        h_src   [n, f, d_src]   neighbor embeddings, f per destination
        q_feats [n, d_dst]      destination nodes' input features
        mask    [n, f]          True for real (non-padded) neighbors

    and returns ``[n, hidden]``.  It must be pure and shape-polymorphic in
    ``n``/``f`` — the stacked oracle ``vmap``s it over the branch axis.

    ``fused`` names the stacked kernel family this module's aggregate
    lowers to: ``"mean_linear"`` (masked mean + projection; leaves ``w``
    ``[d_src, hidden]`` and ``b`` ``[hidden]`` sharing one scope, and
    ``aggregate == masked_mean(h, mask) @ w + b``), or ``None`` for the
    oracle path.
    """

    name: str = "?"
    specs: Tuple[ParamSpec, ...] = ()
    fused = None  # "mean_linear" | None

    @property
    def scopes(self) -> Tuple[str, ...]:
        """Scopes this module uses, in spec order, deduplicated."""
        return tuple(dict.fromkeys(s.scope for s in self.specs))

    def aggregate(self, p: Dict[str, torch.Tensor], h_src, q_feats, mask):
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        leaves = ", ".join(f"{s.name}:{s.scope}" for s in self.specs)
        return f"<RelationModule {self.name} [{leaves}]>"


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_MODULES: Dict[str, RelationModule] = {}


def register_relation_module(cls: Type[RelationModule]) -> Type[RelationModule]:
    """Class decorator: instantiate + register under ``cls.name``."""
    mod = cls()
    if mod.name == "?":
        raise ValueError(f"{cls.__name__} must set a `name` before registration")
    if mod.name in _MODULES:
        raise ValueError(
            f"relation module {mod.name!r} is already registered "
            f"({type(_MODULES[mod.name]).__name__}); pick a distinct name"
        )
    names = [s.name for s in mod.specs]
    if len(set(names)) != len(names):
        raise ValueError(f"module {mod.name!r} declares duplicate leaf names: {names}")
    _MODULES[mod.name] = mod
    return cls


def get_relation_module(name: str) -> RelationModule:
    if name not in _MODULES:
        raise KeyError(
            f"unknown HGNN model {name!r}; registered: {available_models()}"
        )
    return _MODULES[name]


def available_models() -> Tuple[str, ...]:
    return tuple(sorted(_MODULES))


# --------------------------------------------------------------------------
# initialization + resolution
# --------------------------------------------------------------------------


def _generator(seed: int, name: str) -> torch.Generator:
    """A CPU generator that is a pure function of (run seed, leaf name)."""
    return torch.Generator().manual_seed(
        (int(seed) << 32) + zlib.crc32(name.encode()))


def glorot(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Glorot-uniform over the last two dims, drawn from ``gen``."""
    fan_in, fan_out = shape[-2], shape[-1]
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return u * (2.0 * lim) - lim


def init_leaf(seed: int, spec: ParamSpec, skey: str, sc: ShapeCtx, dtype):
    """Initialize one leaf on the CPU; its generator is seeded from the run
    seed and the *names* (storage key + leaf), so creation order never
    changes values."""
    shape = tuple(spec.shape(sc))
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    w = glorot(_generator(seed, f"{skey}/{spec.name}"), shape, dtype)
    return w * spec.scale if spec.scale != 1.0 else w


def init_module_params(
    seed: int,
    module: RelationModule,
    params: Dict,
    ctx: RelContext,
    sc: ShapeCtx,
    dtype,
) -> None:
    """Materialize (idempotently) the parameters ``module`` needs for one
    relation occurrence into the scoped containers of ``params``.  Shared-
    scope groups already present are left untouched."""
    for spec in module.specs:
        container = params[SCOPE_CONTAINER[spec.scope]]
        skey = storage_key(spec.scope, ctx)
        group = container.setdefault(skey, {})
        if spec.name not in group:
            group[spec.name] = init_leaf(seed, spec, skey, sc, dtype)


def resolve_params(
    module: RelationModule, params: Dict, ctx: RelContext
) -> Dict[str, torch.Tensor]:
    """Flat ``{leaf name: tensor}`` view of one relation occurrence's
    parameters, gathered across the scoped containers."""
    return {
        s.name: params[SCOPE_CONTAINER[s.scope]][storage_key(s.scope, ctx)][s.name]
        for s in module.specs
    }


# --------------------------------------------------------------------------
# the built-in model zoo
# --------------------------------------------------------------------------


@register_relation_module
class RGCNModule(RelationModule):
    """R-GCN [39] — masked-mean neighbor aggregation + per-relation linear."""

    name = "rgcn"
    fused = "mean_linear"
    specs = (
        ParamSpec("w", "relation", lambda c: (c.d_src, c.hidden)),
        ParamSpec("b", "relation", lambda c: (c.hidden,), init="zeros"),
    )

    def aggregate(self, p, h_src, q_feats, mask):
        return masked_mean(h_src, mask) @ p["w"] + p["b"]
