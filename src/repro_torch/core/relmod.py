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

Three modules are declared: R-GCN (``fused == "mean_linear"``), and R-GAT
and HGT (``fused == "softmax_combine"``), whose attention epilogue runs
through the hand-written kernels ``csrc/stacked_attn_epilogue.cu`` and
``csrc/stacked_attn_dh.cu``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

__all__ = [
    "SCOPES",
    "SCOPE_CONTAINER",
    "ShapeCtx",
    "ParamSpec",
    "RelContext",
    "AttnEpilogue",
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
    "masked_softmax",
    "leaky_relu",
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


def masked_softmax(e: torch.Tensor, mask: torch.Tensor, axis: int) -> torch.Tensor:
    """Softmax with masked slots excluded; all-masked groups give zeros.

    The reference's numerics: masked logits are filled with
    ``finfo(dtype).min``, the max is taken without a gradient, and the
    denominator is clamped at 1e-9."""
    e = torch.where(mask, e, torch.finfo(e.dtype).min)
    e = e - torch.amax(e, dim=axis, keepdim=True).detach()
    z = torch.exp(e) * mask.to(e.dtype)
    return z / torch.clamp(z.sum(dim=axis, keepdim=True), min=1e-9)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``'s convention: slope 1 at exactly 0, where
    ``F.leaky_relu``'s backward takes ``slope``.  Padded neighbours are zero
    rows, so exact zeros occur."""
    return torch.where(x >= 0, x, slope * x)


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


@dataclasses.dataclass
class AttnEpilogue:
    """Canonical operand form of a fully fused attention epilogue.

    Every ``softmax_combine`` module's AGG_r factors as

        z0 = h_src @ we[ue[s]]                       # logits projection
        zt = z0                 if pe is None else   # per-etype transform
             einsum("nfhd,hde->nfhe", z0, pe[ua[s]])
        e0 = einsum("nfhe,nhe->nfh", zt, qv) * scale (+ eb)
        e  = leaky_relu(e0, slope)  (slope=None -> identity)
        v0 = h_src @ wv[uv[s]]   (shared with z0 when wv is None)
        vt = v0                 if pv is None else
             einsum("nfhd,hde->nfhe", v0, pv[ua[s]])
        out = einsum("nfh,nfhd->nhd", masked_softmax(e), vt) (+ bias)

    where ``we``/``wv`` are the stacked ``[U, d_in, nh*dh]`` projection
    slabs and ``ue``/``uv``/``ua`` the per-slot stack rows: the kernel reads
    each slot's weights from the stack, so no per-slot weight copy is made.
    ``qv`` may have a zero node stride (an expanded per-slot vector, as
    R-GAT's ``a_src``); the kernel then reads one vector per slot.
    """

    we: torch.Tensor  # [Ue, d_in, nh*dh] logits-projection stack
    ue: object  # [rb] int slot -> stack row of `we` (host array or staged tensor)
    qv: torch.Tensor  # [rb, n, nh*dh] per-destination query vectors
    wv: Optional[torch.Tensor] = None  # [Uv, d_in, nh*dh]; None -> shares `we`
    uv: object = None  # [rb] int; None -> `ue`
    pe: Optional[torch.Tensor] = None  # [Ua, nh, dh, dh] logits transform
    pv: Optional[torch.Tensor] = None  # [Ua, nh, dh, dh] values transform
    ua: object = None  # [rb] int (required with pe/pv)
    eb: Optional[torch.Tensor] = None  # [rb, n, nh] additive logit term
    bias: Optional[torch.Tensor] = None  # [rb, hidden] additive output bias
    num_heads: int = 1
    head_dim: int = 1
    scale: float = 1.0
    slope: Optional[float] = None  # leaky_relu negative slope on logits


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
    lowers to (``None`` keeps it on the oracle path):

      * ``"mean_linear"`` — masked mean + projection.  Contract: leaves
        ``w`` ``[d_src, hidden]`` and ``b`` ``[hidden]`` sharing one scope,
        and ``aggregate == masked_mean(h, mask) @ w + b``.
      * ``"softmax_combine"`` — attention.  Contract: the module implements
        :meth:`attn_parts` (and optionally :meth:`attn_bias`) so that
        ``aggregate`` is :meth:`_softmax_aggregate`, and
        :meth:`attn_epilogue` gives the stacked operands of the fused
        kernel (``csrc/stacked_attn_epilogue.cu``).
    """

    name: str = "?"
    specs: Tuple[ParamSpec, ...] = ()
    fused: Optional[str] = None  # "mean_linear" | "softmax_combine" | None

    @property
    def scopes(self) -> Tuple[str, ...]:
        """Scopes this module uses, in spec order, deduplicated."""
        return tuple(dict.fromkeys(s.scope for s in self.specs))

    def aggregate(self, p: Dict[str, torch.Tensor], h_src, q_feats, mask):
        raise NotImplementedError

    # -- softmax_combine family hooks -------------------------------------

    def attn_parts(self, p: Dict[str, torch.Tensor], h_src, q_feats):
        """(logits ``[n, f, nh]``, values ``[n, f, nh, dh]``) of the masked
        softmax + combine: everything of AGG_r before the softmax."""
        raise NotImplementedError

    def attn_bias(self, p: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """Additive output bias ``[hidden]`` applied after the combine."""
        return None

    def attn_epilogue(self, stacks, slot_u, q_feats, linear, take) -> Optional[AttnEpilogue]:
        """Stacked-operand form of this module's attention epilogue.

        ``stacks`` / ``slot_u`` are one shard's per-scope parameter slabs and
        per-slot stack rows; ``q_feats`` is ``[rb, n, d_dst]``.  The kernel
        layer injects two ops: ``linear(w_stack, u, x)`` computes the
        per-slot projection ``x @ w_stack[u]`` without a gathered weight
        copy (its backward lands in stack form), and ``take(stack, u)``
        gathers the per-slot rows ``stack[u]`` of a small leaf with a
        deterministic backward (a one-hot slot sum, not atomics).

        ``None`` keeps the module on the ``attn_parts`` path.
        """
        return None

    def _softmax_aggregate(self, p, h_src, q_feats, mask):
        """The canonical ``softmax_combine`` factoring of ``aggregate``: the
        fused path replaces the epilogue below with the kernel."""
        e, v = self.attn_parts(p, h_src, q_feats)
        n, f, nh, dh = v.shape
        alpha = masked_softmax(e, mask[:, :, None], axis=1)
        out = torch.einsum("nfh,nfhd->nhd", alpha, v).reshape(n, nh * dh)
        b = self.attn_bias(p)
        return out if b is None else out + b

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


@register_relation_module
class RGATModule(RelationModule):
    """R-GAT [3] — per-relation multi-head attention; queries are the
    destination nodes' *input* features (tree-sampling variant)."""

    name = "rgat"
    fused = "softmax_combine"
    specs = (
        ParamSpec("w", "relation", lambda c: (c.d_src, c.hidden)),
        ParamSpec("w_dst", "relation", lambda c: (c.d_dst, c.hidden)),
        ParamSpec("a_src", "relation", lambda c: (c.num_heads, c.head_dim), scale=0.1),
        ParamSpec("a_dst", "relation", lambda c: (c.num_heads, c.head_dim), scale=0.1),
        ParamSpec("b", "relation", lambda c: (c.hidden,), init="zeros"),
    )

    def attn_parts(self, p, h_src, q_feats):
        nh, dh = p["a_src"].shape
        n, f, _ = h_src.shape
        z = (h_src @ p["w"]).reshape(n, f, nh, dh)
        qz = (q_feats @ p["w_dst"]).reshape(n, nh, dh)
        e_src = torch.einsum("nfhd,hd->nfh", z, p["a_src"])
        e_dst = torch.einsum("nhd,hd->nh", qz, p["a_dst"])
        return leaky_relu(e_src + e_dst[:, None, :], 0.2), z

    def attn_bias(self, p):
        return p["b"]

    def attn_epilogue(self, stacks, slot_u, q_feats, linear, take):
        u = slot_u["relation"]
        nh, dh = stacks["a_src"].shape[1:]
        rb, n, _ = q_feats.shape
        # e_dst per destination: the q-side projection through the stacked
        # kernel, contracted with the per-slot a_dst
        qz = linear(stacks["w_dst"], u, q_feats).reshape(rb, n, nh, dh)
        eb = torch.einsum("rnhd,rhd->rnh", qz, take(stacks["a_dst"], u))
        # e_src = einsum(z, a_src) is the canonical qv contraction with qv =
        # a_src; expanded over the destinations (node stride 0), not copied
        qv = take(stacks["a_src"], u).reshape(rb, 1, nh * dh).expand(rb, n, nh * dh)
        return AttnEpilogue(
            we=stacks["w"], ue=u, qv=qv, eb=eb, bias=take(stacks["b"], u),
            num_heads=nh, head_dim=dh, scale=1.0, slope=0.2,
        )

    def aggregate(self, p, h_src, q_feats, mask):
        return self._softmax_aggregate(p, h_src, q_feats, mask)


@register_relation_module
class HGTModule(RelationModule):
    """HGT [21] — per-node-type K/Q/V projections + per-edge-type attention
    and message matrices (simplified: no residual/prior-mu tricks)."""

    name = "hgt"
    fused = "softmax_combine"
    specs = (
        ParamSpec("wk", "src_type", lambda c: (c.d_src, c.hidden)),
        ParamSpec("wv", "src_type", lambda c: (c.d_src, c.hidden)),
        ParamSpec("wq", "dst_type", lambda c: (c.d_dst, c.hidden)),
        ParamSpec("w_att", "etype", lambda c: (c.num_heads, c.head_dim, c.head_dim)),
        ParamSpec("w_msg", "etype", lambda c: (c.num_heads, c.head_dim, c.head_dim)),
    )

    def attn_parts(self, p, h_src, q_feats):
        nh, dh, _ = p["w_att"].shape
        n, f, _ = h_src.shape
        k = (h_src @ p["wk"]).reshape(n, f, nh, dh)
        v = (h_src @ p["wv"]).reshape(n, f, nh, dh)
        q = (q_feats @ p["wq"]).reshape(n, nh, dh)
        kw = torch.einsum("nfhd,hde->nfhe", k, p["w_att"])
        att = torch.einsum("nfhe,nhe->nfh", kw, q) / float(np.sqrt(np.float32(dh)))
        msg = torch.einsum("nfhd,hde->nfhe", v, p["w_msg"])
        return att, msg

    def attn_epilogue(self, stacks, slot_u, q_feats, linear, take):
        us, ud, ue = slot_u["src_type"], slot_u["dst_type"], slot_u["etype"]
        nh, dh = stacks["w_att"].shape[1:3]
        qv = linear(stacks["wq"], ud, q_feats)  # [rb, n, nh*dh]
        return AttnEpilogue(
            we=stacks["wk"], ue=us, wv=stacks["wv"], uv=us,
            pe=stacks["w_att"], pv=stacks["w_msg"], ua=ue, qv=qv,
            num_heads=nh, head_dim=dh,
            scale=float(1.0 / np.sqrt(dh)), slope=None,
        )

    def aggregate(self, p, h_src, q_feats, mask):
        return self._softmax_aggregate(p, h_src, q_feats, mask)
