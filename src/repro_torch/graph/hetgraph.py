"""Heterogeneous graph container.

A HetG is ``G = (V, E, A, R)`` (paper §2.1): nodes/edges carry types, a
*relation* is a triple ``(src_type, edge_type, dst_type)`` and the HetG
decomposes into *mono-relation subgraphs*, one per relation.  We store each
mono-relation subgraph as an in-CSR indexed by destination node (message
passing aggregates in-neighbors), which is the layout both the sampler and
the Pallas aggregation kernel consume.

Everything here is host-side numpy; device arrays enter the picture only in
``core/raf.py`` / ``core/vanilla.py`` once a minibatch has been sampled.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "Relation",
    "CSR",
    "HetGraph",
    "Metagraph",
    "reverse_relation",
]


@dataclasses.dataclass(frozen=True, order=True)
class Relation:
    """A relation triple (τ(u), φ(e), τ(v)); messages flow src → dst."""

    src: str
    etype: str
    dst: str

    def __str__(self) -> str:  # compact, used in logs/partition dumps
        return f"{self.src}-{self.etype}-{self.dst}"

    @property
    def key(self) -> str:
        return str(self)


def reverse_relation(rel: Relation) -> Relation:
    """The reverse relation r^{-1} = (τ(v), φ̄(e), τ(u)) (paper §2.1)."""
    if rel.etype.startswith("rev_"):
        return Relation(rel.dst, rel.etype[len("rev_"):], rel.src)
    return Relation(rel.dst, f"rev_{rel.etype}", rel.src)


@dataclasses.dataclass
class CSR:
    """In-CSR of one mono-relation subgraph: for each dst node, its in-edges.

    ``indptr`` has length ``num_dst + 1``; ``indices[indptr[v]:indptr[v+1]]``
    are the source node ids (of the relation's src type) of v's in-edges.
    """

    indptr: np.ndarray  # int64 [num_dst + 1]
    indices: np.ndarray  # int32/int64 [num_edges]

    def __post_init__(self) -> None:
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int64)
        if self.indptr.ndim != 1 or self.indices.ndim != 1:
            raise ValueError("CSR arrays must be 1-D")
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.indices):
            raise ValueError("inconsistent CSR indptr")

    @property
    def num_dst(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, num_dst: int) -> "CSR":
        """Build an in-CSR from a COO edge list."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.shape != dst.shape:
            raise ValueError("src/dst shape mismatch")
        order = np.argsort(dst, kind="stable")
        dst_sorted = dst[order]
        counts = np.bincount(dst_sorted, minlength=num_dst)
        indptr = np.zeros(num_dst + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSR(indptr=indptr, indices=src[order])

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (src, dst) COO arrays (inverse of :meth:`from_edges`)."""
        dst = np.repeat(np.arange(self.num_dst, dtype=np.int64), self.degrees())
        return self.indices.copy(), dst


@dataclasses.dataclass
class Metagraph:
    """Weighted metagraph M = (A, R): vertex weights = node counts, link
    weights = edge counts (paper §5, input to meta-partitioning)."""

    node_types: Dict[str, int]  # type -> num nodes (vertex weight)
    relations: Dict[Relation, int]  # relation -> num edges (link weight)

    def in_relations(self, ntype: str) -> List[Relation]:
        """Relations whose messages arrive at ``ntype`` (dst == ntype)."""
        return [r for r in self.relations if r.dst == ntype]

    def out_relations(self, ntype: str) -> List[Relation]:
        return [r for r in self.relations if r.src == ntype]

    @property
    def num_vertices(self) -> int:
        return len(self.node_types)

    @property
    def num_links(self) -> int:
        return len(self.relations)


@dataclasses.dataclass
class HetGraph:
    """A heterogeneous graph decomposed into mono-relation subgraphs.

    ``features[t]`` is a dense [num_nodes[t], feat_dim[t]] array for featured
    node types; featureless types (``t not in features``) receive *learnable*
    features managed by :mod:`repro.embed` (paper §2.1/§6).
    """

    num_nodes: Dict[str, int]
    relations: Dict[Relation, CSR]
    target_type: str
    num_classes: int
    features: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    labels: Optional[np.ndarray] = None  # [num_nodes[target_type]] int labels
    train_nodes: Optional[np.ndarray] = None  # subset of target nodes
    name: str = "hetg"

    def __post_init__(self) -> None:
        for rel, csr in self.relations.items():
            if rel.dst not in self.num_nodes or rel.src not in self.num_nodes:
                raise ValueError(f"relation {rel} references unknown node type")
            if csr.num_dst != self.num_nodes[rel.dst]:
                raise ValueError(
                    f"{rel}: CSR num_dst {csr.num_dst} != {self.num_nodes[rel.dst]}"
                )
            if csr.num_edges and csr.indices.max() >= self.num_nodes[rel.src]:
                raise ValueError(f"{rel}: src index out of range")
        if self.target_type not in self.num_nodes:
            raise ValueError("unknown target type")
        if self.train_nodes is None:
            self.train_nodes = np.arange(self.num_nodes[self.target_type])
        if self.labels is None:
            rng = np.random.default_rng(0)
            self.labels = rng.integers(
                0, self.num_classes, self.num_nodes[self.target_type]
            ).astype(np.int64)

    # ---- schema-level views -------------------------------------------------

    def metagraph(self) -> Metagraph:
        return Metagraph(
            node_types=dict(self.num_nodes),
            relations={r: c.num_edges for r, c in self.relations.items()},
        )

    def feat_dim(self, ntype: str) -> Optional[int]:
        f = self.features.get(ntype)
        return None if f is None else int(f.shape[1])

    @property
    def node_types(self) -> List[str]:
        return sorted(self.num_nodes)

    @property
    def total_nodes(self) -> int:
        return int(sum(self.num_nodes.values()))

    @property
    def total_edges(self) -> int:
        return int(sum(c.num_edges for c in self.relations.values()))

    # ---- subgraph extraction ------------------------------------------------

    def restrict(self, rels: Sequence[Relation], name: str = "") -> "HetGraph":
        """The sub-HetG containing the given complete mono-relation subgraphs
        (used to materialize a meta-partition, paper §5 step 4)."""
        rels = list(dict.fromkeys(rels))  # dedup, keep order
        ntypes = {self.target_type}
        for r in rels:
            ntypes.add(r.src)
            ntypes.add(r.dst)
        return HetGraph(
            num_nodes={t: self.num_nodes[t] for t in ntypes},
            relations={r: self.relations[r] for r in rels},
            target_type=self.target_type,
            num_classes=self.num_classes,
            features={t: f for t, f in self.features.items() if t in ntypes},
            labels=self.labels,
            train_nodes=self.train_nodes,
            name=name or f"{self.name}:restricted",
        )

    def storage_bytes(self) -> int:
        """Approximate host storage (topology + dense features)."""
        topo = sum(c.indptr.nbytes + c.indices.nbytes for c in self.relations.values())
        feat = sum(f.nbytes for f in self.features.values())
        return int(topo + feat)
