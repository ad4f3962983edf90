"""Meta-partitioning of a HetG (paper §5, Algorithm 2).

Four steps:
  1. build a metatree from the metagraph (k-depth BFS from the target type,
     or from user metapaths);
  2. split it into sub-metatrees, one per child of the root — each keeps the
     root, so every partition holds all target nodes and complete aggregation
     paths, confining boundary nodes to the target type;
  3. LPT-assign sub-metatrees to p partitions by weight (greedy longest-
     processing-time-first on the p-way number-partitioning problem);
  4. deduplicate relations within each partition and materialize complete
     mono-relation subgraphs.

Also provides the generic edge-cut partition analysis used by the vanilla
baseline and the Prop-2/3 communication-complexity checks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.metatree import (
    MetaTreeNode,
    build_metatree,
    build_metatree_from_metapaths,
)
from repro_torch.graph.hetgraph import HetGraph, Metagraph, Relation

__all__ = [
    "SubMetatree",
    "MetaPartition",
    "MetaPartitioning",
    "meta_partition",
    "EdgeCutPartition",
    "random_edge_cut",
    "greedy_edge_cut",
    "boundary_nodes",
    "cross_edges",
    "HierarchicalPartition",
    "hierarchical_partition",
]


# --------------------------------------------------------------------------
# Steps 1-2: sub-metatrees
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SubMetatree:
    """S_c: the root, one child c of the root, and all of c's descendants."""

    root_child: MetaTreeNode
    root_type: str
    weight: int  # sum of unique vertex + link weights (Algorithm 2, line 8)

    def relations(self) -> List[Relation]:
        rels = [self.root_child.rel] if self.root_child.rel else []
        rels += self.root_child.relations()
        return rels

    def unique_relations(self) -> List[Relation]:
        return list(dict.fromkeys(self.relations()))

    def vertex_types(self) -> List[str]:
        return list(dict.fromkeys([self.root_type] + self.root_child.vertex_types()))


def _subtree_weight(sub: "SubMetatree", meta: Metagraph) -> int:
    """Weight = Σ node counts of unique vertex types + Σ edge counts of unique
    relations in S_c.  Unique (deduplicated) counts reflect the actual size of
    the partition the sub-metatree will create."""
    w = sum(meta.node_types[t] for t in sub.vertex_types())
    w += sum(meta.relations[r] for r in sub.unique_relations())
    return int(w)


def split_metatree(tree: MetaTreeNode, meta: Metagraph) -> List[SubMetatree]:
    """Step 2: one sub-metatree per child of the root."""
    subs: List[SubMetatree] = []
    for child in tree.children:
        sub = SubMetatree(root_child=child, root_type=tree.ntype, weight=0)
        sub.weight = _subtree_weight(sub, meta)
        subs.append(sub)
    return subs


# --------------------------------------------------------------------------
# Steps 3-4: LPT assignment + dedup
# --------------------------------------------------------------------------


@dataclasses.dataclass
class MetaPartition:
    """One HetG partition produced by meta-partitioning."""

    index: int
    sub_metatrees: List[SubMetatree]
    relations: List[Relation]  # deduplicated
    weight: int
    graph: Optional[HetGraph] = None  # materialized complete mono-rel subgraphs
    replica_group: int = 0  # >0 partitions replicate sub-metatrees (paper §5
    #   discussion: more machines than sub-metatrees → replicate + split
    #   target nodes with data parallelism)

    @property
    def node_types(self) -> List[str]:
        ts: List[str] = []
        for s in self.sub_metatrees:
            ts += s.vertex_types()
        return list(dict.fromkeys(ts))


@dataclasses.dataclass
class MetaPartitioning:
    """The result of Algorithm 2 plus bookkeeping used by RAF and benchmarks."""

    partitions: List[MetaPartition]
    metatree: MetaTreeNode
    target_type: str
    elapsed_s: float
    replicated: bool = False

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def relation_to_partition(self) -> Dict[Relation, int]:
        """Owner of each relation at the *root level*; deeper duplicates are
        intentional replication, not ownership."""
        owner: Dict[Relation, int] = {}
        for p in self.partitions:
            for r in p.relations:
                owner.setdefault(r, p.index)
        return owner

    def max_boundary_nodes(self) -> int:
        """Meta-partitioning confines boundary nodes to the target type
        (paper §5 Step 2): every partition holds all target nodes and complete
        aggregation paths, so the only cross-partition dependency is the
        cross-relation reduce at target nodes."""
        if self.num_partitions <= 1:
            return 0
        g = self.partitions[0].graph
        n_target = g.num_nodes[self.target_type] if g is not None else 0
        return int(n_target)

    def summary(self) -> str:
        lines = [
            f"meta-partitioning: {self.num_partitions} partitions, "
            f"{self.elapsed_s * 1e3:.2f} ms"
        ]
        for p in self.partitions:
            g = p.graph
            extra = (
                f" nodes={g.total_nodes:,} edges={g.total_edges:,}" if g else ""
            )
            lines.append(
                f"  P{p.index}: {len(p.relations)} relations "
                f"weight={p.weight:,}{extra} (replica_group={p.replica_group})"
            )
        return "\n".join(lines)


def meta_partition(
    graph: HetGraph,
    num_partitions: int,
    num_layers: int = 2,
    metapaths: Optional[Sequence[Sequence[Relation]]] = None,
    materialize: bool = True,
) -> MetaPartitioning:
    """Paper Algorithm 2 (all four steps).

    Operates purely on the metagraph — O(|A| log |A| + |R|) — and only touches
    the HetG itself when materializing partitions (slicing out complete
    mono-relation subgraphs, no node/edge reshuffling).
    """
    t0 = time.perf_counter()
    meta = graph.metagraph()
    root = graph.target_type

    # Step 1: metatree
    if metapaths:
        tree = build_metatree_from_metapaths(meta, root, metapaths)
    else:
        tree = build_metatree(meta, root, num_layers)

    # Step 2: split into sub-metatrees
    subs = split_metatree(tree, meta)
    if not subs:
        raise ValueError(
            f"target type {root!r} has no in-relations; nothing to partition"
        )

    # Paper §5 discussion: more partitions than sub-metatrees → replicate the
    # heaviest sub-metatrees; replicas split target nodes (data parallelism).
    replicated = False
    if num_partitions > len(subs):
        replicated = True
        subs = sorted(subs, key=lambda s: -s.weight)
        i = 0
        while len(subs) < num_partitions:
            clone = SubMetatree(
                root_child=subs[i % len(subs)].root_child,
                root_type=root,
                weight=subs[i % len(subs)].weight,
            )
            subs.append(clone)
            i += 1

    # Step 3: LPT greedy assignment (sort desc, place on least-loaded)
    order = sorted(range(len(subs)), key=lambda i: -subs[i].weight)
    parts: List[List[SubMetatree]] = [[] for _ in range(num_partitions)]
    sums = np.zeros(num_partitions, dtype=np.int64)
    for i in order:
        j = int(np.argmin(sums))
        parts[j].append(subs[i])
        sums[j] += subs[i].weight

    # Step 4: dedup relations per partition + materialize
    partitions: List[MetaPartition] = []
    rel_seen: Dict[Tuple[Relation, ...], int] = {}
    for idx, plist in enumerate(parts):
        rels: List[Relation] = []
        for s in plist:
            rels += s.relations()
        rels = list(dict.fromkeys(rels))  # dedup (line 19)
        key = tuple(sorted(rels, key=str))
        group = rel_seen.setdefault(key, idx)
        partitions.append(
            MetaPartition(
                index=idx,
                sub_metatrees=plist,
                relations=rels,
                weight=int(sums[idx]),
                replica_group=group,
            )
        )
    elapsed = time.perf_counter() - t0  # algorithm time, excl. materialization

    if materialize:
        for p in partitions:
            p.graph = graph.restrict(p.relations, name=f"{graph.name}:part{p.index}")

    return MetaPartitioning(
        partitions=partitions,
        metatree=tree,
        target_type=root,
        elapsed_s=elapsed,
        replicated=replicated,
    )


# --------------------------------------------------------------------------
# Edge-cut baselines + boundary/cross-edge analysis (vanilla model, Prop 2/3)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EdgeCutPartition:
    """Node-to-partition assignment per node type (edge-cut partitioning as in
    DGL-Random / GraphLearn; edges live with their dst node)."""

    assignment: Dict[str, np.ndarray]  # ntype -> [num_nodes[t]] partition id
    num_partitions: int
    elapsed_s: float = 0.0
    method: str = "random"

    def part_of(self, ntype: str, nids: np.ndarray) -> np.ndarray:
        return self.assignment[ntype][nids]


def random_edge_cut(
    graph: HetGraph, num_partitions: int, seed: int = 0
) -> EdgeCutPartition:
    """DGL-Random / GraphLearn analog: uniform random node assignment."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    assignment = {
        t: rng.integers(0, num_partitions, n).astype(np.int32)
        for t, n in graph.num_nodes.items()
    }
    return EdgeCutPartition(
        assignment, num_partitions, time.perf_counter() - t0, "random"
    )


def greedy_edge_cut(
    graph: HetGraph, num_partitions: int, seed: int = 0
) -> EdgeCutPartition:
    """Greedy LDG-style streaming edge-cut (METIS stand-in — METIS is not
    available offline; see DESIGN.md §7).  Nodes are streamed in degree order
    and placed on the partition holding most of their already-placed neighbors,
    penalized by load."""
    t0 = time.perf_counter()
    # flatten to a homogeneous view with global ids (as DGL does before METIS)
    offsets: Dict[str, int] = {}
    total = 0
    for t in graph.node_types:
        offsets[t] = total
        total += graph.num_nodes[t]
    # adjacency in global id space (undirected union over relations)
    srcs, dsts = [], []
    for rel, csr in graph.relations.items():
        s, d = csr.edges()
        srcs.append(s + offsets[rel.src])
        dsts.append(d + offsets[rel.dst])
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    und_src = np.concatenate([src, dst])
    und_dst = np.concatenate([dst, src])
    order = np.argsort(und_src, kind="stable")
    und_src, und_dst = und_src[order], und_dst[order]
    indptr = np.zeros(total + 1, dtype=np.int64)
    np.cumsum(np.bincount(und_src, minlength=total), out=indptr[1:])

    assign = np.full(total, -1, dtype=np.int32)
    load = np.zeros(num_partitions, dtype=np.int64)
    cap = max(1, total // num_partitions + 1)
    rng = np.random.default_rng(seed)
    visit = rng.permutation(total)
    for v in visit:
        nbrs = und_dst[indptr[v]:indptr[v + 1]]
        placed = assign[nbrs]
        score = np.bincount(placed[placed >= 0], minlength=num_partitions).astype(
            np.float64
        )
        score *= 1.0 - load / cap  # LDG load penalty
        assign[v] = int(np.argmax(score)) if score.any() else int(np.argmin(load))
        load[assign[v]] += 1
    assignment = {
        t: assign[offsets[t]: offsets[t] + graph.num_nodes[t]]
        for t in graph.node_types
    }
    return EdgeCutPartition(
        assignment, num_partitions, time.perf_counter() - t0, "greedy-ldg"
    )


def cross_edges(graph: HetGraph, cut: EdgeCutPartition) -> int:
    """E(G_i, G_j) summed over all partition pairs (vanilla comm ∝ this)."""
    n = 0
    for rel, csr in graph.relations.items():
        s, d = csr.edges()
        n += int(
            (cut.part_of(rel.src, s) != cut.part_of(rel.dst, d)).sum()
        )
    return n


def boundary_nodes(graph: HetGraph, cut: EdgeCutPartition) -> List[int]:
    """|B(G_i)| per partition: nodes with at least one neighbor in another
    partition (Prop 2/3)."""
    # boundary[t] = set of node ids of type t that touch a cross edge
    flags = {
        t: np.zeros(n, dtype=bool) for t, n in graph.num_nodes.items()
    }
    for rel, csr in graph.relations.items():
        s, d = csr.edges()
        cross = cut.part_of(rel.src, s) != cut.part_of(rel.dst, d)
        flags[rel.src][s[cross]] = True
        flags[rel.dst][d[cross]] = True
    counts = [0] * cut.num_partitions
    for t, fl in flags.items():
        ids = np.nonzero(fl)[0]
        parts = cut.part_of(t, ids)
        for p, c in zip(*np.unique(parts, return_counts=True)):
            counts[int(p)] += int(c)
    return counts


# --------------------------------------------------------------------------
# Hierarchical composition (DistDGL-style two-level scale-out, DESIGN.md §13)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class HierarchicalPartition:
    """Two-level partition hierarchy for multi-process scale-out.

    Composes the paper's schema-level meta-partitioning (level 0, across
    *trainer groups*) with greedy edge-cut partitioning (level 1, *inside*
    each group) — the DistDGL hybrid billion-scale layout (PAPERS.md,
    arxiv 2112.15345) applied to Heta:

    * **Level 0 — groups.**  ``meta_partition(graph, num_groups)`` assigns
      whole relation types to groups.  Each group holds complete
      mono-relation subgraphs plus all target nodes (paper §5 Step 2), so
      the only *inter-group* traffic is the RAF partial-aggregate exchange
      at target nodes — Θ(|B|·hidden) per batch, independent of the
      relation module (Prop 2).
    * **Level 1 — sub-partitions.**  Inside each group,
      ``greedy_edge_cut`` over the group's materialized subgraph splits
      nodes into ``trainers_per_group`` sub-partitions.  Trainers in a
      group run data-parallel over a *shared* store (shm or mmap), so
      *intra-group* traffic is the gradient allreduce only — edge-cut
      locality governs DRAM/page-cache reads, never network bytes.

    **Ownership invariant** (tested): every node of every type is owned by
    exactly one ``(group, sub_partition)`` pair.

    * Target-type nodes are *replicated* across groups at level 0; their
      unique owner group is the deterministic stripe ``nid % num_groups``
      (replicas split target nodes with data parallelism, paper §5
      discussion), and the owner sub-partition is that group's edge-cut
      assignment.
    * Every other type is owned by the first group whose schema contains
      it (deeper duplicates are replication, not ownership — same rule as
      :meth:`MetaPartitioning.relation_to_partition`); the sub-partition
      is that group's edge-cut assignment.
    * Types outside every group's schema (unreachable within
      ``num_layers`` of the metatree) fall back to group 0 with the
      stripe ``nid % trainers_per_group``.

    Global trainer ranks are row-major: ``rank = group * trainers_per_group
    + sub``.  Per-level byte accounting for this layout lives in
    :func:`repro.core.comm.hierarchical_comm_bytes` and is surfaced through
    ``Heta.comm_report``.
    """

    meta: MetaPartitioning
    cuts: List[EdgeCutPartition]  # one per group, over the group's subgraph
    group_of: Dict[str, np.ndarray]  # ntype -> [n] owning group id (int32)
    sub_of: Dict[str, np.ndarray]  # ntype -> [n] sub-partition in the group
    num_groups: int
    trainers_per_group: int
    elapsed_s: float = 0.0

    @property
    def num_trainers(self) -> int:
        return self.num_groups * self.trainers_per_group

    def owner(self, ntype: str, nids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(group, sub-partition) owning each node — exactly one per node."""
        nids = np.asarray(nids)
        return self.group_of[ntype][nids], self.sub_of[ntype][nids]

    def rank_of(self, ntype: str, nids: np.ndarray) -> np.ndarray:
        """Global trainer rank owning each node (row-major group × sub)."""
        g, s = self.owner(ntype, nids)
        return g.astype(np.int64) * self.trainers_per_group + s.astype(np.int64)

    def trainer_train_nodes(self, graph: HetGraph, rank: int) -> np.ndarray:
        """The disjoint slice of ``graph.train_nodes`` trainer ``rank`` owns.

        Concatenating over all ranks is a permutation of ``train_nodes``
        (every seed trained exactly once per epoch, no replication)."""
        if not 0 <= rank < self.num_trainers:
            raise ValueError(
                f"rank {rank} out of range for {self.num_trainers} trainers"
            )
        seeds = np.asarray(graph.train_nodes)
        return seeds[self.rank_of(graph.target_type, seeds) == rank]

    def validate_ownership(self, graph: HetGraph) -> None:
        """Assert the ownership invariant over every node of every type."""
        for t, n in graph.num_nodes.items():
            g, s = self.group_of.get(t), self.sub_of.get(t)
            if g is None or s is None or len(g) != n or len(s) != n:
                raise AssertionError(f"ownership missing/short for type {t!r}")
            if not ((g >= 0).all() and (g < self.num_groups).all()):
                raise AssertionError(f"group out of range for type {t!r}")
            if not ((s >= 0).all() and (s < self.trainers_per_group).all()):
                raise AssertionError(f"sub-partition out of range for {t!r}")

    def summary(self) -> str:
        lines = [
            f"hierarchical partition: {self.num_groups} group(s) x "
            f"{self.trainers_per_group} trainer(s) = {self.num_trainers} "
            f"ranks, {self.elapsed_s * 1e3:.2f} ms"
        ]
        for p in self.meta.partitions:
            cut = self.cuts[p.index]
            owned = sum(
                int((self.group_of[t] == p.index).sum())
                for t in self.group_of
            )
            lines.append(
                f"  G{p.index}: {len(p.relations)} relations, "
                f"{owned:,} owned nodes, edge-cut {cut.method} "
                f"({cut.elapsed_s * 1e3:.1f} ms)"
            )
        return "\n".join(lines)


def hierarchical_partition(
    graph: HetGraph,
    num_groups: int,
    trainers_per_group: int,
    num_layers: int = 2,
    metapaths: Optional[Sequence[Sequence[Relation]]] = None,
    seed: int = 0,
    edge_cut: str = "greedy",
) -> HierarchicalPartition:
    """Build the two-level hierarchy (see :class:`HierarchicalPartition`).

    Level 0 is Algorithm 2 verbatim (``meta_partition`` with
    ``materialize=True`` — level-1 cuts need the group subgraphs); level 1
    runs ``greedy_edge_cut`` (or ``random_edge_cut`` with
    ``edge_cut="random"``) per group with a per-group derived seed so group
    cuts are independent but deterministic in ``seed``.
    """
    if num_groups < 1 or trainers_per_group < 1:
        raise ValueError(
            f"num_groups and trainers_per_group must be >= 1, got "
            f"{num_groups} x {trainers_per_group}"
        )
    cut_fn = {"greedy": greedy_edge_cut, "random": random_edge_cut}.get(edge_cut)
    if cut_fn is None:
        raise ValueError(f"edge_cut must be 'greedy' or 'random', got {edge_cut!r}")
    t0 = time.perf_counter()
    meta = meta_partition(
        graph, num_groups, num_layers=num_layers, metapaths=metapaths,
        materialize=True,
    )
    cuts = [
        cut_fn(p.graph, trainers_per_group, seed=seed + 1000 * p.index)
        for p in meta.partitions
    ]

    # level-0 ownership: first group whose schema holds the type; target
    # nodes stripe across groups (replicas split seeds, paper §5).
    type_owner: Dict[str, int] = {}
    for p in meta.partitions:
        for t in p.node_types:
            type_owner.setdefault(t, p.index)
    target = graph.target_type
    G, S = len(meta.partitions), trainers_per_group
    group_of: Dict[str, np.ndarray] = {}
    sub_of: Dict[str, np.ndarray] = {}
    for t, n in graph.num_nodes.items():
        ids = np.arange(n, dtype=np.int64)
        if t == target:
            group_of[t] = (ids % G).astype(np.int32)
            sub = np.empty(n, dtype=np.int32)
            for g in range(G):
                mine = group_of[t] == g
                sub[mine] = cuts[g].part_of(t, ids[mine])
            sub_of[t] = sub
        elif t in type_owner:
            g = type_owner[t]
            group_of[t] = np.full(n, g, dtype=np.int32)
            sub_of[t] = cuts[g].part_of(t, ids).astype(np.int32)
        else:  # outside the metatree: deterministic fallback stripes
            group_of[t] = np.zeros(n, dtype=np.int32)
            sub_of[t] = (ids % S).astype(np.int32)

    return HierarchicalPartition(
        meta=meta,
        cuts=cuts,
        group_of=group_of,
        sub_of=sub_of,
        num_groups=G,
        trainers_per_group=S,
        elapsed_s=time.perf_counter() - t0,
    )
