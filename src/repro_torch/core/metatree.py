"""Metatree construction (paper §5, Step 1).

The metatree encodes the HGNN computation dependency: starting from the
target node type (the only type with labels), k-hop neighborhood sampling can
only traverse relations whose *destination* is the currently-expanded type
(messages flow src → dst, so sampling walks edges backwards).  A k-depth BFS
over the metagraph from the target type therefore enumerates exactly the
relations an k-layer HGNN touches, in the order hierarchical aggregation
consumes them.

Alternatively the user provides metapaths (sequences of relations starting at
the root), mirroring Heta's optional ``metapaths`` argument.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.graph.hetgraph import Metagraph, Relation

__all__ = ["MetaTreeNode", "build_metatree", "build_metatree_from_metapaths"]


@dataclasses.dataclass
class MetaTreeNode:
    """A vertex occurrence in the metatree.

    ``rel`` is the relation connecting this node to its *parent* (messages
    flow from this node's type to the parent's type); ``None`` at the root.
    """

    ntype: str
    rel: Optional[Relation] = None
    depth: int = 0
    children: List["MetaTreeNode"] = dataclasses.field(default_factory=list)

    # -- traversal helpers ----------------------------------------------------

    def walk(self) -> Iterator["MetaTreeNode"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def relations(self) -> List[Relation]:
        """All relations in this (sub)tree, in BFS-ish order, with duplicates
        (duplicates arise from cycles in the metagraph; paper §5 Step 4
        deduplicates per partition)."""
        return [n.rel for n in self.walk() if n.rel is not None]

    def vertex_types(self) -> List[str]:
        return [n.ntype for n in self.walk()]

    def max_depth(self) -> int:
        return max(n.depth for n in self.walk())

    def num_nodes(self) -> int:
        return sum(1 for _ in self.walk())

    def render(self, indent: int = 0) -> str:
        via = f" <-[{self.rel.etype}]-" if self.rel else ""
        lines = [f"{'  ' * indent}{via} {self.ntype}"]
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)


def build_metatree(meta: Metagraph, root: str, depth: int) -> MetaTreeNode:
    """k-depth BFS from the target node type (paper Algorithm 2, line 4).

    Each level expands every in-relation of the frontier types; a relation may
    recur at deeper levels (e.g. Paper<-cites-Paper), exactly as multi-hop
    sampling revisits it.
    """
    if root not in meta.node_types:
        raise ValueError(f"unknown root type {root!r}")
    tree = MetaTreeNode(ntype=root, depth=0)
    frontier = [tree]
    for d in range(1, depth + 1):
        nxt: List[MetaTreeNode] = []
        for node in frontier:
            for rel in sorted(meta.in_relations(node.ntype)):
                child = MetaTreeNode(ntype=rel.src, rel=rel, depth=d)
                node.children.append(child)
                nxt.append(child)
        frontier = nxt
    return tree


def build_metatree_from_metapaths(
    meta: Metagraph, root: str, metapaths: Sequence[Sequence[Relation]]
) -> MetaTreeNode:
    """Construct a metatree from user metapaths (paper Algorithm 2, line 2).

    Each metapath is a sequence of relations walked from the root: relation i
    must have ``dst`` equal to the current type, and the walk steps to its
    ``src`` type (the node type sampled at hop i+1).
    """
    tree = MetaTreeNode(ntype=root, depth=0)
    for path in metapaths:
        cur = tree
        for rel in path:
            if rel not in meta.relations:
                raise ValueError(f"metapath relation {rel} not in metagraph")
            if rel.dst != cur.ntype:
                raise ValueError(
                    f"metapath relation {rel} does not extend type {cur.ntype!r}"
                )
            # merge shared prefixes so the tree reflects the union of paths
            nxt = next(
                (c for c in cur.children if c.rel == rel and c.ntype == rel.src),
                None,
            )
            if nxt is None:
                nxt = MetaTreeNode(ntype=rel.src, rel=rel, depth=cur.depth + 1)
                cur.children.append(nxt)
            cur = nxt
    return tree
