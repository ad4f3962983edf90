"""RAF — Relation-Aggregation-First placement of metatree branches (paper §4).

Each partition holds complete mono-relation subgraphs for its relations plus
the relation-specific parameters, computes *partial aggregations* for the
target-node batch entirely locally, and only the partials cross partition
boundaries.  This module keeps the branch -> partition assignment the SPMD
plan (``repro_torch.core.raf_spmd``) is built from: the meta-partitioning
placement of Algorithm 2 and the naive random placement of the ablation.
The simulated multi-partition forward and the communication accounting
(the dict-form ``raf`` executor) are a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.meta_partition import MetaPartitioning
from repro_torch.graph.sampler import SampleSpec

__all__ = [
    "BranchAssignment",
    "assign_branches",
    "random_branch_assignment",
]


# --------------------------------------------------------------------------
# branch -> partition assignment
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BranchAssignment:
    """Owner partition of every metatree branch, plus derived masks.

    ``meta_local`` is True iff every branch lives in the same partition as its
    parent (the meta-partitioning invariant: sub-metatrees are never split),
    in which case the only cross-partition traffic is the root-level exchange
    of [B, hidden] partials — Θ(|targets|) as in paper §5 Step 2.
    """

    owner: List[np.ndarray]  # per level d: int array [R_d] of partition ids
    num_partitions: int

    @property
    def meta_local(self) -> bool:
        return len(self.violations()) == 0

    def violations(self) -> List[Tuple[int, int]]:
        """(depth, branch) pairs whose owner differs from their parent's."""
        bad = []
        for d in range(1, len(self.owner)):
            parents = self._parents[d]
            for b in range(len(self.owner[d])):
                if self.owner[d][b] != self.owner[d - 1][parents[b]]:
                    bad.append((d + 1, b))
        return bad

    def attach_parents(self, spec: SampleSpec) -> "BranchAssignment":
        self._parents = [None] + [
            np.array([bs.parent for bs in lv], dtype=np.int64)
            for lv in spec.levels[1:]
        ]
        return self

    def branch_mask(self, part: int) -> Dict[Tuple[int, int], bool]:
        """hgnn_forward-style inclusion mask for one partition."""
        mask: Dict[Tuple[int, int], bool] = {}
        for d, own in enumerate(self.owner, start=1):
            for b, p in enumerate(own):
                if int(p) == part:
                    mask[(d, b)] = True
        return mask

    def fold(self, num_shards: int, spec: SampleSpec) -> "BranchAssignment":
        """Fold P partitions onto ``num_shards`` model shards (p % shards).

        Used when the mesh's model axis is smaller than the partition count
        (e.g. single-device tests, or more sub-metatrees than chips).  The
        fold is a function of the partition id alone, so parent/child
        branches stay co-located and meta-locality is preserved.
        """
        folded = BranchAssignment(
            [o % num_shards for o in self.owner], num_shards
        )
        return folded.attach_parents(spec)

    def relations_of(self, part: int, spec: SampleSpec) -> List[str]:
        rels: List[str] = []
        for d, own in enumerate(self.owner, start=1):
            for b, p in enumerate(own):
                if int(p) == part:
                    rels.append(spec.levels[d - 1][b].rel.key)
        return list(dict.fromkeys(rels))


def assign_branches(spec: SampleSpec, parting: MetaPartitioning) -> BranchAssignment:
    """Assign every branch to the partition owning its root-level sub-metatree.

    The metatree used to build ``spec`` and the one inside ``parting`` share
    BFS child order, so root-child index b at level 1 corresponds to
    ``parting.metatree.children[b]``; descendants inherit the owner (the
    sub-metatree is assigned wholesale — Algorithm 2, Step 3).
    """
    root_children = parting.metatree.children
    if len(root_children) != len(spec.levels[0]):
        raise ValueError("spec/partitioning metatree mismatch")
    child_owner: Dict[int, int] = {}
    for p in parting.partitions:
        for s in p.sub_metatrees:
            for i, c in enumerate(root_children):
                if c is s.root_child and i not in child_owner:
                    child_owner[i] = p.index
    owner: List[np.ndarray] = [
        np.array([child_owner[i] for i in range(len(spec.levels[0]))], np.int64)
    ]
    for d in range(2, spec.num_layers + 1):
        prev = owner[-1]
        owner.append(
            np.array([prev[bs.parent] for bs in spec.levels[d - 1]], np.int64)
        )
    return BranchAssignment(owner, parting.num_partitions).attach_parents(spec)


def random_branch_assignment(
    spec: SampleSpec, num_partitions: int, seed: int = 0
) -> BranchAssignment:
    """Naive relation placement (no metatree awareness): branches land on
    random partitions, so parent/child branches split across machines and the
    inner-hop partials must cross the network (paper §4's 8.0 MB case)."""
    rng = np.random.default_rng(seed)
    owner = [
        rng.integers(0, num_partitions, len(lv)).astype(np.int64)
        for lv in spec.levels
    ]
    return BranchAssignment(owner, num_partitions).attach_parents(spec)
