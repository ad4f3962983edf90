"""RAF — Relation-Aggregation-First placement of metatree branches (paper §4).

Each partition holds complete mono-relation subgraphs for its relations plus
the relation-specific parameters, computes *partial aggregations* for the
target-node batch entirely locally, and only the partials cross partition
boundaries.  This module keeps the branch -> partition assignment the SPMD
plan (``repro_torch.core.raf_spmd``) is built from: the meta-partitioning
placement of Algorithm 2 and the naive random placement of the ablation.

:func:`raf_forward` / :func:`raf_loss` are the *simulated* multi-partition
execution of Alg. 1 (the dict-form ``raf`` executor): partitions are
explicit Python structure on one device, and the cross-partition exchange
is an actual sum of per-partition partials.  :func:`raf_comm_bytes` counts
the bytes that exchange moves per batch (paper §4), in numpy alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hgnn import BatchArrays, HGNNConfig, Params, hgnn_forward, nll_loss
from repro_torch.core.meta_partition import MetaPartitioning
from repro_torch.graph.sampler import SampleSpec

__all__ = [
    "BranchAssignment",
    "assign_branches",
    "random_branch_assignment",
    "raf_forward",
    "raf_loss",
    "raf_comm_bytes",
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


# --------------------------------------------------------------------------
# simulated multi-partition execution
# --------------------------------------------------------------------------


def raf_forward(
    cfg: HGNNConfig,
    params_parts: Sequence[Params],
    tables: Dict[str, torch.Tensor],
    batch: BatchArrays,
    spec: SampleSpec,
    assignment: BranchAssignment,
    kernels=None,
) -> torch.Tensor:
    """Alg. 1 forward: per-partition partial aggregations, then AGG_all + head.

    ``params_parts[p]`` holds partition p's relation parameters (and the
    learnable-feature tables under ``params['embed']``).  The designated
    worker's extra work (loss + head) is partition 0 by convention.
    ``kernels`` opts the per-relation aggregations into the kernel path
    (see ``repro_torch.core.hgnn.agg_relation``)."""
    partials = [
        hgnn_forward(cfg, params, tables, batch, spec, branch_mask=assignment.branch_mask(p),
                     return_partial=True, kernels=kernels)
        for p, params in enumerate(params_parts)
    ]
    root = sum(partials)  # AGG_all (cross-relation aggregation, paper Eq. 1)
    head = params_parts[0]["head"]
    return torch.relu(root) @ head["w"] + head["b"]


def raf_loss(
    cfg: HGNNConfig,
    params_parts: Sequence[Params],
    tables: Dict[str, torch.Tensor],
    batch: BatchArrays,
    spec: SampleSpec,
    assignment: BranchAssignment,
    kernels=None,
) -> torch.Tensor:
    logits = raf_forward(cfg, params_parts, tables, batch, spec, assignment, kernels)
    return nll_loss(logits, batch.labels)


# --------------------------------------------------------------------------
# communication accounting (paper §4 "Communication Reduction" example)
# --------------------------------------------------------------------------


def raf_comm_bytes(
    spec: SampleSpec,
    assignment: BranchAssignment,
    batch_size: int,
    hidden: int,
    bytes_per_elem: int = 2,
    style: str = "designated",
) -> int:
    """Bytes RAF moves for one batch: root-level partial exchange + any
    inner-level partials whose branch sits on a different partition than its
    parent (zero under meta-partitioning, Prop 2 / §5 Step 2).

    Forward partials and backward gradients are symmetric, hence the x2.
    ``designated``: (P-1) workers send to / receive from the designated one.
    ``allreduce``: bidirectional ring all-reduce moves 2·(P-1)/P x size per
    device; total wire bytes across the job are comparable — the designated
    style is the default, as in the paper's accounting."""
    P = assignment.num_partitions
    if P <= 1:
        return 0
    n_at = {0: batch_size}
    n = batch_size
    for d, f in enumerate(spec.fanouts, start=1):
        n *= f
        n_at[d] = n

    total_elems = 0
    # root-level exchange: every non-designated partition with >= 1 root
    # branch sends its [B, hidden] partial (fwd) and receives its gradient
    parts_with_root = {int(p) for p in assignment.owner[0]}
    senders = len(parts_with_root - {0}) if style == "designated" else P - 1
    total_elems += 2 * senders * batch_size * hidden
    # inner-level violations (only non-meta placements have any)
    for d in range(2, spec.num_layers + 1):
        parents = assignment._parents[d - 1]
        for b in range(len(assignment.owner[d - 1])):
            if assignment.owner[d - 1][b] != assignment.owner[d - 2][parents[b]]:
                total_elems += 2 * n_at[d - 1] * hidden
    return int(total_elems * bytes_per_elem)
