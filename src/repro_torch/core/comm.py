"""Communication-volume accounting for both execution models (paper §4).

The vanilla execution model (DGL/GraphLearn, paper Fig. 3) fetches raw
features of every remotely-stored sampled neighbor; RAF exchanges only
partial aggregations and their gradients.  These functions reproduce the
paper's §4 worked example (92.3 MB vanilla → 8.0 MB RAF-random → 0.5 MB
RAF+meta-partitioning on MAG240M-like settings) and drive
``benchmarks/comm_volume.py``.

All byte counts are *exact* given a sampled batch and a partition assignment;
nothing is modeled or estimated here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.meta_partition import EdgeCutPartition, HierarchicalPartition
from repro_torch.graph.hetgraph import HetGraph
from repro_torch.graph.sampler import SampledBatch

__all__ = [
    "vanilla_comm_bytes",
    "vanilla_update_bytes",
    "hierarchical_comm_bytes",
    "CommReport",
]


def _seed_owner(batch: SampledBatch, cut: EdgeCutPartition) -> np.ndarray:
    """DistDGL processes each training node on its home partition."""
    return cut.part_of(batch.spec.target_type, batch.seeds)


def vanilla_comm_bytes(
    batch: SampledBatch,
    cut: EdgeCutPartition,
    feat_dims: Dict[str, int],
    learnable_dim: int = 64,
    bytes_per_elem: int = 2,
    include_topology: bool = True,
    index_bytes: int = 8,
) -> int:
    """Bytes the vanilla model moves for one batch: features of every unique
    remotely-stored sampled node, fetched by the worker processing the seed
    (+ the sampled topology: one node id per sampled slot that is remote)."""
    owner = _seed_owner(batch, cut)
    B = batch.batch_size
    total = 0
    # (requester, ntype) -> set of remote node ids, deduplicated
    for lv, branches in zip(batch.levels, batch.spec.levels):
        n_per_seed = lv.nids.shape[1] // B
        req = np.repeat(owner, n_per_seed)  # [N_d] requester per slot
        for b, bs in enumerate(branches):
            nids, mask = lv.nids[b], lv.mask[b]
            node_part = cut.part_of(bs.src_type, nids)
            remote = (node_part != req) & mask
            if not remote.any():
                continue
            dim = feat_dims.get(bs.src_type, learnable_dim)
            pairs = np.stack([req[remote], nids[remote]], axis=1)
            uniq = np.unique(pairs, axis=0)
            total += len(uniq) * dim * bytes_per_elem
            if include_topology:
                total += int(remote.sum()) * index_bytes
    return int(total)


def vanilla_update_bytes(
    batch: SampledBatch,
    cut: EdgeCutPartition,
    graph: HetGraph,
    learnable_dim: int = 64,
    bytes_per_elem: int = 2,
    optimizer_state_mult: int = 2,  # Adam: moment + variance (paper §2.2)
) -> int:
    """Write-back traffic for learnable features: the vanilla model pushes
    updated learnable features + optimizer states to their home KVStore
    (paper Fig. 3 step 5); remote rows cross the network twice (read+write)."""
    owner = _seed_owner(batch, cut)
    B = batch.batch_size
    total = 0
    featless = [t for t in graph.num_nodes if t not in graph.features]
    for lv, branches in zip(batch.levels, batch.spec.levels):
        n_per_seed = lv.nids.shape[1] // B
        req = np.repeat(owner, n_per_seed)
        for b, bs in enumerate(branches):
            if bs.src_type not in featless:
                continue
            nids, mask = lv.nids[b], lv.mask[b]
            remote = (cut.part_of(bs.src_type, nids) != req) & mask
            if not remote.any():
                continue
            pairs = np.stack([req[remote], nids[remote]], axis=1)
            uniq = np.unique(pairs, axis=0)
            row = learnable_dim * bytes_per_elem * (1 + optimizer_state_mult)
            total += len(uniq) * row * 2  # read + write-back
    return int(total)


def hierarchical_comm_bytes(
    batch: SampledBatch,
    hier: HierarchicalPartition,
    hidden: int,
    feat_dims: Optional[Dict[str, int]] = None,
    learnable_dim: int = 64,
    bytes_per_elem: int = 2,
    grad_bytes: int = 0,
) -> "CommReport":
    """Exact per-level, per-batch byte accounting for the two-level
    hierarchy (DESIGN.md §13; DistDGL-style layout, PAPERS.md 2112.15345).

    * ``level0_raf`` — inter-group RAF partial-aggregate exchange.  Every
      group holds ≥1 root branch by construction (one sub-metatree per
      root child, paper §5), so each of the ``G-1`` non-designated groups
      moves one ``[B, hidden]`` partial forward and its gradient back:
      ``2·(G-1)·B·hidden`` elements — independent of the relation module
      and of every feature dimension (Prop 2).
    * ``level0_grad`` — inter-group model sync: group leaders all-reduce
      the shared gradient buffer (``2·(G-1)·grad_bytes`` wire bytes,
      designated style, fwd+bwd symmetric reduce+broadcast).
    * ``level1_grad`` — intra-group data parallelism: per group, a ring
      all-reduce of ``grad_bytes`` among ``S`` trainers moves
      ``2·(S-1)·grad_bytes`` aggregate wire bytes; summed over groups.
    * ``level1_local_read`` — feature bytes each batch pulls from the
      *shared* store (unique sampled nodes × dim).  These are DRAM /
      page-cache reads, **not** network traffic: trainers inside a group
      attach the same shm/mmap store, which is exactly why level 1 adds
      bandwidth, not bytes.  Reported for the vanilla contrast (an
      edge-cut-only system ships a large share of these over the wire).

    ``total_wire`` sums the three network levels and excludes the local
    reads.  All counts are exact given the batch and the hierarchy.
    """
    G, S = hier.num_groups, hier.trainers_per_group
    B = int(batch.batch_size)
    level0_raf = 2 * max(0, G - 1) * B * hidden * bytes_per_elem
    level0_grad = 2 * max(0, G - 1) * int(grad_bytes)
    level1_grad = G * 2 * max(0, S - 1) * int(grad_bytes)
    local_read = 0
    fd = feat_dims or {}
    for lv, branches in zip(batch.levels, batch.spec.levels):
        for b, bs in enumerate(branches):
            nids, mask = lv.nids[b], lv.mask[b]
            uniq = np.unique(nids[mask])
            dim = fd.get(bs.src_type, learnable_dim)
            local_read += uniq.size * dim * bytes_per_elem
    return CommReport(
        level0_raf=int(level0_raf),
        level0_grad=int(level0_grad),
        level1_grad=int(level1_grad),
        level1_local_read=int(local_read),
        total_wire=int(level0_raf + level0_grad + level1_grad),
    )


class CommReport(dict):
    """Convenience dict with pretty printing for benchmark output."""

    def render(self) -> str:
        width = max(len(k) for k in self)
        return "\n".join(
            f"  {k:<{width}}  {v / 1e6:10.3f} MB" if isinstance(v, (int, float))
            else f"  {k:<{width}}  {v}"
            for k, v in self.items()
        )
