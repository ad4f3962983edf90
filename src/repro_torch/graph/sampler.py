"""Fixed-fanout k-hop neighborhood sampling over the metatree.

JAX needs static shapes, so we sample a *fixed* number of in-neighbors per
node per relation (with replacement; degree-0 slots are masked).  The sampled
computation structure is exactly the metatree (paper §5): every metatree node
below the root becomes a *branch* — a stack of ``fanout`` samples per parent
node — and the HGNN evaluates branches bottom-up with relation-specific
aggregations, combining children by cross-relation summation (Eq. 1).

The branch representation is deliberately tensor-friendly:

  level d (1-based):  nids [R_d, N_d]  mask [R_d, N_d]
  with N_d = batch * f_1 * ... * f_d, R_d = number of metatree nodes at depth d

so relation-specific aggregation at level d is a single gather + reshape
[R_d, N_{d-1}, f_d, dim] + masked reduce — the shape the Pallas
``gather_agg`` kernel and the sharded RAF executor both consume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.metatree import MetaTreeNode
from repro_torch.graph.hetgraph import CSR, HetGraph, Relation

__all__ = [
    "BranchSpec",
    "SampleSpec",
    "Level",
    "SampledBatch",
    "NeighborSampler",
    "sample_neighbors",
]


@dataclasses.dataclass(frozen=True)
class BranchSpec:
    """Static description of one metatree branch (= one relation instance)."""

    rel: Relation
    parent: int  # branch index at the previous level (level 0 has one "branch")
    depth: int  # 1-based

    @property
    def src_type(self) -> str:
        return self.rel.src


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    """Static sampling plan derived from a metatree + fanouts."""

    target_type: str
    fanouts: Tuple[int, ...]
    levels: Tuple[Tuple[BranchSpec, ...], ...]  # levels[d-1] = branches at depth d

    @property
    def num_layers(self) -> int:
        return len(self.fanouts)

    def branches(self) -> Iterator[BranchSpec]:
        for lv in self.levels:
            yield from lv

    def num_sampled(self, batch_size: int) -> Dict[int, int]:
        """N_d per depth (nodes sampled per branch)."""
        out, n = {}, batch_size
        for d, f in enumerate(self.fanouts, start=1):
            n = n * f
            out[d] = n
        return out

    @staticmethod
    def from_metatree(tree: MetaTreeNode, fanouts: Sequence[int]) -> "SampleSpec":
        k = len(fanouts)
        levels: List[List[BranchSpec]] = [[] for _ in range(k)]
        # walk the tree breadth-first, recording each node's branch index so
        # children can reference their parent's index at the previous level
        frontier: List[Tuple[MetaTreeNode, int]] = [(tree, 0)]
        for d in range(1, k + 1):
            nxt: List[Tuple[MetaTreeNode, int]] = []
            for node, idx in frontier:
                for child in node.children:
                    levels[d - 1].append(BranchSpec(child.rel, idx, d))
                    nxt.append((child, len(levels[d - 1]) - 1))
            frontier = nxt
        return SampleSpec(
            target_type=tree.ntype,
            fanouts=tuple(int(f) for f in fanouts),
            levels=tuple(tuple(lv) for lv in levels),
        )


@dataclasses.dataclass
class Level:
    """Sampled node ids for every branch at one depth."""

    nids: np.ndarray  # int32 [R_d, N_d]
    mask: np.ndarray  # bool  [R_d, N_d]


@dataclasses.dataclass
class SampledBatch:
    """One sampled minibatch: seeds (target nodes) + per-level branch samples."""

    spec: SampleSpec
    seeds: np.ndarray  # int64 [B]
    labels: np.ndarray  # int64 [B]
    levels: List[Level]

    @property
    def batch_size(self) -> int:
        return int(len(self.seeds))

    def nodes_at(self, depth: int, branch: int) -> Tuple[np.ndarray, np.ndarray]:
        """(nids, mask) of the nodes feeding branch ``branch`` at ``depth``."""
        if depth == 0:
            return self.seeds, np.ones_like(self.seeds, dtype=bool)
        lv = self.levels[depth - 1]
        return lv.nids[branch], lv.mask[branch]

    def total_sampled(self) -> int:
        return int(sum(lv.mask.sum() for lv in self.levels)) + self.batch_size

    def count_visits(self, counts: Dict[str, np.ndarray]) -> None:
        """Accumulate this batch's per-type node visit counts into ``counts``
        (the §6 pre-sampling statistic; shared by the serial profiler and the
        pooled hotness task so both count identically)."""
        np.add.at(counts[self.spec.target_type], self.seeds, 1)
        for lv, branches in zip(self.levels, self.spec.levels):
            for b, bs in enumerate(branches):
                ids = lv.nids[b][lv.mask[b]]
                np.add.at(counts[bs.src_type], ids, 1)

    def unique_nodes_per_type(self) -> Dict[str, np.ndarray]:
        """Unique node ids touched per node type (drives feature fetching,
        cache lookups and the vanilla-model communication accounting)."""
        acc: Dict[str, List[np.ndarray]] = {self.spec.target_type: [self.seeds]}
        for lv, branches in zip(self.levels, self.spec.levels):
            for b, spec in enumerate(branches):
                acc.setdefault(spec.src_type, []).append(lv.nids[b][lv.mask[b]])
        return {t: np.unique(np.concatenate(v)) for t, v in acc.items() if v}


def sample_neighbors(
    csr: CSR,
    parents: np.ndarray,
    parent_mask: np.ndarray,
    fanout: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample ``fanout`` in-neighbors per parent, with replacement.

    Degree-0 parents (and invalid parents) yield masked slots pointing at 0.
    """
    n = len(parents)
    deg = csr.indptr[parents + 1] - csr.indptr[parents]  # [n]
    valid = (deg > 0) & parent_mask
    if csr.num_edges == 0:
        return np.zeros((n, fanout), np.int64), np.zeros((n, fanout), bool)
    safe_deg = np.maximum(deg, 1)
    offs = (rng.random((n, fanout)) * safe_deg[:, None]).astype(np.int64)
    raw = csr.indptr[parents][:, None] + offs
    raw = np.minimum(raw, csr.num_edges - 1)  # clamp degree-0 tail slots
    idx = np.where(valid[:, None], csr.indices[raw], 0)
    mask = np.broadcast_to(valid[:, None], (n, fanout)).copy()
    return idx, mask


class NeighborSampler:
    """Minibatch iterator producing :class:`SampledBatch` per step.

    The sampler is a host-side data-pipeline stage (paper Fig. 3 step 2); the
    RAF executor consumes its output.  Sampling uses only the mono-relation
    CSRs of the relations in ``spec`` — with meta-partitioning each partition
    owns complete mono-relation subgraphs for its relations, so its branches
    sample entirely locally (paper §4 "outer-hop features are local").

    **Determinism model.**  Every batch's randomness is derived from
    ``(seed, epoch_seed, step)`` via :func:`numpy.random.SeedSequence` — the
    :class:`~repro.data.pipeline.SyntheticCorpus` trick — instead of one
    shared mutating generator.  :meth:`batch_at` is therefore a *pure
    function* of its position: any batch can be (re)materialized
    independently, out of order, from another thread, or after a restart,
    and the async sample stream produces bit-identical batches to the
    serial loop.  Ad-hoc :meth:`sample_batch` calls without an explicit
    ``rng`` draw from a per-instance call counter, so a fresh sampler
    replayed through the same call sequence still reproduces itself.
    """

    def __init__(
        self,
        graph: HetGraph,
        spec: SampleSpec,
        batch_size: int,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.graph = graph
        self.spec = spec
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.drop_last = drop_last
        self._draws = 0  # ad-hoc sample_batch() call counter
        self._epochs_started = 0  # seedless epoch() call counter
        self._order_cache: Dict[Tuple[bool, int], np.ndarray] = {}
        missing = [b.rel for b in spec.branches() if b.rel not in graph.relations]
        if missing:
            raise ValueError(f"graph lacks relations required by spec: {missing}")

    def _rng_for(self, *key: int) -> np.random.Generator:
        """Per-batch generator, a pure function of (seed, *key)."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed & 0xFFFFFFFF]
                                   + [int(k) & 0xFFFFFFFF for k in key])
        )

    def sample_batch(
        self, seeds: np.ndarray, rng: Optional[np.random.Generator] = None
    ) -> SampledBatch:
        seeds = np.asarray(seeds, dtype=np.int64)
        if rng is None:
            # deterministic per call index (not shared mutable state)
            rng = self._rng_for(0xAD0C, self._draws)
            self._draws += 1
        levels: List[Level] = []
        prev_nids: List[np.ndarray] = [seeds]  # per-branch node arrays, prev level
        prev_mask: List[np.ndarray] = [np.ones(len(seeds), dtype=bool)]
        for d, branches in enumerate(self.spec.levels, start=1):
            f = self.spec.fanouts[d - 1]
            nids = np.zeros((len(branches), len(prev_nids[0]) * f), dtype=np.int64)
            mask = np.zeros_like(nids, dtype=bool)
            for b, spec in enumerate(branches):
                csr = self.graph.relations[spec.rel]
                idx, m = sample_neighbors(
                    csr, prev_nids[spec.parent], prev_mask[spec.parent], f, rng
                )
                nids[b] = idx.reshape(-1)
                mask[b] = m.reshape(-1)
            levels.append(Level(nids=nids, mask=mask))
            prev_nids = [nids[b] for b in range(len(branches))]
            prev_mask = [mask[b] for b in range(len(branches))]
        labels = self.graph.labels[seeds]
        return SampledBatch(self.spec, seeds, labels, levels)

    def epoch_order(self, shuffle: bool = True, seed: Optional[int] = None) -> np.ndarray:
        """The (shuffled) train-node visit order of one epoch — pure in
        ``(shuffle, seed)``, memoized per sampler."""
        key = (bool(shuffle), int(seed or 0))
        order = self._order_cache.get(key)
        if order is None:
            order = self.graph.train_nodes.copy()
            if shuffle:
                np.random.default_rng(seed or 0).shuffle(order)
            if len(self._order_cache) >= 4:  # one live epoch + prefetch slack
                self._order_cache.pop(next(iter(self._order_cache)))
            self._order_cache[key] = order
        return order

    def batch_at(
        self, step: int, epoch_seed: Optional[int] = None, shuffle: bool = True
    ) -> SampledBatch:
        """Materialize epoch batch ``step`` as a pure function of
        ``(sampler seed, epoch_seed, step)`` — safe to call out of order,
        concurrently, or after a restart (the async-pipeline contract)."""
        if not 0 <= step < self.steps_per_epoch():
            raise IndexError(f"step {step} outside epoch of {self.steps_per_epoch()}")
        order = self.epoch_order(shuffle, epoch_seed)
        seeds = order[step * self.batch_size : (step + 1) * self.batch_size]
        return self.sample_batch(seeds, rng=self._rng_for(int(epoch_seed or 0), step))

    def epoch(self, shuffle: bool = True, seed: Optional[int] = None):
        """One epoch of batches (= ``batch_at(0..steps_per_epoch-1)``).

        ``seed`` is the epoch seed: with per-batch RNG, the *same* seed
        reproduces the *same* epoch bit-for-bit — pass a distinct seed per
        epoch (as the session and profilers do) for fresh neighbor draws.
        When ``seed`` is None, an internal per-sampler epoch counter is
        used, so repeated ``epoch()`` calls vary (matching the pre-per-batch
        expectation) while staying deterministic for a fresh sampler."""
        if seed is None:
            seed = 0x50C8 + self._epochs_started
            self._epochs_started += 1
        for i in range(self.steps_per_epoch()):
            yield self.batch_at(i, epoch_seed=seed, shuffle=shuffle)

    def steps_per_epoch(self) -> int:
        n = len(self.graph.train_nodes)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
