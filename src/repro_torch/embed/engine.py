"""EmbedEngine — learnable feature tables behind the miss-penalty cache.

Featureless node types get trainable rows (paper §2.3 Challenge 3 / §6),
held on the host and fronted by the §6 device cache.  The rows are drawn
with numpy exactly as the reference package draws them, so a port session
and a reference session with the same seed hold bit-identical tables.

This slice serves inference: the engine builds the tables and the cache
and hands out coherent snapshots.  The sparse Adam row update
(``apply_row_grads``) and online ``rebalance`` join with the training slice.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from repro_torch.embed.cache import CacheAllocation, FeatureCache, allocate_cache
from repro_torch.embed.profiler import HotnessProfile, MissPenaltyProfile
from repro_torch.graph.hetgraph import HetGraph

__all__ = ["EmbedEngine"]


class EmbedEngine:
    def __init__(
        self,
        graph: HetGraph,
        learnable_dim: int,
        hotness: HotnessProfile,
        penalties: MissPenaltyProfile,
        cache_bytes: int,
        hotness_only: bool = False,
        num_shards: int = 1,
        seed: int = 0,
        kernels=None,
        device=None,
    ):
        self.graph = graph
        self.learnable_dim = learnable_dim
        # serializes table snapshots against (future) sparse write-backs
        self.lock = threading.RLock()
        rng = np.random.default_rng(seed)

        self.learnable_types = {
            t: learnable_dim for t in graph.num_nodes if t not in graph.features
        }
        host: Dict[str, np.ndarray] = {
            t: f.astype(np.float32, copy=False) for t, f in graph.features.items()
        }
        for t in self.learnable_types:
            host[t] = (
                rng.standard_normal((graph.num_nodes[t], learnable_dim)) * 0.1
            ).astype(np.float32)

        self.allocation: CacheAllocation = allocate_cache(
            hotness, penalties, cache_bytes, graph.num_nodes, hotness_only
        )
        self.cache = FeatureCache(
            host, self.learnable_types, self.allocation, hotness, num_shards,
            kernels=kernels, device=device,
        )
        self.penalties = penalties
        self.cache_bytes = cache_bytes
        self.hotness_only = hotness_only

    def table(self, ntype: str) -> np.ndarray:
        """Host view of a feature table.  For learnable types, cached rows
        are authoritative on the device; this materializes a coherent
        snapshot."""
        with self.lock:
            tab = self.cache.host[ntype].copy()
            c = self.cache.caches.get(ntype)
            if c is not None:
                tab[c.ids] = c.data.cpu().numpy()
            return tab

    def tables_snapshot(self) -> Dict[str, np.ndarray]:
        """Coherent snapshot of every table (atomic w.r.t. the engine lock)."""
        with self.lock:
            return {t: self.table(t) for t in self.graph.num_nodes}
