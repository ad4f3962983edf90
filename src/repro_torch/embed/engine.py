"""EmbedEngine — learnable feature tables behind the miss-penalty cache.

Featureless node types get trainable rows + Adam states (paper §2.3
Challenge 3 / §6), held on the host and fronted by the §6 device cache.  A
minibatch fetches the unique rows it touches (through the cache), the
training step returns row gradients, and the engine applies a sparse Adam
step and writes rows + states back to their single authoritative copy.
The rows are drawn with numpy exactly as the reference package draws them,
so a port session and a reference session with the same seed hold
bit-identical tables.

``adam`` has no default here: the reference engine's own default learning
rate (1e-2) differs from the session's ``run.lr``, and the session passes
its config (``Heta.adam_cfg``) so that learnable rows follow the
reference's trajectory.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from repro_torch.embed.cache import CacheAllocation, FeatureCache, allocate_cache
from repro_torch.embed.profiler import HotnessProfile, MissPenaltyProfile
from repro_torch.graph.hetgraph import HetGraph
from repro_torch.optim.adam import AdamConfig, sparse_adam_rows

__all__ = ["EmbedEngine"]


class EmbedEngine:
    def __init__(
        self,
        graph: HetGraph,
        learnable_dim: int,
        hotness: HotnessProfile,
        penalties: MissPenaltyProfile,
        cache_bytes: int,
        adam: AdamConfig,
        hotness_only: bool = False,
        num_shards: int = 1,
        seed: int = 0,
        kernels=None,
        device=None,
    ):
        self.graph = graph
        self.learnable_dim = learnable_dim
        self.adam = adam
        self.steps = {t: 0 for t in graph.num_nodes}
        # serializes table snapshots against sparse write-backs
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
        # online re-admission state: EMA over observed per-node access
        # counts, seeded from the pre-sampled profile
        self._hotness_ema: Dict[str, np.ndarray] = {
            t: hotness.counts[t].astype(np.float64)
            if t in hotness.counts
            else np.zeros(graph.num_nodes[t], np.float64)
            for t in graph.num_nodes
        }
        self.rebalances = 0

    # -- table access ----------------------------------------------------------

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

    def fetch(self, ntype: str, nids: np.ndarray) -> torch.Tensor:
        return self.cache.fetch(ntype, np.asarray(nids))

    # -- the sparse update path (paper Fig. 3 step 5, cache-accelerated) --------

    def apply_row_grads(self, ntype: str, nids: np.ndarray, grads) -> None:
        """Sparse Adam on the unique rows of one type touched by a batch.

        ``nids`` may contain duplicates (several branches sample the same
        node); their host ``grads`` are summed into unique rows first
        (``np.add.at``, as the reference does), matching dense autodiff."""
        if ntype not in self.learnable_types:
            raise ValueError(f"{ntype} has fixed features")
        nids = np.asarray(nids)
        uniq, inv = np.unique(nids, return_inverse=True)
        g = np.zeros((len(uniq), grads.shape[-1]), np.float32)
        np.add.at(g, inv, np.asarray(grads, np.float32).reshape(len(nids), -1))
        with self.lock:
            rows, m, v = self.cache.fetch_states(ntype, uniq)
            new_rows, new_m, new_v = sparse_adam_rows(
                self.adam, rows, torch.from_numpy(g).to(rows.device), m, v,
                self.steps[ntype])
            self.steps[ntype] += 1
            self.cache.write_learnable(ntype, uniq, new_rows, new_m, new_v)

    # -- checkpoint support -------------------------------------------------------

    def state_snapshot(self) -> Dict[str, object]:
        """The engine's restorable state: per learnable type the coherent
        full table + Adam moments (cached rows merged in), per-type Adam
        step counters, the online-readmission hotness EMA, and the cache
        residency profile.  Atomic w.r.t. concurrent ``apply_row_grads``."""
        with self.lock:
            tables, m, v = self.cache.merged_learnable_state()
            return {
                "tables": tables,
                "m": m,
                "v": v,
                "steps": {t: int(s) for t, s in self.steps.items()},
                "hotness_ema": {t: e.copy() for t, e in self._hotness_ema.items()},
                "residency": self.cache.residency(),
            }

    def load_state(self, state: Dict[str, object]) -> None:
        """Inverse of :meth:`state_snapshot`: write the full tables home,
        then re-gather cached rows from the host — bit-exact, because the
        merged snapshot *was* the authoritative value of every row."""
        with self.lock:
            for t in self.learnable_types:
                self.cache.host[t][:] = state["tables"][t]
                self.cache.host_m[t][:] = state["m"][t]
                self.cache.host_v[t][:] = state["v"][t]
            res = state.get("residency")
            if res is None:  # keep the current residency
                res = self.cache.residency()
            self.cache.set_residency(res)
            for t, s in state.get("steps", {}).items():
                if t in self.steps:
                    self.steps[t] = int(s)
            for t, e in state.get("hotness_ema", {}).items():
                if t in self._hotness_ema:
                    self._hotness_ema[t][:] = np.asarray(e)

    # -- online penalty-aware re-admission (paper §6, observed traffic) ---------

    def rebalance(self, decay: float = 0.5) -> Dict[str, object]:
        """Re-score cache residency from observed traffic (paper §6 online).

        Folds the drained access counters into a decayed running profile
        (``ema = decay·ema + window``), re-runs the hotness × miss-penalty
        allocation under the unchanged byte budget, and applies it
        incrementally via :meth:`FeatureCache.update_residency` (kept rows
        never leave the device, evicted learnable rows write row + Adam
        states home first).  Returns ``{"allocation": rows, "moves": ...}``.
        """
        with self.lock:
            window = self.cache.take_access_counts()
            for t, ema in self._hotness_ema.items():
                ema *= decay
                if t in window:
                    ema += window[t]
            profile = HotnessProfile(counts=self._hotness_ema)
            self.allocation = allocate_cache(
                profile, self.penalties, self.cache_bytes,
                self.graph.num_nodes, self.hotness_only,
            )
            moves = self.cache.update_residency(self.allocation, profile)
            self.rebalances += 1
        return {"allocation": dict(self.allocation.rows), "moves": moves}

    # -- reporting ---------------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        return {
            "hit_rates": self.cache.hit_rates(),
            "allocation": dict(self.allocation.rows),
            "miss_time_s": self.cache.miss_time(self.penalties),
            "rebalances": self.rebalances,
        }
