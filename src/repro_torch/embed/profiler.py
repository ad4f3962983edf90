"""Pre-training profilers: node hotness and per-type miss-penalty ratios.

Paper §6: cache size is allocated per node type in proportion to
``count_a × o_a`` where ``count_a`` is the type's total visit count from a
pre-sampling pass (two epochs, as in GNNLab [50]) and ``o_a`` is the
*miss-penalty ratio* — the time penalty per byte of cache incurred when a
node of type ``a`` misses.

Miss penalties differ across node types because

  * small feature dims pay a larger fixed per-transfer overhead per byte
    (PCIe/DMA transaction setup, paper Fig. 7a);
  * learnable features must also move their optimizer states and be written
    *back*, roughly (1 read + 1 write) × (1 + 2×Adam states) (paper Fig. 7b).

``measure_miss_penalty`` times real host→device copies with PyTorch on the
session's device; the analytic PCIe model (the default, see
``CacheConfig.measured_penalties``) keeps the paper's qualitative shape.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.graph.hetgraph import HetGraph
from repro_torch.graph.sampler import NeighborSampler, SampleSpec

__all__ = [
    "HotnessProfile",
    "presample_hotness",
    "measure_miss_penalty",
    "analytic_miss_penalty",
    "MissPenaltyProfile",
    "profile_miss_penalties",
]


# --------------------------------------------------------------------------
# hotness (pre-sampling)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class HotnessProfile:
    counts: Dict[str, np.ndarray]  # ntype -> visit count per node id

    def total(self, ntype: str) -> int:
        return int(self.counts[ntype].sum())

    def hottest(self, ntype: str, n: int) -> np.ndarray:
        """Node ids sorted by descending visit count, truncated to n."""
        c = self.counts[ntype]
        order = np.argsort(-c, kind="stable")
        return order[: min(n, len(order))]

    def skew(self, ntype: str, top_frac: float = 0.1) -> float:
        """Fraction of visits captured by the hottest ``top_frac`` of nodes."""
        c = np.sort(self.counts[ntype])[::-1]
        k = max(1, int(len(c) * top_frac))
        tot = c.sum()
        return float(c[:k].sum() / tot) if tot else 0.0


def presample_hotness(
    graph: HetGraph,
    spec: SampleSpec,
    batch_size: int,
    epochs: int = 2,
    max_batches: Optional[int] = None,
    seed: int = 7,
) -> HotnessProfile:
    """Sample ``epochs`` epochs before training and count node visits
    (paper §6, following GNNLab's pre-sampling)."""
    counts = {t: np.zeros(n, dtype=np.int64) for t, n in graph.num_nodes.items()}
    sampler = NeighborSampler(graph, spec, batch_size, seed=seed)
    done = 0
    for ep in range(epochs):
        for batch in sampler.epoch(shuffle=True, seed=seed + ep):
            batch.count_visits(counts)
            done += 1
            if max_batches and done >= max_batches:
                return HotnessProfile(counts)
    return HotnessProfile(counts)


# --------------------------------------------------------------------------
# miss-penalty ratios
# --------------------------------------------------------------------------


ADAM_STATE_MULT = 2  # moment + variance rows, same shape as the feature row


def row_bytes(dim: int, learnable: bool, bytes_per_elem: int = 4) -> int:
    """Cache footprint of one row: learnable rows carry their Adam states
    (paper §6 'extend caching to optimizer states')."""
    mult = 1 + (ADAM_STATE_MULT if learnable else 0)
    return dim * bytes_per_elem * mult


def measure_miss_penalty(
    dim: int,
    learnable: bool,
    n_rows: int = 4096,
    repeats: int = 5,
    bytes_per_elem: int = 4,
    device=None,
) -> float:
    """Measured miss-penalty ratio o_a in seconds/byte on ``device``
    (``None``: the GPU).

    Read-only rows: host→device transfer time per cached byte.  Learnable
    rows: read + write of features *and* optimizer states.
    """
    import torch  # lazy: hotness profiling must stay importable torch-free

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    host = torch.from_numpy(
        np.random.default_rng(0).standard_normal((n_rows, dim)).astype(np.float32))
    mult = 1 + (ADAM_STATE_MULT if learnable else 0)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(mult):
            d = host.to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if learnable:
                _ = d.cpu()  # write-back path
        best = min(best, time.perf_counter() - t0)
    cache_bytes = n_rows * row_bytes(dim, learnable, bytes_per_elem)
    return best / cache_bytes


def analytic_miss_penalty(
    dim: int,
    learnable: bool,
    bytes_per_elem: int = 4,
    link_gbps: float = 16.0,  # PCIe 3.0 x16 effective, paper's T4 testbed
    fixed_us: float = 10.0,  # per-transfer setup cost (paper Fig. 7a)
) -> float:
    """Analytic o_a with the paper's qualitative shape: fixed per-transfer
    overhead dominates small rows; learnable rows pay read+write × states."""
    data = dim * bytes_per_elem
    t_read = fixed_us * 1e-6 + data / (link_gbps * 1e9)
    mult = 1 + (ADAM_STATE_MULT if learnable else 0)
    t = t_read * mult * (2.0 if learnable else 1.0)  # writes mirror reads
    return t / row_bytes(dim, learnable, bytes_per_elem)


@dataclasses.dataclass
class MissPenaltyProfile:
    ratios: Dict[str, float]  # ntype -> o_a (s/byte)
    learnable: Dict[str, bool]
    dims: Dict[str, int]

    def render(self) -> str:
        lines = ["  type                 dim  learnable  o_a (us/KB)"]
        for t in sorted(self.ratios):
            lines.append(
                f"  {t:<18} {self.dims[t]:>5}  {str(self.learnable[t]):<9}"
                f"  {self.ratios[t] * 1e6 * 1024:10.3f}"
            )
        return "\n".join(lines)


def profile_miss_penalties(
    graph: HetGraph,
    learnable_dim: int = 64,
    measured: bool = True,
    device=None,
    **analytic_kwargs,
) -> MissPenaltyProfile:
    """o_a per node type (paper Fig. 7).  ``measured=False`` uses the PCIe
    model (used when projecting to the paper's GPU testbed); ``measured=True``
    times copies to ``device``."""
    ratios, learn, dims = {}, {}, {}
    for t in graph.node_types:
        is_learn = t not in graph.features
        dim = learnable_dim if is_learn else graph.feat_dim(t)
        if measured:
            ratios[t] = measure_miss_penalty(dim, is_learn, device=device)
        else:
            ratios[t] = analytic_miss_penalty(dim, is_learn, **analytic_kwargs)
        learn[t], dims[t] = is_learn, dim
    return MissPenaltyProfile(ratios=ratios, learnable=learn, dims=dims)
