"""Token data pipeline for the LM training path.

Offline container ⇒ the corpus is synthetic, but the pipeline is real:
deterministic sharded sequence generation (each host materializes only its
slice), host-side double-buffered prefetch, and device placement with the
production batch shardings.  The structure mirrors what a deployment would
swap a real tokenized dataset into (same iterator contract).

The port's copy of ``repro/data/pipeline.py``, with the imports rewritten:
numpy only, over the port's ``data/prefetch.py``.  ``place_fn`` is where a
caller puts a batch on its device (``repro_torch.launch.train_lm`` copies
it there from pinned memory).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.prefetch import Prefetcher

__all__ = ["SyntheticCorpus", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    """Deterministic pseudo-corpus: shard s / sequence i is a pure function
    of (seed, s, i), so any host can materialize any slice independently —
    the property real sharded datasets provide via index files."""

    vocab: int
    seq_len: int
    num_shards: int = 16
    seed: int = 0
    # Zipf token distribution: realistic hot-token skew for embedding traffic
    zipf_a: float = 1.3

    def sequence(self, shard: int, index: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, shard, index])
        )
        ranks = rng.zipf(self.zipf_a, size=self.seq_len + 1)
        return np.minimum(ranks - 1, self.vocab - 1).astype(np.int32)

    def batch(self, shard: int, start: int, n: int) -> Dict[str, np.ndarray]:
        seqs = np.stack([self.sequence(shard, start + i) for i in range(n)])
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


class TokenPipeline:
    """Host-side prefetching batch iterator.

    ``global_batch`` sequences per step are drawn round-robin from the
    corpus shards owned by this host (all of them in single-host runs); a
    background :class:`~repro_torch.data.prefetch.Prefetcher` keeps ``prefetch``
    batches ready so the accelerator never waits on generation (paper
    Fig. 3's sampler stage, LM flavor).  ``close()`` joins the producer
    thread; iterating after ``close()`` raises instead of hanging.
    """

    def __init__(
        self,
        corpus: SyntheticCorpus,
        global_batch: int,
        prefetch: int = 2,
        host_id: int = 0,
        num_hosts: int = 1,
        place_fn=None,  # optional: np batch -> device arrays (sharded put)
    ):
        self.corpus = corpus
        self.global_batch = global_batch
        self.host_batch = global_batch // num_hosts
        if global_batch % num_hosts:
            raise ValueError("global_batch must divide num_hosts")
        self.host_shards = [
            s for s in range(corpus.num_shards) if s % num_hosts == host_id
        ]
        self.place_fn = place_fn
        self._step = 0
        self._prefetcher = Prefetcher(self._make, depth=prefetch,
                                      name="token-pipeline")

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        per_shard = -(-self.host_batch // len(self.host_shards))
        parts = []
        for j, s in enumerate(self.host_shards):
            n = min(per_shard, self.host_batch - j * per_shard)
            if n <= 0:
                break
            parts.append(self.corpus.batch(s, step * per_shard, n))
        return {
            k: np.concatenate([p[k] for p in parts]) for k in parts[0]
        }

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        batch = next(self._prefetcher)
        self._step += 1
        if self.place_fn is not None:
            return self.place_fn(batch)
        return batch

    def close(self):
        """Stop and join the producer thread (idempotent); ``__next__``
        afterwards raises :class:`RuntimeError` instead of hanging."""
        self._prefetcher.close()
