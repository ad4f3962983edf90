"""The benchmark's inputs, drawn from ``--seed``: rows of a pseudo-corpus
that are a pure function of (seed, shard, index).  A text configuration
gets token ids with a Zipf skew, as a tokenized corpus has; an audio
configuration gets frames N(0, 1) of the frontend's width and a target id a
frame.  The object serves the program's ``TokenPipeline`` as its corpus
(``num_shards``, ``batch``) and the reference reads the same rows."""

from __future__ import annotations

from typing import Dict

import numpy as np


class Corpus:
    def __init__(self, cfg: dict, traffic: dict, seed: int):
        self.vocab = int(cfg["vocab_size"])
        self.seq_len = int(traffic["seq_len"])
        self.num_shards = int(traffic["num_shards"])
        self.zipf_a = float(traffic["zipf_a"])
        self.frame_dim = int(cfg["conv_dim_last"]) if cfg["run_as"]["frontend"] == "audio" else 0
        self.seed = int(seed)

    def _ids(self, rng, n: int) -> np.ndarray:
        return np.minimum(rng.zipf(self.zipf_a, size=n) - 1, self.vocab - 1).astype(np.int32)

    def row(self, shard: int, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, shard, index]))
        if self.frame_dim:
            frames = rng.standard_normal((self.seq_len, self.frame_dim), dtype=np.float32)
            return {"frames": frames, "labels": self._ids(rng, self.seq_len)}
        seq = self._ids(rng, self.seq_len + 1)
        return {"tokens": seq[:-1], "labels": seq[1:]}

    def batch(self, shard: int, start: int, n: int) -> Dict[str, np.ndarray]:
        rows = [self.row(shard, start + i) for i in range(n)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
