"""Online inference tier: materialize once, serve forever (DESIGN.md §10).

  * :mod:`repro_torch.serve.full_graph` — layer-wise full-graph inference:
    level-l representations for *every* node of every type, in node
    blocks, through the same stacked-relation dispatch the trainer runs,
    materialized into a per-type :class:`EmbeddingStore`.
  * :mod:`repro_torch.serve.server` — the serving executor: a
    :class:`MicroBatcher` coalesces concurrent lookups under a latency
    budget and the :class:`EmbeddingServer` answers each flush with one
    ``FeatureCache`` gather per node type plus a head application on the
    device.

Session surface: ``Heta.infer_all()`` builds the store, ``Heta.serve()``
starts a server over it.
"""

from repro_torch.serve.full_graph import (
    EmbeddingStore,
    bounded_graph,
    exhaustive_batch,
    exhaustive_fanouts,
    infer_all,
    spmd_logits_for_batch,
)
from repro_torch.serve.server import (
    EmbeddingServer,
    MicroBatcher,
    ServeResult,
    ServeStats,
)

__all__ = [
    "EmbeddingStore",
    "EmbeddingServer",
    "MicroBatcher",
    "ServeResult",
    "ServeStats",
    "bounded_graph",
    "exhaustive_batch",
    "exhaustive_fanouts",
    "infer_all",
    "spmd_logits_for_batch",
]
