"""Relation aggregation of one relation, the dict-form executors' R-GCN
AGG_r (``csrc/relation_agg.cu``)."""

from repro_torch.kernels.relation_agg.ops import relation_agg  # noqa: F401
from repro_torch.kernels.relation_agg.ref import relation_agg_ref  # noqa: F401
