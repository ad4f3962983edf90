"""Stacked relation-aggregation family: one call per metatree level runs
AGG_r for every branch slot, weights read straight from the ``[U, ...]``
parameter stacks (``csrc/stacked_mean_linear.cu`` for R-GCN)."""

from repro_torch.kernels.stacked_relation_agg.ops import (  # noqa: F401
    stacked_agg,
    stacked_agg_ref,
    stacked_mean_linear,
    stacked_mean_linear_ref,
    stage_slot_u,
)
