"""Stacked relation-aggregation family: one call per metatree level runs
AGG_r for every branch slot, weights read straight from the ``[U, ...]``
parameter stacks (``csrc/stacked_mean_linear.cu`` for R-GCN, and its
backward ``csrc/stacked_mean_linear_dh.cu``)."""

from repro_torch.kernels.stacked_relation_agg.ops import (  # noqa: F401
    stacked_agg,
    stacked_agg_ref,
    stacked_mean_linear,
    stacked_mean_linear_dh,
    stacked_mean_linear_dh_ref,
    stacked_mean_linear_ref,
    segment_sum,
    stage_slot_u,
)
