"""Stacked relation-aggregation family: one call per metatree level runs
AGG_r for every branch slot, weights read straight from the ``[U, ...]``
parameter stacks (``csrc/stacked_mean_linear.cu`` for R-GCN and its
backward ``csrc/stacked_mean_linear_dh.cu``; ``csrc/stacked_attn_epilogue.cu``
for R-GAT and HGT and its backward ``csrc/stacked_attn_dh.cu``; with the
epilogue unfused, ``csrc/stacked_softmax_combine.cu``); kernels 1, 3 and 4
launch in the layout ``repro_torch.kernels.ops.resolve_blocks`` gives."""

from repro_torch.kernels.stacked_relation_agg.ops import (  # noqa: F401
    FanoutTooWideError,
    attn_epilogue_forward,
    attn_slots,
    segment_sum,
    stacked_agg,
    stacked_agg_ref,
    stacked_attn_dh,
    stacked_attn_dh_ref,
    stacked_attn_epilogue,
    stacked_attn_epilogue_ref,
    stacked_mean_linear,
    stacked_mean_linear_dh,
    stacked_mean_linear_dh_ref,
    stacked_mean_linear_ref,
    stacked_softmax_combine,
    stacked_softmax_combine_ref,
    stage_slot_u,
    take_slots,
)
