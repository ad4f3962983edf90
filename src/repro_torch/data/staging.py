"""Host-side batch staging shared by the port's device paths.

The SPMD executor's ``stage`` turns a sampled batch into stacked arrays —
masks, padded parent-feature gathers (``qfeat``) and leaf-feature gathers
(``hfeat``) laid out branch-major per shard.  All of that is numpy; only the
final copy to the device needs torch (``repro_torch.core.raf_spmd.
stack_batch``).  A :class:`StackRecipe` is the small picklable extract of
the plan that the gathers need, so the sampler worker pool of a later slice
can run :func:`stack_batch_host` in its workers unchanged.

A copy of the reference's ``repro/data/staging.py`` with one change:
``stack_batch_host`` has no ``out=``/``prefix=`` arguments, which only the
batch arena uses; they return with the arena in the worker-pool slice.
:func:`_padded_gather` also serves layer-wise inference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["StackRecipe", "stack_batch_host", "_padded_gather"]


@dataclasses.dataclass(frozen=True)
class StackRecipe:
    """Picklable description of the host staging of a stacked batch.

    Per level ``d`` (1-based, index ``d-1`` in the tuples below):
    ``slot_branch[d-1]`` maps ``[num_shards, rb]`` stack slots to original
    branch indices (-1 = padding slot); ``src_types``/``dst_types`` give the
    feature table feeding each branch; ``parents`` gives each branch's parent
    branch at level ``d-1``.  ``d_pad`` is the common padded feature width.
    """

    num_shards: int
    d_pad: int
    num_layers: int
    slot_branch: Tuple[np.ndarray, ...]
    src_types: Tuple[Tuple[str, ...], ...]
    dst_types: Tuple[Tuple[str, ...], ...]
    parents: Tuple[Tuple[int, ...], ...]

    @classmethod
    def from_plan(cls, plan) -> "StackRecipe":
        """Extract the staging recipe from a ``StackedPlan`` (duck-typed)."""
        spec = plan.spec
        return cls(
            num_shards=int(plan.num_shards),
            d_pad=int(plan.d_pad),
            num_layers=int(spec.num_layers),
            slot_branch=tuple(np.asarray(lp.slot_branch) for lp in plan.levels),
            src_types=tuple(tuple(row) for row in plan.src_types),
            dst_types=tuple(tuple(row) for row in plan.dst_types),
            parents=tuple(
                tuple(int(b.parent) for b in lv) for lv in spec.levels
            ),
        )

    def table_types(self) -> Tuple[str, ...]:
        """Node types whose feature tables staging reads."""
        out = set()
        for row in self.src_types:
            out.update(row)
        for row in self.dst_types:
            out.update(row)
        return tuple(sorted(out))


def _padded_gather(tab: np.ndarray, nids: np.ndarray, d_pad: int) -> np.ndarray:
    """Rows ``tab[nids]`` as float32, zero-padded on the right to ``d_pad``."""
    out = np.zeros((len(nids), d_pad), np.float32)
    out[:, : tab.shape[1]] = tab[nids]
    return out


def _gather_into(dst: np.ndarray, tab: np.ndarray, nids: np.ndarray) -> None:
    # in-place _padded_gather: dst is pre-zeroed, so only the real width
    # needs filling
    dst[:, : tab.shape[1]] = tab[nids]


def stack_batch_host(
    recipe: StackRecipe,
    batch,
    tables: Dict[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """Assemble the stacked host arrays for one
    :class:`~repro_torch.graph.sampler.SampledBatch`.

    ``tables`` must hold a feature table for every node type the recipe's
    branches touch (learnable tables included).  Returns the
    ``seeds``/``labels``/``mask{d}``/``qfeat{d}``/``hfeat{k}`` dict the SPMD
    executor copies to the device.
    """
    k, dp, P = recipe.num_layers, recipe.d_pad, recipe.num_shards
    B = batch.batch_size

    res: Dict[str, np.ndarray] = {
        "seeds": np.asarray(batch.seeds),
        "labels": np.asarray(batch.labels),
    }
    n_prev = B
    for d in range(1, k + 1):
        sb = recipe.slot_branch[d - 1]
        rb = sb.shape[1]
        lv = batch.levels[d - 1]
        n_d = lv.nids.shape[1]
        mask = np.zeros((P, rb, n_d), bool)
        qfeat = np.zeros((P, rb, n_prev, dp), np.float32)
        hfeat = np.zeros((P, rb, n_d, dp), np.float32) if d == k else None
        for p in range(P):
            for s in range(rb):
                b = int(sb[p, s])
                if b < 0:
                    continue
                mask[p, s] = lv.mask[b]
                parent_nids = (
                    batch.seeds if d == 1
                    else batch.levels[d - 2].nids[recipe.parents[d - 1][b]]
                )
                _gather_into(qfeat[p, s],
                             tables[recipe.dst_types[d - 1][b]], parent_nids)
                if d == k:
                    _gather_into(hfeat[p, s],
                                 tables[recipe.src_types[d - 1][b]], lv.nids[b])
        res[f"mask{d}"] = mask.reshape(P * rb, n_d)
        res[f"qfeat{d}"] = qfeat.reshape(P * rb, n_prev, dp)
        if d == k:
            res[f"hfeat{d}"] = hfeat.reshape(P * rb, n_d, dp)
        n_prev = n_d
    return res
