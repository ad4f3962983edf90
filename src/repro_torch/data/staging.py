"""Host-side batch staging shared by the port's device paths.

The SPMD executor's ``stage`` turns a sampled batch into stacked arrays —
masks, padded parent-feature gathers (``qfeat``) and leaf-feature gathers
(``hfeat``) laid out branch-major per shard.  All of that is numpy; only the
final copy to the device needs torch (``repro_torch.core.raf_spmd.
stack_batch``).  This module holds the numpy core so that:

  * the SPMD executor's ``stage`` and the sampler worker pool
    (``repro_torch.data.worker_pool``, DESIGN.md §9) run the **same** code —
    a worker-staged batch is bit-identical to a consumer-staged one by
    construction;
  * sampler worker processes stay torch-free: a :class:`StackRecipe` is a
    small picklable extract of the :class:`~repro_torch.core.raf_spmd.
    StackedPlan` (slot→branch maps and type names, no tensors), so shipping
    it to a spawned worker costs a few kilobytes and no torch import.

A copy of the reference's ``repro/data/staging.py``; the port adds
:func:`_padded_gather` to ``__all__``, since layer-wise inference
(``repro_torch.serve.full_graph``) gathers with it too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "_padded_gather",
    "StackRecipe",
    "stack_batch_host",
    "BATCH_PREFIX",
    "HOST_PREFIX",
    "pack_batch_arrays",
    "pack_batch_into",
    "arena_fields",
    "unpack_slot",
]

# key prefixes inside a batch-arena slot (DESIGN.md §11): raw sampled batch
# arrays vs pre-staged host arrays (the stack_batch_host outputs)
BATCH_PREFIX = "b/"
HOST_PREFIX = "h/"


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
    out: "Dict[str, np.ndarray] | None" = None,
    prefix: str = "",
) -> Dict[str, np.ndarray]:
    """The numpy core of ``raf_spmd.stack_batch``: assemble the stacked host
    arrays for one :class:`~repro_torch.graph.sampler.SampledBatch`.

    ``tables`` must hold a feature table for every node type the recipe's
    branches touch (frozen learnable tables included).  Returns the
    ``seeds``/``labels``/``mask{d}``/``qfeat{d}``/``hfeat{k}`` dict the SPMD
    executor device-puts; values are plain numpy so a worker process can
    compute them and ship them over a queue.

    With ``out`` (the write-into-slot variant, DESIGN.md §11), every array is
    assembled **in place** inside ``out[prefix + name]`` — the batch-arena
    slot views — instead of freshly allocated; the returned dict then holds
    those views.  Both paths run the same fill loop over pre-zeroed
    destinations, so a worker-staged slot is bit-identical to a
    consumer-staged allocation.
    """
    k, dp, P = recipe.num_layers, recipe.d_pad, recipe.num_shards
    B = batch.batch_size

    res: Dict[str, np.ndarray] = {}

    def _dest(name: str, shape: Tuple[int, ...], dtype) -> np.ndarray:
        if out is None:
            arr = np.zeros(shape, dtype)
        else:
            arr = out[prefix + name].reshape(shape)
            arr[...] = 0
        return arr

    for name, src in (("seeds", np.asarray(batch.seeds)),
                      ("labels", np.asarray(batch.labels))):
        if out is None:
            res[name] = src
        else:
            np.copyto(out[prefix + name], src, casting="no")
            res[name] = out[prefix + name]

    n_prev = B
    for d in range(1, k + 1):
        sb = recipe.slot_branch[d - 1]
        rb = sb.shape[1]
        lv = batch.levels[d - 1]
        n_d = lv.nids.shape[1]
        mask = _dest(f"mask{d}", (P, rb, n_d), bool)
        qfeat = _dest(f"qfeat{d}", (P, rb, n_prev, dp), np.float32)
        hfeat = _dest(f"hfeat{d}", (P, rb, n_d, dp), np.float32) if d == k else None
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


# --------------------------------------------------------------------------
# batch-arena slot packing (DESIGN.md §11)
# --------------------------------------------------------------------------
#
# A slot holds the raw sampled batch under ``b/`` keys and, when the pool
# stages, the stack_batch_host outputs under ``h/`` keys.  Slot layouts are
# static — the sampler pads every level to fixed [R_d, N_d] and the recipe
# pads features to d_pad — so one probe batch sizes the whole arena.


def pack_batch_arrays(batch) -> Dict[str, np.ndarray]:
    """A sampled batch as a flat ``b/``-prefixed array dict (no copies)."""
    arrays = {
        BATCH_PREFIX + "seeds": np.asarray(batch.seeds),
        BATCH_PREFIX + "labels": np.asarray(batch.labels),
    }
    for d, lv in enumerate(batch.levels, start=1):
        arrays[f"{BATCH_PREFIX}nids{d}"] = np.asarray(lv.nids)
        arrays[f"{BATCH_PREFIX}mask{d}"] = np.asarray(lv.mask)
    return arrays


def pack_batch_into(views: Dict[str, np.ndarray], batch) -> None:
    """Write a sampled batch into a slot's ``b/`` views (worker side)."""
    for key, src in pack_batch_arrays(batch).items():
        np.copyto(views[key], src, casting="no")


def arena_fields(batch, recipe=None, tables=None) -> Dict[str, np.ndarray]:
    """Probe arrays sizing one arena slot: the batch layout plus, when the
    pool stages, the stacked host arrays (``shm.create_arena`` reads only
    shapes/dtypes)."""
    fields = pack_batch_arrays(batch)
    if recipe is not None:
        host = stack_batch_host(recipe, batch, tables)
        fields.update({HOST_PREFIX + k: v for k, v in host.items()})
    return fields


def unpack_slot(views: Dict[str, np.ndarray], spec):
    """Consumer side: rebuild ``(batch, host)`` from a slot's views.

    The returned batch's arrays alias the slot — the caller must not release
    the slot until every view (and anything zero-copy derived from it) is
    dead; ``SampleStream`` defers the release past the consuming step."""
    from repro_torch.graph.sampler import Level, SampledBatch

    levels = [
        Level(nids=views[f"{BATCH_PREFIX}nids{d}"],
              mask=views[f"{BATCH_PREFIX}mask{d}"])
        for d in range(1, spec.num_layers + 1)
    ]
    batch = SampledBatch(
        spec=spec,
        seeds=views[BATCH_PREFIX + "seeds"],
        labels=views[BATCH_PREFIX + "labels"],
        levels=levels,
    )
    host = {k[len(HOST_PREFIX):]: v for k, v in views.items()
            if k.startswith(HOST_PREFIX)}
    return batch, (host or None)
