"""SPMD RAF plan — relation branches stacked per model shard.

The production executor of paper Alg. 1 groups the metatree's branches by
owning meta-partition and lays the branch axis along the model shards: each
shard holds its partition's relation parameters, sampled blocks and
feature slices, and the only cross-shard exchange is the root partial sum.

The stacking layer is **scope-driven** (relation-module IR, DESIGN.md §3):
for every parameter scope the model declares, the plan carries per-shard
unique storage-key lists, per-slot index arrays, and shared-slot groups.
:func:`stack_params_from_dict` packs each scope's parameters into
``[P, U, ...]`` slabs.  The plan is numpy; only the stacks are tensors.

In this slice every shard lives on one device and the plan feeds
layer-wise inference (``repro_torch.serve.full_graph``); the stacked
training forward, ``sync_stack_grads`` and the train step join with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.hgnn import HGNNConfig, Params, rel_context
from repro_torch.core.raf import BranchAssignment
from repro_torch.core.relmod import SCOPE_CONTAINER, storage_key
from repro_torch.device import resolve_device
from repro_torch.graph.sampler import SampleSpec

__all__ = [
    "LevelPlan",
    "StackedPlan",
    "build_plan",
    "stack_params_from_dict",
]


# --------------------------------------------------------------------------
# static plan
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LevelPlan:
    depth: int
    layer: int
    fanout: int
    d_in: int  # aggregation input dim (d_pad at the leaf layer, hidden above)
    slot_branch: np.ndarray  # [P, rb] original branch index, -1 for dummies
    parent_local: np.ndarray  # [P, rb] parent slot within the shard, level d-1
    parent_global: np.ndarray  # [P, rb] parent global slot (naive mode)
    # per scope the model declares: [P, rb] index into that scope's layer stack
    slot_u: Dict[str, np.ndarray]
    valid: np.ndarray  # [P, rb] bool

    @property
    def rb(self) -> int:
        return self.slot_branch.shape[1]


@dataclasses.dataclass
class StackedPlan:
    spec: SampleSpec
    cfg: HGNNConfig
    num_shards: int
    d_pad: int
    levels: List[LevelPlan]
    # (scope, layer) -> per-shard list of storage keys occupying stack slots
    scope_keys: Dict[Tuple[str, int], List[List[str]]]
    # (scope, layer) -> [P, U] global group id per slot (shared-param sync);
    # slots holding the same storage key share an id, unused slots get
    # singleton ids, so segment-summing gradients over groups is exact
    slot_groups: Dict[Tuple[str, int], np.ndarray]
    src_types: List[List[str]]  # per level: src type per original branch
    dst_types: List[List[str]]  # per level: dst type per original branch

    @property
    def module(self):
        return self.cfg.module

    @property
    def layers(self) -> List[int]:
        return sorted({layer for (_, layer) in self.scope_keys})

    def u_of(self, scope: str, layer: int) -> int:
        return max(1, max(len(row) for row in self.scope_keys[(scope, layer)]))

    def has_shared(self, scope: str, layer: int) -> bool:
        """Whether any storage key occupies more than one stack slot (then
        gradients need cross-slot summing to match the dict-mode trajectory)."""
        rows = self.scope_keys[(scope, layer)]
        keys = [nm for row in rows for nm in row]
        return len(keys) != len(set(keys))

    def layer_shape_ctx(self, layer: int):
        d_in = self.d_pad if layer == 1 else self.cfg.hidden
        return self.cfg.shape_ctx(d_src=d_in, d_dst=self.d_pad)


def build_plan(
    spec: SampleSpec,
    assignment: BranchAssignment,
    cfg: HGNNConfig,
    feat_dims: Dict[str, int],
) -> StackedPlan:
    module = cfg.module
    Pn = assignment.num_partitions
    k = spec.num_layers
    dims = lambda t: feat_dims.get(t, cfg.learnable_dim)
    all_types = set([spec.target_type])
    for lv in spec.levels:
        for b in lv:
            all_types.add(b.rel.src)
    d_pad = max(dims(t) for t in all_types)

    # paper-faithful bookkeeping of src/dst types per branch (feature gathers)
    src_types, dst_types = [], []
    parents = [spec.target_type]
    for lv in spec.levels:
        src_types.append([b.rel.src for b in lv])
        dst_types.append([parents[b.parent] for b in lv])
        parents = [b.rel.src for b in lv]

    # group branches by owner, pad to uniform per-shard counts
    slot_of: List[Dict[int, Tuple[int, int]]] = []  # per level: branch -> (p, slot)
    level_plans: List[LevelPlan] = []
    scope_keys: Dict[Tuple[str, int], List[List[str]]] = {}
    for d in range(1, k + 1):
        layer = k - d + 1
        owners = assignment.owner[d - 1]
        by_p: List[List[int]] = [[] for _ in range(Pn)]
        for b, o in enumerate(owners):
            by_p[int(o)].append(b)
        rb = max(1, max(len(x) for x in by_p))
        slot_branch = np.full((Pn, rb), -1, dtype=np.int64)
        valid = np.zeros((Pn, rb), dtype=bool)
        smap: Dict[int, Tuple[int, int]] = {}
        for p in range(Pn):
            for s, b in enumerate(by_p[p]):
                slot_branch[p, s] = b
                valid[p, s] = True
                smap[b] = (p, s)
        slot_of.append(smap)

        # per-scope, per-shard unique storage-key lists + per-slot indices
        slot_u: Dict[str, np.ndarray] = {}
        for scope in module.scopes:
            names = scope_keys.setdefault((scope, layer), [[] for _ in range(Pn)])
            u_arr = np.zeros((Pn, rb), dtype=np.int64)
            for p in range(Pn):
                for s, b in enumerate(by_p[p]):
                    bs = spec.levels[d - 1][b]
                    ctx = rel_context(bs.rel, dst_types[d - 1][b], layer)
                    nm = storage_key(scope, ctx)
                    if nm not in names[p]:
                        names[p].append(nm)
                    u_arr[p, s] = names[p].index(nm)
            slot_u[scope] = u_arr

        # parent mapping
        parent_local = np.zeros((Pn, rb), dtype=np.int64)
        parent_global = np.zeros((Pn, rb), dtype=np.int64)
        if d > 1:
            prev = level_plans[-1]
            for p in range(Pn):
                for s in range(rb):
                    b = slot_branch[p, s]
                    if b < 0:
                        continue
                    pb = spec.levels[d - 1][b].parent
                    pp, ps = slot_of[d - 2][pb]
                    parent_global[p, s] = pp * prev.rb + ps
                    parent_local[p, s] = ps
                    if pp != p and assignment.meta_local:
                        raise AssertionError("meta-local assignment violated")
        level_plans.append(
            LevelPlan(
                depth=d,
                layer=layer,
                fanout=spec.fanouts[d - 1],
                d_in=d_pad if d == k else cfg.hidden,
                slot_branch=slot_branch,
                parent_local=parent_local,
                parent_global=parent_global,
                slot_u=slot_u,
                valid=valid,
            )
        )

    # shared-slot groups: same storage key (any shard, any slot) -> same id;
    # unused padding slots get fresh singleton ids
    slot_groups: Dict[Tuple[str, int], np.ndarray] = {}
    for (scope, layer), names in scope_keys.items():
        U = max(1, max(len(row) for row in names))
        uniq = sorted({nm for row in names for nm in row})
        gid = {nm: i for i, nm in enumerate(uniq)}
        groups = np.zeros((Pn, U), dtype=np.int64)
        nxt = len(uniq)
        for p in range(Pn):
            for u in range(U):
                if u < len(names[p]):
                    groups[p, u] = gid[names[p][u]]
                else:
                    groups[p, u] = nxt
                    nxt += 1
        slot_groups[(scope, layer)] = groups

    return StackedPlan(
        spec=spec,
        cfg=cfg,
        num_shards=Pn,
        d_pad=d_pad,
        levels=level_plans,
        scope_keys=scope_keys,
        slot_groups=slot_groups,
        src_types=src_types,
        dst_types=dst_types,
    )


# --------------------------------------------------------------------------
# parameter stacking
# --------------------------------------------------------------------------


def stack_params_from_dict(plan: StackedPlan, params: Params,
                           device=None) -> Dict:
    """Pack dict-form parameters (``init_hgnn_params``) into per-layer stacks
    ``{f"layer{l}": {leaf: [P, U_scope, ...]}, "head": {...}}`` on
    ``device`` (``None``: the GPU), with input dims padded to the plan's common widths
    (``d_pad`` for feature-facing axes).  Padding regions are zero, so
    padded feature slots contribute nothing."""
    device = resolve_device(device)
    module = plan.module
    stacks: Dict = {}
    for layer in plan.layers:
        sc = plan.layer_shape_ctx(layer)
        entry = {}
        for spec_ in module.specs:
            names = plan.scope_keys[(spec_.scope, layer)]
            U = plan.u_of(spec_.scope, layer)
            padded = tuple(spec_.shape(sc))
            arr = np.zeros((plan.num_shards, U) + padded, np.float32)
            container = params[SCOPE_CONTAINER[spec_.scope]]
            for p, row in enumerate(names):
                for u, nm in enumerate(row):
                    w = np.asarray(container[nm][spec_.name])
                    arr[(p, u) + tuple(slice(0, s) for s in w.shape)] = w
            entry[spec_.name] = torch.from_numpy(arr).to(device)
        stacks[f"layer{layer}"] = entry
    stacks["head"] = {
        leaf: torch.tensor(np.asarray(v, np.float32), device=device)
        for leaf, v in params["head"].items()
    }
    return stacks
