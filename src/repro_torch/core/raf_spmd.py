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

Every shard lives on one device.  :func:`raf_spmd_forward` runs the
shards one after another, and the reference's cross-shard ``psum`` of the
root partials is a sum over the shard axis; the ``local_combine=False``
ablation (naive placement) segment-sums every shard's outputs over global
parent slots, and each shard then takes its own slice.  Segment sums go
through the deterministic one-hot :func:`~repro_torch.kernels.
stacked_relation_agg.segment_sum`, so a run repeats bit for bit.
Parameters are plain trees of tensors (the stack dicts); gradients come
from ``torch.autograd.grad`` (:func:`grad_step`), pass through
:func:`sync_stack_grads`, then Adam (:func:`apply_step`; both halves make
:func:`train_step`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.hgnn import HGNNConfig, Params, nll_loss, rel_context
from repro_torch.core.raf import BranchAssignment
from repro_torch.core.relmod import SCOPE_CONTAINER, storage_key
from repro_torch.data.staging import StackRecipe, stack_batch_host
from repro_torch.device import resolve_device
from repro_torch.graph.sampler import SampledBatch, SampleSpec
from repro_torch.optim.adam import AdamConfig, adam_update, tree_map

__all__ = [
    "LevelPlan",
    "StackedPlan",
    "build_plan",
    "stack_params_from_dict",
    "stack_recipe",
    "stack_batch",
    "raf_spmd_forward",
    "raf_spmd_logits",
    "loss_fn",
    "sync_stack_grads",
    "grad_step",
    "apply_step",
    "train_step",
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


# --------------------------------------------------------------------------
# batch stacking (host-side feature gathers)
# --------------------------------------------------------------------------


def stack_recipe(plan: StackedPlan) -> StackRecipe:
    """The plan's picklable host-staging recipe (memoized on the plan)."""
    recipe = getattr(plan, "_stack_recipe", None)
    if recipe is None:
        recipe = StackRecipe.from_plan(plan)
        plan._stack_recipe = recipe
    return recipe


def host_to_device(host: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Staged host arrays as tensors on ``device``, none of them aliasing
    the host memory (which may be a read-only view into a batch-arena
    slot, handed back to its writer once the next batch is drawn).  On a
    GPU each array is copied into a pinned buffer, then to the card
    asynchronously on the current stream (the caching host allocator keeps
    the buffer until that copy is done); on the CPU into a fresh tensor."""
    device = torch.device(device)
    pinned = device.type == "cuda"
    out = {}
    for k, a in host.items():
        t = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                        pin_memory=pinned)
        np.copyto(t.numpy(), a, casting="no")
        out[k] = t.to(device, non_blocking=True) if pinned else t
    return out


def stack_batch(
    plan: StackedPlan,
    batch: SampledBatch,
    tables: Dict[str, np.ndarray],
    device,
) -> Dict[str, torch.Tensor]:
    """The stacked device arrays of one sampled batch: the host gathers of
    :func:`repro_torch.data.staging.stack_batch_host`, then one copy per
    array to ``device``.  ``tables`` holds a feature table for every node
    type (learnable tables included — the embed engine supplies them)."""
    return host_to_device(stack_batch_host(stack_recipe(plan), batch, tables), device)


# --------------------------------------------------------------------------
# the forward over every shard on one device
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _StagedLevel:
    """One level's plan tables on the device, staged once per plan."""

    slot_u: Dict[str, List[torch.Tensor]]  # scope -> per shard [rb] int32
    valid: torch.Tensor  # [P, rb] float32
    parent_local: torch.Tensor  # [P, rb] int64
    parent_global: torch.Tensor  # [P, rb] int64


def _staged_levels(plan: StackedPlan, stacks: Dict, device: torch.device):
    """Per level, the slot indices (range-checked against each scope's
    stack rows), validity and parent maps on ``device`` — memoized on the
    plan, so a training run copies them once."""
    from repro_torch.kernels.stacked_relation_agg import stage_slot_u

    cache = plan.__dict__.setdefault("_staged", {})
    key = str(device)
    if key not in cache:
        scope_of = {s.scope: s.name for s in plan.module.specs}
        levels = []
        for lp in plan.levels:
            rows = {scope: stacks[f"layer{lp.layer}"][scope_of[scope]].shape[1]
                    for scope in plan.module.scopes}
            levels.append(_StagedLevel(
                slot_u={scope: [stage_slot_u(lp.slot_u[scope][p], rows[scope], device)
                                for p in range(plan.num_shards)]
                        for scope in plan.module.scopes},
                valid=torch.from_numpy(lp.valid.astype(np.float32)).to(device),
                parent_local=torch.from_numpy(lp.parent_local).to(device),
                parent_global=torch.from_numpy(lp.parent_global).to(device),
            ))
        cache[key] = levels
    return cache[key]


def _agg_level(plan: StackedPlan, lp: LevelPlan, staged: _StagedLevel, stacks,
               h_in, qfeat, mask, p: int, kernels=None):
    """Relation-specific aggregation for one level on shard ``p``, through
    :func:`repro_torch.kernels.stacked_relation_agg.stacked_agg`: one call
    covers every branch slot of the shard, weights read straight from the
    shard's ``[U, ...]`` stack rows.

    h_in  [rb, n_d, d_in] -> out [rb, n_prev, hidden]
    """
    from repro_torch.kernels.stacked_relation_agg import stacked_agg

    module = plan.module
    layer = stacks[f"layer{lp.layer}"]
    local = {s.name: layer[s.name][p] for s in module.specs}  # each [U, ...]
    slot_u = {scope: staged.slot_u[scope][p] for scope in module.scopes}
    rb, n_d, d_in = h_in.shape
    f = lp.fanout
    n_prev = n_d // f
    hg = h_in.reshape(rb, n_prev, f, d_in)
    mg = mask.reshape(rb, n_prev, f)
    out = stacked_agg(module, local, slot_u, hg, qfeat, mg, opts=kernels)
    return out * staged.valid[p][:, None, None].to(out.dtype)


def raf_spmd_forward(
    plan: StackedPlan,
    stacks: Dict,
    arrays: Dict,
    local_combine: bool = True,
    kernels=None,
) -> torch.Tensor:
    """Root embedding ``[B, hidden]``: every shard's levels, leaf first,
    then the sum of the shards' root partials (the reference's RAF
    ``psum``, Alg. 1 l.6).  ``kernels`` (a ``KernelConfig`` or ``None``)
    selects the aggregation path per level."""
    from repro_torch.kernels.stacked_relation_agg import segment_sum

    k = plan.spec.num_layers
    P = plan.num_shards
    staged = _staged_levels(plan, stacks, stacks["head"]["w"].device)
    child: List[torch.Tensor] = []
    for d in range(k, 0, -1):
        lp = plan.levels[d - 1]
        sl = staged[d - 1]
        rb = lp.rb
        outs = []
        for p in range(P):
            rows = slice(p * rb, (p + 1) * rb)
            h_in = arrays[f"hfeat{d}"][rows] if d == k else torch.relu(child[p])
            outs.append(_agg_level(plan, lp, sl, stacks, h_in, arrays[f"qfeat{d}"][rows],
                                   arrays[f"mask{d}"][rows], p, kernels))
        if d == 1:
            root = outs[0].sum(dim=0)  # shard 0's partial aggregation [B, H]
            for out in outs[1:]:
                root = root + out.sum(dim=0)  # the RAF exchange
            return root
        prev_rb = plan.levels[d - 2].rb
        if local_combine:
            child = [segment_sum(outs[p], sl.parent_local[p], prev_rb) for p in range(P)]
        else:
            # naive placement: parents may live on another shard -> a full
            # inner-level exchange of [R_{d-1}, N, H] partials (the ablation)
            full = segment_sum(outs[0], sl.parent_global[0], prev_rb * P)
            for p in range(1, P):
                full = full + segment_sum(outs[p], sl.parent_global[p], prev_rb * P)
            child = [full[p * prev_rb:(p + 1) * prev_rb] for p in range(P)]
    raise ValueError("the plan has no levels")


def raf_spmd_logits(plan: StackedPlan, stacks: Dict, arrays: Dict,
                    local_combine: bool = True, kernels=None) -> torch.Tensor:
    """Class scores ``relu(root) @ head.w + head.b`` of the batch's seeds."""
    root = raf_spmd_forward(plan, stacks, arrays, local_combine, kernels)
    return torch.relu(root) @ stacks["head"]["w"] + stacks["head"]["b"]


def loss_fn(plan: StackedPlan, stacks: Dict, arrays: Dict,
            local_combine: bool = True, kernels=None) -> torch.Tensor:
    """Mean NLL of the seeds' labels under a float32 ``log_softmax``."""
    logits = raf_spmd_logits(plan, stacks, arrays, local_combine, kernels)
    return nll_loss(logits, arrays["labels"].to(torch.long))


# --------------------------------------------------------------------------
# shared-parameter gradient synchronization
# --------------------------------------------------------------------------


def sync_stack_grads(plan: StackedPlan, grads: Dict) -> Dict:
    """Sum gradients across stack slots holding the *same* parameter and
    broadcast the sum back to every copy.

    A storage key can occupy several slots — one relation sampled into
    branches assigned to different shards, or a node type feeding
    relations owned by different shards.  ``stack_params_from_dict`` seeds
    all copies identically; summed (hence identical) gradients keep the
    per-copy Adam trajectories identical too, so the stacked run follows
    the dict-form run.  Scopes with no sharing are left untouched."""
    from repro_torch.kernels.stacked_relation_agg import segment_sum

    scope_of = {s.name: s.scope for s in plan.module.specs}
    out = dict(grads)
    for layer in plan.layers:
        entry = dict(grads[f"layer{layer}"])
        for leaf, g in entry.items():
            scope = scope_of[leaf]
            if not plan.has_shared(scope, layer):
                continue
            groups = plan.slot_groups[(scope, layer)]
            seg = torch.from_numpy(groups.reshape(-1)).to(g.device)
            flat = g.reshape((groups.size,) + tuple(g.shape[2:]))
            summed = segment_sum(flat, seg, int(groups.max()) + 1)
            entry[leaf] = summed[seg].reshape(g.shape)
        out[f"layer{layer}"] = entry
    return out


# --------------------------------------------------------------------------
# gradients and the train step
# --------------------------------------------------------------------------


def grad_step(
    plan: StackedPlan,
    stacks: Dict,
    arrays: Dict,
    local_combine: bool = True,
    kernels=None,
    learn_feats: bool = False,
):
    """``(loss, grads, feat_grads)``: the loss and its *raw* gradients with
    respect to every stack leaf (the reference's ``make_grad_step``) and,
    with ``learn_feats``, to every gathered feature array (``hfeat*`` /
    ``qfeat*``; else ``{}``).  An input the loss does not read gets zeros
    of its shape, as JAX returns them: R-GCN reads no ``qfeat``, yet the
    reference still runs a (zero-gradient) sparse Adam step for it."""
    params = tree_map(lambda t: t.detach().requires_grad_(True), stacks)
    feats = ({k: v.detach().requires_grad_(True) for k, v in arrays.items()
              if "feat" in k} if learn_feats else {})
    leaves, paths = [], []
    for layer in sorted(params):
        for leaf in sorted(params[layer]):
            leaves.append(params[layer][leaf])
            paths.append((layer, leaf))
    feat_keys = sorted(feats)
    leaves += [feats[k] for k in feat_keys]
    loss = loss_fn(plan, params, {**arrays, **feats}, local_combine, kernels)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, got)]
    grads: Dict = {layer: {} for layer in params}
    for (layer, leaf), g in zip(paths, got):
        grads[layer][leaf] = g
    gf = dict(zip(feat_keys, got[len(paths):]))
    return loss.detach(), grads, gf


def train_step(
    plan: StackedPlan,
    adam_cfg: AdamConfig,
    stacks: Dict,
    opt_state: Dict,
    arrays: Dict,
    local_combine: bool = True,
    kernels=None,
    learn_feats: bool = False,
):
    """One SPMD RAF train step: ``(stacks, opt_state, loss, feat_grads)``:
    :func:`grad_step`, then :func:`apply_step`."""
    loss, grads, gf = grad_step(plan, stacks, arrays, local_combine, kernels, learn_feats)
    stacks, opt_state = apply_step(plan, adam_cfg, stacks, opt_state, grads)
    return stacks, opt_state, loss, gf


def apply_step(plan: StackedPlan, adam_cfg: AdamConfig, stacks: Dict, opt_state: Dict,
               grads: Dict):
    """The update half of :func:`train_step` (the reference's
    ``make_apply_step``): ``(stacks, opt_state)`` after
    :func:`sync_stack_grads` on ``grads`` and Adam, so parameters shared
    across shard slots stay consistent copies.  The data-parallel tier
    (``repro_torch.data.dp_trainer``) runs it on the cross-trainer sum of
    :func:`grad_step`'s raw gradients, so the cross-slot sync happens
    once, on the sum, as in the single-process step."""
    grads = sync_stack_grads(plan, grads)
    with torch.no_grad():
        return adam_update(adam_cfg, stacks, grads, opt_state)
