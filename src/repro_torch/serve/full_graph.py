"""Layer-wise full-graph inference over the metatree plan (DESIGN.md §10).

Training samples fixed-fanout subtrees per seed; inference wants the
embedding of *every* node, and re-sampling a tree per query does redundant
work proportional to fanout^k.  Following GraphStorm's ``dist_inference``
pattern, this module computes level-l representations for **all** nodes of
every type before advancing to level l+1, so each node's layer-l value is
computed exactly once and reused by every consumer at layer l+1.

The recurrence, for layer l = 1..k over level d = k-l+1 of the plan:

    REP[l][t][v] = sum_r AGG_r(params(r, t, l), {h_u : u in N_r(v)}, q=x_t[v])

with h_u = padded input features at l=1, else relu(REP[l-1][src(r)][u])
(zeros for types with no in-relations), and logits = relu(REP[k][target])
@ head.  Branch parameters are gathered *from the same [P, U, ...] stacks
the SPMD executor trains* (via the plan's slot tables), and the per-level
compute is the ``stacked_agg`` dispatch — the hand-written CUDA kernel on
the GPU, its plain PyTorch version on the CPU — with the slot outputs
summed into the destination.

Neighbor gathers run on the host in numpy, block by block; each block is
copied to the device, aggregated there, and copied back.  The store
records the time of each of those phases (``EmbeddingStore.timings``).

The materialized :class:`EmbeddingStore` holds one float32 host array per
node type (pre-ReLU top-layer representations) plus the classifier head;
with ``shm=True`` those arrays live in one shared-memory segment
(``repro_torch.graph.shm.share_arrays``) that another process maps zero-copy
through :meth:`EmbeddingStore.attach`.

:func:`exhaustive_batch` and :func:`spmd_logits_for_batch` are the
minibatch side of the serving tier's parity checks: a batch holding every
neighbor of its seeds, and its logits through the training step's forward.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.staging import _padded_gather
from repro_torch.device import resolve_device
from repro_torch.graph.hetgraph import CSR, HetGraph
from repro_torch.graph.sampler import Level, SampledBatch, SampleSpec
from repro_torch.graph.shm import ArraysHandle, SharedArrays, attach_arrays, share_arrays

__all__ = [
    "EmbeddingStore",
    "infer_all",
    "exhaustive_fanouts",
    "exhaustive_batch",
    "bounded_graph",
    "spmd_logits_for_batch",
]

# cap on one chunk's gathered-neighbor tensor [n_sel, block, f, d_in]; the
# effective node block shrinks below ServeConfig.node_block when a level's
# fanout (= max in-degree) would otherwise blow host/device memory
_BLOCK_BUDGET_BYTES = 128 << 20


# --------------------------------------------------------------------------
# exhaustive neighborhoods (full CSR lists, padding masked)
# --------------------------------------------------------------------------


def _full_neighbors(
    csr: CSR, parents: np.ndarray, parent_mask: np.ndarray, fanout: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Every in-neighbor of each parent, CSR order, padded to ``fanout``.

    The deterministic counterpart of ``sample_neighbors``: slot j of parent v
    holds ``indices[indptr[v] + j]`` for j < deg(v), masked beyond.  Raises
    when any parent's degree exceeds ``fanout`` (exhaustiveness violated)."""
    n = len(parents)
    if csr.num_edges == 0:
        return np.zeros((n, fanout), np.int64), np.zeros((n, fanout), bool)
    deg = csr.indptr[parents + 1] - csr.indptr[parents]
    if int(deg.max(initial=0)) > fanout:
        raise ValueError(
            f"fanout {fanout} < max in-degree {int(deg.max())}: exhaustive "
            "neighborhoods need fanout >= the level's max in-degree"
        )
    cols = np.arange(fanout)
    raw = csr.indptr[parents][:, None] + cols[None, :]
    valid = (cols[None, :] < deg[:, None]) & parent_mask[:, None]
    raw = np.minimum(raw, csr.num_edges - 1)
    idx = np.where(valid, csr.indices[raw], 0)
    return idx, valid


def exhaustive_fanouts(graph: HetGraph, spec: SampleSpec) -> Tuple[int, ...]:
    """Per-level fanouts that make sampling exhaustive: the max in-degree
    over the level's relations (min 1).  A batch sampled with these fanouts
    via :func:`exhaustive_batch` contains every neighbor of every node."""
    out = []
    for branches in spec.levels:
        f = 1
        for b in branches:
            csr = graph.relations[b.rel]
            deg = csr.indptr[1:] - csr.indptr[:-1]
            if len(deg):
                f = max(f, int(deg.max(initial=0)))
        out.append(f)
    return tuple(out)


def bounded_graph(graph: HetGraph, cap: int) -> HetGraph:
    """A copy of ``graph`` with per-node in-degree capped at ``cap`` (the
    first ``cap`` CSR neighbors kept).

    The synthetic dataset family's Zipf skew produces hub nodes with
    thousands of in-edges, which makes exhaustive neighborhoods — fanout =
    max in-degree — intractable for the minibatch side of a parity check.
    Tests, benchmarks and demos train *and* infer on the capped graph, so
    the equivalence being asserted is unaffected."""
    rels = {}
    for rel, csr in graph.relations.items():
        deg = csr.indptr[1:] - csr.indptr[:-1]
        keep = np.minimum(deg, cap)
        indptr = np.zeros(len(deg) + 1, csr.indptr.dtype)
        np.cumsum(keep, out=indptr[1:])
        pos = (np.repeat(csr.indptr[:-1], keep)
               + np.arange(int(keep.sum())) - np.repeat(indptr[:-1], keep))
        rels[rel] = CSR(indptr=indptr, indices=csr.indices[pos])
    return HetGraph(
        num_nodes=dict(graph.num_nodes),
        relations=rels,
        target_type=graph.target_type,
        num_classes=graph.num_classes,
        features=dict(graph.features),
        labels=graph.labels,
        train_nodes=graph.train_nodes,
        name=f"{graph.name}-deg{cap}",
    )


def exhaustive_batch(
    graph: HetGraph, spec: SampleSpec, seeds: np.ndarray
) -> SampledBatch:
    """A :class:`SampledBatch` whose levels hold *full* neighbor lists.

    Requires ``spec.fanouts >= exhaustive_fanouts(graph, spec)`` per level.
    The minibatch forward on such a batch sees exactly the neighborhoods the
    layer-wise engine aggregates — the per-node parity fixture."""
    seeds = np.asarray(seeds, dtype=np.int64)
    levels: List[Level] = []
    prev_nids: List[np.ndarray] = [seeds]
    prev_mask: List[np.ndarray] = [np.ones(len(seeds), dtype=bool)]
    for d, branches in enumerate(spec.levels, start=1):
        f = spec.fanouts[d - 1]
        nids = np.zeros((len(branches), len(prev_nids[0]) * f), dtype=np.int64)
        mask = np.zeros_like(nids, dtype=bool)
        for b, bs in enumerate(branches):
            csr = graph.relations[bs.rel]
            idx, m = _full_neighbors(
                csr, prev_nids[bs.parent], prev_mask[bs.parent], f
            )
            nids[b] = idx.reshape(-1)
            mask[b] = m.reshape(-1)
        levels.append(Level(nids=nids, mask=mask))
        prev_nids = [nids[b] for b in range(len(branches))]
        prev_mask = [mask[b] for b in range(len(branches))]
    labels = graph.labels[seeds]
    return SampledBatch(spec, seeds, labels, levels)


# --------------------------------------------------------------------------
# the materialized store
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EmbeddingStore:
    """Per-type top-layer representations + classifier head (DESIGN.md §10).

    ``embeddings[t]`` is the float32 **pre-ReLU** layer-``layer_of[t]``
    representation of every node of type ``t``; only types that are a
    destination somewhere in the metatree have an entry.  ``scores``
    applies ``relu`` + the head to target-type rows on ``device``
    (``None``: the GPU, as :func:`~repro_torch.device.resolve_device` says).
    ``timings`` holds the seconds :func:`infer_all` spent per phase
    (``host_gather_s``, ``h2d_s``, ``compute_s``, ``d2h_s``; the device
    phases timed with CUDA events on a GPU).  When shm-backed, ``handle``
    is picklable and :meth:`attach` maps the store zero-copy in another
    process; :meth:`close` unlinks (owner) or unmaps (attached)."""

    target_type: str
    num_classes: int
    hidden: int
    embeddings: Dict[str, np.ndarray]
    layer_of: Dict[str, int]
    head: Dict[str, np.ndarray]
    device: Optional[torch.device] = None
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    handle: Optional[ArraysHandle] = None
    _segment: object = None  # SharedArrays (owner) | AttachedArrays | None
    _head_dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def embedding(self, ntype: str, nids) -> np.ndarray:
        """Stored (pre-ReLU) rows for ``nids`` of ``ntype``."""
        return self.embeddings[ntype][np.asarray(nids)]

    def head_on_device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The head's (w, b) as tensors on ``device``, copied once (also on
        the CPU: an attached store's arrays are read-only shm views)."""
        if self._head_dev is None:
            self._head_dev = tuple(
                torch.from_numpy(np.array(self.head[k])).to(self.device)
                for k in ("w", "b"))
        return self._head_dev

    def scores(self, nids) -> np.ndarray:
        """Class logits for target-type nodes: relu(rep) @ W + b."""
        w, b = self.head_on_device()
        emb = torch.from_numpy(self.embeddings[self.target_type][np.asarray(nids)])
        return (torch.relu(emb.to(self.device)) @ w + b).cpu().numpy()

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.embeddings.values()) + sum(
            a.nbytes for a in self.head.values())

    @classmethod
    def attach(cls, handle: ArraysHandle, device=None) -> "EmbeddingStore":
        """Map a shm-backed store exported by :func:`infer_all` zero-copy;
        ``device`` is where :meth:`scores` runs (``None``: the GPU)."""
        seg = attach_arrays(handle)
        meta = handle.meta_dict
        embeddings = {k[len("emb/"):]: v for k, v in seg.arrays.items()
                      if k.startswith("emb/")}
        return cls(
            target_type=meta["target_type"],
            num_classes=int(meta["num_classes"]),
            hidden=int(meta["hidden"]),
            embeddings=embeddings,
            layer_of={t: int(meta[f"layer/{t}"]) for t in embeddings},
            head={"w": seg.arrays["head/w"], "b": seg.arrays["head/b"]},
            device=device,
            handle=handle,
            _segment=seg,
        )

    def close(self) -> None:
        """Release shm backing: owners unlink the segment, attached readers
        unmap their view.  Idempotent; plain-array stores are a no-op."""
        seg, self._segment = self._segment, None
        if seg is None:
            return
        self.embeddings = {}
        self.head = {}
        if isinstance(seg, SharedArrays):
            seg.unlink()
        else:
            seg.close()


def _shm_backed(store: EmbeddingStore) -> EmbeddingStore:
    """Re-materialize a store's arrays inside one shared segment."""
    arrays = {f"emb/{t}": a for t, a in store.embeddings.items()}
    arrays["head/w"] = store.head["w"]
    arrays["head/b"] = store.head["b"]
    meta = {
        "target_type": store.target_type,
        "num_classes": str(store.num_classes),
        "hidden": str(store.hidden),
        **{f"layer/{t}": str(l) for t, l in store.layer_of.items()},
    }
    seg = share_arrays(arrays, meta=meta)
    views = seg.arrays()
    store.embeddings = {t: views[f"emb/{t}"] for t in store.embeddings}
    store.head = {"w": views["head/w"], "b": views["head/b"]}
    store.handle = seg.handle
    store._segment = seg
    return store


# --------------------------------------------------------------------------
# the layer-wise engine
# --------------------------------------------------------------------------


def _host_stacks(stacks: Dict) -> Dict:
    """Pull the trained stacks to host numpy once."""
    return {
        layer: {leaf: v.detach().cpu().numpy() for leaf, v in entry.items()}
        for layer, entry in stacks.items()
    }


def _slot_of(lp) -> Dict[int, Tuple[int, int]]:
    """Invert ``slot_branch``: original branch index -> (shard, slot)."""
    out: Dict[int, Tuple[int, int]] = {}
    sb = lp.slot_branch
    for p in range(sb.shape[0]):
        for s in range(sb.shape[1]):
            b = int(sb[p, s])
            if b >= 0:
                out[b] = (p, s)
    return out


def _dedup_groups(plan, d: int) -> Dict[str, List[int]]:
    """Branches at level ``d`` grouped by dst type, one per relation.

    The metatree repeats (dst type, relation) pairs once per parent branch
    of that type; parameters and neighbor sets depend only on the pair, so
    the engine aggregates each relation once per type — first occurrence,
    which preserves the child order (= sorted in-relation order) any single
    parent's children have in the minibatch tree."""
    groups: Dict[str, List[int]] = {}
    seen: Dict[str, set] = {}
    for b, bs in enumerate(plan.spec.levels[d - 1]):
        t = plan.dst_types[d - 1][b]
        if bs.rel not in seen.setdefault(t, set()):
            seen[t].add(bs.rel)
            groups.setdefault(t, []).append(b)
    return groups


def _gather_branch_params(plan, lp, host_stacks, sel, slot_of):
    """Per-leaf ``[n_sel, ...]`` parameter rows for the selected branches,
    gathered from the trained ``[P, U, ...]`` stacks via the plan's slot
    tables — no unstacking back to dict form."""
    module = plan.module
    scope_of = {s.name: s.scope for s in module.specs}
    layer_entry = host_stacks[f"layer{lp.layer}"]
    out = {}
    for leaf, slab in layer_entry.items():
        rows = []
        for b in sel:
            p, s = slot_of[b]
            u = int(lp.slot_u[scope_of[leaf]][p, s])
            rows.append(slab[p, u])
        out[leaf] = np.stack(rows)
    return out


def _group_fanout(graph: HetGraph, plan, d: int, sel: List[int]) -> int:
    """Max in-degree over the selected branches' relations (min 1).

    Masked padding slots contribute exact zeros to every aggregation, so a
    per-group fanout (tighter than the level-wide max) changes nothing
    numerically while bounding the gathered tensor."""
    f = 1
    for b in sel:
        csr = graph.relations[plan.spec.levels[d - 1][b].rel]
        deg = csr.indptr[1:] - csr.indptr[:-1]
        if len(deg):
            f = max(f, int(deg.max(initial=0)))
    return f


class _Marks:
    """Timestamps between the phases of a block: CUDA events on a GPU
    (read after the final synchronize), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> int:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def seconds(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


def infer_all(
    graph: HetGraph,
    plan,
    stacks: Dict,
    tables: Dict[str, np.ndarray],
    *,
    node_block: int = 1024,
    kernels=None,
    shm: bool = False,
    device=None,
) -> EmbeddingStore:
    """Materialize top-layer representations for every node of every type.

    ``plan``/``stacks`` are the SPMD executor's :class:`~repro_torch.core.
    raf_spmd.StackedPlan` and parameter stacks; ``tables`` is a full
    feature-table snapshot (``EmbedEngine.tables_snapshot()``).  Nodes are
    processed in ``node_block`` chunks (shrunk automatically when a level's
    max in-degree would blow the block budget) on ``device`` (``None``: the
    GPU, or :class:`~repro_torch.device.NoGPUError` without one).  On the
    GPU an attention model's group fanout must fit one row of the epilogue
    kernel's shared memory (f <= 392 for HGT and f <= 792 for R-GAT at
    hidden 64, 4 heads), else
    :class:`~repro_torch.kernels.stacked_relation_agg.FanoutTooWideError`;
    cap the graph's in-degree (:func:`bounded_graph`) beyond that.  With
    ``shm=True`` the store's arrays move into one shared-memory segment
    (:meth:`EmbeddingStore.attach` maps it from another process; the
    store's :meth:`~EmbeddingStore.close` unlinks it)."""
    from repro_torch.kernels.stacked_relation_agg import stacked_agg, stage_slot_u

    device = resolve_device(device)
    spec = plan.spec
    module = plan.module
    k = spec.num_layers
    hidden = plan.cfg.hidden
    d_pad = plan.d_pad
    host_stacks = _host_stacks(stacks)
    marks = _Marks(device)
    spans = []  # per block: (host_gather_s, mark indices of h2d/compute/d2h)

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    prev_rep: Dict[str, np.ndarray] = {}
    final_rep: Dict[str, np.ndarray] = {}
    layer_of: Dict[str, int] = {}
    for l in range(1, k + 1):
        d = k - l + 1
        lp = plan.levels[d - 1]
        slot_of = _slot_of(lp)
        cur_rep: Dict[str, np.ndarray] = {}
        for t, sel in _dedup_groups(plan, d).items():
            n_sel = len(sel)
            f = _group_fanout(graph, plan, d, sel)
            d_in = lp.d_in
            num_nodes = graph.num_nodes[t]
            block = max(1, min(
                node_block, _BLOCK_BUDGET_BYTES // max(1, n_sel * f * d_in * 4)
            ))
            p_sel = {leaf: to_dev(v) for leaf, v in
                     _gather_branch_params(plan, lp, host_stacks, sel, slot_of).items()}
            # every block of the group uses the same slots: staged once
            slot_u = {scope: stage_slot_u(np.arange(n_sel), n_sel, device)
                      for scope in module.scopes}
            rels = [spec.levels[d - 1][b].rel for b in sel]
            rep = np.zeros((num_nodes, hidden), np.float32)
            for lo in range(0, num_nodes, block):
                t0 = time.perf_counter()
                chunk = np.arange(lo, min(lo + block, num_nodes), dtype=np.int64)
                nb = len(chunk)
                ones = np.ones(nb, bool)
                h = np.zeros((n_sel, nb, f, d_in), np.float32)
                mask = np.zeros((n_sel, nb, f), bool)
                for i, rel in enumerate(rels):
                    csr = graph.relations[rel]
                    idx, m = _full_neighbors(csr, chunk, ones, f)
                    mask[i] = m
                    if l == 1:
                        h[i] = _padded_gather(
                            tables[rel.src], idx.reshape(-1), d_in
                        ).reshape(nb, f, d_in)
                    else:
                        src_rep = prev_rep.get(rel.src)
                        if src_rep is not None:
                            # relu of the previous layer; types with no
                            # in-relations stay zeros (the tree's
                            # leaf-at-intermediate-depth case)
                            h[i] = np.maximum(
                                src_rep[idx.reshape(-1)], 0.0
                            ).reshape(nb, f, hidden)
                q_row = _padded_gather(tables[t], chunk, d_pad)
                host_s = time.perf_counter() - t0
                m0 = marks.mark()
                h_d, mask_d = to_dev(h), to_dev(mask)
                q_d = to_dev(q_row)[None].expand(n_sel, nb, d_pad)
                m1 = marks.mark()
                out = stacked_agg(module, p_sel, slot_u, h_d, q_d, mask_d,
                                  opts=kernels).sum(dim=0)
                m2 = marks.mark()
                rep[lo:lo + nb] = out.cpu().numpy()
                m3 = marks.mark()
                spans.append((host_s, m0, m1, m2, m3))
            cur_rep[t] = rep
            final_rep[t] = rep
            layer_of[t] = l
        prev_rep = cur_rep

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings = {"host_gather_s": 0.0, "h2d_s": 0.0, "compute_s": 0.0, "d2h_s": 0.0,
               "blocks": float(len(spans))}
    for host_s, m0, m1, m2, m3 in spans:
        timings["host_gather_s"] += host_s
        timings["h2d_s"] += marks.seconds(m0, m1)
        timings["compute_s"] += marks.seconds(m1, m2)
        timings["d2h_s"] += marks.seconds(m2, m3)
    store = EmbeddingStore(
        target_type=spec.target_type,
        num_classes=int(plan.cfg.num_classes),
        hidden=hidden,
        embeddings=final_rep,
        layer_of=layer_of,
        head={leaf: v.detach().cpu().numpy() for leaf, v in stacks["head"].items()},
        device=device,
        timings=timings,
    )
    return _shm_backed(store) if shm else store


# --------------------------------------------------------------------------
# the minibatch reference (parity fixture for tests)
# --------------------------------------------------------------------------


def spmd_logits_for_batch(plan, stacks, batch, tables, kernels=None) -> np.ndarray:
    """Logits of one batch through the minibatch ``raf_spmd`` forward.

    The exact math of the training step's forward (the same ``stacked_agg``
    dispatch, the head after the root sum), on the device the stacks live
    on, for the serving tier's Prop-1 parity checks.  Requires a
    single-shard plan (fold the assignment to 1 before ``build_plan``), as
    the reference's does."""
    from repro_torch.core import raf_spmd

    if plan.num_shards != 1:
        raise ValueError(
            f"parity reference needs a 1-shard plan, got {plan.num_shards}")
    device = stacks["head"]["w"].device
    arrays = raf_spmd.stack_batch(plan, batch, tables, device)
    with torch.no_grad():
        logits = raf_spmd.raf_spmd_logits(plan, stacks, arrays, True, kernels)
    return logits.cpu().numpy()
