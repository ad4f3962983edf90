"""Executor registry — one protocol per execution model.

Executor choice is a config string (``RunConfig.executor``).  Protocol (all
methods take the owning :class:`repro_torch.api.Heta` session, which
exposes graph / spec / assignment / engine / hgnn_cfg / adam_cfg / device):

  ``build_plan(sess) -> plan``            static artifacts
  ``init_state(sess, plan) -> state``     parameters + optimizer state
  ``stage(sess, plan, batch) -> arrays``
      host-side staging: a :class:`SampledBatch` -> the device arrays the
      step consumes (table snapshot, stack, copy to the device)
  ``step_staged(sess, plan, state, batch, arrays) -> (state, loss, step_time_s)``
      the device step on staged arrays; ``step_time_s`` times the compute
      + sparse-update region only and ends after the loss reaches the host.
      The sparse-update share is recorded in ``plan.last_update_s``.
  ``step(sess, plan, state, batch)``      the serial composition of the two
  ``stage_reads_tables(sess, plan) -> bool``
      whether ``stage`` reads learnable tables that train (drives the
      pipeline's snapshot staleness policy; see ``repro_torch.data``)
  ``worker_stage_recipe(sess, plan) -> picklable | None``
      a picklable recipe with which a *sampler worker process* performs the
      host part of ``stage`` against tables exported into the shared-memory
      store or batch arena (``repro_torch.data.staging.stack_batch_host``),
      or None when staging stays on the consumer (the default)
  ``stage_from_host(sess, plan, batch, host_arrays) -> arrays``
      the consumer's completion of worker staging: the host arrays a worker
      produced under the recipe, on the session's device; with
      ``host_arrays=None`` the full ``stage`` (the default).  ``host_arrays``
      may be read-only views into a batch-arena slot, which the stream hands
      back to its writer when the next item is drawn, so nothing returned
      may alias them
  ``loss_and_metrics(sess, plan, state, batch) -> (loss, metrics)``  eval only

``stage`` may run in the pipeline's producer thread for a future batch while
the trainer's thread runs the current step; it does host work and copies to
the device, and launches no kernel.

The port registers the reference's four:

  * ``vanilla`` — the baseline execution model: one dense parameter bundle,
    full-batch dict-form forward (``hgnn_loss``).  The correctness oracle:
    it passes no kernel options, so by the reference's own design it
    launches no aggregation kernel on the card (its AGG_r is each module's
    ``aggregate`` in torch ops).
  * ``raf`` — simulated multi-partition RAF (paper §4 Alg. 1): explicit
    per-partition parameter dicts, partial aggregations summed in Python,
    R-GCN's AGG_r through the ``relation_agg`` kernel.
  * ``raf_spmd`` — the production SPMD executor: relation branches stacked
    per model shard, learnable features updated sparsely through the §6
    cache.
  * ``serve`` — scores batches against the embedding store ``infer_all``
    materialized; not a training executor.

The two dense executors train the learnable tables (``model.train_learnable``)
as dense leaves of the bundle under ``embed``, starting from the cache
engine's rows, as the reference's do; the engine's own tables stay as they
were.

Register your own with ``@executors.register("name")``.
"""

from __future__ import annotations

import time
import weakref
from types import SimpleNamespace
from typing import Dict, Tuple, Type

import numpy as np
import torch

from repro_torch.optim.adam import tree_map

__all__ = ["Executor", "register", "get", "available", "apply_feature_grads"]

_REGISTRY: Dict[str, Type["Executor"]] = {}


def register(name: str):
    """Class decorator: ``@register("myexec")`` adds it to the registry."""

    def deco(cls: Type["Executor"]) -> Type["Executor"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get(name: str) -> "Executor":
    """Instantiate the executor registered under ``name``."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown executor {name!r}; available: {available()}"
        )
    return _REGISTRY[name]()


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


class Executor:
    """Base protocol.  Stateless: everything mutable lives in ``state``."""

    name = "?"

    def build_plan(self, sess):
        raise NotImplementedError

    def init_state(self, sess, plan):
        raise NotImplementedError

    def stage(self, sess, plan, batch):
        raise NotImplementedError

    def step_staged(self, sess, plan, state, batch, arrays):
        raise NotImplementedError

    def step(self, sess, plan, state, batch):
        """Serial stage + device step."""
        return self.step_staged(sess, plan, state, batch,
                                self.stage(sess, plan, batch))

    def stage_reads_tables(self, sess, plan) -> bool:
        return False

    def worker_stage_recipe(self, sess, plan):
        """Picklable host-staging recipe for sampler worker processes, or
        None when staging stays on the consumer (the default)."""
        return None

    def stage_from_host(self, sess, plan, batch, host_arrays):
        """Finish staging from worker-produced host arrays.  The base
        protocol has no worker staging, so this is the full ``stage``."""
        return self.stage(sess, plan, batch)

    def loss_and_metrics(self, sess, plan, state, batch):
        raise NotImplementedError


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# shared pieces of the dense executors
# --------------------------------------------------------------------------


def _init_full_params(sess):
    """Dense parameter bundle on the session's device, seeded identically
    across executors (the name-seeded init makes partition-restricted inits
    bit-identical — Prop 1)."""
    from repro_torch.core.hgnn import init_hgnn_params

    params = init_hgnn_params(sess.config.run.seed, sess.hgnn_cfg, sess.spec, sess.feat_dims)
    return tree_map(lambda t: t.to(sess.device), params)


def _engine_embed(sess) -> Dict[str, torch.Tensor]:
    """Learnable tables as tensors on the session's device, copied from the
    cache engine's authoritative rows, so every executor starts from the
    same rows."""
    return {t: torch.tensor(sess.engine.table(t), dtype=torch.float32, device=sess.device)
            for t in sess.engine.learnable_types}


def _lookup_tables(sess) -> Dict[str, torch.Tensor]:
    """Feature tables visible to the dense executors: fixed features, plus —
    when learnable training is frozen — the engine's learnable rows as
    constants (otherwise those travel in the bundle and train)."""
    if sess.config.model.train_learnable:
        return sess.fixed_tables
    return {**sess.fixed_tables, **_engine_embed(sess)}


def _trainable(tree):
    """The leaves of ``tree`` as fresh leaf tensors that take gradients."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _bundle_state(bundle) -> Dict:
    """Executor state of a dense bundle: the bundle and zero Adam state."""
    from repro_torch.optim.adam import adam_init

    return {"bundle": bundle, "opt": adam_init(bundle)}


def _bundle_grads(bundle, loss):
    """The gradient tree of ``loss`` for every leaf of ``bundle``; a leaf the
    loss does not read gets zeros, as ``jax.grad`` gives it."""
    from repro_torch.optim.adam import tree_leaves

    leaves = tree_leaves(bundle)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, got)}
    return tree_map(lambda p: by_id[id(p)], bundle)


def _bundle_step_staged(sess, plan, state, arrs):
    """The dense-bundle device step on staged arrays: forward over the
    bundle's leaves made trainable, backward, Adam over the whole bundle;
    timed to the loss on the host (staging excluded)."""
    from repro_torch.optim.adam import adam_update

    t0 = time.perf_counter()
    bundle = _trainable(state["bundle"])
    loss = plan.loss(bundle, arrs)
    grads = _bundle_grads(bundle, loss)
    with torch.no_grad():
        bundle, opt = adam_update(sess.adam_cfg, bundle, grads, state["opt"])
    _sync(sess.device)
    loss = float(loss.detach())
    return {"bundle": bundle, "opt": opt}, loss, time.perf_counter() - t0


class _DenseExecutor(Executor):
    """The protocol shared by ``vanilla`` and ``raf``: staging copies the
    batch's index arrays to the device, the step differentiates
    ``plan.loss``."""

    def stage(self, sess, plan, batch):
        from repro_torch.core.hgnn import batch_to_arrays

        return batch_to_arrays(batch, sess.device)

    def step_staged(self, sess, plan, state, batch, arrays):
        return _bundle_step_staged(sess, plan, state, arrays)

    def loss_and_metrics(self, sess, plan, state, batch):
        with torch.no_grad():
            loss = float(plan.loss(state["bundle"], self.stage(sess, plan, batch)))
        return loss, {"loss": loss}


@register("vanilla")
class VanillaExecutor(_DenseExecutor):
    def build_plan(self, sess):
        from repro_torch.core.hgnn import hgnn_loss

        cfg, spec, tables = sess.hgnn_cfg, sess.spec, _lookup_tables(sess)
        return SimpleNamespace(
            loss=lambda bundle, arrs: hgnn_loss(cfg, bundle, tables, arrs, spec))

    def init_state(self, sess, plan):
        bundle = _init_full_params(sess)
        if sess.config.model.train_learnable:
            bundle["embed"] = _engine_embed(sess)
        return _bundle_state(bundle)


@register("raf")
class RafSimExecutor(_DenseExecutor):
    def build_plan(self, sess):
        from repro_torch.core.raf import raf_loss

        cfg, spec, tables = sess.hgnn_cfg, sess.spec, _lookup_tables(sess)
        assignment = sess.assignment
        P = assignment.num_partitions
        kernels = sess.config.kernels

        def loss(bundle, arrs):
            # one logical copy of the shared leaves (embed tables + head),
            # merged into every partition's local relation parameters;
            # autograd sums their gradients over the partitions
            parts = [{**bundle["parts"][p], "embed": bundle.get("embed", {}),
                      "head": bundle["head"]} for p in range(P)]
            return raf_loss(cfg, parts, tables, arrs, spec, assignment, kernels)

        return SimpleNamespace(loss=loss, num_partitions=P)

    def init_state(self, sess, plan):
        from repro_torch.core.hgnn import init_hgnn_params

        full = _init_full_params(sess)
        parts = []
        for p in range(plan.num_partitions):
            own = init_hgnn_params(sess.config.run.seed, sess.hgnn_cfg, sess.spec,
                                   sess.feat_dims,
                                   restrict_rels=sess.assignment.relations_of(p, sess.spec))
            parts.append(tree_map(lambda t: t.to(sess.device),
                                  {k: own[k] for k in ("rel", "ntype", "etype")}))
        bundle = {"parts": parts, "head": full["head"]}
        if sess.config.model.train_learnable:
            bundle["embed"] = _engine_embed(sess)
        return _bundle_state(bundle)


# --------------------------------------------------------------------------
# raf_spmd — the production executor + cache-mediated feature updates
# --------------------------------------------------------------------------


@register("raf_spmd")
class RafSpmdExecutor(Executor):
    def build_plan(self, sess):
        """The stacked plan over the partition assignment, folded onto the
        run's model-axis shard count (``run.mesh_shape[1]``; p % shards keeps
        meta-locality).  Every shard lives on the session's one device."""
        from repro_torch.core import raf_spmd

        run = sess.config.run
        assignment = sess.assignment
        if assignment.num_partitions != run.mesh_shape[1]:
            assignment = assignment.fold(run.mesh_shape[1], sess.spec)
        plan = raf_spmd.build_plan(sess.spec, assignment, sess.hgnn_cfg, sess.feat_dims)
        learn = (bool(sess.engine.learnable_types)
                 and sess.config.model.train_learnable)
        return SimpleNamespace(
            plan=plan,
            learn_feats=learn,
            local_combine=sess.config.partition.placement == "meta",
            last_update_s=0.0,
        )

    def init_state(self, sess, plan):
        """Initial parameter stacks on the session's device, from the port's
        name-seeded init (``repro_torch.core.hgnn.init_hgnn_params``), and
        zero Adam state."""
        from repro_torch.core import raf_spmd
        from repro_torch.core.hgnn import init_hgnn_params
        from repro_torch.optim.adam import adam_init

        params = init_hgnn_params(sess.config.run.seed, sess.hgnn_cfg, sess.spec,
                                  sess.feat_dims)
        stacks = raf_spmd.stack_params_from_dict(plan.plan, params, device=sess.device)
        return {"stacks": stacks, "opt": adam_init(stacks)}

    def stage(self, sess, plan, batch):
        """Snapshot the tables, stack the batch branch-major on the host and
        copy it to the device.  With frozen features the tables never
        change, so re-staging the same batch object returns the last
        arrays.  The memo holds the batch by weak reference: a pooled
        batch's arrays are views into a batch-arena slot, which must not be
        kept past the next draw.

        When the pipeline stages in its producer thread while learnable
        tables train, the snapshot may lag the device step by up to
        ``pipeline.depth + 1`` steps — the documented ``"stale"`` policy."""
        from repro_torch.core import raf_spmd

        if not plan.learn_feats:
            cached = getattr(plan, "_stage_cache", None)
            if cached is not None and cached[0]() is batch:
                return cached[1]
        tables = sess.engine.tables_snapshot()
        arrays = raf_spmd.stack_batch(plan.plan, batch, tables, sess.device)
        if not plan.learn_feats:
            plan._stage_cache = (weakref.ref(batch), arrays)
        return arrays

    def stage_reads_tables(self, sess, plan) -> bool:
        return bool(plan.learn_feats)

    def worker_stage_recipe(self, sess, plan):
        """With frozen tables the whole host side of :meth:`stage` — the
        padded feature gathers — runs inside sampler workers against tables
        exported into the shm store or batch arena; the consumer only copies
        to the device.

        While learnable tables train, workers cannot see the trainer's row
        updates, so staging stays on the consumer (None) — *except* under
        the batch arena with the ``"stale"`` snapshot policy: the session
        republishes the learnable tables into the arena's seqlock'd table
        region after every step, so workers stage against snapshots at most
        the ring depth behind the trainer (DESIGN.md §11)."""
        if plan.learn_feats:
            p = sess.config.pipeline
            if not (p.arena and p.num_workers > 0 and p.snapshot == "stale"):
                return None
        from repro_torch.core import raf_spmd

        return raf_spmd.stack_recipe(plan.plan)

    def stage_from_host(self, sess, plan, batch, host_arrays):
        """The consumer's completion of worker staging: the worker-staged
        host arrays on the session's device through
        :func:`repro_torch.core.raf_spmd.host_to_device`, which copies each
        (read-only slot views included) into a pinned buffer before the
        asynchronous copy to a GPU, so no tensor aliases slot memory."""
        if host_arrays is None:
            return self.stage(sess, plan, batch)
        from repro_torch.core import raf_spmd

        return raf_spmd.host_to_device(host_arrays, sess.device)

    def step_staged(self, sess, plan, state, batch, arrays):
        from repro_torch.core import raf_spmd

        t0 = time.perf_counter()
        stacks, opt, loss, gf = raf_spmd.train_step(
            plan.plan, sess.adam_cfg, state["stacks"], state["opt"], arrays,
            local_combine=plan.local_combine, kernels=sess.config.kernels,
            learn_feats=plan.learn_feats,
        )
        if plan.learn_feats:
            _sync(sess.device)
            t1 = time.perf_counter()
            apply_feature_grads(sess.engine, plan.plan, batch, gf)
            _sync(sess.device)
            plan.last_update_s = time.perf_counter() - t1
        else:
            plan.last_update_s = 0.0
        loss = float(loss)  # waits for the device
        return {"stacks": stacks, "opt": opt}, loss, time.perf_counter() - t0

    def loss_and_metrics(self, sess, plan, state, batch):
        from repro_torch.core import raf_spmd

        with torch.no_grad():
            loss = float(raf_spmd.loss_fn(
                plan.plan, state["stacks"], self.stage(sess, plan, batch),
                local_combine=plan.local_combine, kernels=sess.config.kernels))
        return loss, {"loss": loss, "hit_rates": sess.engine.cache.hit_rates()}


# --------------------------------------------------------------------------
# serve — the online inference tier (materialized embeddings, no training)
# --------------------------------------------------------------------------


@register("serve")
class ServeExecutor(Executor):
    """Score batches against the materialized embedding store.

    Not a training executor: ``step``/``step_staged`` raise.  ``build_plan``
    requires :meth:`Heta.infer_all` to have materialized the store;
    ``loss_and_metrics`` answers through the micro-batching
    :class:`~repro_torch.serve.server.EmbeddingServer` (the same NLL as the
    training executors), reporting per-type serve-cache hit rates."""

    def build_plan(self, sess):
        from repro_torch.api.session import HetaStageError

        store = getattr(sess, "embedding_store", None)
        if store is None:
            raise HetaStageError(
                "the 'serve' executor requires materialized embeddings; run "
                "session.infer_all() (after compile+fit with a training "
                "executor) before compile(executor='serve')")
        return SimpleNamespace(server=sess.serve(), store=store)

    def init_state(self, sess, plan):
        return {}

    def stage(self, sess, plan, batch):
        return None

    def step_staged(self, sess, plan, state, batch, arrays):
        from repro_torch.api.session import HetaStageError

        raise HetaStageError(
            "the 'serve' executor is inference-only; train with a training "
            "executor (e.g. raf_spmd), then infer_all() + serve()")

    def loss_and_metrics(self, sess, plan, state, batch):
        res = plan.server.query(batch.seeds)
        logits = res.scores.astype(np.float64)
        logits -= logits.max(axis=-1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
        loss = float(-logp[np.arange(len(batch.seeds)), batch.labels].mean())
        return loss, {"loss": loss, "hit_rates": plan.server.cache.hit_rates(),
                      "latency_ms": res.latency_ms}


def apply_feature_grads(engine, plan, batch, gf: Dict) -> None:
    """Route gradients of the gathered feature arrays back to the learnable
    tables (paper Fig. 3 step 5, via the §6 cache).

    The order is the reference's: per level ``d = 1..k``, ``hfeat{d}`` then
    ``qfeat{d}``.  Every key in ``gf`` counts, including the zero gradients
    of arrays the model does not read (R-GCN's ``qfeat``): each still makes
    a sparse Adam step, which moves rows once their first moment is nonzero
    and advances the table's step counter.  Each gradient is copied to the
    host, where duplicates are summed, as the reference does."""
    learnable = set(engine.learnable_types)
    spec = plan.spec
    k = spec.num_layers
    for d in range(1, k + 1):
        lp = plan.levels[d - 1]
        for key, types, get_ids in (
            (f"hfeat{d}", plan.src_types[d - 1], lambda b: batch.levels[d - 1].nids[b]),
            (
                f"qfeat{d}",
                plan.dst_types[d - 1],
                lambda b: (
                    batch.seeds if d == 1
                    else batch.levels[d - 2].nids[spec.levels[d - 1][b].parent]
                ),
            ),
        ):
            if key not in gf:
                continue
            grad = gf[key].cpu().numpy()  # [P*rb, N, d_pad]
            grad = grad.reshape(plan.num_shards, lp.rb, *grad.shape[1:])
            per_type: Dict[str, list] = {}
            for p in range(plan.num_shards):
                for s in range(lp.rb):
                    b = lp.slot_branch[p, s]
                    if b < 0:
                        continue
                    t = types[b]
                    if t not in learnable:
                        continue
                    dim = engine.learnable_dim
                    per_type.setdefault(t, []).append(
                        (get_ids(b), grad[p, s][:, :dim])
                    )
            for t, chunks in per_type.items():
                ids = np.concatenate([c[0] for c in chunks])
                gr = np.concatenate([c[1] for c in chunks])
                engine.apply_row_grads(t, ids, gr)
