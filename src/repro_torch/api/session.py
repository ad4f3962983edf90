"""The ``Heta`` session — explicit pipeline stages on one device.

    sess = Heta(config)                # device=None: the GPU, or NoGPUError
    g      = sess.build_graph()        # HetG (synthetic dataset family)
    part   = sess.partition()          # §5 meta-partitioning -> PartitionReport
    cache  = sess.profile_and_cache()  # §6 hotness/penalty profiling -> CacheReport
    sess.compile()                     # §4 executor plan + parameters + Adam state
    result = sess.fit()                # train; same keys as the reference
    sess.evaluate()                    # held-out loss
    sess.save(dir); sess.restore(dir)  # npz + manifest checkpoints
    store  = sess.infer_all()          # layer-wise full-graph inference (§10)
    server = sess.serve()              # micro-batching embedding server
    sess.close_serving()

Calling a stage out of order raises :class:`HetaStageError` with the missing
prerequisite; ``run()`` executes whatever stages remain and then ``fit()``.
``comm_report()`` (after ``partition()``) gives the §4 per-batch byte
accounting of the execution models.  ``compile(state=...)`` takes parameter
stacks (``raf_spmd``) or a dict-form bundle (``vanilla``, ``raf``) from
elsewhere (``repro_torch.convert``) instead of the port's own init.

With ``pipeline.enabled``, ``fit`` and ``evaluate`` overlap host sampling
and staging with the device step (``repro_torch.data``, DESIGN.md §9/§11):
in one producer thread, or in ``pipeline.num_workers`` spawned sampler
processes over a shared-memory graph store and batch arena, supervised as
DESIGN.md §12 says (``fault_plan`` schedules faults for drills).  The
data-parallel scale-out tier (``scale.enabled``) is a later slice of the
port, and asking for it raises ``NotImplementedError``.
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import json
import os
import re
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.api import executors as _executors
from repro_torch.api.config import HetaConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adam import AdamConfig, adam_init, tree_leaves, tree_map

__all__ = ["Heta", "HetaStageError", "PartitionReport", "CacheReport"]


class HetaStageError(RuntimeError):
    """A lifecycle method was called before its prerequisite stage."""


@dataclasses.dataclass
class PartitionReport:
    """Inspectable result of the §5 partitioning stage."""

    summary: str
    meta_local: bool
    num_partitions: int
    metatree: object  # MetaTreeNode (render() for the figure-style tree)
    mp: object  # MetaPartitioning
    spec: object  # SampleSpec
    assignment: object  # BranchAssignment (pre-fold)

    def raf_bytes(self, batch_size: int, hidden: int, bytes_per_elem: int = 2,
                  style: str = "designated") -> int:
        """Per-batch RAF exchange bytes under this assignment (paper §4)."""
        from repro_torch.core.raf import raf_comm_bytes

        return raf_comm_bytes(self.spec, self.assignment, batch_size, hidden,
                              bytes_per_elem, style=style)


@dataclasses.dataclass
class CacheReport:
    """Inspectable result of the §6 profiling + cache-allocation stage."""

    allocation_rows: Dict[str, int]
    learnable_types: Dict[str, int]
    hotness: object  # HotnessProfile
    penalties: object  # MissPenaltyProfile
    engine: object  # EmbedEngine


class Heta:
    """Session over one :class:`HetaConfig` on one device (see module
    docstring).  ``device=None`` means the GPU; pass ``device="cpu"`` to run
    the plain PyTorch path on the CPU."""

    def __init__(self, config: Optional[HetaConfig] = None, *, device=None,
                 **sections):
        if config is None:
            config = HetaConfig().updated(**sections) if sections else HetaConfig()
        elif sections:
            config = config.updated(**sections)
        self.config = config
        self.device = resolve_device(device)
        # one optimizer config for the dense stacks and the sparse rows, at
        # the run's learning rate (the engine has no default of its own)
        self.adam_cfg = AdamConfig(lr=config.run.lr)
        self.stage_times: Dict[str, float] = {}
        # stage products
        self.graph = None
        self.hgnn_cfg = None
        self.feat_dims = None
        self.fixed_tables = None
        self.mp = None
        self.spec = None
        self.assignment = None
        self.meta_local = None
        self.engine = None
        self.executor = None
        self.plan = None
        self.state = None
        self.sampler = None
        self.losses: List[float] = []
        self.step_times: List[float] = []  # compute + sparse update, per step
        self.host_times: List[float] = []  # sample + stage, per step
        self.update_times: List[float] = []  # sparse update share of step_times
        # seconds of each pooled "stale" step's republish of the learnable
        # tables into the batch arena (on the consumer, after the step)
        self.republish_times: List[float] = []
        # fit-loop overlap accounting (wall vs serial sum; see results())
        self._fit_wall_s = 0.0
        self._fit_serial_s = 0.0
        self._fit_steps = 0
        self._steps_done = 0
        self._queue_bytes: List[int] = []  # pooled fits: per-item queue size
        # persistent sampler pool:
        # [store, arena, pool, next_global_step, workers]
        # (spawn + shm export amortize across fit() calls; see _acquire_pool)
        self._pool_cache = None
        self._pool_atexit_cb = None
        # online inference tier (repro_torch.serve)
        self.embedding_store = None
        self._server = None
        # deterministic chaos drills (repro_torch.data.faults.FaultPlan, or
        # None): threaded into the training pool's SampleStageTask and the
        # embedding server
        self.fault_plan = None

    # -- stage guards --------------------------------------------------------

    def _require(self, attr: str, stage: str, needed_by: str):
        if getattr(self, attr) is None:
            raise HetaStageError(
                f"{needed_by}() requires the {stage}() stage; "
                f"run session.{stage}() first"
            )

    # -- stage 1: data ------------------------------------------------------

    def build_graph(self, graph=None):
        """Materialize the HetG and the model config derived from it.

        Pass ``graph`` to reuse a pre-built :class:`HetGraph` instead of
        synthesizing from ``DataConfig``."""
        from repro_torch.graph.shm import cleanup_stale_segments
        from repro_torch.graph.synthetic import make_dataset

        t0 = time.perf_counter()
        # shm janitor (DESIGN.md §12): a hard-crashed earlier run can leave
        # orphaned graph/arena segments; sweep the port's whose owner pid is
        # gone before allocating new ones (the reference also sweeps its
        # on-disk mmap stores here, which the port does not have yet)
        try:
            cleanup_stale_segments()
        except OSError:
            pass  # best-effort: /dev/shm may be absent on this platform
        cfg = self.config
        self.graph = graph if graph is not None else make_dataset(
            cfg.data.dataset, scale=cfg.data.scale, seed=cfg.run.seed)
        self.feat_dims = {
            t: self.graph.feat_dim(t)
            for t in self.graph.num_nodes if self.graph.feat_dim(t)
        }
        # the fixed features on the device, read by the dense executors
        self.fixed_tables = {t: torch.from_numpy(np.ascontiguousarray(f)).to(self.device)
                             for t, f in self.graph.features.items()}
        self.hgnn_cfg = cfg.model.to_hgnn_config(cfg.num_layers, self.graph.num_classes)
        self.stage_times["build_graph"] = time.perf_counter() - t0
        return self.graph

    # -- stage 2: §5 meta-partitioning ---------------------------------------

    def partition(self) -> PartitionReport:
        """Meta-partition the graph and place relation branches."""
        from repro_torch.core.meta_partition import meta_partition
        from repro_torch.core.raf import assign_branches, random_branch_assignment
        from repro_torch.graph.sampler import SampleSpec

        self._require("graph", "build_graph", "partition")
        t0 = time.perf_counter()
        cfg = self.config
        self.mp = meta_partition(self.graph, cfg.partition.num_partitions,
                                 num_layers=cfg.num_layers)
        self.spec = SampleSpec.from_metatree(self.mp.metatree, cfg.data.fanouts)
        self.assignment = (
            random_branch_assignment(self.spec, cfg.partition.num_partitions,
                                     seed=cfg.run.seed)
            if cfg.partition.placement == "naive"
            else assign_branches(self.spec, self.mp)
        )
        self.meta_local = self.assignment.meta_local
        self.stage_times["partition"] = time.perf_counter() - t0
        return PartitionReport(
            summary=self.mp.summary(),
            meta_local=self.meta_local,
            num_partitions=cfg.partition.num_partitions,
            metatree=self.mp.metatree,
            mp=self.mp,
            spec=self.spec,
            assignment=self.assignment,
        )

    def comm_report(self, bytes_per_elem: int = 2, hidden: Optional[int] = None,
                    include_topology: bool = True) -> Dict[str, int]:
        """Per-batch communication accounting of the three execution models
        (the paper's §4 worked example: 92.3 -> 8.0 -> 0.5 MB), the
        reference's integers.

        Returns bytes for ``vanilla_feat`` (edge-cut feature fetching),
        ``vanilla_update`` (remote learnable-row read + write), ``raf_naive``
        (RAF, random placement) and ``raf_meta`` (RAF under the §5 meta
        placement, computed from ``assign_branches`` even when this
        session's placement is naive).  With ``scale.num_trainers > 1`` or an
        explicit ``scale.hierarchy``, the ``hier_*`` keys of
        :func:`repro_torch.core.comm.hierarchical_comm_bytes` ride along;
        their gradient bytes are those of the compiled parameters."""
        from repro_torch.core.comm import vanilla_comm_bytes, vanilla_update_bytes
        from repro_torch.core.meta_partition import random_edge_cut
        from repro_torch.core.raf import (assign_branches, raf_comm_bytes,
                                          random_branch_assignment)
        from repro_torch.graph.sampler import NeighborSampler

        self._require("spec", "partition", "comm_report")
        cfg = self.config
        B = cfg.data.batch_size
        h = hidden or cfg.model.hidden
        P = cfg.partition.num_partitions
        seed = cfg.run.seed
        batch = NeighborSampler(self.graph, self.spec, B, seed=seed).sample_batch(
            self.graph.train_nodes[:B])
        cut = random_edge_cut(self.graph, P, seed=seed)
        ld = cfg.model.learnable_dim
        out = {
            "vanilla_feat": vanilla_comm_bytes(
                batch, cut, self.feat_dims, learnable_dim=ld,
                bytes_per_elem=bytes_per_elem, include_topology=include_topology),
            "vanilla_update": vanilla_update_bytes(
                batch, cut, self.graph, learnable_dim=ld, bytes_per_elem=bytes_per_elem),
            "raf_naive": raf_comm_bytes(
                self.spec, random_branch_assignment(self.spec, P, seed=seed + 1),
                B, h, bytes_per_elem),
            "raf_meta": raf_comm_bytes(
                self.spec,
                self.assignment if self.meta_local else assign_branches(self.spec, self.mp),
                B, h, bytes_per_elem),
        }
        sc = cfg.scale
        if sc.enabled or sc.hierarchy is not None:
            from repro_torch.core.comm import hierarchical_comm_bytes
            from repro_torch.core.meta_partition import hierarchical_partition

            g, s = sc.resolved_hierarchy
            hier = hierarchical_partition(self.graph, g, s, num_layers=cfg.num_layers,
                                          seed=seed)
            grad_bytes = 0
            if isinstance(self.state, dict):
                # the data-parallel all-reduce moves one gradient set (= the
                # parameters' bytes)
                params = self.state.get("stacks") or self.state.get("bundle")
                if params is not None:
                    grad_bytes = int(sum(leaf.numel() * leaf.element_size()
                                         for leaf in tree_leaves(params)))
            rep = hierarchical_comm_bytes(
                batch, hier, h, feat_dims=self.feat_dims, learnable_dim=ld,
                bytes_per_elem=bytes_per_elem, grad_bytes=grad_bytes)
            out.update({f"hier_{k}": int(v) for k, v in rep.items()})
        return out

    # -- stage 3: §6 profiling + cache ---------------------------------------

    def profile_and_cache(self) -> CacheReport:
        """Pre-sample hotness, profile miss penalties, allocate the cache.

        With ``pipeline.num_workers > 0`` the §6 pre-sampling epoch — the
        same ``batch_at`` sweep the training pool runs — fans out over a
        worker pool (bit-identical counts; visit counting is an
        order-independent sum)."""
        from repro_torch.embed import EmbedEngine, profile_miss_penalties
        from repro_torch.embed.profiler import presample_hotness, presample_hotness_pooled

        self._require("spec", "partition", "profile_and_cache")
        t0 = time.perf_counter()
        cfg = self.config
        if cfg.pipeline.enabled and cfg.pipeline.num_workers > 0:
            hotness = presample_hotness_pooled(
                self.graph, self.spec, cfg.data.batch_size,
                num_workers=cfg.pipeline.num_workers,
                epochs=cfg.cache.presample_epochs,
                max_batches=cfg.cache.presample_max_batches,
                seed=cfg.run.seed, depth=cfg.pipeline.depth,
            )
        else:
            hotness = presample_hotness(
                self.graph, self.spec, cfg.data.batch_size,
                epochs=cfg.cache.presample_epochs,
                max_batches=cfg.cache.presample_max_batches, seed=cfg.run.seed,
            )
        penalties = profile_miss_penalties(
            self.graph, learnable_dim=cfg.model.learnable_dim,
            measured=cfg.cache.measured_penalties, device=self.device,
        )
        self.engine = EmbedEngine(
            self.graph, cfg.model.learnable_dim, hotness, penalties,
            cache_bytes=cfg.cache.cache_bytes, adam=self.adam_cfg,
            hotness_only=cfg.cache.hotness_only,
            num_shards=int(np.prod(cfg.run.mesh_shape)), seed=cfg.run.seed,
            kernels=cfg.kernels, device=self.device,
        )
        self.stage_times["profile_and_cache"] = time.perf_counter() - t0
        return CacheReport(
            allocation_rows=dict(self.engine.allocation.rows),
            learnable_types=dict(self.engine.learnable_types),
            hotness=hotness,
            penalties=penalties,
            engine=self.engine,
        )

    # -- stage 4: executor compilation ----------------------------------------

    def compile(self, executor: Optional[str] = None,
                state: Optional[Dict] = None) -> "Heta":
        """Build the executor plan, its initial state and the training
        sampler.

        ``state`` replaces the port's own parameter init: ``{"stacks": ...}``
        for ``raf_spmd`` (e.g. from
        :func:`repro_torch.convert.stacks_from_reference`) or ``{"bundle":
        ...}`` for ``vanilla``/``raf`` (from
        :func:`repro_torch.convert.bundle_from_reference`).  Its tensors are
        moved to the session's device, and Adam state starts at zero."""
        from repro_torch.graph.sampler import NeighborSampler

        self._require("engine", "profile_and_cache", "compile")
        t0 = time.perf_counter()
        name = executor or self.config.run.executor
        self.executor = _executors.get(name)  # raises KeyError w/ available list
        self.plan = self.executor.build_plan(self)
        if state is None:
            self.state = self.executor.init_state(self, self.plan)
        elif "bundle" in state:
            self.state = _executors._bundle_state(
                tree_map(lambda v: v.to(self.device), state["bundle"]))
        else:
            stacks = tree_map(lambda v: v.to(self.device), state["stacks"])
            self.state = {"stacks": stacks, "opt": adam_init(stacks)}
        self.sampler = NeighborSampler(
            self.graph, self.spec, self.config.data.batch_size,
            seed=self.config.run.seed + 1,
        )
        self.stage_times["compile"] = time.perf_counter() - t0
        return self

    # -- stage 5: training / evaluation ---------------------------------------

    def _refuse_scale_out(self, what: str) -> None:
        if self.config.scale.enabled:
            raise NotImplementedError(
                f"{what} with scale.enabled: the data-parallel trainer "
                "(data/dp_trainer.py on torch.distributed) is a later slice of "
                "the port; use scale.num_trainers=1")

    def step(self, batch=None) -> float:
        """One optimization step (samples the next batch when none given).

        Recorded step times come from the executor's timed region — compute
        + sparse update, host staging excluded; host sample + stage time is
        recorded separately in ``host_times``."""
        self._require("state", "compile", "step")
        t0 = time.perf_counter()
        if batch is None:
            batch = self._next_batch()
        if not self._staged_protocol():
            # an executor that overrides only the composed step()
            host_s = time.perf_counter() - t0
            self.state, loss, dt = self.executor.step(self, self.plan, self.state, batch)
            return self._record(loss, dt, host_s)
        arrays = self.executor.stage(self, self.plan, batch)
        return self._consume(batch, arrays, time.perf_counter() - t0)

    def _staged_protocol(self) -> bool:
        """Whether the executor implements the staged-step seam (an executor
        that overrides only the composed ``step`` keeps working on the
        serial path)."""
        return type(self.executor).stage is not _executors.Executor.stage

    def _consume(self, batch, arrays, host_s: float) -> float:
        """Run the device step on staged arrays and record the books."""
        self.state, loss, dt = self.executor.step_staged(
            self, self.plan, self.state, batch, arrays)
        return self._record(loss, dt, host_s)

    def _record(self, loss: float, dt: float, host_s: float) -> float:
        """The books of one consumed step, then re-admission and
        checkpointing when they are due."""
        self.host_times.append(host_s)
        self.step_times.append(dt)
        self.update_times.append(float(getattr(self.plan, "last_update_s", 0.0)))
        self.losses.append(loss)
        self._steps_done += 1
        self._maybe_rebalance()
        self._maybe_checkpoint()
        return loss

    def _maybe_rebalance(self) -> None:
        """Online §6 re-admission: every ``cache.readmit_every`` consumed
        steps, re-score cache residency from the observed access trace
        (``EmbedEngine.rebalance``)."""
        every = self.config.cache.readmit_every
        if every > 0 and self.engine is not None and self._steps_done % every == 0:
            self.engine.rebalance()

    def fit(self, steps: Optional[int] = None) -> Dict:
        """Train for ``steps`` (default ``RunConfig.steps``); returns
        :meth:`results`.

        With ``pipeline.enabled`` the loop is driven by a
        :class:`repro_torch.data.SampleStream`: sampling + staging for batch
        *i+1* runs in the background while batch *i* trains, under the
        configured snapshot staleness policy — in one producer thread by
        default, or in ``pipeline.num_workers`` sampler processes over a
        shared-memory graph store (DESIGN.md §9), batches flowing through
        the zero-pickle batch arena (DESIGN.md §11) unless
        ``pipeline.arena`` is off.  The pool + store + arena persist across
        consecutive ``fit()`` calls (see :meth:`close_pipeline`) and are
        torn down on error.  Batches are bit-identical to the serial path
        for any worker count (per-batch RNG); losses are bit-identical too
        except under ``snapshot="stale"`` with learnable tables, where
        staging reads tables at most the queue or ring depth behind."""
        self._require("state", "compile", "fit")
        steps = self.config.run.steps if steps is None else steps
        if steps:
            self._refuse_scale_out("fit")
        log_every = self.config.run.log_every

        def logged(loss: float) -> None:
            i = self._steps_done - 1
            if log_every and i % log_every == 0:
                print(f"step {i:4d} loss {loss:.4f} "
                      f"({self.step_times[-1]*1e3:.1f} ms)")

        t_wall = time.perf_counter()
        n0 = len(self.step_times)
        if steps and self.config.pipeline.enabled:
            self._pipelined_fit(steps, logged)
        else:
            for _ in range(steps):
                logged(self.step())
        self._fit_wall_s += time.perf_counter() - t_wall
        self._fit_steps += len(self.step_times) - n0
        self._fit_serial_s += sum(self.host_times[n0:]) + sum(self.step_times[n0:])
        return self.results()

    def _pipelined_fit(self, steps: int, logged) -> None:
        """The body of a pipelined :meth:`fit` (the reference's pipelined
        branch of ``fit``)."""
        if not self._staged_protocol():
            raise HetaStageError(
                f"executor {self.executor.name!r} does not implement the "
                "staged-step protocol (stage/step_staged) required by "
                "pipeline.enabled; disable the pipeline or implement it")
        from repro_torch.data.sample_stream import SampleStream

        pcfg = self.config.pipeline
        start = self._steps_done
        defer = (pcfg.snapshot == "fresh"
                 and self.executor.stage_reads_tables(self, self.plan))
        stream_kw = {}
        arena = None
        if pcfg.num_workers > 0:
            pool, arena = self._acquire_pool(start)
            stream_kw = dict(
                num_workers=pcfg.num_workers,
                pool=pool,
                arena=arena,
                spec=self.spec,
                finish_stage=lambda b, host: self.executor.stage_from_host(
                    self, self.plan, b, host),
            )
        # learnable-"stale" worker staging: after every consumed step,
        # republish the updated learnable tables into the arena's seqlock'd
        # region so workers stage batch i+k against tables at most the ring
        # depth behind the trainer (DESIGN.md §11).  On a GPU each republish
        # copies every learnable table's cached rows to the host, on the
        # consumer's critical path; its seconds go to republish_times.
        republish = arena is not None and arena.handle.tables_mutable
        try:
            with SampleStream(
                lambda i: self._batch_for_step(start + i),
                lambda b: self.executor.stage(self, self.plan, b),
                num_steps=steps, depth=pcfg.depth, defer_stage=defer,
                **stream_kw,
            ) as stream:
                for batch, arrays, host_s in stream:
                    logged(self._consume(batch, arrays, host_s))
                    if self._pool_cache is not None and stream_kw:
                        self._pool_cache[3] += 1  # pool stays in sync
                    if republish:
                        t0 = time.perf_counter()
                        arena.publish_tables({
                            t: self.engine.table(t)
                            for t in self.engine.learnable_types
                        })
                        self.republish_times.append(time.perf_counter() - t0)
                self._queue_bytes.extend(stream.queue_bytes)
        except BaseException:
            # a failed pooled fit leaves pool position and _steps_done out
            # of sync (and possibly dead workers): tear down so the next fit
            # starts a fresh, aligned pool
            self.close_pipeline()
            raise

    def evaluate(self, num_batches: int = 1, use_full_graph: bool = False) -> Dict:
        """Mean held-out-batch loss via the executor's eval path (no update).

        With ``pipeline.enabled``, batches are prefetched in the background
        — by a thread, or by ``pipeline.num_workers`` sampler processes over
        a shared-memory graph store (eval staging never trains tables, so
        any producer is bit-exact).

        ``use_full_graph=True`` scores the *same* held-out batches against
        the embeddings :meth:`infer_all` materialized instead of running the
        executor's sampled forward."""
        from repro_torch.graph.sampler import NeighborSampler

        self._require("state", "compile", "evaluate")
        self._refuse_scale_out("evaluate")
        eval_seed = self.config.run.seed + 9999
        sampler = NeighborSampler(
            self.graph, self.spec, self.config.data.batch_size, seed=eval_seed,
        )
        n = min(num_batches, sampler.steps_per_epoch())
        losses, metrics = [], {}
        if use_full_graph:
            self._require("embedding_store", "infer_all",
                          "evaluate(use_full_graph=True)")
            it = sampler.epoch(shuffle=True, seed=eval_seed)
            for _ in range(n):
                b = next(it)
                logits = self.embedding_store.scores(b.seeds).astype(np.float64)
                logits -= logits.max(axis=-1, keepdims=True)
                logp = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
                losses.append(float(-logp[np.arange(len(b.seeds)), b.labels].mean()))
            return {"loss": float(np.mean(losses)),
                    "num_batches": len(losses), "full_graph": True}

        def consume(b):
            loss, m = self.executor.loss_and_metrics(self, self.plan, self.state, b)
            losses.append(loss)
            return m

        pcfg = self.config.pipeline
        if pcfg.enabled and pcfg.num_workers > 0:
            from repro_torch.data.sample_stream import SampleStream
            from repro_torch.data.worker_pool import EpochSchedule, WorkerPool

            store, arena, task = self._pool_task(
                EpochSchedule(eval_seed, sampler.steps_per_epoch()), eval_seed)
            try:
                with WorkerPool(task, num_workers=pcfg.num_workers,
                                depth=pcfg.depth, num_items=n, name="eval-pool",
                                **self._supervision_kw(arena)) as pool:
                    # the stream resolves arena SlotRefs (and passes tuples
                    # through); eval consumes raw batches, so the
                    # consumer-side completion is a no-op
                    with SampleStream(
                        num_steps=n, num_workers=pcfg.num_workers,
                        pool=pool, arena=arena, spec=self.spec,
                        finish_stage=lambda b, host: None,
                    ) as stream:
                        for b, _, _ in stream:
                            metrics = consume(b)
            finally:
                try:
                    store.unlink()
                finally:
                    if arena is not None:
                        arena.unlink()
        elif pcfg.enabled:
            from repro_torch.data.prefetch import Prefetcher

            with Prefetcher(lambda i: sampler.batch_at(i, epoch_seed=eval_seed),
                            depth=pcfg.depth, num_items=n, name="eval-stream") as pf:
                for b in pf:
                    metrics = consume(b)
        else:
            it = sampler.epoch(shuffle=True, seed=eval_seed)
            for _ in range(n):
                metrics = consume(next(it))
        return {"loss": float(np.mean(losses)), "num_batches": len(losses),
                **{k: v for k, v in metrics.items() if k != "loss"}}

    def run(self) -> Dict:
        """Execute whatever stages remain, then ``fit()``."""
        if self.graph is None:
            self.build_graph()
        if self.spec is None:
            self.partition()
        if self.engine is None:
            self.profile_and_cache()
        if self.state is None:
            self.compile()
        return self.fit()

    def results(self) -> Dict:
        """The reference's result dict (plus ``update_time_s``, the median
        sparse-update share of a step)."""
        self._require("engine", "profile_and_cache", "results")
        # the first two steps hold the kernel loads and first launches
        timed = (self.step_times[2:] if len(self.step_times) > 4
                 else self.step_times) or [0.0]
        updates = (self.update_times[2:] if len(self.update_times) > 4
                   else self.update_times) or [0.0]
        # overlap fraction: share of serial host+device work hidden by the
        # pipeline (0 when serial: wall >= host + step by construction)
        serial = self._fit_serial_s
        overlap = max(0.0, 1.0 - self._fit_wall_s / serial) if serial > 0 else 0.0
        # seeds consumed per second of fit() wall time
        samples_per_s = (
            self._fit_steps * self.config.data.batch_size / self._fit_wall_s
            if self._fit_wall_s > 0 else 0.0
        )
        pcfg = self.config.pipeline
        return {
            "losses": list(self.losses),
            "step_time_s": float(np.median(timed)),
            "host_time_s": float(np.median(self.host_times or [0.0])),
            "update_time_s": float(np.median(updates)),
            "setup_s": sum(self.stage_times.values()),
            "pipeline": bool(pcfg.enabled),
            "sampler_workers": pcfg.num_workers if pcfg.enabled else 0,
            "samples_per_s": float(samples_per_s),
            "overlap_fraction": float(overlap),
            # mean pickled bytes per worker→consumer queue item — ~1e2 with
            # the batch arena (SlotRef descriptors), ~1e6 without (ndarrays)
            "queue_bytes_per_step": (
                float(np.mean(self._queue_bytes)) if self._queue_bytes else 0.0),
            "hit_rates": self.engine.cache.hit_rates(),
            "partitioning": self.mp.summary(),
            "meta_local": self.meta_local,
            "cache_allocation": dict(self.engine.allocation.rows),
            "executor": self.executor.name if self.executor else None,
        }

    # -- checkpoint / resume --------------------------------------------------------

    def config_fingerprint(self) -> str:
        """sha256 over the canonical config dict — stamped into every
        checkpoint manifest so :meth:`restore` refuses state trained under
        a different configuration (the reference computes the same)."""
        blob = json.dumps(self.config.to_dict(), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()

    def _ckpt_tree(self) -> Dict:
        """The checkpointable tree: executor state (parameter stacks + Adam),
        learnable tables + Adam rows + step counters, readmission EMA, and
        the cache residency — the reference's keys."""
        snap = self.engine.state_snapshot()
        return {
            "state": self.state,
            "embed": {
                "tables": snap["tables"],
                "m": snap["m"],
                "v": snap["v"],
                "steps": {t: np.int64(s) for t, s in snap["steps"].items()},
                "hotness_ema": snap["hotness_ema"],
                "residency": {t: np.asarray(ids, np.int64)
                              for t, ids in snap["residency"].items()},
            },
        }

    def save(self, directory: Optional[str] = None, name: str = "ckpt") -> str:
        """Atomically checkpoint the full session state at the current step
        (:func:`repro_torch.checkpoint.save_checkpoint`).  The manifest's
        ``extra`` records the config fingerprint and the sampler position,
        so :meth:`restore` resumes the loss trajectory.  ``directory``
        defaults to ``checkpoint.dir``."""
        from repro_torch.checkpoint import save_checkpoint

        self._require("state", "compile", "save")
        directory = directory or self.config.checkpoint.dir
        if directory is None:
            raise ValueError(
                "save() needs a directory (argument or checkpoint.dir config)")
        step = self._steps_done
        epoch_seed, idx = self._schedule().seed_and_index(step)
        extra = {
            "fingerprint": self.config_fingerprint(),
            "steps_done": step,
            "epoch_seed": int(epoch_seed),
            "step_in_epoch": int(idx),
            "seed": int(self.config.run.seed),
        }
        path = save_checkpoint(directory, step, self._ckpt_tree(), name=name, extra=extra)
        self._prune_checkpoints(directory, name)
        return path

    def restore(self, directory: Optional[str] = None,
                step: Optional[int] = None, name: str = "ckpt") -> int:
        """Load a committed checkpoint (the port's or the reference's) and
        position the session at its step.  Runs any missing stages first,
        verifies the config fingerprint and every array's hash
        (:class:`~repro_torch.checkpoint.CheckpointError`), so the next
        ``fit``/``step`` continues the interrupted run.  Returns the step."""
        from repro_torch.checkpoint import (CheckpointError, latest_step,
                                            load_checkpoint, read_manifest)

        directory = directory or self.config.checkpoint.dir
        if directory is None:
            raise ValueError(
                "restore() needs a directory (argument or checkpoint.dir)")
        if step is None:
            step = latest_step(directory, name)
            if step is None:
                raise CheckpointError(
                    f"no committed checkpoint found in {directory!r}")
        if self.graph is None:
            self.build_graph()
        if self.spec is None:
            self.partition()
        if self.engine is None:
            self.profile_and_cache()
        if self.state is None:
            self.compile()
        manifest = read_manifest(directory, step, name)
        extra = manifest.get("extra", {})
        fp = extra.get("fingerprint")
        if fp and fp != self.config_fingerprint():
            raise CheckpointError(
                f"checkpoint at step {step} was written under a different "
                f"HetaConfig (fingerprint {fp[:12]}… != "
                f"{self.config_fingerprint()[:12]}…)")
        template = self._ckpt_tree()
        # residency sets change size across rebalances: their template
        # shapes come from the manifest
        template["embed"]["residency"] = {
            key.split("/", 2)[2]: np.zeros(tuple(manifest["shapes"][key]), np.int64)
            for key in manifest.get("keys", [])
            if key.startswith("embed/residency/")
        }
        tree = load_checkpoint(directory, step, template, name=name)
        self.state = tree["state"]
        emb = tree["embed"]
        self.engine.load_state({
            "tables": emb["tables"],
            "m": emb["m"],
            "v": emb["v"],
            "steps": {t: int(s) for t, s in emb["steps"].items()},
            "hotness_ema": emb["hotness_ema"],
            "residency": emb["residency"],
        })
        self._steps_done = int(extra.get("steps_done", step))
        # the persistent pool (if any) is positioned at the pre-restore
        # step; tear it down so the next fit respawns aligned
        self.close_pipeline()
        return step

    def _maybe_checkpoint(self) -> None:
        """Periodic checkpointing: every ``checkpoint.every_steps`` consumed
        steps, :meth:`save` to ``checkpoint.dir``."""
        c = self.config.checkpoint
        if (c.every_steps > 0 and self._steps_done > 0
                and self._steps_done % c.every_steps == 0):
            self.save(c.dir)

    def _prune_checkpoints(self, directory: str, name: str) -> None:
        """Keep only the newest ``checkpoint.keep`` committed checkpoints
        (0 = keep everything)."""
        keep = self.config.checkpoint.keep
        if keep <= 0:
            return
        steps = sorted(
            int(m.group(1))
            for f in os.listdir(directory)
            if (m := re.fullmatch(rf"{name}_(\d+)\.npz", f))
            and os.path.exists(os.path.join(directory, f + ".json"))
        )
        for s in steps[:-keep]:
            base = os.path.join(directory, f"{name}_{s:08d}.npz")
            for p in (base, base + ".json"):
                try:
                    os.remove(p)
                except OSError:
                    pass

    # -- the training schedule --------------------------------------------------

    def _schedule(self, start_step: int = 0):
        """The epoch schedule of the training loop: epoch ``e`` starts at
        step ``e * steps_per_epoch`` and shuffles with ``run.seed + 2 +
        first_step_of_epoch``, as the reference's."""
        from repro_torch.data.worker_pool import EpochSchedule

        E = self.sampler.steps_per_epoch()
        if E == 0:
            raise ValueError(
                f"batch_size ({self.config.data.batch_size}) exceeds the "
                f"number of train nodes ({len(self.graph.train_nodes)})"
            )
        return EpochSchedule(self.config.run.seed + 2, E, start_step=start_step)

    def _batch_for_step(self, s: int):
        """The training batch of global step ``s`` — a pure function of
        ``(config seed, s)``."""
        epoch_seed, i = self._schedule().seed_and_index(s)
        return self.sampler.batch_at(i, epoch_seed=epoch_seed)

    def _next_batch(self):
        return self._batch_for_step(self._steps_done)

    # -- the sampler worker pool ------------------------------------------------

    def _acquire_pool(self, start_step: int):
        """The persistent sampler pool positioned at ``start_step``.

        Spawning workers and exporting the shm store cost about a second;
        one pool therefore serves consecutive ``fit()`` calls as long as the
        requested start lines up with where the pool's stripe left off
        (tracked in ``_pool_cache``) and the worker count is unchanged.
        Misalignment — a serial ``step()`` in between, a config change, a
        prior failure — tears the old pool down and spawns a fresh one.
        ``close_pipeline()`` (also invoked on fit errors) releases
        everything explicitly; an atexit hook is the fallback."""
        from repro_torch.data.worker_pool import WorkerPool

        pcfg = self.config.pipeline
        if self._pool_cache is not None:
            store, arena, pool, next_step, workers = self._pool_cache
            if (workers == pcfg.num_workers and next_step == start_step
                    and not pool._closed):
                return pool, arena
            self.close_pipeline()
        store, arena, task = self._pool_task(
            self._schedule(start_step), self.config.run.seed + 1,
            recipe=self.executor.worker_stage_recipe(self, self.plan),
            faults=self.fault_plan,
        )
        try:
            pool = WorkerPool(task, num_workers=pcfg.num_workers,
                              depth=pcfg.depth, num_items=None,
                              **self._supervision_kw(arena))
        except BaseException:
            store.unlink()
            if arena is not None:
                arena.unlink()
            raise
        self._pool_cache = [store, arena, pool, start_step, pcfg.num_workers]
        if self._pool_atexit_cb is None:
            # scripts that train and simply exit must not leave the store to
            # the resource tracker's leaked-segment shutdown path (it cleans
            # up, but warns); weakref so the hook never pins the session
            ref = weakref.ref(self)

            def _cleanup(_ref=ref):
                sess = _ref()
                if sess is not None:
                    sess.close_pipeline()

            atexit.register(_cleanup)
            self._pool_atexit_cb = _cleanup
        return pool, arena

    def close_pipeline(self) -> None:
        """Tear down the persistent sampler pool and unlink its shm store
        and arena.  Idempotent; safe to call any time."""
        cb, self._pool_atexit_cb = self._pool_atexit_cb, None
        if cb is not None:
            atexit.unregister(cb)  # don't accumulate dead hooks
        if self._pool_cache is None:
            return
        store, arena, pool, _, _ = self._pool_cache
        self._pool_cache = None
        try:
            pool.close()
        finally:
            try:
                store.unlink()
            finally:
                if arena is not None:
                    arena.unlink()

    def _supervision_kw(self, arena) -> Dict:
        """WorkerPool supervision kwargs from ``FaultConfig`` (DESIGN.md
        §12): restart budget, backoff, and the death hook that poisons the
        dead worker's arena sub-ring so stale ``SlotRef``\\ s fail loudly
        before the replacement replays the stripe."""
        fcfg = self.config.faults
        kw = dict(max_restarts=fcfg.max_worker_restarts,
                  restart_backoff_s=fcfg.worker_backoff_s)
        if arena is not None:
            kw["on_worker_death"] = arena.invalidate_worker_slots
        return kw

    def _pool_task(self, schedule, sampler_seed: int, recipe=None, faults=None):
        """Shared-memory graph store, batch arena and picklable sampling task
        for a worker pool following ``schedule`` (the caller owns both:
        ``_acquire_pool`` parks them in ``_pool_cache``, ``evaluate`` unlinks
        per call).  Staging moves into the workers when the executor
        provides a ``recipe`` — exactly the tables its branches read travel
        with the batch pipeline; with ``recipe=None`` workers sample only.

        With ``pipeline.arena`` (default) batches flow through a fixed-slot
        shm ring buffer (DESIGN.md §11): the tables live in the arena
        segment — seqlock-republishable when learnable tables train under
        the ``"stale"`` policy — and the queues carry only ``SlotRef``
        descriptors.  ``arena=False`` pickles batches through the queues
        (tables exported read-only into the graph store)."""
        from repro_torch.data.staging import arena_fields
        from repro_torch.data.worker_pool import SampleStageTask
        from repro_torch.graph.shm import create_arena, share_graph

        pcfg = self.config.pipeline
        tables = None
        if recipe is not None:
            snapshot = self.engine.tables_snapshot()
            tables = {t: snapshot[t] for t in recipe.table_types()}
        arena = None
        if pcfg.arena:
            store = share_graph(self.graph, include_features=False)
            try:
                probe = self._batch_for_step(0)  # padded shapes: any step works
                mutable = (recipe is not None
                           and bool(getattr(self.plan, "learn_feats", False)))
                arena = create_arena(
                    arena_fields(probe, recipe=recipe, tables=tables),
                    num_workers=pcfg.num_workers, depth=pcfg.depth,
                    tables=tables, tables_mutable=mutable,
                )
            except BaseException:
                store.unlink()
                raise
        else:
            store = share_graph(self.graph, include_features=False, tables=tables)
        task = SampleStageTask(
            handle=store.handle,
            spec=self.spec,
            batch_size=self.config.data.batch_size,
            sampler_seed=sampler_seed,
            schedule=schedule,
            recipe=recipe,
            arena=arena.handle if arena is not None else None,
            faults=faults,
            write_timeout_s=self.config.faults.arena_write_timeout_s,
            pin_cpus=pcfg.pin_workers,
        )
        return store, arena, task

    # -- stage 6: the online inference tier (repro_torch.serve) ----------------

    def infer_all(self, node_block: Optional[int] = None,
                  shm: Optional[bool] = None):
        """Materialize top-layer embeddings for every node of every type via
        layer-wise full-graph inference (DESIGN.md §10), from the SPMD
        stacks.  ``node_block``/``shm`` default to ``ServeConfig``.
        Returns (and parks on the session) the
        :class:`~repro_torch.serve.full_graph.EmbeddingStore`."""
        from repro_torch.serve.full_graph import infer_all as _infer_all

        self._require("state", "compile", "infer_all")
        if not isinstance(self.state, dict) or self.state.get("stacks") is None:
            raise HetaStageError(
                f"infer_all() needs the stacked SPMD plan, but executor "
                f"{self.executor.name!r} does not expose one; "
                "compile(executor='raf_spmd') first")
        t0 = time.perf_counter()
        scfg = self.config.serve
        store = _infer_all(
            self.graph, self.plan.plan, self.state["stacks"],
            self.engine.tables_snapshot(),
            node_block=scfg.node_block if node_block is None else node_block,
            kernels=self.config.kernels,
            shm=scfg.shm if shm is None else shm,
            device=self.device,
        )
        if self.embedding_store is not None:
            self.close_serving()
        self.embedding_store = store
        self.stage_times["infer_all"] = time.perf_counter() - t0
        return store

    def serve(self, **overrides):
        """Start (or return) the micro-batching
        :class:`~repro_torch.serve.server.EmbeddingServer` over the
        materialized store.  Flush policy / cache budget come from
        ``ServeConfig`` (keyword overrides win).  ``close_serving()`` stops
        it."""
        if self._server is not None:
            return self._server
        self._require("embedding_store", "infer_all", "serve")
        from repro_torch.serve.server import EmbeddingServer

        scfg = self.config.serve
        if scfg.production_mesh:
            raise NotImplementedError(
                "serve.production_mesh: multi-GPU serving arrives with the "
                "port's multi-GPU slice; the server runs on the session's device")
        kw = dict(
            max_batch=scfg.max_batch, max_wait_ms=scfg.max_wait_ms,
            max_queue=scfg.max_queue, cache_mb=scfg.cache_mb,
            kernels=self.config.kernels,
            readmit_every=scfg.readmit_every,
            deadline_ms=scfg.deadline_ms,
            flush_retries=scfg.flush_retries,
            retry_backoff_ms=scfg.retry_backoff_ms,
            breaker_threshold=scfg.breaker_threshold,
            breaker_cooldown_ms=scfg.breaker_cooldown_ms,
            faults=self.fault_plan,
        )
        kw.update(overrides)
        self._server = EmbeddingServer(self.embedding_store, **kw)
        return self._server

    def close_serving(self) -> None:
        """Stop the embedding server and release the store (unlinking its
        shm segment when shm-backed).  Idempotent."""
        srv, self._server = self._server, None
        if srv is not None:
            srv.close()
        store, self.embedding_store = self.embedding_store, None
        if store is not None:
            store.close()
