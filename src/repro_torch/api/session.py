"""The ``Heta`` session — explicit pipeline stages on one device.

    sess = Heta(config)                # device=None: the GPU, or NoGPUError
    g      = sess.build_graph()        # HetG (synthetic dataset family)
    part   = sess.partition()          # §5 meta-partitioning -> PartitionReport
    cache  = sess.profile_and_cache()  # §6 hotness/penalty profiling -> CacheReport
    sess.compile()                     # §4 executor plan + parameter stacks
    store  = sess.infer_all()          # layer-wise full-graph inference (§10)
    server = sess.serve()              # micro-batching embedding server
    sess.close_serving()

Calling a stage out of order raises :class:`HetaStageError` with the missing
prerequisite.  ``compile(state=...)`` takes parameter stacks from elsewhere
(``repro_torch.convert.stacks_from_reference``) instead of the port's own
init.  Training (``fit``/``evaluate``), checkpointing, the sampler pool and
the scale-out tier join with later slices of the port; the configuration
sections that drive them are accepted and validated, and the stage that
would need them raises a named error.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.api import executors as _executors
from repro_torch.api.config import HetaConfig
from repro_torch.device import resolve_device

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
        self.stage_times: Dict[str, float] = {}
        # stage products
        self.graph = None
        self.hgnn_cfg = None
        self.feat_dims = None
        self.mp = None
        self.spec = None
        self.assignment = None
        self.meta_local = None
        self.engine = None
        self.executor = None
        self.plan = None
        self.state = None
        # online inference tier (repro_torch.serve)
        self.embedding_store = None
        self._server = None

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
        from repro_torch.graph.synthetic import make_dataset

        t0 = time.perf_counter()
        cfg = self.config
        self.graph = graph if graph is not None else make_dataset(
            cfg.data.dataset, scale=cfg.data.scale, seed=cfg.run.seed)
        self.feat_dims = {
            t: self.graph.feat_dim(t)
            for t in self.graph.num_nodes if self.graph.feat_dim(t)
        }
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

    # -- stage 3: §6 profiling + cache ---------------------------------------

    def profile_and_cache(self) -> CacheReport:
        """Pre-sample hotness, profile miss penalties, allocate the cache."""
        from repro_torch.embed import EmbedEngine, profile_miss_penalties
        from repro_torch.embed.profiler import presample_hotness

        self._require("spec", "partition", "profile_and_cache")
        t0 = time.perf_counter()
        cfg = self.config
        if cfg.pipeline.enabled and cfg.pipeline.num_workers > 0:
            raise NotImplementedError(
                "pipeline.num_workers > 0: the sampler worker pool arrives "
                "with the port's training slice; use num_workers=0")
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
            cache_bytes=cfg.cache.cache_bytes,
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
        """Build the executor plan and its initial state via the registry.

        ``state`` (``{"stacks": ...}``, e.g. from
        :func:`repro_torch.convert.stacks_from_reference`) replaces the
        port's own parameter init; its tensors are moved to the session's
        device."""
        self._require("engine", "profile_and_cache", "compile")
        t0 = time.perf_counter()
        name = executor or self.config.run.executor
        self.executor = _executors.get(name)  # raises KeyError w/ available list
        self.plan = self.executor.build_plan(self)
        if state is None:
            self.state = self.executor.init_state(self, self.plan)
        else:
            self.state = {
                "stacks": {layer: {leaf: v.to(self.device) for leaf, v in entry.items()}
                           for layer, entry in state["stacks"].items()},
            }
        self.stage_times["compile"] = time.perf_counter() - t0
        return self

    # -- stage 5: the online inference tier (repro_torch.serve) ----------------

    def infer_all(self, node_block: Optional[int] = None,
                  shm: Optional[bool] = None):
        """Materialize top-layer embeddings for every node of every type via
        layer-wise full-graph inference (DESIGN.md §10), from the SPMD
        stacks.  ``node_block``/``shm`` default to ``ServeConfig``.
        Returns (and parks on the session) the
        :class:`~repro_torch.serve.full_graph.EmbeddingStore`."""
        from repro_torch.serve.full_graph import infer_all as _infer_all

        self._require("state", "compile", "infer_all")
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
        )
        kw.update(overrides)
        self._server = EmbeddingServer(self.embedding_store, **kw)
        return self._server

    def close_serving(self) -> None:
        """Stop the embedding server and drop the store.  Idempotent."""
        srv, self._server = self._server, None
        if srv is not None:
            srv.close()
        self.embedding_store = None
