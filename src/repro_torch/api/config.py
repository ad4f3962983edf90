"""HetaConfig — the typed, validated configuration tree of the public API.

The port keeps the reference package's configuration field for field, so a
config dict round-trips between the two packages unchanged; the section
whose machinery belongs to a later slice of the port (scale-out) is
accepted and validated here, and the stage that would use it raises a
named error.

One config object describes a complete Heta run.  It composes eleven
section dataclasses mirroring the pipeline stages:

  * :class:`DataConfig`      — dataset, scale, fanouts, batch size
  * :class:`PartitionConfig` — partition count + relation placement policy
  * :class:`ModelConfig`     — HGNN architecture (wraps ``HGNNConfig``)
  * :class:`CacheConfig`     — miss-penalty cache budget + profiling knobs
  * :class:`RunConfig`       — executor, mesh, steps, lr, seed
  * :class:`PipelineConfig`  — async host pipeline (prefetch depth, snapshot
    staleness policy; see the ``repro.data`` package docstring)
  * :class:`KernelConfig`    — hand-written CUDA kernel layer (per-op
    toggles; the reference's block-size fields, which no launch reads; see
    ``repro_torch.kernels``)
  * :class:`ServeConfig`     — online inference tier (layer-wise inference
    node block, micro-batch flush policy, serve cache budget, degradation
    policy — deadlines, flush retries, circuit breaker; see ``repro.serve``
    and DESIGN.md §10/§12)
  * :class:`CheckpointConfig`— periodic session checkpointing
    (``Heta.save``/``restore``; see ``repro.checkpoint`` and DESIGN.md §12)
  * :class:`FaultConfig`     — fault-tolerance policy (worker restart
    budget/backoff, arena write stall timeout; DESIGN.md §12)
  * :class:`ScaleConfig`     — hierarchical scale-out (trainer process
    count, group hierarchy, store flavor, allreduce overlap; see
    ``repro.data.dp_trainer`` and DESIGN.md §13)

Three interchange formats round-trip losslessly:

  * nested dicts          — ``to_dict()`` / ``from_dict()`` (JSON-friendly)
  * the legacy kwargs blob — ``from_flat_kwargs()`` / ``to_flat_kwargs()``
    (the historical ``train_hgnn(...)`` surface)
  * CLI flags             — ``add_config_args(parser)`` /
    ``config_from_args(args)``; ``python -m repro.launch.train`` flags are
    *derived* from the dataclass fields below, not duplicated by hand.

This module is deliberately torch-free so CLI/arg handling stays cheap.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = [
    "DataConfig",
    "PartitionConfig",
    "ModelConfig",
    "CacheConfig",
    "RunConfig",
    "PipelineConfig",
    "KernelConfig",
    "ServeConfig",
    "CheckpointConfig",
    "FaultConfig",
    "ScaleConfig",
    "HetaConfig",
    "add_config_args",
    "config_from_args",
]

PLACEMENTS = ("meta", "naive")
CACHE_POLICIES = ("miss_penalty", "hotness")
# the built-in relation modules; the authoritative registry is
# ``repro_torch.core.relmod``
HGNN_MODELS = ("rgcn", "rgat", "hgt")
SNAPSHOT_POLICIES = ("stale", "fresh")


def _known_models() -> Tuple[str, ...]:
    """Model names accepted by validation: the relation-module registry when
    it is loaded, else the built-in list.  Consulting ``sys.modules`` (never
    importing) keeps this module torch-free for cheap CLI parsing while letting
    user-registered relation modules pass config validation."""
    import sys

    relmod = sys.modules.get("repro_torch.core.relmod")
    if relmod is not None:
        return tuple(relmod.available_models())
    return HGNN_MODELS


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """What to train on and how to sample it."""

    dataset: str = "ogbn-mag"
    scale: Optional[float] = None  # None = the dataset's default scale
    fanouts: Tuple[int, ...] = (4, 3)  # per-hop fanouts; len == num HGNN layers
    batch_size: int = 32

    def __post_init__(self):
        object.__setattr__(self, "fanouts", tuple(int(f) for f in self.fanouts))
        if not self.fanouts or any(f < 1 for f in self.fanouts):
            raise ValueError(f"fanouts must be non-empty positive ints, got {self.fanouts}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """§5 meta-partitioning: how many partitions, and how relations land."""

    num_partitions: int = 4
    placement: str = "meta"  # meta (Alg. 2) | naive (random, the ablation)

    def __post_init__(self):
        if self.num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got {self.num_partitions}")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, got {self.placement!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """HGNN architecture.  ``num_layers`` / ``num_classes`` are derived from
    the data (fanouts length, graph label count) when the session builds the
    underlying :class:`repro_torch.core.hgnn.HGNNConfig`."""

    model: str = "rgcn"  # any registered relation module (rgcn | rgat | hgt built in)
    hidden: int = 64
    num_heads: int = 4
    learnable_dim: int = 64
    # False freezes the learnable feature tables (no sparse updates) — used
    # by device-compute-only benchmarks and feature-transfer experiments
    train_learnable: bool = True

    def __post_init__(self):
        known = _known_models()
        if self.model not in known:
            raise ValueError(f"model must be one of {known}, got {self.model!r}")
        if self.hidden < 1 or self.hidden % self.num_heads:
            raise ValueError(
                f"hidden ({self.hidden}) must be positive and divisible by "
                f"num_heads ({self.num_heads})"
            )
        if self.learnable_dim < 1:
            raise ValueError(f"learnable_dim must be >= 1, got {self.learnable_dim}")

    def to_hgnn_config(self, num_layers: int, num_classes: int):
        from repro_torch.core.hgnn import HGNNConfig

        return HGNNConfig(
            model=self.model,
            hidden=self.hidden,
            num_layers=num_layers,
            num_heads=self.num_heads,
            num_classes=num_classes,
            learnable_dim=self.learnable_dim,
        )


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """§6 miss-penalty cache + the pre-training profilers that feed it."""

    cache_mb: int = 4
    policy: str = "miss_penalty"  # miss_penalty (Heta) | hotness (GNNLab-style)
    presample_epochs: int = 2
    presample_max_batches: int = 20
    measured_penalties: bool = False  # measure real copies vs analytic model
    # online re-admission: every N training steps, re-score residency from
    # the cache's observed access counters (EmbedEngine.rebalance) under
    # the same byte budget.  0 = one-shot allocation only.
    readmit_every: int = 0

    def __post_init__(self):
        if self.cache_mb < 0:
            raise ValueError(f"cache_mb must be >= 0, got {self.cache_mb}")
        if self.policy not in CACHE_POLICIES:
            raise ValueError(f"policy must be one of {CACHE_POLICIES}, got {self.policy!r}")
        if self.readmit_every < 0:
            raise ValueError(
                f"readmit_every must be >= 0, got {self.readmit_every}")

    @property
    def cache_bytes(self) -> int:
        return self.cache_mb << 20

    @property
    def hotness_only(self) -> bool:
        return self.policy == "hotness"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution: which executor, on what mesh, for how long."""

    executor: str = "raf_spmd"  # a name registered in repro_torch.api.executors
    mesh_shape: Tuple[int, int] = (1, 1)  # (data, model) mesh axes
    steps: int = 20
    lr: float = 5e-3
    seed: int = 0
    log_every: int = 0

    def __post_init__(self):
        object.__setattr__(self, "mesh_shape", tuple(int(x) for x in self.mesh_shape))
        if len(self.mesh_shape) != 2 or any(x < 1 for x in self.mesh_shape):
            raise ValueError(f"mesh_shape must be 2 positive ints, got {self.mesh_shape}")
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0, got {self.steps}")
        if self.lr <= 0:
            raise ValueError(f"lr must be > 0, got {self.lr}")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Async host pipeline: overlap sampling + feature staging with the
    device step (see the ``repro.data`` package docstring for the design
    and the staleness semantics of ``snapshot``).

    ``num_workers`` selects the producer: 0 (default) keeps the single
    background thread; N > 0 runs a pool of N sampler *processes* over a
    shared-memory graph store (``repro.data.worker_pool``, DESIGN.md §9) —
    bit-identical batches for any worker count, ``depth`` prefetched items
    per worker.

    ``arena`` (pool mode only) moves batch payloads off the queues into a
    fixed-slot shared-memory ring buffer (the batch arena, DESIGN.md §11):
    workers write sampled + pre-staged arrays straight into seqlock-stamped
    slots and the queues carry only slot descriptors — zero pickled
    ndarrays on the hot path.  With the arena and ``snapshot="stale"``,
    learnable-table staging runs *inside* workers against bounded-stale
    table snapshots republished each step (staleness ≤ ring depth); with
    ``snapshot="fresh"`` (or ``arena=False``) learnable staging stays on
    the consumer and is bit-exact."""

    enabled: bool = False
    depth: int = 2  # prefetched batches kept ready ahead of the device step
    snapshot: str = "stale"  # stale (max overlap) | fresh (bit-exact staging)
    num_workers: int = 0  # 0 = thread producer; N > 0 = sampler process pool
    arena: bool = True  # pool mode: shm ring-buffer slots, descriptor queues
    # opt-in CPU-affinity pin: sampler worker w sticks to core (w+1) % ncpu,
    # biasing core 0 toward the consumer (best-effort; Linux only)
    pin_workers: bool = False

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if self.snapshot not in SNAPSHOT_POLICIES:
            raise ValueError(
                f"snapshot must be one of {SNAPSHOT_POLICIES}, got {self.snapshot!r}"
            )
        if self.num_workers < 0:
            raise ValueError(
                f"num_workers must be >= 0, got {self.num_workers}"
            )
        if self.num_workers > 0 and not self.enabled:
            raise ValueError(
                "pipeline.num_workers > 0 requires pipeline.enabled "
                "(pass --pipeline / pipeline=dict(enabled=True, ...)); a "
                "worker pool only exists inside the async host pipeline"
            )


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Hand-written CUDA kernel layer (``repro_torch.kernels``).

    ``enabled`` gates the whole layer; the per-op toggles select individual
    kernels (``stacked_agg`` — the SPMD executor's stacked relation
    aggregation; ``relation_agg`` — the unstacked dict-form variant;
    ``gather`` — the cache-fetch row gather).  Backend policy lives in
    ``repro_torch.kernels.ops.kernel_choice``: an enabled op launches its
    kernel on a CUDA tensor (or raises) and runs its plain PyTorch version
    on a CPU tensor.  There is no interpreter, so ``interpret=True`` raises.

    ``fuse_epilogue`` (R-GAT, HGT) selects the fused attention kernels
    (``stacked_attn_epilogue`` and its backward) when on; off, the
    ``attn_parts`` factoring runs the projections in torch ops and the
    masked softmax + combine through ``stacked_softmax_combine``.
    ``relation_agg`` routes the dict-form ``raf`` executor's R-GCN
    aggregation through its kernel.  ``block_n`` / ``block_out`` /
    ``block_in`` are the reference's fields, validated and kept so that
    configurations round-trip between the packages, but no CUDA launch
    reads them: every kernel of the port has a fixed tile (kernels 1 and 5
    pick their rows per block from the shape, kernel 4 from the fanout).
    There is no tuning table,
    so ``autotune=True`` raises
    (``repro_torch.kernels.ops.refuse_autotune``).
    """

    enabled: bool = True
    stacked_agg: bool = True
    relation_agg: bool = True
    gather: bool = True
    interpret: Optional[bool] = None  # None = auto per backend
    fuse_epilogue: bool = True
    autotune: bool = False  # the reference's tuning table; True raises here
    block_n: Optional[int] = None  # the reference's node block; no launch reads it
    block_out: Optional[int] = None  # the reference's d_out block; no launch reads it
    block_in: Optional[int] = None  # the reference's d_in chunk; no launch reads it

    def __post_init__(self):
        for f in ("enabled", "stacked_agg", "relation_agg", "gather",
                  "fuse_epilogue", "autotune"):
            if not isinstance(getattr(self, f), bool):
                raise ValueError(f"kernels.{f} must be a bool")
        if self.interpret is not None and not isinstance(self.interpret, bool):
            raise ValueError("kernels.interpret must be True, False or None")
        for f in ("block_n", "block_out", "block_in"):
            v = getattr(self, f)
            if v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                raise ValueError(
                    f"kernels.{f} must be a positive int or None, got {v!r}"
                )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Online inference tier (``repro_torch.serve``, DESIGN.md §10).

    ``node_block`` chunks the layer-wise full-graph inference sweep;
    ``max_batch`` / ``max_wait_ms`` / ``max_queue`` are the micro-batcher's
    flush-and-backpressure policy; ``cache_mb`` budgets the serve-side
    ``FeatureCache`` over the materialized embeddings; ``shm`` backs the
    embedding store with a shared-memory segment for zero-copy attach;
    ``production_mesh`` places the scoring step on ``make_production_mesh``
    (256 devices) instead of the run's mesh; ``readmit_every`` re-admits
    the serve cache from the served-id trace every N flushes (0 = off).

    Degradation policy (DESIGN.md §12): ``deadline_ms`` is the default
    per-request deadline (0 = none) — ``query`` waits at most this long and
    the flusher stops retrying once the oldest queued request would blow
    it; a failing flush is retried ``flush_retries`` times with exponential
    backoff from ``retry_backoff_ms``; ``breaker_threshold`` consecutive
    primary-path failures trip a circuit breaker that serves requests from
    a degraded direct-store gather (cache bypass) until a probe succeeds
    after ``breaker_cooldown_ms``."""

    node_block: int = 1024
    max_batch: int = 64
    max_wait_ms: float = 2.0
    max_queue: int = 1024
    cache_mb: int = 4
    shm: bool = False
    production_mesh: bool = False
    readmit_every: int = 0
    deadline_ms: float = 0.0
    flush_retries: int = 2
    retry_backoff_ms: float = 1.0
    breaker_threshold: int = 3
    breaker_cooldown_ms: float = 1000.0

    def __post_init__(self):
        if self.node_block < 1:
            raise ValueError(f"node_block must be >= 1, got {self.node_block}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.max_queue < self.max_batch:
            raise ValueError(
                f"max_queue ({self.max_queue}) must be >= max_batch "
                f"({self.max_batch})"
            )
        if self.cache_mb < 0:
            raise ValueError(f"cache_mb must be >= 0, got {self.cache_mb}")
        if self.readmit_every < 0:
            raise ValueError(
                f"readmit_every must be >= 0, got {self.readmit_every}")
        if self.deadline_ms < 0:
            raise ValueError(
                f"deadline_ms must be >= 0, got {self.deadline_ms}")
        if self.flush_retries < 0:
            raise ValueError(
                f"flush_retries must be >= 0, got {self.flush_retries}")
        if self.retry_backoff_ms < 0:
            raise ValueError(
                f"retry_backoff_ms must be >= 0, got {self.retry_backoff_ms}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}")
        if self.breaker_cooldown_ms < 0:
            raise ValueError(
                f"breaker_cooldown_ms must be >= 0, got "
                f"{self.breaker_cooldown_ms}")


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Periodic session checkpointing (``repro_torch.checkpoint``, DESIGN.md §12).

    With ``every_steps > 0`` the fit loop calls ``Heta.save(dir)`` after
    every N consumed steps; checkpoints are written atomically (tmp +
    rename, content-hashed manifest) and ``Heta.restore(dir)`` resumes the
    loss trajectory bit-for-bit.  ``keep`` prunes all but the newest K
    checkpoints (0 = keep everything)."""

    every_steps: int = 0
    dir: Optional[str] = None
    keep: int = 0

    def __post_init__(self):
        if self.every_steps < 0:
            raise ValueError(
                f"every_steps must be >= 0, got {self.every_steps}")
        if self.keep < 0:
            raise ValueError(f"keep must be >= 0, got {self.keep}")
        if self.every_steps > 0 and not self.dir:
            raise ValueError(
                "checkpoint.every_steps > 0 requires checkpoint.dir")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-tolerance policy (DESIGN.md §12).

    ``max_worker_restarts`` bounds how many times the pool supervisor
    respawns a silently-dead sampler worker per fit (0 disables respawn —
    a death raises :class:`~repro.data.worker_pool.WorkerDiedError`
    immediately); respawn ``r`` backs off ``worker_backoff_s * 2**r``
    seconds first.  ``arena_write_timeout_s`` bounds the batch-arena
    writer's backpressure poll: a worker whose consumer vanished raises
    ``ArenaStalledError`` instead of spinning forever."""

    max_worker_restarts: int = 2
    worker_backoff_s: float = 0.05
    arena_write_timeout_s: float = 60.0

    def __post_init__(self):
        if self.max_worker_restarts < 0:
            raise ValueError(
                f"max_worker_restarts must be >= 0, got "
                f"{self.max_worker_restarts}")
        if self.worker_backoff_s < 0:
            raise ValueError(
                f"worker_backoff_s must be >= 0, got {self.worker_backoff_s}")
        if self.arena_write_timeout_s <= 0:
            raise ValueError(
                f"arena_write_timeout_s must be > 0, got "
                f"{self.arena_write_timeout_s}")


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """Hierarchical scale-out (``repro.data.dp_trainer``, DESIGN.md §13).

    ``num_trainers`` spawns that many data-parallel trainer processes in
    ``Heta.fit`` (1 = today's in-process loop, no spawn).  Each trainer
    owns one edge-cut sub-partition of a *shared* graph store, samples its
    own seed slice locally, and synchronizes gradients through a shm
    all-reduce folded into the ``sync_stack_grads`` discipline.

    ``hierarchy`` is the two-level layout ``(groups, trainers_per_group)``
    of :func:`repro.core.meta_partition.hierarchical_partition` — schema-
    level meta-partitioning across groups, greedy edge-cut within.  The
    default ``None`` resolves to ``(1, num_trainers)``; when given, the
    product must equal ``num_trainers``.

    ``store`` picks the shared-store flavor trainers attach: ``"shm"``
    (``/dev/shm`` segment, RAM-resident) or ``"mmap"`` (on-disk
    memory-mapped store, out-of-core).  ``overlap`` keeps the gradient
    all-reduce overlapped against the next batch's host sampling
    (scale-out adds bandwidth, not a barrier); off, trainers synchronize
    at a barrier each step (debugging aid).

    ``mode`` selects the data-parallel discipline (DESIGN.md §13):

    * ``"global"`` (default) — trainers stripe-own the *global* batch
      schedule (trainer ``r`` computes steps ``r, r+N, …`` with the fused
      train step and publishes the updated state through the shm
      exchange); the loss trajectory is **bit-identical** to the
      single-process fit.
    * ``"local"`` — each trainer draws sub-batches from the train nodes
      its hierarchy sub-partition owns; raw stack gradients are summed
      across trainers in fixed rank order, then ``sync_stack_grads`` +
      Adam run on the sum.  Deterministic and bit-identical *across
      trainers*, but a different (equally valid) trajectory from the
      single-process schedule."""

    num_trainers: int = 1
    hierarchy: Optional[Tuple[int, int]] = None  # (groups, trainers_per_group)
    store: str = "shm"  # shm (RAM segment) | mmap (out-of-core store)
    overlap: bool = True
    mode: str = "global"  # global (stripe, single-process-identical) | local

    def __post_init__(self):
        if self.num_trainers < 1:
            raise ValueError(
                f"num_trainers must be >= 1, got {self.num_trainers}")
        if self.hierarchy is not None:
            object.__setattr__(
                self, "hierarchy", tuple(int(x) for x in self.hierarchy))
            if len(self.hierarchy) != 2 or any(x < 1 for x in self.hierarchy):
                raise ValueError(
                    f"hierarchy must be 2 positive ints (groups, "
                    f"trainers_per_group), got {self.hierarchy}")
            g, s = self.hierarchy
            if g * s != self.num_trainers:
                raise ValueError(
                    f"hierarchy {g}x{s} must multiply to num_trainers "
                    f"({self.num_trainers})")
        if self.store not in ("shm", "mmap"):
            raise ValueError(
                f"store must be 'shm' or 'mmap', got {self.store!r}")
        if self.mode not in ("global", "local"):
            raise ValueError(
                f"mode must be 'global' or 'local', got {self.mode!r}")

    @property
    def resolved_hierarchy(self) -> Tuple[int, int]:
        """(groups, trainers_per_group); default = one flat group."""
        return self.hierarchy or (1, self.num_trainers)

    @property
    def enabled(self) -> bool:
        return self.num_trainers > 1


@dataclasses.dataclass(frozen=True)
class HetaConfig:
    """The full run description; the single argument of :class:`repro_torch.api.Heta`."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    partition: PartitionConfig = dataclasses.field(default_factory=PartitionConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    kernels: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    scale: ScaleConfig = dataclasses.field(default_factory=ScaleConfig)

    SECTIONS = ("data", "partition", "model", "cache", "run", "pipeline",
                "kernels", "serve", "checkpoint", "faults", "scale")

    # -- derived ------------------------------------------------------------

    @property
    def num_layers(self) -> int:
        return len(self.data.fanouts)

    # -- functional updates --------------------------------------------------

    def updated(self, **sections: Dict[str, Any]) -> "HetaConfig":
        """Replace fields inside sections: ``cfg.updated(run=dict(steps=5))``."""
        repl = {}
        for name, kw in sections.items():
            if name not in self.SECTIONS:
                raise TypeError(f"unknown config section {name!r}; sections: {self.SECTIONS}")
            repl[name] = dataclasses.replace(getattr(self, name), **kw)
        return dataclasses.replace(self, **repl)

    def with_executor(self, name: str) -> "HetaConfig":
        """The one-liner benchmarks use to sweep the executor registry."""
        return self.updated(run=dict(executor=name))

    # -- dict round-trip ------------------------------------------------------

    def to_dict(self) -> Dict[str, Dict[str, Any]]:
        d = dataclasses.asdict(self)
        for sec in d.values():
            for k, v in sec.items():
                if isinstance(v, tuple):
                    sec[k] = list(v)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Dict[str, Any]]) -> "HetaConfig":
        sections = {}
        for name, sec in d.items():
            if name not in cls.SECTIONS:
                raise TypeError(f"unknown config section {name!r}; sections: {cls.SECTIONS}")
            sec_cls = {"data": DataConfig, "partition": PartitionConfig,
                       "model": ModelConfig, "cache": CacheConfig,
                       "run": RunConfig, "pipeline": PipelineConfig,
                       "kernels": KernelConfig, "serve": ServeConfig,
                       "checkpoint": CheckpointConfig,
                       "faults": FaultConfig, "scale": ScaleConfig}[name]
            known = {f.name for f in dataclasses.fields(sec_cls)}
            bad = set(sec) - known
            if bad:
                raise TypeError(f"unknown {name} config fields: {sorted(bad)}")
            sections[name] = sec_cls(**sec)
        return cls(**sections)

    # -- the legacy train_hgnn kwargs blob ------------------------------------

    @classmethod
    def from_flat_kwargs(cls, **kwargs: Any) -> "HetaConfig":
        """Build a config from the historical ``train_hgnn(...)`` keyword
        surface (plus ``executor=``/``placement=``).  Unknown keys raise."""
        sections: Dict[str, Dict[str, Any]] = {s: {} for s in cls.SECTIONS}
        for key, value in kwargs.items():
            if key not in _FLAT_MAP:
                raise TypeError(
                    f"unknown train_hgnn kwarg {key!r}; known: {sorted(_FLAT_MAP)}"
                )
            section, field, to_cfg, _ = _FLAT_MAP[key]
            sections[section][field] = to_cfg(value)
        return cls().updated(**{s: kw for s, kw in sections.items() if kw})

    def to_flat_kwargs(self) -> Dict[str, Any]:
        """Inverse of :meth:`from_flat_kwargs` (lossless round-trip)."""
        out = {}
        for key, (section, field, _, to_flat) in _FLAT_MAP.items():
            out[key] = to_flat(getattr(getattr(self, section), field))
        return out


def _parse_fanouts(s) -> Tuple[int, ...]:
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    return tuple(int(x) for x in str(s).split(","))


def _parse_mesh(s) -> Tuple[int, int]:
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    return tuple(int(x) for x in str(s).lower().split("x"))


_FLAT_MAP: Dict[str, Tuple[str, str, Callable, Callable]] = {
    "dataset": ("data", "dataset", str, str),
    "scale": ("data", "scale", lambda v: v, lambda v: v),
    "fanouts": ("data", "fanouts", _parse_fanouts, tuple),
    "batch_size": ("data", "batch_size", int, int),
    "num_partitions": ("partition", "num_partitions", int, int),
    "naive_placement": (
        "partition", "placement",
        lambda v: "naive" if v else "meta", lambda v: v == "naive",
    ),
    "model": ("model", "model", str, str),
    "hidden": ("model", "hidden", int, int),
    "num_heads": ("model", "num_heads", int, int),
    "learnable_dim": ("model", "learnable_dim", int, int),
    "train_learnable": ("model", "train_learnable", bool, bool),
    "cache_mb": ("cache", "cache_mb", int, int),
    "hotness_only": (
        "cache", "policy",
        lambda v: "hotness" if v else "miss_penalty", lambda v: v == "hotness",
    ),
    "presample_epochs": ("cache", "presample_epochs", int, int),
    "presample_max_batches": ("cache", "presample_max_batches", int, int),
    "measured_penalties": ("cache", "measured_penalties", bool, bool),
    "readmit_every": ("cache", "readmit_every", int, int),
    "executor": ("run", "executor", str, str),
    "mesh_shape": ("run", "mesh_shape", _parse_mesh, tuple),
    "steps": ("run", "steps", int, int),
    "lr": ("run", "lr", float, float),
    "seed": ("run", "seed", int, int),
    "log_every": ("run", "log_every", int, int),
    "pipeline": ("pipeline", "enabled", bool, bool),
    "prefetch_depth": ("pipeline", "depth", int, int),
    "snapshot_policy": ("pipeline", "snapshot", str, str),
    "num_workers": ("pipeline", "num_workers", int, int),
    "batch_arena": ("pipeline", "arena", bool, bool),
    "pin_workers": ("pipeline", "pin_workers", bool, bool),
    "kernels": ("kernels", "enabled", bool, bool),
    "kernel_stacked_agg": ("kernels", "stacked_agg", bool, bool),
    "kernel_relation_agg": ("kernels", "relation_agg", bool, bool),
    "kernel_gather": ("kernels", "gather", bool, bool),
    "kernel_interpret": ("kernels", "interpret", lambda v: v, lambda v: v),
    "kernel_fuse_epilogue": ("kernels", "fuse_epilogue", bool, bool),
    "kernel_autotune": ("kernels", "autotune", bool, bool),
    "kernel_block_n": ("kernels", "block_n", lambda v: v, lambda v: v),
    "kernel_block_out": ("kernels", "block_out", lambda v: v, lambda v: v),
    "kernel_block_in": ("kernels", "block_in", lambda v: v, lambda v: v),
    "serve_node_block": ("serve", "node_block", int, int),
    "serve_max_batch": ("serve", "max_batch", int, int),
    "serve_max_wait_ms": ("serve", "max_wait_ms", float, float),
    "serve_max_queue": ("serve", "max_queue", int, int),
    "serve_cache_mb": ("serve", "cache_mb", int, int),
    "serve_shm": ("serve", "shm", bool, bool),
    "serve_production_mesh": ("serve", "production_mesh", bool, bool),
    "serve_readmit_every": ("serve", "readmit_every", int, int),
    "serve_deadline_ms": ("serve", "deadline_ms", float, float),
    "serve_flush_retries": ("serve", "flush_retries", int, int),
    "serve_retry_backoff_ms": ("serve", "retry_backoff_ms", float, float),
    "serve_breaker_threshold": ("serve", "breaker_threshold", int, int),
    "serve_breaker_cooldown_ms": ("serve", "breaker_cooldown_ms", float, float),
    "checkpoint_every_steps": ("checkpoint", "every_steps", int, int),
    "checkpoint_dir": ("checkpoint", "dir", lambda v: v, lambda v: v),
    "checkpoint_keep": ("checkpoint", "keep", int, int),
    "max_worker_restarts": ("faults", "max_worker_restarts", int, int),
    "worker_backoff_s": ("faults", "worker_backoff_s", float, float),
    "arena_write_timeout_s": ("faults", "arena_write_timeout_s", float, float),
    "num_trainers": ("scale", "num_trainers", int, int),
    "hierarchy": (
        "scale", "hierarchy",
        lambda v: None if v is None else _parse_mesh(v),
        lambda v: v,
    ),
    "scale_store": ("scale", "store", str, str),
    "scale_overlap": ("scale", "overlap", bool, bool),
    "scale_mode": ("scale", "mode", str, str),
}


# --------------------------------------------------------------------------
# CLI generation — flags are derived from the dataclass fields above
# --------------------------------------------------------------------------

# (section, field) -> (flag override, parse fn, help); fields not listed get
# --<field-with-dashes> and their annotated scalar type.  A parse fn of None
# marks a boolean flag (BooleanOptionalAction).
_CLI_OVERRIDES: Dict[Tuple[str, str], Tuple[str, Optional[Callable], str]] = {
    ("data", "fanouts"): ("--fanouts", _parse_fanouts, "per-hop fanouts, e.g. 4,3"),
    ("partition", "num_partitions"): ("--partitions", int, "number of meta-partitions"),
    ("partition", "placement"): ("--placement", str, f"relation placement {PLACEMENTS}"),
    ("cache", "policy"): ("--cache-policy", str, f"cache allocation policy {CACHE_POLICIES}"),
    ("cache", "readmit_every"): (
        "--readmit-every", int,
        "online cache re-admission period in steps (0 = one-shot)"),
    ("run", "mesh_shape"): ("--mesh", _parse_mesh, "DATAxMODEL mesh, e.g. 2x4"),
    ("pipeline", "enabled"): ("--pipeline", None, "async host pipeline on/off"),
    ("pipeline", "depth"): ("--prefetch-depth", int, "pipeline prefetch depth"),
    ("pipeline", "snapshot"): (
        "--snapshot-policy", str, f"learnable-table snapshot policy {SNAPSHOT_POLICIES}"),
    ("pipeline", "num_workers"): (
        "--num-workers", int, "sampler worker processes (0 = single thread)"),
    ("pipeline", "arena"): (
        "--batch-arena", None, "shm ring-buffer batch arena (pool mode)"),
    ("pipeline", "pin_workers"): (
        "--pin-workers", None,
        "pin sampler workers to distinct CPU cores (Linux, best-effort)"),
    ("kernels", "enabled"): ("--kernels", None, "hand-written CUDA kernel layer on/off"),
    ("kernels", "stacked_agg"): (
        "--kernel-stacked-agg", None, "stacked relation-aggregation kernel"),
    ("kernels", "relation_agg"): (
        "--kernel-relation-agg", None, "unstacked relation-aggregation kernel"),
    ("kernels", "gather"): ("--kernel-gather", None, "cache-fetch row-gather kernel"),
    ("kernels", "interpret"): (
        "--kernel-interpret", None, "interpret mode (not available in the port: raises)"),
    ("kernels", "fuse_epilogue"): (
        "--kernel-fuse-epilogue", None,
        "fully fused attention epilogue (stack-streamed projections)"),
    ("kernels", "autotune"): (
        "--kernel-autotune", None,
        "the reference's block-size tuning table (the port has none: raises)"),
    ("kernels", "block_n"): (
        "--kernel-block-n", int, "the reference's node-block size (no CUDA launch reads it)"),
    ("kernels", "block_out"): (
        "--kernel-block-out", int, "the reference's d_out-block size (no CUDA launch reads it)"),
    ("kernels", "block_in"): (
        "--kernel-block-in", int, "the reference's d_in-chunk size (no CUDA launch reads it)"),
    ("serve", "node_block"): (
        "--serve-node-block", int, "layer-wise inference node-block size"),
    ("serve", "max_batch"): (
        "--serve-max-batch", int, "micro-batch flush size"),
    ("serve", "max_wait_ms"): (
        "--serve-max-wait-ms", float, "micro-batch latency budget (ms)"),
    ("serve", "max_queue"): (
        "--serve-max-queue", int, "bounded request queue (backpressure)"),
    ("serve", "cache_mb"): (
        "--serve-cache-mb", int, "serve-side embedding cache budget (MiB)"),
    ("serve", "shm"): (
        "--serve-shm", None, "shm-backed embedding store (zero-copy attach)"),
    ("serve", "production_mesh"): (
        "--serve-production-mesh", None,
        "score on make_production_mesh instead of the run mesh"),
    ("serve", "readmit_every"): (
        "--serve-readmit-every", int,
        "serve-cache re-admission period in flushes (0 = one-shot)"),
    ("serve", "deadline_ms"): (
        "--serve-deadline-ms", float,
        "default per-request deadline in ms (0 = none)"),
    ("serve", "flush_retries"): (
        "--serve-flush-retries", int,
        "retries of a failing flush before the breaker counts it"),
    ("serve", "retry_backoff_ms"): (
        "--serve-retry-backoff-ms", float,
        "base backoff between flush retries (doubles per attempt)"),
    ("serve", "breaker_threshold"): (
        "--serve-breaker-threshold", int,
        "consecutive flush failures that trip the circuit breaker"),
    ("serve", "breaker_cooldown_ms"): (
        "--serve-breaker-cooldown-ms", float,
        "open-breaker cooldown before a half-open probe"),
    ("checkpoint", "every_steps"): (
        "--checkpoint-every-steps", int,
        "save a session checkpoint every N steps (0 = off)"),
    ("checkpoint", "dir"): (
        "--checkpoint-dir", str, "checkpoint directory"),
    ("checkpoint", "keep"): (
        "--checkpoint-keep", int,
        "retain only the newest K checkpoints (0 = all)"),
    ("faults", "max_worker_restarts"): (
        "--max-worker-restarts", int,
        "pool supervisor restart budget per worker (0 = fail fast)"),
    ("faults", "worker_backoff_s"): (
        "--worker-backoff-s", float,
        "base respawn backoff in seconds (doubles per restart)"),
    ("faults", "arena_write_timeout_s"): (
        "--arena-write-timeout-s", float,
        "arena writer backpressure stall timeout (seconds)"),
    ("scale", "num_trainers"): (
        "--num-trainers", int,
        "data-parallel trainer processes (1 = in-process loop)"),
    ("scale", "hierarchy"): (
        "--hierarchy", _parse_mesh,
        "GROUPSxTRAINERS partition hierarchy, e.g. 2x2"),
    ("scale", "store"): (
        "--scale-store", str,
        "shared graph store flavor: shm | mmap (out-of-core)"),
    ("scale", "overlap"): (
        "--scale-overlap", None,
        "overlap the gradient all-reduce with next-batch sampling"),
    ("scale", "mode"): (
        "--scale-mode", str,
        "DP discipline: global (stripe, single-process-identical) | local "
        "(hierarchy-owned sub-batches, gradient allreduce)"),
}

_SCALAR_PARSERS = {int: int, float: float, str: str, Optional[float]: float, bool: None}


def _cli_specs():
    """Yield (section, field_name, flag, parse_fn, is_bool, help)."""
    import typing

    for section, sec_cls in (("data", DataConfig), ("partition", PartitionConfig),
                             ("model", ModelConfig), ("cache", CacheConfig),
                             ("run", RunConfig), ("pipeline", PipelineConfig),
                             ("kernels", KernelConfig), ("serve", ServeConfig),
                             ("checkpoint", CheckpointConfig),
                             ("faults", FaultConfig), ("scale", ScaleConfig)):
        hints = typing.get_type_hints(sec_cls)
        for f in dataclasses.fields(sec_cls):
            default = getattr(sec_cls(), f.name)
            if (section, f.name) in _CLI_OVERRIDES:
                flag, parse, help_ = _CLI_OVERRIDES[(section, f.name)]
                yield (section, f.name, flag, parse, parse is None,
                       f"{help_} (default: {default})")
                continue
            hint = hints[f.name]
            if hint is bool:
                yield (section, f.name, "--" + f.name.replace("_", "-"), None, True,
                       f"[{section}] (default: {default})")
                continue
            parse = _SCALAR_PARSERS.get(hint, None)
            if parse is None:  # Optional[float] etc: unwrap
                args = typing.get_args(hint)
                parse = next((a for a in args if a in (int, float, str)), str)
            yield (section, f.name, "--" + f.name.replace("_", "-"), parse, False,
                   f"[{section}] (default: {default})")


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """Add one flag per HetaConfig field (defaults deferred to the config, so
    only explicitly-passed flags override)."""
    for _, _, flag, parse, is_bool, help_ in _cli_specs():
        if is_bool:
            parser.add_argument(flag, action=argparse.BooleanOptionalAction,
                                default=None, help=help_)
        else:
            parser.add_argument(flag, type=parse, default=None, help=help_)


def config_from_args(args: argparse.Namespace,
                     base: Optional[HetaConfig] = None) -> HetaConfig:
    """Merge explicitly-passed CLI flags onto ``base`` (default HetaConfig())."""
    cfg = base or HetaConfig()
    sections: Dict[str, Dict[str, Any]] = {}
    for section, field, flag, _, _, _ in _cli_specs():
        dest = flag.lstrip("-").replace("-", "_")
        value = getattr(args, dest, None)
        if value is not None:
            sections.setdefault(section, {})[field] = value
    return cfg.updated(**sections) if sections else cfg
