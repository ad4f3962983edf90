"""``repro_torch.data`` — the unified async host-pipeline subsystem.

The breakdown benchmark (paper Fig. 10) shows host-side work — neighbor
sampling plus feature staging (table snapshot → ``stack_batch`` →
``shard_arrays``) — dominating step time once RAF has removed network
traffic.  This package overlaps that host work with the device step, the
DistDGLv2/HopGNN recipe, behind three pieces:

:class:`~repro_torch.data.prefetch.Prefetcher`
    The shared double-buffered background producer (bounded queue, one
    daemon thread, exception propagation into the consumer, ``close()``
    joins).  :class:`~repro_torch.data.sample_stream.SampleStream` (HGNN
    path) sits on it.

:class:`~repro_torch.data.sample_stream.SampleStream`
    The host-pipeline facade: runs sample → snapshot → stack → shard in the
    background and yields ``(batch, arrays, host_seconds)`` ready for the
    device step.  ``num_workers=0`` selects the thread ``Prefetcher``
    (bit-for-bit today's behavior); ``num_workers>0`` selects the process
    pool below.

:class:`~repro_torch.data.worker_pool.WorkerPool`
    N sampler *processes* over a shared-memory graph store
    (``repro_torch.graph.shm``), lifting the one-CPU-core ceiling of the thread
    producer (paper Fig. 10 — host sampling dominates once RAF removes
    network traffic).  Worker ``w`` samples the interleaved stripe
    ``w, w+N, ...``; per-worker bounded queues round-robined by the
    consumer reconstruct strict step order; ``batch_at`` purity makes any
    worker count bit-identical.  Staging placement follows the snapshot
    policy: frozen-table and learnable-"stale" batches are staged *inside*
    workers via the shared numpy core
    (``repro_torch.data.staging.stack_batch_host``), while learnable-"fresh"
    staging stays on the consumer.  Architecture: DESIGN.md §9.

The **batch arena** (DESIGN.md §11) closes the pool's last copy: instead of
pickling batches through the worker→consumer queues, workers write sampled
(and pre-staged) arrays directly into fixed seqlock-stamped slots of one
shared-memory ring buffer (``repro_torch.graph.shm.create_arena``), and the queue
carries only a few-hundred-byte ``SlotRef`` descriptor — zero pickled
ndarrays on the hot path.  Slot layout, version-stamp discipline, the
bounded-staleness contract for learnable tables, and failure/unlink rules
are specified in DESIGN.md §11; ``repro_torch.data.staging`` holds the slot
pack/unpack helpers and the write-into-slot staging variant.

**The staged-step protocol.**  Executors (``repro_torch.api.executors``) split
one training step into two public methods::

    stage(sess, plan, batch)                 -> arrays   # host staging
    step_staged(sess, plan, state, batch, arrays)        # device step
    step(sess, plan, state, batch)  ==  step_staged(..., stage(...))

``stage`` is pure host work (safe to run in the producer thread for a
*future* batch while the device trains the current one); ``step_staged``
owns the timed compute + sparse-update region.  ``step`` remains the serial
composition for callers that don't pipeline.

**Determinism.**  ``NeighborSampler`` derives each batch's RNG from
``(seed, epoch_seed, step)`` (the ``SyntheticCorpus`` trick), so
``batch_at`` is a pure function of position and pipeline-on/off produce
bit-identical batches regardless of prefetch depth or thread scheduling.

**Snapshot staleness policy** (``PipelineConfig.snapshot``).  With frozen
feature tables staging is time-invariant, so the pipeline is bit-exact.
When learnable tables train (``ModelConfig.train_learnable`` with an
executor whose staging reads them, e.g. ``raf_spmd``), staging batch *i+k*
in the background observes tables before steps *i..i+k-1* wrote back:

* ``"stale"`` (default) — stage in the producer against a snapshot that may
  lag by at most ``depth + 1`` steps (the queue bound).  Maximum overlap;
  losses track the serial path within optimization noise, the standard
  bounded-staleness trade every async-pipeline system makes.
* ``"fresh"`` — producer only samples; table-reading staging runs on the
  consumer right before the step.  Bit-exact parity with the serial loop,
  overlapping only the sampling stage.

The port's copy of the reference's ``repro/data/__init__.py``: it exports
the same names except ``SyntheticCorpus`` and ``TokenPipeline`` (the LM
token feed, ported with LM training).  Nothing here imports torch: spawned
sampler workers import this package when they unpickle their task.  The
GPU side of the pipeline lives in the session and the executors: a
``stage`` run by the producer thread copies to the device on PyTorch's
current stream of that thread (the legacy default stream, which the
trainer's thread shares, so the copies and the steps stay in order), and
worker-staged arrays reach the card through ``Executor.stage_from_host``.
"""

from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.sample_stream import SampleStream
from repro_torch.data.staging import (
    StackRecipe,
    arena_fields,
    pack_batch_into,
    stack_batch_host,
    unpack_slot,
)
from repro_torch.data.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.data.worker_pool import (
    EpochSchedule,
    HotnessCountTask,
    SampleStageTask,
    SlotRef,
    WorkerDiedError,
    WorkerPool,
)

__all__ = [
    "Prefetcher",
    "SampleStream",
    "StackRecipe",
    "stack_batch_host",
    "arena_fields",
    "pack_batch_into",
    "unpack_slot",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "EpochSchedule",
    "HotnessCountTask",
    "SampleStageTask",
    "SlotRef",
    "WorkerDiedError",
    "WorkerPool",
]
