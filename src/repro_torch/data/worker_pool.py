"""Process-pool sampling over a shared-memory graph (DESIGN.md §9).

The thread :class:`~repro_torch.data.prefetch.Prefetcher` caps host throughput at
one CPU core; this module lifts the host pipeline onto N worker *processes*:

  * **stripe assignment** — worker ``w`` of ``W`` computes items
    ``w, w+W, w+2W, ...``.  Each worker produces its stripe strictly in
    order onto its own bounded queue, so the consumer reconstructs global
    step order by round-robining the queues (``step i`` is always the head
    of queue ``i % W``) — a reorder buffer with zero bookkeeping, and
    bounded lookahead of ``W × depth`` items.
  * **determinism** — tasks are pure functions of their item index
    (``NeighborSampler.batch_at`` under an :class:`EpochSchedule`), so the
    stripe decomposition cannot change the data: any worker count, including
    the thread path, yields bit-identical batches.
  * **zero-copy graph** — workers attach the shared-memory graph store
    (``repro_torch.graph.shm``) named in the task; only the few-hundred-byte
    handle crosses the process boundary at startup, never the graph.
  * **failure discipline** — an exception anywhere in a worker (setup or
    per-item) is shipped to the consumer and re-raised from ``__next__``
    after the pool shuts down; a worker that dies without a word raises
    :class:`WorkerDiedError`.  ``close()`` is idempotent, drains the queues,
    joins every process, and terminates stragglers.
  * **supervision** (DESIGN.md §12) — with ``max_restarts > 0`` a silent
    death (SIGKILL, OOM, ``os._exit``) is *survived* instead: the consumer
    detects it at the exact stripe position the dead worker owed
    (``__next__`` only ever blocks on queue ``i % W``), discards the dead
    worker's queue (any undelivered ``SlotRef`` in it is stale), invokes
    ``on_worker_death`` (the session poisons the worker's arena sub-ring
    there so stale refs fail loudly), and respawns a replacement that
    replays the stripe from that position — tasks are pure functions of
    the item index, so the replayed items are bit-identical and the
    consumer-visible stream is indistinguishable from a faultless run.
    Respawn ``r`` of a worker backs off ``restart_backoff_s * 2**r``
    first; once a worker exhausts the budget, :class:`WorkerDiedError`
    carries the exit code and the last stripe index it delivered.

Workers are **spawned** (never forked — the parent owns a CUDA context,
and a forked child that touches CUDA fails) and deliberately torch-free:
unpickling a :class:`SampleStageTask` imports ``repro_torch``,
``repro_torch.data`` and the numpy-level modules of ``repro_torch.graph``
and ``repro_torch.data``, none of which imports torch, so spawn cost is
numpy import plus a shared-memory attach.

A copy of the reference's ``repro/data/worker_pool.py`` with one
difference: :meth:`SampleStageTask.setup` attaches the store with
:func:`repro_torch.graph.shm.attach`, where the reference calls
``repro.graph.mmap_store.attach_any`` (shm or on-disk mmap stores); the
port's mmap store arrives with its data-parallel tier, and until then its
workers attach shm stores only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing as mp
import os
import queue as _queue
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "WorkerPool",
    "WorkerDiedError",
    "EpochSchedule",
    "SlotRef",
    "SampleStageTask",
    "HotnessCountTask",
]

_POLL_S = 0.05


class WorkerDiedError(RuntimeError):
    """A worker process exited without posting a result or a failure."""


class _Done:
    """Queue sentinel: this worker's stripe is exhausted."""


class _Failure:
    """Queue sentinel: a worker raised; carries the exception + traceback."""

    def __init__(self, exc: BaseException, tb: str):
        self.exc = exc
        self.tb = tb


def _put(q, stop, item) -> bool:
    """Blocking put that aborts (returns False) once the pool is stopping."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except _queue.Full:
            continue
    return False


@contextlib.contextmanager
def _spawnable_main():
    """Make ``spawn`` work when ``__main__`` has a phantom ``__file__``.

    ``python - <<EOF`` scripts (CI smoke jobs, ad-hoc drivers) leave
    ``__main__.__file__ = "<stdin>"``; spawn's preparation step would try to
    re-run that non-file in every worker and crash.  Hiding the attribute
    while the workers start makes spawn skip main-module re-execution —
    correct here, since pool tasks live in importable modules, never in
    ``__main__``."""
    main = sys.modules.get("__main__")
    path = getattr(main, "__file__", None)
    phantom = (
        main is not None and path is not None
        and getattr(main, "__spec__", None) is None
        and not os.path.exists(path)
    )
    if phantom:
        del main.__file__
    try:
        yield
    finally:
        if phantom:
            main.__file__ = path


def _picklable_failure(exc: BaseException) -> _Failure:
    """Wrap ``exc`` so it survives the queue (exotic exceptions that don't
    pickle are downgraded to a RuntimeError carrying their repr)."""
    import pickle

    tb = traceback.format_exc()
    try:
        pickle.loads(pickle.dumps(exc))
        return _Failure(exc, tb)
    except BaseException:
        return _Failure(RuntimeError(f"worker failure: {exc!r}"), tb)


def _worker_main(task, wid: int, num_workers: int,
                 num_items: Optional[int], q, stop,
                 start_item: Optional[int] = None, attempt: int = 0) -> None:
    """Entry point of one spawned worker: setup, stripe loop, teardown.

    ``start_item`` (default ``wid``) is where the stripe loop begins —
    the supervisor respawns a replacement at the consumer's next
    undelivered index so the stripe replays deterministically.
    ``attempt`` counts this worker slot's incarnations (0 = original);
    tasks with fault plans consult it so scheduled faults fire once."""
    try:
        # tasks that block outside the queues (the arena's backpressure
        # gate) need the stop event to exit promptly on pool shutdown
        bind = getattr(task, "bind_stop", None)
        if bind is not None:
            bind(stop)
        bind_w = getattr(task, "bind_worker", None)
        if bind_w is not None:
            bind_w(wid, attempt)
        task.setup()
    except BaseException as exc:  # noqa: BLE001 — delivered to the consumer
        _put(q, stop, _picklable_failure(exc))
        return
    try:
        i = wid if start_item is None else start_item
        while not stop.is_set() and (num_items is None or i < num_items):
            item = task(i)
            if not _put(q, stop, item):
                return
            i += num_workers
        if not stop.is_set():
            _put(q, stop, _Done())
    except BaseException as exc:  # noqa: BLE001
        _put(q, stop, _picklable_failure(exc))
    finally:
        try:
            task.teardown()
        except BaseException:
            pass


class WorkerPool:
    """Ordered fan-out of ``task(0), task(1), ...`` over N processes.

    ``task`` must be picklable with three hooks: ``setup()`` (once, in the
    worker), ``__call__(i)`` (the item for global index ``i``), and
    ``teardown()`` (best-effort, at exit).  Iterator + context manager;
    items come back strictly in index order.

    ``max_restarts`` arms supervision (see module docstring): each worker
    slot may be respawned that many times after a silent death, with
    exponential backoff from ``restart_backoff_s``; ``on_worker_death(wid)``
    runs in the consumer before each respawn (arena slot invalidation).
    ``restarts`` records one event dict per respawn —
    ``{"wid", "item", "exitcode", "attempt", "downtime_s"}`` — the
    recovery-time figure ``benchmarks/fault_drill.py`` reports.
    """

    def __init__(
        self,
        task,
        num_workers: int,
        depth: int = 2,
        num_items: Optional[int] = None,
        name: str = "sampler-pool",
        max_restarts: int = 0,
        restart_backoff_s: float = 0.05,
        on_worker_death=None,
    ):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if num_items is not None and num_items < 0:
            raise ValueError(f"num_items must be >= 0, got {num_items}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        ctx = mp.get_context("spawn")
        self.num_workers = num_workers
        self.num_items = num_items
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.on_worker_death = on_worker_death
        self.restarts: List[Dict] = []  # one event dict per respawn
        self._ctx = ctx
        self._task = task
        self._depth = depth
        self._name = name
        self._restart_counts = [0] * num_workers
        self._stop = ctx.Event()
        self._queues = [ctx.Queue(maxsize=depth) for _ in range(num_workers)]
        self._procs = []
        self._next = 0
        self._closed = False
        self._done = False
        try:
            with _spawnable_main():
                for w in range(num_workers):
                    p = ctx.Process(
                        target=_worker_main,
                        args=(task, w, num_workers, num_items,
                              self._queues[w], self._stop),
                        name=f"{name}-{w}",
                        daemon=True,
                    )
                    p.start()
                    self._procs.append(p)
        except BaseException:
            self.close()
            raise

    # -- consumer side -------------------------------------------------------

    def __iter__(self) -> "WorkerPool":
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError("WorkerPool is closed")
        if self._done:
            raise StopIteration
        w = self._next % self.num_workers
        while True:
            q, proc = self._queues[w], self._procs[w]
            try:
                item = q.get(timeout=_POLL_S)
                break
            except _queue.Empty:
                if not proc.is_alive():
                    # a last put may still be in flight in the feeder pipe
                    try:
                        item = q.get(timeout=_POLL_S)
                        break
                    except _queue.Empty:
                        if self._restart_counts[w] < self.max_restarts:
                            self._respawn(w, proc.exitcode)
                            continue
                        last = self._next - self.num_workers
                        self.close()
                        raise WorkerDiedError(
                            f"worker {w} exited (code {proc.exitcode}) without "
                            f"delivering item {self._next} (last stripe index "
                            f"delivered: {last if last >= 0 else None}; "
                            f"restarts used: {self._restart_counts[w]}/"
                            f"{self.max_restarts})"
                        ) from None
        if isinstance(item, _Done):
            # stripes interleave: worker w done at position i means every
            # worker's next index is >= num_items — iteration is complete
            self._done = True
            raise StopIteration
        if isinstance(item, _Failure):
            self.close()
            if item.tb:
                item.exc.__cause__ = RuntimeError(
                    f"worker traceback:\n{item.tb}")
            raise item.exc
        self._next += 1
        return item

    # -- supervision ---------------------------------------------------------

    def _respawn(self, w: int, exitcode) -> None:
        """Replace silently-dead worker ``w``, replaying from ``self._next``.

        The dead worker's queue is discarded wholesale: per-producer FIFO
        means item ``self._next`` missing implies nothing later from this
        stripe is trustworthy either, and a late-arriving stale ``SlotRef``
        would shift the stream.  ``on_worker_death`` runs *before* the
        replacement spawns so the session can poison the worker's arena
        sub-ring first (DESIGN.md §12)."""
        t0 = time.monotonic()
        r = self._restart_counts[w]
        self._restart_counts[w] = r + 1
        if self.restart_backoff_s > 0:
            time.sleep(min(self.restart_backoff_s * (2 ** r), 5.0))
        # discard the dead worker's queue (stale refs) and give the
        # replacement a fresh one
        old_q = self._queues[w]
        try:
            while True:
                old_q.get_nowait()
        except (_queue.Empty, OSError, ValueError):
            pass
        try:
            old_q.cancel_join_thread()
            old_q.close()
        except BaseException:
            pass
        if self.on_worker_death is not None:
            self.on_worker_death(w)
        self._queues[w] = self._ctx.Queue(maxsize=self._depth)
        old_p = self._procs[w]
        with _spawnable_main():
            p = self._ctx.Process(
                target=_worker_main,
                args=(self._task, w, self.num_workers, self.num_items,
                      self._queues[w], self._stop, self._next, r + 1),
                name=f"{self._name}-{w}-r{r + 1}",
                daemon=True,
            )
            p.start()
        self._procs[w] = p
        old_p.join(timeout=1.0)
        self.restarts.append({
            "wid": w,
            "item": self._next,
            "exitcode": exitcode,
            "attempt": r + 1,
            "downtime_s": time.monotonic() - t0,
        })

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Stop all workers, drain the queues, join (terminate stragglers).

        Idempotent; after it returns ``__next__`` raises RuntimeError."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in self._procs):
            # drain so workers blocked on a full queue observe the stop event
            for q in self._queues:
                try:
                    while True:
                        q.get_nowait()
                except (_queue.Empty, OSError, ValueError):
                    pass
            if time.monotonic() >= deadline:
                break
            for p in self._procs:
                p.join(timeout=_POLL_S)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        for q in self._queues:
            try:
                q.cancel_join_thread()
                q.close()
            except BaseException:
                pass

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: never leak processes
        try:
            self.close(timeout=0.5)
        except BaseException:
            pass


# --------------------------------------------------------------------------
# the sampling task
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpochSchedule:
    """Maps a global step to ``(epoch_seed, step-in-epoch)``.

    Epoch ``e`` covers global steps ``[e*E, (e+1)*E)`` and shuffles with
    ``epoch_seed_base + e*seed_stride`` — by default ``seed_stride = E``,
    the session's historical seeding, shared here so the serial loop, the
    thread stream and every pool worker derive identical batches from
    identical positions.  The §6 pre-sampling sweep seeds epochs with
    ``seed + ep`` instead, which is ``seed_stride=1``."""

    epoch_seed_base: int
    steps_per_epoch: int
    start_step: int = 0
    shuffle: bool = True
    seed_stride: Optional[int] = None  # None = steps_per_epoch

    def seed_and_index(self, i: int) -> Tuple[int, int]:
        s = self.start_step + i
        e, idx = divmod(s, self.steps_per_epoch)
        stride = (self.steps_per_epoch if self.seed_stride is None
                  else self.seed_stride)
        return self.epoch_seed_base + e * stride, idx


@dataclasses.dataclass(frozen=True)
class SlotRef:
    """Queue descriptor of one arena-staged item (DESIGN.md §11).

    This ~200-byte record is the *entire* queue payload when the batch arena
    is active — the batch and staged arrays live in the slot it names.
    ``table_version`` stamps which staging-table publish the worker staged
    against (the staleness bound check); ``staged`` says whether ``h/``
    arrays are present."""

    step: int
    slot: int
    use: int  # slot generation; consumer releases with the same value
    host_s: float
    table_version: int = 0
    staged: bool = False


@dataclasses.dataclass
class SampleStageTask:
    """The pool task of the HGNN host pipeline: sample (and optionally
    stage) the batch at one global step.

    ``handle`` names the shared-memory graph store; ``recipe`` (a
    :class:`~repro_torch.data.staging.StackRecipe`, or None) moves the host
    staging into the worker — its feature tables must have been exported
    into the store (``share_graph(..., tables=...)``) or, with an arena,
    into the arena's table region.  Without ``arena`` each item returns
    ``(batch, host_arrays | None, host_seconds)``, mirroring the thread
    stream's payload; with an :class:`~repro_torch.graph.shm.ArenaHandle` the
    arrays are written straight into the item's ring slot and only a
    :class:`SlotRef` crosses the queue (zero pickled ndarrays).

    ``faults`` (a :class:`~repro_torch.data.faults.FaultPlan`, or None) arms
    deterministic chaos drills: a scheduled ``kill_worker`` exits the
    process with :data:`~repro_torch.data.faults.KILL_EXIT_CODE` before the item
    is produced, ``raise_item`` raises
    :class:`~repro_torch.data.faults.InjectedFault`, and ``poison_slot`` corrupts
    the slot stamp after a completed write.  ``write_timeout_s`` bounds the
    arena backpressure wait — a dead consumer raises
    :class:`~repro_torch.graph.shm.ArenaStalledError` instead of hanging the
    worker forever (DESIGN.md §12).
    """

    handle: object  # repro_torch.graph.shm.GraphHandle
    spec: object  # repro_torch.graph.sampler.SampleSpec
    batch_size: int
    sampler_seed: int
    schedule: EpochSchedule
    recipe: object = None
    arena: object = None  # repro_torch.graph.shm.ArenaHandle
    faults: object = None  # repro_torch.data.faults.FaultPlan
    write_timeout_s: float = 60.0
    pin_cpus: bool = False  # opt-in: pin worker w to core (w+1) % ncpu

    def bind_stop(self, stop) -> None:
        """Called by the pool runner so the arena backpressure wait can
        observe shutdown."""
        self._stop = stop

    def bind_worker(self, wid: int, attempt: int) -> None:
        """Called by the pool runner: this incarnation's identity, consulted
        by the fault plan so scheduled faults fire deterministically."""
        self._wid = wid
        self._attempt = attempt

    def setup(self) -> None:
        from repro_torch.graph.sampler import NeighborSampler
        from repro_torch.graph.shm import attach, attach_arena

        if self.pin_cpus:
            # opt-in affinity pin (pipeline.pin_workers): worker w sticks to
            # core (w+1) % ncpu, biasing core 0 toward the consumer — spares
            # the samplers' cache/NUMA locality from scheduler migration.
            # Best-effort: unsupported platforms (macOS) just skip it.
            try:
                ncpu = os.cpu_count() or 1
                os.sched_setaffinity(
                    0, {(getattr(self, "_wid", 0) + 1) % ncpu})
            except (AttributeError, OSError):
                pass

        # the reference: mmap_store.attach_any(self.handle) (shm or mmap)
        self._attached = attach(self.handle)
        self._sampler = NeighborSampler(
            self._attached.graph, self.spec, self.batch_size,
            seed=self.sampler_seed,
        )
        self._tables = self._attached.tables
        self._arena = attach_arena(self.arena) if self.arena is not None else None
        if self._arena is not None and self._arena.handle.tables:
            if not self._arena.handle.tables_mutable:
                # frozen tables: zero-copy views, read once
                self._tables, _ = self._arena.read_tables()

    def __call__(self, i: int):
        from repro_torch.data.staging import (HOST_PREFIX, pack_batch_into,
                                        stack_batch_host)

        t0 = time.perf_counter()
        if self.faults is not None and self.faults:
            from repro_torch.data.faults import KILL_EXIT_CODE, InjectedFault

            wid = getattr(self, "_wid", 0)
            attempt = getattr(self, "_attempt", 0)
            if self.faults.kill_at(wid, attempt, i):
                os._exit(KILL_EXIT_CODE)  # a silent death: no queue message
            if self.faults.raise_at(wid, attempt, i):
                raise InjectedFault(
                    f"scheduled raise_item fault at item {i} "
                    f"(worker {wid}, attempt {attempt})")
        epoch_seed, idx = self.schedule.seed_and_index(i)
        batch = self._sampler.batch_at(
            idx, epoch_seed=epoch_seed, shuffle=self.schedule.shuffle)
        if self._arena is None:
            host = (
                stack_batch_host(self.recipe, batch, self._tables)
                if self.recipe is not None else None
            )
            return batch, host, time.perf_counter() - t0

        a = self._arena
        slot, use = a.handle.slot_for(i)
        # backpressure: the sub-ring is full until the consumer releases
        # this slot's previous generation
        stop = getattr(self, "_stop", None)
        if not a.wait_writable(slot, use, stop=stop,
                               timeout=self.write_timeout_s):
            if stop is not None and stop.is_set():
                return None  # pool is stopping; the queue put will abort too
            from repro_torch.graph.shm import ArenaStalledError

            raise ArenaStalledError(
                f"arena slot {slot} (use {use}) not writable after "
                f"{self.write_timeout_s:.1f}s — consumer dead or wedged "
                f"(DESIGN.md §12)")
        table_version = 0
        a.begin_write(slot, use)
        try:
            views = a.slot_views(slot, writable=True)
            pack_batch_into(views, batch)
            if self.recipe is not None:
                tables, table_version = (
                    a.read_tables() if a.handle.tables_mutable
                    else (self._tables, a.table_version())
                )
                stack_batch_host(self.recipe, batch, tables,
                                 out=views, prefix=HOST_PREFIX)
        finally:
            a.end_write(slot, use)
        if self.faults is not None and self.faults and self.faults.poison_at(
                getattr(self, "_wid", 0), getattr(self, "_attempt", 0), i):
            a.poison_slot(slot)
        return SlotRef(step=i, slot=slot, use=use,
                       host_s=time.perf_counter() - t0,
                       table_version=table_version,
                       staged=self.recipe is not None)

    def teardown(self) -> None:
        attached = getattr(self, "_attached", None)
        if attached is not None:
            attached.close()
        arena = getattr(self, "_arena", None)
        if arena is not None:
            arena.close()


@dataclasses.dataclass
class HotnessCountTask:
    """Pool task of the §6 pre-sampling sweep: sample the batch at one
    global position and accumulate its node-visit counts locally.

    Counting is a sum over batches, hence order-independent: each worker
    returns ``None`` per item and ships its partial counts dict once, on
    its stripe's last item; the consumer sums the partials — bit-identical
    to the serial :func:`repro_torch.embed.profiler.presample_hotness` loop."""

    handle: object  # repro_torch.graph.shm.GraphHandle
    spec: object
    batch_size: int
    sampler_seed: int
    schedule: EpochSchedule
    num_items: int
    num_workers: int

    def setup(self) -> None:
        import numpy as np

        from repro_torch.graph.sampler import NeighborSampler
        from repro_torch.graph.shm import attach

        self._attached = attach(self.handle)
        self._sampler = NeighborSampler(
            self._attached.graph, self.spec, self.batch_size,
            seed=self.sampler_seed,
        )
        self._counts = {
            t: np.zeros(n, dtype=np.int64)
            for t, n in self._attached.graph.num_nodes.items()
        }

    def __call__(self, i: int):
        epoch_seed, idx = self.schedule.seed_and_index(i)
        batch = self._sampler.batch_at(
            idx, epoch_seed=epoch_seed, shuffle=self.schedule.shuffle)
        batch.count_visits(self._counts)
        if i + self.num_workers >= self.num_items:  # stripe's last item
            return self._counts
        return None

    def teardown(self) -> None:
        attached = getattr(self, "_attached", None)
        if attached is not None:
            attached.close()
