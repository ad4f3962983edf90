"""SampleStream — the async HGNN host pipeline facade.

Runs sample → snapshot → stack → shard in the background and yields
``(batch, arrays, host_seconds)`` ready for the device step, selecting one
of two engines (see the ``repro_torch.data`` package docstring and DESIGN.md §9):

``num_workers == 0`` (default)
    Today's thread pipeline, bit-for-bit: one
    :class:`~repro_torch.data.prefetch.Prefetcher` producer thread runs

      ``make_batch(i) -> batch``   deterministic batch for pipeline step ``i``
      ``stage(batch)  -> arrays``  the executor's host-staging seam

    ``defer_stage=True`` implements the ``"fresh"`` snapshot policy: the
    producer only samples and staging runs synchronously in ``__next__``.

``num_workers > 0``
    A :class:`~repro_torch.data.worker_pool.WorkerPool` of sampler processes over
    a shared-memory graph store.  The caller supplies ``worker_task`` (a
    picklable :class:`~repro_torch.data.worker_pool.SampleStageTask` yielding
    ``(batch, host_arrays | None, host_s)``) and ``finish_stage(batch,
    host_arrays) -> arrays`` — the consumer-side completion (device
    placement of worker-staged arrays, or the executor's full ``stage``
    when workers only sample, e.g. while learnable tables train).
    ``make_batch``/``stage``/``defer_stage`` are ignored in this mode; the
    time ``finish_stage`` spends on the consumer is added to the item's
    ``host_seconds`` (it is not overlapped).

    Alternatively the caller passes an already-running ``pool`` it owns
    (spawn cost amortized across many ``fit`` calls — the session does
    this): the stream then draws exactly ``num_steps`` items and its
    ``close()`` leaves the pool alive for the next stream.

    With a batch **arena** (DESIGN.md §11) the queue items are
    :class:`~repro_torch.data.worker_pool.SlotRef` descriptors; the stream
    resolves each against ``arena``/``spec`` into zero-copy slot views and
    **defers the slot release by one step**: slot ``i`` is handed back to
    its writer only when step ``i+1`` is drawn (or on ``close()``), so the
    consuming device step may alias slot memory safely.  ``queue_bytes``
    records the pickled size of each queue item — the zero-pickle
    guarantee CI asserts on.

In both modes ``host_seconds`` is the sample+stage time actually spent on
the item, measured where it ran, so the consumer can compute the overlap
fraction (host work that ran concurrently with the device step costs no
wall time).  Exceptions raised in any producer — thread or process —
surface in the consumer's ``__next__``; ``close()`` joins everything and is
idempotent.

A copy of the reference's ``repro/data/sample_stream.py``; only this
paragraph differs.  It imports no torch: what ``stage``/``finish_stage``
return (device tensors, in the session) passes through it untouched.  The
session's ``finish_stage`` (``Executor.stage_from_host``) copies the slot's
read-only views before they reach torch: into pinned buffers ahead of the
asynchronous copy to a GPU, into fresh host tensors on the CPU, so no
tensor aliases slot memory once the slot is handed back.
"""

from __future__ import annotations

import pickle
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.data.prefetch import Prefetcher

__all__ = ["SampleStream"]


class SampleStream:
    def __init__(
        self,
        make_batch: Optional[Callable[[int], object]] = None,
        stage: Optional[Callable[[object], object]] = None,
        num_steps: Optional[int] = None,
        depth: int = 2,
        defer_stage: bool = False,
        num_workers: int = 0,
        worker_task: Optional[object] = None,
        finish_stage: Optional[Callable[[object, object], object]] = None,
        pool: Optional[object] = None,
        arena: Optional[object] = None,
        spec: Optional[object] = None,
    ):
        if num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        self._stage = stage
        self._defer = defer_stage
        self._finish = finish_stage
        self._pool = None
        self._owns_pool = True
        self._remaining = None
        self._prefetcher = None
        self._arena = arena
        self._spec = spec
        self._pending_release = None  # (slot, use) alive through the step
        self._legacy_item_bytes = None  # measured once; tuple items are big
        self.queue_bytes: List[int] = []  # pickled size of each queue item
        if arena is not None and spec is None:
            raise ValueError("arena mode requires the sampler spec")

        if num_workers == 0:
            if make_batch is None or stage is None:
                raise ValueError("thread mode requires make_batch and stage")

            def produce(i: int) -> Tuple[object, object, float]:
                t0 = time.perf_counter()
                batch = make_batch(i)
                arrays = None if defer_stage else stage(batch)
                return batch, arrays, time.perf_counter() - t0

            self._prefetcher = Prefetcher(produce, depth=depth,
                                          num_items=num_steps,
                                          name="sample-stream")
        else:
            if self._finish is None:
                if stage is None:
                    raise ValueError(
                        "pool mode requires finish_stage (or stage as the "
                        "consumer-side fallback)"
                    )
                self._finish = lambda batch, host: stage(batch)
            if pool is not None:
                # externally-owned, open-ended pool: draw num_steps items,
                # leave it running on close
                self._pool = pool
                self._owns_pool = False
                self._remaining = num_steps
            else:
                if worker_task is None:
                    raise ValueError(
                        "num_workers > 0 requires a picklable worker_task "
                        "(see repro_torch.data.worker_pool.SampleStageTask) or an "
                        "already-running pool"
                    )
                from repro_torch.data.worker_pool import WorkerPool

                self._pool = WorkerPool(worker_task, num_workers=num_workers,
                                        depth=depth, num_items=num_steps,
                                        name="sample-pool")

    @property
    def num_workers(self) -> int:
        return self._pool.num_workers if self._pool is not None else 0

    def __iter__(self) -> "SampleStream":
        return self

    def _release_pending(self) -> None:
        if self._pending_release is not None:
            slot, use = self._pending_release
            self._pending_release = None
            self._arena.release(slot, use)

    def __next__(self) -> Tuple[object, object, float]:
        if self._pool is not None:
            if self._remaining is not None:
                if self._remaining <= 0:
                    raise StopIteration
                self._remaining -= 1
            try:
                item = next(self._pool)
            except BaseException:
                self._release_pending()
                raise
            if self._arena is not None and hasattr(item, "slot"):
                from repro_torch.data.staging import unpack_slot

                # the previous step's views (and any zero-copy device
                # aliases) are dead once the caller asks for the next item
                # — only now may the writer reuse that slot
                self._release_pending()
                self.queue_bytes.append(len(pickle.dumps(item)))
                views = self._arena.resolve(item.slot, item.use)
                batch, host = unpack_slot(views, self._spec)
                t0 = time.perf_counter()
                arrays = self._finish(batch, host)
                self._pending_release = (item.slot, item.use)
                return batch, arrays, item.host_s + time.perf_counter() - t0
            batch, host, host_s = item
            if self._legacy_item_bytes is None:
                # tuple payloads are ~MBs of pickled ndarrays; measure once
                # and reuse (the per-step cost is what the arena removes)
                self._legacy_item_bytes = len(pickle.dumps(item))
            self.queue_bytes.append(self._legacy_item_bytes)
            # consumer-side completion: device placement of worker-staged
            # arrays, or full (fresh) staging when workers only sampled —
            # either way this slice of host time is NOT overlapped
            t0 = time.perf_counter()
            arrays = self._finish(batch, host)
            return batch, arrays, host_s + time.perf_counter() - t0
        batch, arrays, host_s = next(self._prefetcher)
        if self._defer:
            # "fresh" snapshot policy: stage on the consumer, against the
            # current tables (this part of the host time is NOT overlapped)
            t0 = time.perf_counter()
            arrays = self._stage(batch)
            host_s += time.perf_counter() - t0
        return batch, arrays, host_s

    def close(self) -> None:
        self._release_pending()
        if self._pool is not None and self._owns_pool:
            self._pool.close()
        if self._prefetcher is not None:
            self._prefetcher.close()

    def __enter__(self) -> "SampleStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
