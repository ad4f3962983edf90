"""Micro-batching serving executor over a materialized store (DESIGN.md §10).

Online queries arrive one at a time; the device wants big batches.  The
:class:`MicroBatcher` bridges the two with the classic latency-budget
policy: requests queue until either ``max_batch`` of them are pending or
the *oldest* has waited ``max_wait_ms``, then the whole group flushes as
one batch.  The queue is bounded (``max_queue``) — submitters block when
it is full (backpressure) — and a flush failure is propagated to exactly
the callers whose requests were in that flush.

:class:`EmbeddingServer` is the HGNN tier's hot path: a micro-batcher whose
flush groups the queued lookups per node type, issues **one**
``FeatureCache.fetch_many`` gather per type from the layer-wise
:class:`~repro_torch.serve.full_graph.EmbeddingStore` (the ``gather_rows``
kernel on all-hit fetches), and scores target-type rows with
``relu(e) @ W + b`` on the device.

Degradation (DESIGN.md §12): the primary flush path (cache gather + device
scoring) is wrapped in retry-with-backoff, and a circuit breaker —
``closed`` → (``breaker_threshold`` consecutive flush failures) → ``open``
→ (after ``breaker_cooldown_ms``) → ``half_open`` → one probe flush →
``closed`` again or back to ``open`` — trips into a *degraded*
cache-bypass path: a numpy gather from the store's host arrays plus a
numpy head.  Degraded answers are slower but correct, so callers are never
rejected; trips, recoveries, retries and degraded-answer counts surface in
:class:`ServeStats` — a run that expects the device path checks they are 0.
A kernel that fails to build or launch is not a device fault the breaker
absorbs: it reaches the callers of that flush, since on the GPU a kernel
runs or the call raises.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.embed.cache import CacheAllocation, FeatureCache, allocate_cache
from repro_torch.embed.profiler import HotnessProfile, MissPenaltyProfile
from repro_torch.kernels.build import KernelBuildError
from repro_torch.kernels.ops import KernelLaunchError
from repro_torch.serve.full_graph import EmbeddingStore

__all__ = ["MicroBatcher", "EmbeddingServer", "ServeResult", "ServeStats"]

# raised past the breaker to the flush's callers, never answered degraded
_KERNEL_FAULTS = (KernelLaunchError, KernelBuildError)


# --------------------------------------------------------------------------
# the micro-batcher
# --------------------------------------------------------------------------


class _Future:
    """Single-use result slot (set exactly once: value or exception)."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def set_result(self, value) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serve request timed out")
        if self._exc is not None:
            raise self._exc
        return self._value


class MicroBatcher:
    """Coalesce concurrent ``submit`` calls into bounded batches.

    ``process(items) -> results`` is called on a dedicated flusher thread
    with 1..``max_batch`` queued items whenever the batch fills or the
    oldest pending item ages past ``max_wait_ms``.  ``submit`` returns a
    future; it blocks while ``max_queue`` items are pending (backpressure)
    and raises once the batcher is closed.  ``close`` drains every pending
    item before the flusher exits, so in-flight callers always get an
    answer; an exception from ``process`` is delivered to exactly the
    callers in that flush and the batcher keeps serving."""

    def __init__(
        self,
        process: Callable[[List], List],
        *,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int = 1024,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._process = process
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: deque = deque()  # (item, future, t_submit)
        self._closed = False
        self.flushes = 0
        self._thread = threading.Thread(
            target=self._run, name="serve-microbatcher", daemon=True
        )
        self._thread.start()

    # -- producer side ------------------------------------------------------

    def submit(self, item) -> _Future:
        fut = _Future()
        with self._cond:
            while not self._closed and len(self._pending) >= self.max_queue:
                self._cond.wait(0.05)
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._pending.append((item, fut, time.monotonic()))
            self._cond.notify_all()
        return fut

    def __call__(self, item, timeout: Optional[float] = None):
        """Blocking submit: enqueue and wait for the flush result."""
        return self.submit(item).result(timeout)

    # -- flusher side -------------------------------------------------------

    def _take_batch(self) -> List[Tuple]:
        """Wait until a flush is due, then pop up to ``max_batch`` items.
        Returns [] only when closed with nothing left to drain."""
        budget = self.max_wait_ms / 1e3
        with self._cond:
            while True:
                if self._pending:
                    age = time.monotonic() - self._pending[0][2]
                    if (
                        len(self._pending) >= self.max_batch
                        or age >= budget
                        or self._closed
                    ):
                        n = min(len(self._pending), self.max_batch)
                        batch = [self._pending.popleft() for _ in range(n)]
                        self._cond.notify_all()  # wake backpressured submitters
                        return batch
                    self._cond.wait(budget - age)
                elif self._closed:
                    return []
                else:
                    self._cond.wait()

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            items = [item for item, _, _ in batch]
            try:
                results = self._process(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"process returned {len(results)} results for "
                        f"{len(items)} items"
                    )
            except BaseException as exc:  # propagate to exactly this flush
                for _, fut, _ in batch:
                    fut.set_exception(exc)
                continue
            self.flushes += 1
            for (_, fut, _), res in zip(batch, results):
                fut.set_result(res)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Stop accepting work, drain in-flight requests, join the flusher."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------------
# the embedding server
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ServeResult:
    """One answered lookup: stored rows (pre-ReLU), class scores for
    target-type requests (None otherwise), and the request's end-to-end
    latency (submit -> flush complete)."""

    ntype: str
    embeddings: np.ndarray
    scores: Optional[np.ndarray]
    latency_ms: float


@dataclasses.dataclass
class ServeStats:
    count: int
    flushes: int
    p50_ms: float
    p99_ms: float
    qps: float
    hit_rates: Dict[str, float]
    # degradation bookkeeping (DESIGN.md §12)
    breaker_state: str = "closed"
    breaker_trips: int = 0
    breaker_recoveries: int = 0
    degraded: int = 0  # requests answered via the cache-bypass path
    retries: int = 0  # primary-path retry attempts

    def render(self) -> str:
        lines = [
            f"  requests={self.count}  flushes={self.flushes}  "
            f"p50={self.p50_ms:.3f} ms  p99={self.p99_ms:.3f} ms  "
            f"qps={self.qps:,.0f}"
        ]
        if self.breaker_trips or self.degraded or self.retries:
            lines.append(
                f"    breaker={self.breaker_state}  trips={self.breaker_trips}"
                f"  recoveries={self.breaker_recoveries}"
                f"  degraded={self.degraded}  retries={self.retries}")
        for t, r in sorted(self.hit_rates.items()):
            lines.append(f"    cache[{t}] hit-rate={r:.2%}")
        return "\n".join(lines)


def _build_serve_cache(
    store: EmbeddingStore, cache_mb: int, kernels=None,
    hotness: Optional[HotnessProfile] = None,
) -> FeatureCache:
    """A read-only :class:`FeatureCache` over the store's embedding tables,
    on the store's device.

    Serving has no training-time hotness trace, so absent a profile the
    budget splits uniformly across types and each type caches its
    lowest-id rows (every row is equally hot under the uniform profile;
    ``HotnessProfile.hottest`` then keeps ids stable)."""
    tables = store.embeddings
    uniform = hotness is None
    if uniform:
        hotness = HotnessProfile(
            counts={t: np.ones(a.shape[0], np.float64) for t, a in tables.items()}
        )
    total = int(cache_mb) << 20
    budget = total // max(1, len(tables))
    rows = {
        t: min(a.shape[0], budget // max(1, a.shape[1] * 4))
        for t, a in tables.items()
    }
    alloc = CacheAllocation(
        rows=rows,
        bytes_={t: rows[t] * tables[t].shape[1] * 4 for t in tables},
        total_bytes=total,
        policy="serve-uniform" if uniform else "serve",
    )
    return FeatureCache(tables, {}, alloc, hotness, kernels=kernels,
                        device=store.device)


class EmbeddingServer:
    """Serve embeddings / class scores from a materialized store.

    One :class:`MicroBatcher` fronts the device: a flush groups queued
    ``(ntype, nids)`` lookups per type, gathers each type's union of rows
    in a single ``FeatureCache.fetch_many`` call, scores the target-type
    rows with one head application on the store's device, and splits the
    batch back per request.  ``query`` blocks; ``submit`` returns a future for
    closed-loop concurrency tests and benchmarks."""

    def __init__(
        self,
        store: EmbeddingStore,
        *,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int = 1024,
        cache_mb: int = 4,
        kernels=None,
        hotness: Optional[HotnessProfile] = None,
        readmit_every: int = 0,
        deadline_ms: float = 0.0,
        flush_retries: int = 2,
        retry_backoff_ms: float = 1.0,
        breaker_threshold: int = 3,
        breaker_cooldown_ms: float = 1000.0,
        faults=None,
    ):
        self.store = store
        # degradation policy (DESIGN.md §12) + deterministic fault plan
        self.deadline_ms = float(deadline_ms)
        self.flush_retries = int(flush_retries)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_ms = float(breaker_cooldown_ms)
        self.faults = faults
        self.breaker_state = "closed"
        self.breaker_trips = 0
        self.breaker_recoveries = 0
        self.degraded_count = 0
        self.retry_count = 0
        self._consec_failures = 0
        self._breaker_opened_t = 0.0
        self._flush_index = 0  # attempted flushes (fault-plan coordinate)
        self.cache = _build_serve_cache(store, cache_mb, kernels, hotness)
        # online re-admission from the served-id trace: every fetch_many
        # already bumps the cache's access counters, so after every
        # `readmit_every` flushes the flusher thread re-splits the same
        # byte budget across types ∝ observed traffic and re-admits each
        # type's observed-hottest rows (0 = off).  Serving fronts
        # read-only materialized embeddings, so the re-allocation is the
        # hotness-only policy (all types share one miss penalty).
        self.readmit_every = int(readmit_every)
        self.readmits = 0
        self._flush_count = 0
        self._cache_bytes = int(cache_mb) << 20
        self._hotness_ema = {
            t: (
                hotness.counts[t].astype(np.float64)
                if hotness is not None and t in hotness.counts
                else np.ones(a.shape[0], np.float64)
            )
            for t, a in store.embeddings.items()
        }
        w, b = store.head_on_device()
        self._score = lambda e: torch.relu(e) @ w + b
        self._latencies: deque = deque(maxlen=100_000)
        self._count = 0
        self._stats_lock = threading.Lock()
        self._t_start = time.monotonic()
        self.batcher = MicroBatcher(
            self._flush,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            max_queue=max_queue,
        )

    # -- the flush (device hot path) ----------------------------------------

    @staticmethod
    def _group(items):
        """Group requests per type, remembering each one's batch slice."""
        grouped: Dict[str, List[np.ndarray]] = {}
        offsets: List[Tuple[str, int, int]] = []
        for ntype, nids, _ in items:
            lo = sum(len(x) for x in grouped.get(ntype, []))
            grouped.setdefault(ntype, []).append(nids)
            offsets.append((ntype, lo, lo + len(nids)))
        return ({t: np.concatenate(parts) for t, parts in grouped.items()},
                offsets)

    def _package(self, items, offsets, host_rows, scores, degraded=False):
        now = time.monotonic()
        out = []
        target = self.store.target_type
        for (ntype, nids, t_submit), (_, lo, hi) in zip(items, offsets):
            lat_ms = (now - t_submit) * 1e3
            out.append(
                ServeResult(
                    ntype=ntype,
                    embeddings=host_rows[ntype][lo:hi] if len(nids) else
                    np.zeros((0, self.store.hidden), np.float32),
                    scores=(
                        scores[lo:hi]
                        if ntype == target and scores is not None
                        else None
                    ),
                    latency_ms=lat_ms,
                )
            )
        with self._stats_lock:
            self._count += len(items)
            if degraded:
                self.degraded_count += len(items)
            for r in out:
                self._latencies.append(r.latency_ms)
        return out

    def _primary(self, items) -> List[ServeResult]:
        """The device hot path: cache gather + device scoring.  An
        exception here is a flush failure for the retry/breaker state
        machine, except a kernel build or launch error, which propagates.
        The fault plan's ``fail_flush``/``delay_flush`` triggers fire here,
        at the ``fetch_many`` call site, exactly as a transient device or
        cache error would; the plan's coordinate is the primary-*attempt*
        index (each retry advances it, so a ``count=1`` fault is a clean
        transient and ``count >= breaker_threshold * (flush_retries + 1)``
        forces a trip)."""
        requests, offsets = self._group(items)
        if self.faults is not None and self.faults:
            from repro_torch.data.faults import InjectedFault

            fi = self._flush_index
            self._flush_index += 1
            delay = self.faults.flush_delay(fi)
            if delay > 0:
                time.sleep(delay)
            if self.faults.flush_fault(fi) is not None:
                raise InjectedFault(
                    f"scheduled fail_flush fault at primary attempt {fi}")
        rows = self.cache.fetch_many(requests)  # one gather per type
        target = self.store.target_type
        scores = (
            self._score(rows[target]).cpu().numpy() if target in rows else None
        )
        host_rows = {t: r.cpu().numpy() for t, r in rows.items()}
        return self._package(items, offsets, host_rows, scores)

    def _degraded(self, items) -> List[ServeResult]:
        """The cache-bypass path: direct host gather from the store's
        embedding arrays + numpy head scoring.  Device- and cache-free, so
        it survives whatever broke the primary path; slower, never wrong."""
        requests, offsets = self._group(items)
        host_rows = {
            t: np.asarray(self.store.embeddings[t])[nids]
            for t, nids in requests.items()
        }
        target = self.store.target_type
        scores = None
        if target in host_rows:
            w = np.asarray(self.store.head["w"], np.float32)
            b = np.asarray(self.store.head["b"], np.float32)
            scores = np.maximum(host_rows[target], 0.0) @ w + b
        return self._package(items, offsets, host_rows, scores, degraded=True)

    def _oldest_deadline_blown(self, items, extra_ms: float = 0.0) -> bool:
        if self.deadline_ms <= 0:
            return False
        age_ms = (time.monotonic() - min(t for _, _, t in items)) * 1e3
        return age_ms + extra_ms >= self.deadline_ms

    def _flush(self, items: List[Tuple[str, np.ndarray, float]]) -> List[ServeResult]:
        out = self._flush_with_degradation(items)
        self._flush_count += 1
        if self.readmit_every and self._flush_count % self.readmit_every == 0:
            self._readmit()
        return out

    def _flush_with_degradation(self, items) -> List[ServeResult]:
        """Breaker + retry state machine around :meth:`_primary` (module
        docstring; DESIGN.md §12).  Every exit answers the flush — the
        degraded path is the fallback, never an exception to callers —
        except for kernel faults (``_KERNEL_FAULTS``), which propagate."""
        if self.breaker_state == "open":
            since_ms = (time.monotonic() - self._breaker_opened_t) * 1e3
            if since_ms < self.breaker_cooldown_ms:
                return self._degraded(items)
            self.breaker_state = "half_open"
        if self.breaker_state == "half_open":
            # one probe, no retries: failure re-opens, success closes
            try:
                out = self._primary(items)
            except _KERNEL_FAULTS:
                raise
            except Exception:
                self.breaker_state = "open"
                self._breaker_opened_t = time.monotonic()
                return self._degraded(items)
            with self._stats_lock:
                self.breaker_state = "closed"
                self.breaker_recoveries += 1
                self._consec_failures = 0
            return out
        # closed: primary with bounded retries under the oldest deadline
        attempts = self.flush_retries + 1
        for a in range(attempts):
            try:
                out = self._primary(items)
                self._consec_failures = 0
                return out
            except _KERNEL_FAULTS:
                raise
            except Exception:
                backoff_ms = self.retry_backoff_ms * (2 ** a)
                if (a + 1 < attempts
                        and not self._oldest_deadline_blown(items, backoff_ms)):
                    with self._stats_lock:
                        self.retry_count += 1
                    time.sleep(backoff_ms / 1e3)
                    continue
                break
        self._consec_failures += 1
        if self._consec_failures >= self.breaker_threshold:
            with self._stats_lock:
                self.breaker_state = "open"
                self.breaker_trips += 1
            self._breaker_opened_t = time.monotonic()
        return self._degraded(items)

    def _readmit(self, decay: float = 0.5) -> None:
        """Re-allocate the serve cache from the served-id trace.

        Runs on the flusher thread — the only thread that calls
        ``fetch_many`` — so the cache swap needs no extra locking.  The
        drained access counters fold into a decayed running profile, the
        unchanged byte budget re-splits across types ∝ observed traffic
        (hotness-only: materialized embeddings are read-only and
        penalty-uniform), and ``update_residency`` moves only the delta."""
        window = self.cache.take_access_counts()
        for t, ema in self._hotness_ema.items():
            ema *= decay
            if t in window:
                ema += window[t]
        profile = HotnessProfile(counts=self._hotness_ema)
        tables = self.store.embeddings
        pen = MissPenaltyProfile(
            ratios={t: 1.0 for t in tables},
            learnable={t: False for t in tables},
            dims={t: a.shape[1] for t, a in tables.items()},
        )
        alloc = allocate_cache(
            profile, pen, self._cache_bytes,
            {t: a.shape[0] for t, a in tables.items()}, hotness_only=True,
        )
        self.cache.update_residency(alloc, profile)
        self.readmits += 1

    # -- client surface ------------------------------------------------------

    def submit(self, nids: Sequence[int], ntype: Optional[str] = None) -> _Future:
        """Async lookup: returns a future resolving to a :class:`ServeResult`."""
        t = ntype or self.store.target_type
        if t not in self.store.embeddings:
            raise KeyError(
                f"no materialized embeddings for type {t!r} "
                f"(have {sorted(self.store.embeddings)})"
            )
        arr = np.asarray(nids, dtype=np.int64).reshape(-1)
        return self.batcher.submit((t, arr, time.monotonic()))

    def query(
        self, nids: Sequence[int], ntype: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> ServeResult:
        """Blocking lookup (submit + wait for the micro-batch flush).

        With ``deadline_ms`` configured the wait is bounded by it by
        default (explicit ``timeout`` wins); retries and breaker trips are
        budgeted against the same deadline, so a degraded answer normally
        lands inside it."""
        if timeout is None and self.deadline_ms > 0:
            timeout = self.deadline_ms / 1e3
        return self.submit(nids, ntype).result(timeout)

    # -- stats / lifecycle ---------------------------------------------------

    def stats(self) -> ServeStats:
        with self._stats_lock:
            lats = np.asarray(self._latencies, np.float64)
            count = self._count
        wall = max(time.monotonic() - self._t_start, 1e-9)
        return ServeStats(
            count=count,
            flushes=self.batcher.flushes,
            p50_ms=float(np.percentile(lats, 50)) if len(lats) else 0.0,
            p99_ms=float(np.percentile(lats, 99)) if len(lats) else 0.0,
            qps=count / wall,
            hit_rates=self.cache.hit_rates(),
            breaker_state=self.breaker_state,
            breaker_trips=self.breaker_trips,
            breaker_recoveries=self.breaker_recoveries,
            degraded=self.degraded_count,
            retries=self.retry_count,
        )

    def reset_stats(self) -> None:
        with self._stats_lock:
            self._latencies.clear()
            self._count = 0
            self._t_start = time.monotonic()
        self.cache.reset_stats()

    def close(self) -> None:
        self.batcher.close()

    def __enter__(self) -> "EmbeddingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
