"""Prefetcher — the shared double-buffered background producer.

One thread, one bounded queue, and a strict lifecycle contract; the HGNN
host pipeline (:class:`~repro_torch.data.sample_stream.SampleStream`) and
the session's pipelined ``evaluate`` are built on it rather than
hand-rolling thread + queue management:

  * items are produced by calling ``make(i)`` for ``i = 0, 1, 2, ...`` in a
    daemon thread; up to ``depth`` finished items wait in the queue, so the
    consumer (the device-step loop) never blocks on host work that could
    have happened during the previous step;
  * an exception inside ``make`` is captured and re-raised *in the
    consumer* at the next ``__next__`` — background failures are never
    silent and never hang the training loop;
  * ``close()`` is idempotent, drains the queue, and **joins** the producer
    thread; ``__next__`` after ``close()`` raises :class:`RuntimeError`
    instead of blocking on an empty queue;
  * a finite ``num_items`` ends iteration with ``StopIteration`` once the
    producer is exhausted (infinite when ``None``).

A copy of the reference's ``repro/data/prefetch.py``; only this docstring
differs (the LM ``TokenPipeline`` that also sits on it in the reference is
not ported yet).  It imports neither torch nor numpy.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

__all__ = ["Prefetcher"]

_POLL_S = 0.05  # producer/consumer poll interval while checking for shutdown


class _Done:
    """Queue sentinel: producer finished all ``num_items`` items."""


class _Failure:
    """Queue sentinel: producer raised; carries the exception to re-raise."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Background producer of ``make(0), make(1), ...`` with bounded lookahead.

    Iterator protocol; also a context manager (``close()`` on exit).
    """

    def __init__(
        self,
        make: Callable[[int], object],
        depth: int = 2,
        num_items: Optional[int] = None,
        name: str = "prefetcher",
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if num_items is not None and num_items < 0:
            raise ValueError(f"num_items must be >= 0, got {num_items}")
        self._make = make
        self.depth = depth
        self.num_items = num_items
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._producer, name=name,
                                        daemon=True)
        self._thread.start()

    # -- producer side -------------------------------------------------------

    def _producer(self):
        i = 0
        try:
            while not self._stop.is_set():
                if self.num_items is not None and i >= self.num_items:
                    self._put(_Done())
                    return
                item = self._make(i)
                i += 1
                if not self._put(item):
                    return  # closed while waiting for queue space
        except BaseException as exc:  # noqa: BLE001 — delivered to consumer
            try:
                if not self._stop.is_set():
                    self._put(_Failure(exc))
            except BaseException:
                # interpreter teardown: queue internals may already be gone;
                # a daemon thread must exit silently, not spray noise
                pass

    # queue.Full is bound as a default arg: at interpreter shutdown module
    # globals can be cleared under a daemon thread's feet, and a NameError
    # here would masquerade as a producer failure
    def _put(self, item, _Full=queue.Full) -> bool:
        """Blocking put that aborts (returns False) once close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except _Full:
                continue
        return False

    # -- consumer side -------------------------------------------------------

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError("Prefetcher is closed")
        while True:
            try:
                item = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                if self._closed:
                    raise RuntimeError("Prefetcher is closed") from None
                if not self._thread.is_alive():
                    # producer died without posting a sentinel (should not
                    # happen, but never hang the training loop on it)
                    raise RuntimeError(
                        "Prefetcher producer exited unexpectedly"
                    ) from None
                continue
            if isinstance(item, _Done):
                self._q.put(item)  # keep the sentinel for repeated __next__
                raise StopIteration
            if isinstance(item, _Failure):
                self.close()
                raise item.exc
            return item

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 5.0, warn: bool = True,
              _Empty=queue.Empty) -> None:
        """Stop the producer, drain the queue, and join the thread.

        Idempotent — including after a producer failure already shut the
        stream down from ``__next__``, and when called again mid-teardown.
        After it returns ``__next__`` raises :class:`RuntimeError`.  A
        producer stuck inside ``make`` longer than ``timeout`` cannot be
        killed from here — that case is reported with a
        :class:`RuntimeWarning` (the daemon thread exits at its next
        queue/stop check and cannot re-enter ``make``).  ``warn=False``
        suppresses the warning — used by ``__del__``, where a stream GC'd
        mid-run at interpreter shutdown must not spray warnings from a
        half-torn-down runtime.
        """
        if getattr(self, "_closed", True):  # True: constructor failed early
            return
        self._closed = True
        stop = getattr(self, "_stop", None)
        thread = getattr(self, "_thread", None)
        if stop is None or thread is None:  # constructor failed part-way
            return
        stop.set()
        # the producer may be blocked on a full queue; drain so its
        # stop-aware put() observes the event and the thread exits
        try:
            while True:
                self._q.get_nowait()
        except _Empty:
            pass
        except BaseException:
            pass  # queue internals gone at interpreter shutdown
        try:
            thread.join(timeout=timeout)
        except RuntimeError:
            # joining from the thread itself / runtime tearing down
            return
        if warn and thread.is_alive():
            import warnings

            warnings.warn(
                f"{thread.name}: producer still inside make() after "
                f"{timeout}s close timeout; it will exit at its next stop "
                "check", RuntimeWarning, stacklevel=2,
            )

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        # best-effort: don't leak threads on GC, and stay silent when the
        # GC runs at interpreter shutdown (no warnings, no queue errors)
        try:
            self.close(timeout=0.1, warn=False)
        except BaseException:
            pass
