"""Deterministic fault injection (DESIGN.md §12).

Fault tolerance that is only exercised by real crashes is anecdotal; this
module makes every failure domain *schedulable* so the recovery guarantees
are regression-tested.  A :class:`FaultPlan` is a frozen, picklable list of
:class:`FaultSpec` triggers keyed on deterministic coordinates — pool item
index, worker id, attempt number, flush index — never wall-clock time, so
a drill replays identically on every run:

  * ``kill_worker``  — sampler worker ``worker`` calls ``os._exit(73)``
    *before* producing item ``step`` (first attempt only, so the
    supervisor's respawned replacement sails through the replay).  Drives
    the worker-supervision battery: a pooled frozen-mode ``fit`` must
    complete with bit-identical losses.
  * ``poison_slot``  — the worker completes item ``step``'s arena write
    but then corrupts the slot's ``write_seq`` stamp, so the consumer's
    ``resolve`` fails loudly (the torn-write detector battery).
  * ``raise_item``   — the worker raises :class:`InjectedFault` from
    ``task(step)`` (first attempt only): the classic transient error.
  * ``fail_flush``   — the serving tier's primary flush path raises
    :class:`InjectedFault` for ``count`` consecutive flushes starting at
    flush index ``step`` (drives retry-with-backoff and the circuit
    breaker into the degraded cache-bypass path).
  * ``delay_flush``  — the flush sleeps ``delay_s`` first (deadline
    drills).

Consumed by ``SampleStageTask``/``EmbeddingServer`` (both accept a
``faults=`` plan), the chaos test batteries, and
``chip_smoke.py``.  Deliberately torch-free and numpy-free: plans cross
the spawn boundary into sampler workers.

A copy of the reference's ``repro/data/faults.py``; only this docstring
differs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

__all__ = ["FaultKind", "FaultSpec", "FaultPlan", "InjectedFault"]

FaultKind = str

KINDS = ("kill_worker", "poison_slot", "raise_item", "fail_flush",
         "delay_flush")

# exit code of an injected worker kill — distinctive in WorkerDiedError
# messages and never produced by a Python exception path
KILL_EXIT_CODE = 73


class InjectedFault(RuntimeError):
    """An error raised on purpose by a :class:`FaultPlan` trigger."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``step`` is the pool item index (worker-side kinds) or the flush index
    (serve-side kinds).  ``worker`` narrows worker-side kinds to one worker
    id (-1 = any).  ``count`` widens ``fail_flush``/``delay_flush`` to that
    many consecutive flushes.  ``first_attempt_only`` (default) makes
    ``kill_worker``/``raise_item`` fire only on a worker's first
    incarnation — the respawned replacement replays the stripe cleanly."""

    kind: FaultKind
    step: int
    worker: int = -1
    count: int = 1
    delay_s: float = 0.0
    first_attempt_only: bool = True

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.step < 0:
            raise ValueError(f"step must be >= 0, got {self.step}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of faults (see module docstring).

    Query helpers take the exact coordinates the hook sites have — worker
    id + attempt + item index, or flush index — and return whether/what to
    inject.  An empty plan injects nothing, so hook sites can hold a plan
    unconditionally."""

    faults: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    # -- worker-side queries ------------------------------------------------

    def _worker_match(self, kind: str, wid: int, attempt: int,
                      item: int) -> Optional[FaultSpec]:
        for f in self.faults:
            if f.kind != kind or f.step != item:
                continue
            if f.worker >= 0 and f.worker != wid:
                continue
            if f.first_attempt_only and attempt > 0:
                continue
            return f
        return None

    def kill_at(self, wid: int, attempt: int, item: int) -> bool:
        """Should worker ``wid`` (incarnation ``attempt``) die before
        producing ``item``?"""
        return self._worker_match("kill_worker", wid, attempt, item) is not None

    def raise_at(self, wid: int, attempt: int, item: int) -> bool:
        """Should the task raise :class:`InjectedFault` for ``item``?"""
        return self._worker_match("raise_item", wid, attempt, item) is not None

    def poison_at(self, wid: int, attempt: int, item: int) -> bool:
        """Should the arena slot written for ``item`` be stamp-corrupted?"""
        return self._worker_match("poison_slot", wid, attempt, item) is not None

    # -- serve-side queries --------------------------------------------------

    def flush_fault(self, flush_index: int) -> Optional[FaultSpec]:
        """The ``fail_flush`` spec covering ``flush_index``, if any."""
        for f in self.faults:
            if f.kind == "fail_flush" and f.step <= flush_index < f.step + f.count:
                return f
        return None

    def flush_delay(self, flush_index: int) -> float:
        """Seconds the flush at ``flush_index`` should sleep first."""
        for f in self.faults:
            if f.kind == "delay_flush" and f.step <= flush_index < f.step + f.count:
                return f.delay_s
        return 0.0

    # -- interchange ---------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(f) for f in self.faults])

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls(faults=tuple(FaultSpec(**d) for d in json.loads(s)))

    def __bool__(self) -> bool:
        return bool(self.faults)
