"""Shared-memory backing for :class:`~repro_torch.graph.hetgraph.HetGraph`.

The multi-worker sampling pool (``repro_torch.data.worker_pool``, DESIGN.md §9)
feeds N sampler processes from **one** copy of the graph: topology
(``indptr``/``indices`` per mono-relation CSR), labels, the train-node set,
and optionally frozen feature tables are exported once into a single
:mod:`multiprocessing.shared_memory` segment, and each worker maps them
zero-copy — no pickling of the graph per task, no per-worker replicas.

Three pieces:

:func:`share_graph`
    Owner side.  Copies the graph's arrays into a fresh named segment and
    returns a :class:`SharedHetGraph` whose picklable :attr:`~SharedHetGraph.
    handle` describes the layout.  Creation is transactional: any failure
    while populating the segment closes **and unlinks** it before re-raising,
    so an error path never leaks a ``/dev/shm`` segment.

:func:`attach`
    Worker side.  Maps the segment named by a :class:`GraphHandle` and
    rebuilds a read-only :class:`HetGraph` (plus any exported staging tables)
    whose numpy arrays are views into the shared buffer.  Attaching never
    registers with the ``resource_tracker`` (workers must not unlink the
    owner's segment at exit, nor warn about "leaked" memory they don't own).

Lifecycle
    ``SharedHetGraph.close()`` unmaps the owner's view; ``unlink()`` (also
    run by ``__exit__`` and, best-effort, ``__del__``) removes the segment
    from the OS.  ``AttachedHetGraph.close()`` unmaps a worker's view and is
    likewise idempotent.  :func:`live_segments` lists segments still present
    under ``/dev/shm`` — the leak check used by tests and CI.

This module is deliberately torch-free: sampler workers import it (via
``repro_torch.data.worker_pool``) and must stay lightweight numpy processes.

A copy of the reference's ``repro/graph/shm.py`` with one deliberate
difference: the port names its segments ``heta-tshm-<pidhex>-<token>``, not
``heta-shm-...``.  The reference's :func:`live_segments` and
:func:`cleanup_stale_segments` list every ``/dev/shm`` entry under their
prefix, whoever made it; under the same prefix a port segment alive in one
test process would show up in the reference's leak checks running in
another (pytest-xdist workers share ``/dev/shm``), and the reference's
janitor would judge the port's segments by its own rules.  With its own
prefix each package lists and sweeps only its own segments.
"""

from __future__ import annotations

import dataclasses
import os
import secrets
import time
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.graph.hetgraph import CSR, HetGraph, Relation

__all__ = [
    "GraphHandle",
    "SharedHetGraph",
    "AttachedHetGraph",
    "share_graph",
    "attach",
    "ArraysHandle",
    "SharedArrays",
    "AttachedArrays",
    "share_arrays",
    "attach_arrays",
    "ArenaHandle",
    "BatchArena",
    "AttachedArena",
    "ArenaStalledError",
    "create_arena",
    "attach_arena",
    "live_segments",
    "cleanup_stale_segments",
]

_ALIGN = 64  # byte alignment of each array inside the segment
SEGMENT_PREFIX = "heta-tshm-"  # the reference uses "heta-shm-" (see above)


@dataclasses.dataclass(frozen=True)
class ArrayRef:
    """Location of one array inside the shared segment."""

    offset: int
    shape: Tuple[int, ...]
    dtype: str


@dataclasses.dataclass(frozen=True)
class GraphHandle:
    """Picklable description of a shared graph segment.

    Workers receive this (a few hundred bytes) instead of the graph itself;
    :func:`attach` turns it back into a :class:`HetGraph` of zero-copy views.
    Array keys: ``rel/<i>/indptr|indices`` (relation order matches
    :attr:`relations`), ``labels``, ``train_nodes``, ``feat/<ntype>`` and
    ``table/<name>`` for exported staging tables.
    """

    segment: str
    owner_pid: int
    num_nodes: Tuple[Tuple[str, int], ...]
    relations: Tuple[Tuple[str, str, str], ...]
    target_type: str
    num_classes: int
    graph_name: str
    arrays: Tuple[Tuple[str, ArrayRef], ...]

    @property
    def table_names(self) -> Tuple[str, ...]:
        return tuple(k[len("table/"):] for k, _ in self.arrays
                     if k.startswith("table/"))


def _layout(arrays: Dict[str, np.ndarray]) -> Tuple[Dict[str, ArrayRef], int]:
    refs, off = {}, 0
    for key, arr in arrays.items():
        if arr.dtype.hasobject:
            # object arrays are pointers — meaningless in another process
            raise ValueError(f"array {key!r} has object dtype; only plain "
                             "numeric/bool arrays can be shared")
        refs[key] = ArrayRef(offset=off, shape=tuple(arr.shape),
                             dtype=arr.dtype.str)
        off += -(-arr.nbytes // _ALIGN) * _ALIGN
    return refs, max(off, 1)


def _view(buf, ref: ArrayRef, writeable: bool = False) -> np.ndarray:
    arr = np.ndarray(ref.shape, dtype=np.dtype(ref.dtype), buffer=buf,
                     offset=ref.offset)
    if not writeable:
        arr.flags.writeable = False
    return arr


def _open_attached(name: str, owner_pid: int) -> shared_memory.SharedMemory:
    """Attach to an existing segment, tracker-neutrally.

    Sampler workers are always *spawned children* of the owner, and spawn
    hands them the owner's resource-tracker fd — so their attach-time
    registration is a set-level no-op on the tracker the owner already
    registered with, and the owner's eventual ``unlink()`` unregisters the
    single entry.  Explicit ``track=False`` / ``unregister`` games are not
    only unnecessary here, they *remove the owner's entry* (same tracker!)
    and break crash cleanup.  ``owner_pid`` is carried in the handle for
    diagnostics and for any future non-child attacher that would need its
    own untracking."""
    return shared_memory.SharedMemory(name=name)


class SharedHetGraph:
    """Owner handle of a shared graph segment (see module docstring)."""

    def __init__(self, shm: shared_memory.SharedMemory, handle: GraphHandle):
        self._shm = shm
        self.handle = handle
        self._closed = False
        self._unlinked = False

    # owner-side (writable) view, used by share_graph to populate and by
    # tests to verify the attach path is genuinely zero-copy
    def _array(self, key: str) -> np.ndarray:
        refs = dict(self.handle.arrays)
        return _view(self._shm.buf, refs[key], writeable=True)

    @property
    def nbytes(self) -> int:
        return self._shm.size

    def close(self) -> None:
        """Unmap the owner's view (the segment itself stays until unlink)."""
        if not self._closed:
            self._closed = True
            self._shm.close()

    def unlink(self) -> None:
        """Remove the segment from the OS.  Idempotent; implies close()."""
        self.close()
        if not self._unlinked:
            self._unlinked = True
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def __enter__(self) -> "SharedHetGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.unlink()

    def __del__(self):  # best-effort: never leak a segment on error paths
        try:
            self.unlink()
        except BaseException:
            pass


class AttachedHetGraph:
    """A worker's zero-copy view of a shared graph segment.

    ``graph`` is a fully functional read-only :class:`HetGraph`; ``tables``
    maps exported staging-table names to read-only arrays.  Keep this object
    alive as long as any view is in use; ``close()`` unmaps."""

    def __init__(self, handle: GraphHandle):
        self.handle = handle
        self._shm = _open_attached(handle.segment, handle.owner_pid)
        self._closed = False
        refs = dict(handle.arrays)
        relations: Dict[Relation, CSR] = {}
        for i, (src, etype, dst) in enumerate(handle.relations):
            relations[Relation(src, etype, dst)] = CSR(
                indptr=_view(self._shm.buf, refs[f"rel/{i}/indptr"]),
                indices=_view(self._shm.buf, refs[f"rel/{i}/indices"]),
            )
        features = {
            k[len("feat/"):]: _view(self._shm.buf, r)
            for k, r in refs.items() if k.startswith("feat/")
        }
        self.graph = HetGraph(
            num_nodes=dict(handle.num_nodes),
            relations=relations,
            target_type=handle.target_type,
            num_classes=handle.num_classes,
            features=features,
            labels=_view(self._shm.buf, refs["labels"]),
            train_nodes=_view(self._shm.buf, refs["train_nodes"]),
            name=handle.graph_name,
        )
        self.tables: Dict[str, np.ndarray] = {
            k[len("table/"):]: _view(self._shm.buf, r)
            for k, r in refs.items() if k.startswith("table/")
        }

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.graph = None
            self.tables = {}
            self._shm.close()

    def __enter__(self) -> "AttachedHetGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except BaseException:
            pass


def share_graph(
    graph: HetGraph,
    include_features: bool = True,
    tables: Optional[Dict[str, np.ndarray]] = None,
    name: Optional[str] = None,
) -> SharedHetGraph:
    """Export ``graph`` (and optional staging ``tables``) into one segment.

    ``include_features=False`` skips the graph's dense feature arrays —
    sampler-only pools never read them, and staging pools read the
    authoritative ``tables`` snapshot instead (which includes frozen
    learnable rows the graph doesn't carry).  Transactional: a failure while
    populating closes and unlinks the segment before re-raising.
    """
    rel_list: List[Tuple[Relation, CSR]] = sorted(
        graph.relations.items(), key=lambda rc: rc[0]
    )
    arrays: Dict[str, np.ndarray] = {}
    for i, (_, csr) in enumerate(rel_list):
        arrays[f"rel/{i}/indptr"] = csr.indptr
        arrays[f"rel/{i}/indices"] = csr.indices
    arrays["labels"] = np.asarray(graph.labels)
    arrays["train_nodes"] = np.asarray(graph.train_nodes)
    if include_features:
        for t, f in graph.features.items():
            arrays[f"feat/{t}"] = np.ascontiguousarray(f)
    for tname, tab in (tables or {}).items():
        arrays[f"table/{tname}"] = np.ascontiguousarray(tab)

    refs, total = _layout(arrays)
    segment = name or f"{SEGMENT_PREFIX}{os.getpid():x}-{secrets.token_hex(4)}"
    shm = shared_memory.SharedMemory(name=segment, create=True, size=total)
    handle = GraphHandle(
        segment=segment,
        owner_pid=os.getpid(),
        # insertion order, NOT sorted: per-type arena offsets downstream
        # follow the graph dict's iteration order, so the attached twin
        # must reproduce it exactly (DESIGN.md §13)
        num_nodes=tuple(graph.num_nodes.items()),
        relations=tuple((r.src, r.etype, r.dst) for r, _ in rel_list),
        target_type=graph.target_type,
        num_classes=int(graph.num_classes),
        graph_name=graph.name,
        arrays=tuple(refs.items()),
    )
    store = SharedHetGraph(shm, handle)
    try:
        for key, arr in arrays.items():
            np.copyto(store._array(key), arr, casting="no")
    except BaseException:
        store.unlink()
        raise
    return store


def attach(handle: GraphHandle) -> AttachedHetGraph:
    """Map the segment described by ``handle`` (see :class:`AttachedHetGraph`)."""
    return AttachedHetGraph(handle)


# --------------------------------------------------------------------------
# generic shared array bundles (the serving tier's embedding store backing)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArraysHandle:
    """Picklable description of a generic shared array bundle.

    The graph-shaped :class:`GraphHandle` above hard-codes the HetGraph
    layout; the serving tier (``repro_torch.serve``, DESIGN.md §10) exports a
    *flat* dict of named arrays — per-type embedding tables plus the
    classifier head — so serving processes attach the materialized store
    zero-copy.  ``meta`` carries small string key/value pairs (target type,
    class count, per-type layer indices) alongside the array refs.
    """

    segment: str
    owner_pid: int
    arrays: Tuple[Tuple[str, ArrayRef], ...]
    meta: Tuple[Tuple[str, str], ...] = ()

    @property
    def meta_dict(self) -> Dict[str, str]:
        return dict(self.meta)


class SharedArrays:
    """Owner handle of a shared array bundle (same lifecycle discipline as
    :class:`SharedHetGraph`: ``close()`` unmaps, ``unlink()`` removes,
    ``__exit__``/``__del__`` never leak a segment)."""

    def __init__(self, shm: shared_memory.SharedMemory, handle: ArraysHandle):
        self._shm = shm
        self.handle = handle
        self._closed = False
        self._unlinked = False

    def array(self, key: str) -> np.ndarray:
        """Owner-side writable view of one array in the segment."""
        refs = dict(self.handle.arrays)
        return _view(self._shm.buf, refs[key], writeable=True)

    def arrays(self) -> Dict[str, np.ndarray]:
        """Owner-side writable views of every array, keyed as exported."""
        return {k: _view(self._shm.buf, r, writeable=True)
                for k, r in self.handle.arrays}

    @property
    def nbytes(self) -> int:
        return self._shm.size

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._shm.close()

    def unlink(self) -> None:
        self.close()
        if not self._unlinked:
            self._unlinked = True
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def __enter__(self) -> "SharedArrays":
        return self

    def __exit__(self, *exc) -> None:
        self.unlink()

    def __del__(self):
        try:
            self.unlink()
        except BaseException:
            pass


class AttachedArrays:
    """A reader's zero-copy view of a shared array bundle.

    ``arrays`` maps exported names to read-only views into the segment; keep
    this object alive while any view is in use.  ``close()`` unmaps and is
    idempotent; attaching never unlinks the owner's segment."""

    def __init__(self, handle: ArraysHandle):
        self.handle = handle
        self._shm = _open_attached(handle.segment, handle.owner_pid)
        self._closed = False
        self.arrays: Dict[str, np.ndarray] = {
            k: _view(self._shm.buf, r) for k, r in handle.arrays
        }

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.arrays = {}
            self._shm.close()

    def __enter__(self) -> "AttachedArrays":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except BaseException:
            pass


def share_arrays(
    arrays: Dict[str, np.ndarray],
    meta: Optional[Dict[str, str]] = None,
    name: Optional[str] = None,
) -> SharedArrays:
    """Export a dict of named arrays into one shared segment.

    Transactional like :func:`share_graph`: a failure while populating
    closes and unlinks the segment before re-raising, so error paths never
    leak ``/dev/shm`` space."""
    src = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    refs, total = _layout(src)
    segment = name or f"{SEGMENT_PREFIX}{os.getpid():x}-{secrets.token_hex(4)}"
    shm = shared_memory.SharedMemory(name=segment, create=True, size=total)
    handle = ArraysHandle(
        segment=segment,
        owner_pid=os.getpid(),
        arrays=tuple(refs.items()),
        meta=tuple(sorted((meta or {}).items())),
    )
    store = SharedArrays(shm, handle)
    try:
        for key, arr in src.items():
            np.copyto(store.array(key), arr, casting="no")
    except BaseException:
        store.unlink()
        raise
    return store


def attach_arrays(handle: ArraysHandle) -> AttachedArrays:
    """Map the bundle described by ``handle`` (see :class:`AttachedArrays`)."""
    return AttachedArrays(handle)


# --------------------------------------------------------------------------
# batch arena — fixed-slot shm ring buffer for the worker→consumer hot path
# --------------------------------------------------------------------------
#
# DESIGN.md §11.  N sampler workers write sampled batches (and, when a
# StackRecipe is active, the pre-staged host arrays) directly into fixed
# per-worker slots of one shared segment; the mp.Queue between worker and
# consumer carries only a tiny picklable slot descriptor — zero pickled
# ndarrays on the hot path.
#
# Concurrency model (pragmatic seqlock — single writer per word, aligned
# 8-byte loads/stores, which x86-64 and AArch64 perform atomically and
# in order for this single-producer/single-consumer pattern):
#
#   per slot:  write_seq   (worker-owned)   odd while the worker is writing,
#                                           ``2*use + 2`` once generation
#                                           ``use`` of the slot is complete
#              release_seq (consumer-owned) number of completed consumptions;
#                                           the worker may overwrite the slot
#                                           for generation ``use`` only once
#                                           ``release_seq >= use``
#   tables:    one global version word, odd while the trainer republishes
#              learnable tables; readers copy-then-revalidate (torn reads
#              retry).  Immutable table regions skip the copy and hand out
#              zero-copy views.
#
# Slot assignment is a pure function of the pool item index (stripe order,
# matching ``worker_pool``): worker ``w = i % stride`` owns the sub-ring
# ``[w*depth, (w+1)*depth)``, so no two writers ever share a slot and no
# cross-process allocator is needed.  Backpressure falls out of the
# release gate: when every slot of a worker's sub-ring is in flight the
# worker polls until the consumer releases one (or the pool stops).


_CTRL_WORDS = 2  # per-slot control: [write_seq, release_seq]

# write_seq value stamped by invalidate_worker_slots: odd (so resolve()
# rejects it as torn) and impossibly large (so it can never collide with a
# live generation's 2*use+1) — any SlotRef that still points at the slot
# fails loudly instead of reading a dead worker's half-written payload
_POISON_SEQ = (1 << 63) | 1


class ArenaStalledError(RuntimeError):
    """An arena writer's backpressure poll timed out (DESIGN.md §12).

    The release gate (`release_seq >= use`) is consumer-driven; if the
    consumer process dies without setting the pool stop event, a worker
    blocked on a full sub-ring would spin forever.  The bounded wait turns
    that hang into this error, so the worker exits and the death is
    observable."""


@dataclasses.dataclass(frozen=True)
class ArenaHandle:
    """Picklable description of a batch-arena segment.

    ``fields`` are slot-relative :class:`ArrayRef`\\ s (identical layout in
    every slot); ``tables`` are segment-absolute refs of the staging-table
    region.  ``stride`` is the worker count; ``slot_for`` maps a pool item
    index to its (slot, generation) pair."""

    segment: str
    owner_pid: int
    stride: int  # worker count; worker w owns slots [w*depth, (w+1)*depth)
    depth: int  # slots per worker (= pool prefetch depth)
    fields: Tuple[Tuple[str, ArrayRef], ...]  # slot-relative layout
    slot_bytes: int  # aligned byte stride between consecutive slots
    slots_offset: int  # absolute offset of slot 0
    tables: Tuple[Tuple[str, ArrayRef], ...] = ()  # absolute offsets
    tables_mutable: bool = False

    @property
    def n_slots(self) -> int:
        return self.stride * self.depth

    def slot_for(self, item: int) -> Tuple[int, int]:
        """Map pool item index -> (slot, use generation)."""
        w, k = item % self.stride, item // self.stride
        return w * self.depth + k % self.depth, k // self.depth


class _ArenaOps:
    """Slot/table protocol shared by the owner and attached sides."""

    _shm: shared_memory.SharedMemory
    handle: ArenaHandle

    def _bind_views(self) -> None:
        h = self.handle
        buf = self._shm.buf
        self._tver = np.ndarray((1,), dtype=np.uint64, buffer=buf, offset=0)
        self._ctrl = np.ndarray((h.n_slots, _CTRL_WORDS), dtype=np.uint64,
                                buffer=buf, offset=_ALIGN)
        self._table_refs = dict(h.tables)

    # -- slot protocol ----------------------------------------------------

    def slot_views(self, slot: int, writable: bool = False
                   ) -> Dict[str, np.ndarray]:
        """Views of one slot's arrays (writable only on the writing worker)."""
        base = self.handle.slots_offset + slot * self.handle.slot_bytes
        buf = self._shm.buf
        return {
            k: _view(buf, ArrayRef(base + r.offset, r.shape, r.dtype),
                     writeable=writable)
            for k, r in self.handle.fields
        }

    def slot_state(self, slot: int) -> Tuple[int, int]:
        """(write_seq, release_seq) of one slot."""
        return int(self._ctrl[slot, 0]), int(self._ctrl[slot, 1])

    def wait_writable(self, slot: int, use: int, stop=None,
                      timeout: Optional[float] = None,
                      poll: float = 5e-4) -> bool:
        """Block until generation ``use`` of ``slot`` may be written.

        Returns False if ``stop`` is set or ``timeout`` elapses first (the
        backpressure gate doubles as the pool-shutdown exit)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while int(self._ctrl[slot, 1]) < use:
            if stop is not None and stop.is_set():
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(poll)
        return True

    def begin_write(self, slot: int, use: int) -> None:
        self._ctrl[slot, 0] = 2 * use + 1  # odd: payload being written

    def end_write(self, slot: int, use: int) -> None:
        self._ctrl[slot, 0] = 2 * use + 2  # even: generation `use` complete

    def resolve(self, slot: int, use: int) -> Dict[str, np.ndarray]:
        """Consumer side: read-only views of a completed slot generation.

        The descriptor arrives on the queue strictly after ``end_write``, so
        an odd/short ``write_seq`` here is a protocol violation, not a race."""
        seq = int(self._ctrl[slot, 0])
        if seq == _POISON_SEQ:
            raise RuntimeError(
                f"arena slot {slot} generation {use}: slot was invalidated "
                "after its writer died (stale SlotRef; DESIGN.md §12)")
        if seq != 2 * use + 2:
            raise RuntimeError(
                f"arena slot {slot} generation {use}: write_seq={seq}, "
                f"expected {2 * use + 2} (torn or out-of-order write)")
        return self.slot_views(slot, writable=False)

    def release(self, slot: int, use: int) -> None:
        """Consumer side: hand generation ``use`` of ``slot`` back to its
        writer.  Call only once every view of the slot is dead."""
        self._ctrl[slot, 1] = use + 1

    def poison_slot(self, slot: int) -> None:
        """Stamp one slot's ``write_seq`` torn (fault injection; the slot
        heals on the next ``begin_write``/``end_write`` pair)."""
        self._ctrl[slot, 0] = _POISON_SEQ

    def invalidate_worker_slots(self, wid: int) -> None:
        """Poison the ``write_seq`` of worker ``wid``'s whole sub-ring
        (DESIGN.md §12 slot-invalidation rule).

        Called by the pool supervisor before respawning a dead worker: a
        crashed writer may have left any of its slots mid-write (odd seq)
        or stamped-complete-but-undelivered.  Stamping every slot with the
        poison generation makes any stale :class:`SlotRef` fail loudly in
        :meth:`resolve` instead of silently yielding a torn or duplicated
        payload; the replacement worker's own ``begin_write``/``end_write``
        restores valid stamps as it deterministically replays the stripe.
        ``release_seq`` is consumer-owned and left untouched — the
        replacement writer still honors the normal backpressure gate."""
        if not 0 <= wid < self.handle.stride:
            raise ValueError(
                f"wid must be in [0, {self.handle.stride}), got {wid}")
        d = self.handle.depth
        self._ctrl[wid * d:(wid + 1) * d, 0] = _POISON_SEQ

    # -- staging-table region ---------------------------------------------

    def table_view(self, name: str, writable: bool = False) -> np.ndarray:
        return _view(self._shm.buf, self._table_refs[name], writeable=writable)

    def table_version(self) -> int:
        return int(self._tver[0])

    def publish_tables(self, updates: Dict[str, np.ndarray]) -> None:
        """Owner side: republish mutable staging tables under the seqlock."""
        if not self.handle.tables_mutable:
            raise RuntimeError("arena tables are immutable")
        self._tver[0] += 1  # odd: republish in progress
        try:
            for name, arr in updates.items():
                if name in self._table_refs:
                    np.copyto(self.table_view(name, writable=True),
                              np.asarray(arr), casting="same_kind")
        finally:
            self._tver[0] += 1

    def read_tables(self, poll: float = 5e-4
                    ) -> Tuple[Dict[str, np.ndarray], int]:
        """Consistent staging tables + the version they correspond to.

        Immutable arenas return zero-copy views; mutable ones copy under the
        seqlock and retry torn reads until a stable version brackets the
        copy."""
        if not self.handle.tables_mutable:
            return ({k: self.table_view(k) for k in self._table_refs},
                    self.table_version())
        while True:
            v1 = self.table_version()
            if v1 % 2:  # republish in flight
                time.sleep(poll)
                continue
            out = {k: np.array(self.table_view(k), copy=True)
                   for k in self._table_refs}
            if self.table_version() == v1:
                return out, v1
            # torn read: a republish landed mid-copy — retry


class BatchArena(_ArenaOps):
    """Owner handle of a batch-arena segment (same lifecycle discipline as
    :class:`SharedHetGraph`: ``close()`` unmaps, ``unlink()`` removes,
    ``__exit__``/``__del__`` never leak a segment)."""

    def __init__(self, shm: shared_memory.SharedMemory, handle: ArenaHandle):
        self._shm = shm
        self.handle = handle
        self._closed = False
        self._unlinked = False
        self._bind_views()

    @property
    def nbytes(self) -> int:
        return self._shm.size

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._tver = self._ctrl = None
            self._shm.close()

    def unlink(self) -> None:
        self.close()
        if not self._unlinked:
            self._unlinked = True
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def __enter__(self) -> "BatchArena":
        return self

    def __exit__(self, *exc) -> None:
        self.unlink()

    def __del__(self):
        try:
            self.unlink()
        except BaseException:
            pass


class AttachedArena(_ArenaOps):
    """A worker's view of a batch arena (write side of the slot protocol)."""

    def __init__(self, handle: ArenaHandle):
        self.handle = handle
        self._shm = _open_attached(handle.segment, handle.owner_pid)
        self._closed = False
        self._bind_views()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._tver = self._ctrl = None
            self._shm.close()

    def __enter__(self) -> "AttachedArena":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except BaseException:
            pass


def create_arena(
    fields: Dict[str, np.ndarray],
    num_workers: int,
    depth: int,
    tables: Optional[Dict[str, np.ndarray]] = None,
    tables_mutable: bool = False,
    name: Optional[str] = None,
) -> BatchArena:
    """Create a batch arena sized from probe arrays.

    ``fields`` is a probe batch/staging dict — only shapes and dtypes are
    read (slot layouts are static: the sampler pads every level to fixed
    ``[R_d, N_d]`` and the recipe pads features to ``d_pad``).  ``tables``
    are copied into the table region; ``tables_mutable=True`` arms the
    seqlock so :meth:`~_ArenaOps.publish_tables` may republish them while
    workers stage.  Transactional like :func:`share_graph`."""
    if num_workers < 1 or depth < 1:
        raise ValueError(f"need num_workers >= 1 and depth >= 1, got "
                         f"{num_workers}, {depth}")
    slot_refs, slot_bytes = _layout(fields)
    slot_bytes = -(-slot_bytes // _ALIGN) * _ALIGN
    table_refs, table_bytes = _layout(tables or {})
    n_slots = num_workers * depth
    ctrl_bytes = n_slots * _CTRL_WORDS * 8
    tables_off = _ALIGN + (-(-ctrl_bytes // _ALIGN) * _ALIGN)
    slots_off = tables_off + (-(-table_bytes // _ALIGN) * _ALIGN)
    total = slots_off + n_slots * slot_bytes

    segment = name or f"{SEGMENT_PREFIX}{os.getpid():x}-{secrets.token_hex(4)}"
    shm = shared_memory.SharedMemory(name=segment, create=True, size=total)
    handle = ArenaHandle(
        segment=segment,
        owner_pid=os.getpid(),
        stride=num_workers,
        depth=depth,
        fields=tuple(slot_refs.items()),
        slot_bytes=slot_bytes,
        slots_offset=slots_off,
        tables=tuple((k, ArrayRef(tables_off + r.offset, r.shape, r.dtype))
                     for k, r in table_refs.items()),
        tables_mutable=tables_mutable,
    )
    arena = BatchArena(shm, handle)
    try:
        arena._tver[0] = 0
        arena._ctrl[:] = 0
        for tname, tab in (tables or {}).items():
            np.copyto(arena.table_view(tname, writable=True),
                      np.ascontiguousarray(tab), casting="no")
    except BaseException:
        arena.unlink()
        raise
    return arena


def attach_arena(handle: ArenaHandle) -> AttachedArena:
    """Map the arena described by ``handle`` (see :class:`AttachedArena`)."""
    return AttachedArena(handle)


def live_segments(prefix: str = SEGMENT_PREFIX) -> List[str]:
    """Names of shared-memory segments currently present (the leak check).

    Reads ``/dev/shm``; returns ``[]`` on platforms without it (the tests
    that use this skip there)."""
    try:
        return sorted(n for n in os.listdir("/dev/shm") if n.startswith(prefix))
    except FileNotFoundError:
        return []


def _segment_owner_pid(name: str) -> Optional[int]:
    """Parse the creator pid encoded in a ``heta-tshm-<pidhex>-<token>``
    segment name (None when the name doesn't follow the convention)."""
    rest = name[len(SEGMENT_PREFIX):]
    pid_hex, sep, _ = rest.partition("-")
    if not sep or not pid_hex:
        return None
    try:
        return int(pid_hex, 16)
    except ValueError:
        return None


def cleanup_stale_segments(prefix: str = SEGMENT_PREFIX) -> List[str]:
    """Unlink orphaned ``/dev/shm`` segments whose creator is dead
    (the shm janitor; DESIGN.md §12).

    Every segment this package creates embeds its creator's pid in the
    name (``heta-tshm-<pidhex>-<token>``).  A hard-crashed owner — SIGKILL,
    OOM — never runs ``unlink()``, and when the crash takes the
    ``resource_tracker`` down with it nothing reclaims the segment: the
    leak survives until reboot.  This sweep runs at session start
    (``Heta.build_graph``; also ``launch/train.py --shm-cleanup``): any
    segment under ``prefix`` whose named creator no longer exists is
    unlinked.  Conservative by construction — a live pid (even a recycled
    one), an unparsable name, or this process's own segments are skipped,
    so a concurrent healthy run is never touched.  Returns the names
    removed."""
    removed: List[str] = []
    for name in live_segments(prefix):
        pid = _segment_owner_pid(name)
        if pid is None or pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)
            continue  # creator alive: not ours to reap
        except ProcessLookupError:
            pass
        except PermissionError:
            continue  # pid exists under another uid
        try:
            os.unlink(os.path.join("/dev/shm", name))
            removed.append(name)
        except FileNotFoundError:
            pass  # lost the race to another janitor
        except OSError:
            pass  # best-effort: never fail session start over a sweep
    return removed
