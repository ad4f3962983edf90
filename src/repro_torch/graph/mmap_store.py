"""Memory-mapped out-of-core graph store (DESIGN.md §13).

The shm store (:mod:`repro_torch.graph.shm`) caps out at RAM: ``/dev/shm`` is a
tmpfs, and ``share_graph`` copies a graph that already exists in one
address space.  The scale-out tier needs neither — a billion-edge-schema
graph should be *built* chunk-wise straight to disk and *shared* by every
trainer process on the host through the page cache.  This module grows the
shm contract into that shape, keeping its discipline intact:

* **Same attach contract.**  A picklable :class:`MmapGraphHandle` (same
  array-key scheme as :class:`~repro_torch.graph.shm.GraphHandle` —
  ``rel/<i>/indptr|indices``, ``labels``, ``train_nodes``,
  ``feat/<ntype>``, ``table/<name>``); :func:`attach_mmap` rebuilds a
  read-only :class:`~repro_torch.graph.hetgraph.HetGraph` of zero-copy views,
  exactly like :func:`repro_torch.graph.shm.attach`.  :func:`attach_any`
  dispatches on handle type so pool/trainer code accepts either store.
* **Transactional create.**  A store is one directory
  ``heta-tmmap-<pidhex>-<token>/`` under :func:`store_root` holding
  ``data.bin`` (every array at a 64-byte-aligned offset, the shm
  ``_layout``) and ``MANIFEST.json`` — written last, atomically (write +
  rename): a directory without a manifest is an uncommitted wreck.  Any
  failure before commit removes the directory before re-raising.
* **Idempotent lifecycle.**  ``close()`` unmaps, ``unlink()`` removes the
  directory tree (implies close, safe to repeat, also ``__exit__``/best-
  effort ``__del__``) — mirroring ``SharedHetGraph``.
* **Janitor-sweepable.**  The creator pid is embedded in the directory
  name; :func:`cleanup_stale_stores` reaps stores — committed or not —
  whose creator is dead, with the same conservatism as the shm janitor
  (live pids, foreign uids, unparsable names and the caller's own stores
  are skipped).  Wired into the session-start sweep (``Heta.build_graph``)
  and ``launch/train.py --shm-cleanup``.

Chunk-wise construction goes through :class:`MmapStoreWriter`: declare
array shapes up front, fill writable memmap views in chunks (the streaming
synthetic generator in :mod:`repro_torch.graph.synthetic` does a two-pass
counting sort per relation), then ``commit()``.  Peak RAM is O(nodes) work
arrays; the O(edges) payload only ever exists on disk.

Attach-time validation note: building the ``HetGraph`` runs the usual CSR
/ index-range checks, which sequentially fault in the topology pages once
per process.  Exact at any scale; for truly disk-bound graphs a
skip-validation fast path is a recorded ROADMAP follow-on.

Like :mod:`repro_torch.graph.shm`, this module is deliberately torch-free:
sampler workers import it when they attach a store
(:meth:`repro_torch.data.worker_pool.SampleStageTask.setup`) and must stay
lightweight numpy processes.

A copy of the reference's ``repro/graph/mmap_store.py`` with one deliberate
difference: the port names its stores ``heta-tmmap-<pidhex>-<token>``, not
``heta-mmap-...``, for the reason :mod:`repro_torch.graph.shm` gives for its
``heta-tshm-`` segments.  The reference's :func:`live_stores` lists every
directory under its prefix in the store root, whoever made it, and its
tests assert that a fit leaves no new store behind; under the same prefix
a port store alive in one test process would show up in those checks
running in another, and each package's janitor would judge the other's
stores by its own rules.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import secrets
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.graph.hetgraph import CSR, HetGraph, Relation
from repro_torch.graph.shm import ArrayRef, GraphHandle, _view

__all__ = [
    "MmapGraphHandle",
    "MmapHetGraph",
    "AttachedMmapGraph",
    "MmapStoreWriter",
    "create_store_writer",
    "mmap_share_graph",
    "attach_mmap",
    "attach_any",
    "store_root",
    "live_stores",
    "cleanup_stale_stores",
    "STORE_PREFIX",
]

STORE_PREFIX = "heta-tmmap-"  # the reference uses "heta-mmap-" (see above)
_DATA_FILE = "data.bin"
_MANIFEST = "MANIFEST.json"


def store_root() -> str:
    """Directory stores live under (``HETA_MMAP_ROOT`` or the tempdir)."""
    return os.environ.get("HETA_MMAP_ROOT") or tempfile.gettempdir()


@dataclasses.dataclass(frozen=True)
class MmapGraphHandle:
    """Picklable description of an mmap store (the disk-backed twin of
    :class:`~repro_torch.graph.shm.GraphHandle`; same array-key scheme)."""

    path: str  # the store directory
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


def _handle_to_json(handle: MmapGraphHandle) -> str:
    d = dataclasses.asdict(handle)
    return json.dumps(d)


def _handle_from_json(text: str, path: str) -> MmapGraphHandle:
    d = json.loads(text)
    return MmapGraphHandle(
        path=path,  # the store may have been moved; trust where we found it
        owner_pid=int(d["owner_pid"]),
        num_nodes=tuple((t, int(n)) for t, n in d["num_nodes"]),
        relations=tuple(tuple(r) for r in d["relations"]),
        target_type=d["target_type"],
        num_classes=int(d["num_classes"]),
        graph_name=d["graph_name"],
        arrays=tuple(
            (k, ArrayRef(offset=int(r["offset"]), shape=tuple(r["shape"]),
                         dtype=r["dtype"]))
            for k, r in d["arrays"]
        ),
    )


def read_manifest(path: str) -> MmapGraphHandle:
    """Load the committed handle of the store directory at ``path``."""
    with open(os.path.join(path, _MANIFEST), "r", encoding="utf-8") as f:
        return _handle_from_json(f.read(), path)


def _map_file(path: str, writable: bool) -> Tuple[mmap.mmap, int]:
    fd = os.open(path, os.O_RDWR if writable else os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        access = mmap.ACCESS_WRITE if writable else mmap.ACCESS_READ
        mm = mmap.mmap(fd, size, access=access)
    finally:
        os.close(fd)  # the mapping holds its own reference
    return mm, size


class MmapStoreWriter:
    """Chunk-wise store construction: declare shapes, fill views, commit.

    Created by :func:`create_store_writer`.  ``array(key)`` returns a
    writable memmap-backed view (zero-filled initially — ``data.bin`` is
    allocated sparse with ``ftruncate``); ``commit()`` writes the manifest
    atomically and returns the owning :class:`MmapHetGraph`.  If the
    writer is garbage-collected, ``__exit__``-ed or ``abort()``-ed before
    commit, the directory is removed — an uncommitted store never
    survives its writer."""

    def __init__(self, path: str, handle: MmapGraphHandle, mm: mmap.mmap):
        self._path = path
        self._handle = handle
        self._mm: Optional[mmap.mmap] = mm
        self._refs = dict(handle.arrays)
        self._committed = False

    @property
    def handle(self) -> MmapGraphHandle:
        return self._handle

    def array(self, key: str) -> np.ndarray:
        if self._mm is None:
            raise RuntimeError("writer is closed")
        return _view(self._mm, self._refs[key], writeable=True)

    def commit(self) -> "MmapHetGraph":
        if self._committed or self._mm is None:
            raise RuntimeError("store already committed or aborted")
        self._mm.flush()
        tmp = os.path.join(self._path, _MANIFEST + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(_handle_to_json(self._handle))
        os.replace(tmp, os.path.join(self._path, _MANIFEST))
        self._committed = True
        store = MmapHetGraph(self._handle, self._mm)
        self._mm = None  # ownership transferred
        return store

    def abort(self) -> None:
        """Drop an uncommitted store (idempotent; no-op after commit)."""
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if not self._committed:
            shutil.rmtree(self._path, ignore_errors=True)

    def __enter__(self) -> "MmapStoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.abort()

    def __del__(self):
        try:
            self.abort()
        except BaseException:
            pass


class MmapHetGraph:
    """Owner handle of a committed mmap store (twin of ``SharedHetGraph``)."""

    def __init__(self, handle: MmapGraphHandle, mm: Optional[mmap.mmap] = None):
        self.handle = handle
        if mm is None:
            mm, _ = _map_file(os.path.join(handle.path, _DATA_FILE),
                              writable=True)
        self._mm: Optional[mmap.mmap] = mm
        self._unlinked = False

    def _array(self, key: str) -> np.ndarray:
        refs = dict(self.handle.arrays)
        return _view(self._mm, refs[key], writeable=True)

    @property
    def nbytes(self) -> int:
        try:
            return os.path.getsize(os.path.join(self.handle.path, _DATA_FILE))
        except OSError:
            return 0

    def close(self) -> None:
        """Unmap the owner's view (the store stays on disk until unlink)."""
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def unlink(self) -> None:
        """Remove the store directory.  Idempotent; implies close()."""
        self.close()
        if not self._unlinked:
            self._unlinked = True
            shutil.rmtree(self.handle.path, ignore_errors=True)

    def __enter__(self) -> "MmapHetGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.unlink()

    def __del__(self):  # best-effort: never leak a store on error paths
        try:
            self.unlink()
        except BaseException:
            pass


class AttachedMmapGraph:
    """A trainer's zero-copy, read-only view of a committed mmap store.

    ``graph`` is a fully functional read-only HetGraph whose arrays page
    in lazily from ``data.bin``; ``tables`` maps exported staging-table
    names to read-only views.  Same surface as
    :class:`~repro_torch.graph.shm.AttachedHetGraph`."""

    def __init__(self, handle: MmapGraphHandle):
        self.handle = handle
        self._mm, _ = _map_file(os.path.join(handle.path, _DATA_FILE),
                                writable=False)
        self._closed = False
        refs = dict(handle.arrays)
        relations: Dict[Relation, CSR] = {}
        for i, (src, etype, dst) in enumerate(handle.relations):
            relations[Relation(src, etype, dst)] = CSR(
                indptr=_view(self._mm, refs[f"rel/{i}/indptr"]),
                indices=_view(self._mm, refs[f"rel/{i}/indices"]),
            )
        features = {
            k[len("feat/"):]: _view(self._mm, r)
            for k, r in refs.items() if k.startswith("feat/")
        }
        self.graph = HetGraph(
            num_nodes=dict(handle.num_nodes),
            relations=relations,
            target_type=handle.target_type,
            num_classes=handle.num_classes,
            features=features,
            labels=_view(self._mm, refs["labels"]),
            train_nodes=_view(self._mm, refs["train_nodes"]),
            name=handle.graph_name,
        )
        self.tables: Dict[str, np.ndarray] = {
            k[len("table/"):]: _view(self._mm, r)
            for k, r in refs.items() if k.startswith("table/")
        }

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.graph = None
            self.tables = {}
            self._mm.close()

    def __enter__(self) -> "AttachedMmapGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except BaseException:
            pass


def create_store_writer(
    arrays_spec: Dict[str, Tuple[Tuple[int, ...], str]],
    num_nodes: Dict[str, int],
    relations: Tuple[Tuple[str, str, str], ...],
    target_type: str,
    num_classes: int,
    graph_name: str,
    root: Optional[str] = None,
) -> MmapStoreWriter:
    """Open a writer for a new store (see :class:`MmapStoreWriter`).

    ``arrays_spec`` maps array keys (shm key scheme) to ``(shape, dtype)``;
    ``relations`` fixes the relation order the ``rel/<i>/...`` keys index.
    """
    # shm's _layout sizes from materialized arrays; here shapes are declared
    # up front (the payload never exists in RAM), so lay out from the specs
    # with the same 64-byte alignment rule.
    refs: Dict[str, ArrayRef] = {}
    off = 0
    align = 64
    for key, (shape, dt) in arrays_spec.items():
        dtype = np.dtype(dt)
        if dtype.hasobject:
            raise ValueError(f"array {key!r} has object dtype")
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        refs[key] = ArrayRef(offset=off, shape=tuple(int(s) for s in shape),
                             dtype=dtype.str)
        off += -(-nbytes // align) * align
    total = max(off, 1)

    path = os.path.join(
        root or store_root(),
        f"{STORE_PREFIX}{os.getpid():x}-{secrets.token_hex(4)}",
    )
    os.makedirs(path, exist_ok=False)
    try:
        data = os.path.join(path, _DATA_FILE)
        fd = os.open(data, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, total)  # sparse: pages materialize on write
            mm = mmap.mmap(fd, total, access=mmap.ACCESS_WRITE)
        finally:
            os.close(fd)
    except BaseException:
        shutil.rmtree(path, ignore_errors=True)
        raise
    handle = MmapGraphHandle(
        path=path,
        owner_pid=os.getpid(),
        # insertion order, NOT sorted — attached twins must iterate node
        # types exactly like the source graph (type-arena offsets depend
        # on it; DESIGN.md §13)
        num_nodes=tuple((t, int(n)) for t, n in num_nodes.items()),
        relations=tuple(tuple(r) for r in relations),
        target_type=target_type,
        num_classes=int(num_classes),
        graph_name=graph_name,
        arrays=tuple(refs.items()),
    )
    return MmapStoreWriter(path, handle, mm)


def mmap_share_graph(
    graph: HetGraph,
    include_features: bool = True,
    tables: Optional[Dict[str, np.ndarray]] = None,
    root: Optional[str] = None,
) -> MmapHetGraph:
    """Export an in-RAM graph into an mmap store (disk-backed twin of
    :func:`repro_torch.graph.shm.share_graph`; transactional the same way)."""
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

    spec = {k: (tuple(a.shape), a.dtype.str) for k, a in arrays.items()}
    writer = create_store_writer(
        spec,
        num_nodes=graph.num_nodes,
        relations=tuple((r.src, r.etype, r.dst) for r, _ in rel_list),
        target_type=graph.target_type,
        num_classes=int(graph.num_classes),
        graph_name=graph.name,
        root=root,
    )
    try:
        for key, arr in arrays.items():
            np.copyto(writer.array(key), arr, casting="no")
        return writer.commit()
    except BaseException:
        writer.abort()
        raise


def attach_mmap(handle: MmapGraphHandle) -> AttachedMmapGraph:
    """Map the store described by ``handle`` (see :class:`AttachedMmapGraph`)."""
    return AttachedMmapGraph(handle)


def attach_any(handle):
    """Attach either store flavor: dispatches :class:`MmapGraphHandle` to
    :func:`attach_mmap` and :class:`~repro_torch.graph.shm.GraphHandle` to
    :func:`repro_torch.graph.shm.attach` — pool workers and DP trainers accept
    both transparently."""
    if isinstance(handle, MmapGraphHandle):
        return attach_mmap(handle)
    if isinstance(handle, GraphHandle):
        from repro_torch.graph.shm import attach

        return attach(handle)
    raise TypeError(f"not a graph store handle: {type(handle).__name__}")


# --------------------------------------------------------------------------
# janitor (DESIGN.md §12/§13) — same conservatism as the shm sweep
# --------------------------------------------------------------------------


def live_stores(root: Optional[str] = None,
                prefix: str = STORE_PREFIX) -> List[str]:
    """Store directory names currently on disk (the leak check)."""
    base = root or store_root()
    try:
        return sorted(
            n for n in os.listdir(base)
            if n.startswith(prefix)
            and os.path.isdir(os.path.join(base, n))
        )
    except FileNotFoundError:
        return []


def _store_owner_pid(name: str, prefix: str = STORE_PREFIX) -> Optional[int]:
    """Parse the creator pid from a ``heta-tmmap-<pidhex>-<token>`` name."""
    rest = name[len(prefix):]
    pid_hex, sep, _ = rest.partition("-")
    if not sep or not pid_hex:
        return None
    try:
        return int(pid_hex, 16)
    except ValueError:
        return None


def cleanup_stale_stores(root: Optional[str] = None,
                         prefix: str = STORE_PREFIX) -> List[str]:
    """Remove orphaned mmap stores whose creator pid is dead.

    Exactly the shm janitor's rules (``cleanup_stale_segments``) applied
    to store directories: a killed trainer or generator never runs
    ``unlink()``, so its store — committed or an uncommitted wreck without
    a manifest — sits on disk until swept.  Conservative: live pids (even
    recycled ones), foreign-uid pids, unparsable names and this process's
    own stores are skipped.  Runs from the session-start sweep and
    ``launch/train.py --shm-cleanup``.  Returns the names removed."""
    base = root or store_root()
    removed: List[str] = []
    for name in live_stores(base, prefix):
        pid = _store_owner_pid(name, prefix)
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
            shutil.rmtree(os.path.join(base, name))
            removed.append(name)
        except FileNotFoundError:
            pass  # lost the race to another janitor
        except OSError:
            pass  # best-effort: never fail session start over a sweep
    return removed
