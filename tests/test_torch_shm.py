"""The port's shared-memory stores and batch arena (``repro_torch.graph.shm``
and the arena half of ``repro_torch.data.staging``).

  * a shared graph or array bundle attaches bit-equal, zero-copy and
    read-only; a failed create leaves no segment;
  * the port's segments carry their own prefix, so the reference's
    ``repro.graph.shm.live_segments()`` never lists one, and the port's
    janitor reaps only dead owners' segments;
  * the arena's slot ring (per-worker sub-rings, generations, backpressure,
    stop), its seqlock'd tables (no torn read under a concurrent writer) and
    the slot pack/unpack round trip;
  * ``arena_fields`` of a port batch equal the reference's field names,
    shapes and dtypes for the same batch, staged arrays included.

Every leak check lists only segments named with this process's pid
(``heta-tshm-<pidhex>-``): pytest-xdist workers share ``/dev/shm``.
"""

import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core.metatree import build_metatree
from repro_torch.data.staging import (
    BATCH_PREFIX,
    HOST_PREFIX,
    arena_fields,
    pack_batch_arrays,
    pack_batch_into,
    stack_batch_host,
    unpack_slot,
)
from repro_torch.data.worker_pool import EpochSchedule, SampleStageTask
from repro_torch.graph import shm
from repro_torch.graph.sampler import NeighborSampler, SampleSpec
from repro_torch.graph.synthetic import ogbn_mag_like

pytestmark = pytest.mark.skipif(
    not os.path.isdir("/dev/shm"), reason="the shm stores rely on /dev/shm"
)

OWN = f"heta-tshm-{os.getpid():x}-"


def _own_segments():
    return shm.live_segments(OWN)


def _mag():
    g = ogbn_mag_like(scale=0.002)
    tree = build_metatree(g.metagraph(), g.target_type, 2)
    return g, SampleSpec.from_metatree(tree, [3, 2])


def _probe_fields():
    return {"x": np.zeros((4, 3), np.float32), "y": np.zeros(4, np.int64)}


def _assert_batches_equal(a, b):
    np.testing.assert_array_equal(a.seeds, b.seeds)
    np.testing.assert_array_equal(a.labels, b.labels)
    for la, lb in zip(a.levels, b.levels):
        np.testing.assert_array_equal(la.nids, lb.nids)
        np.testing.assert_array_equal(la.mask, lb.mask)


# --------------------------------------------------------------------------
# graph and array stores
# --------------------------------------------------------------------------


def test_graph_attach_round_trips_zero_copy_and_read_only():
    g, spec = _mag()
    tables = {"paper": g.features["paper"].astype(np.float32)}
    with shm.share_graph(g, include_features=True, tables=tables) as store:
        assert store.handle.segment.startswith(OWN)
        handle = pickle.loads(pickle.dumps(store.handle))
        assert len(pickle.dumps(handle)) < 10_000  # a handle, never the graph
        att = shm.attach(handle)
        assert att.graph.num_nodes == g.num_nodes
        assert list(att.graph.num_nodes) == list(g.num_nodes)  # insertion order kept
        assert (att.graph.target_type, att.graph.num_classes) == (g.target_type,
                                                                  g.num_classes)
        assert set(att.graph.relations) == set(g.relations)
        for r, csr in g.relations.items():
            for a, b in ((att.graph.relations[r].indptr, csr.indptr),
                         (att.graph.relations[r].indices, csr.indices)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        np.testing.assert_array_equal(att.graph.labels, g.labels)
        np.testing.assert_array_equal(att.graph.train_nodes, g.train_nodes)
        for t, f in g.features.items():
            np.testing.assert_array_equal(att.graph.features[t], f)
        np.testing.assert_array_equal(att.tables["paper"], tables["paper"])
        # zero-copy: a write through the owner's view shows in the worker's
        owner = store._array("labels")
        before = int(att.graph.labels[0])
        owner[0] = before + 1
        assert int(att.graph.labels[0]) == before + 1
        owner[0] = before
        with pytest.raises(ValueError):  # the worker's views are read-only
            att.graph.labels[0] = 0
        # the sampler over the attached graph draws the same batches
        a, b = (NeighborSampler(x, spec, 8, seed=5) for x in (g, att.graph))
        for i in (0, 3, 1):
            _assert_batches_equal(a.batch_at(i, epoch_seed=11), b.batch_at(i, epoch_seed=11))
        att.close()
        att.close()  # idempotent
    assert not shm.live_segments(store.handle.segment)
    with pytest.raises(FileNotFoundError):
        shm.attach(store.handle)


def test_array_bundle_attach_round_trips():
    arrays = {"emb/a": np.arange(12, dtype=np.float32).reshape(3, 4),
              "head/b": np.array([1.5, -2.0], np.float32),
              "ids": np.array([3, 1, 2], np.int64)}
    with shm.share_arrays(arrays, meta={"k": "v"}) as seg:
        att = shm.attach_arrays(pickle.loads(pickle.dumps(seg.handle)))
        assert att.handle.meta_dict == {"k": "v"}
        for k, a in arrays.items():
            np.testing.assert_array_equal(att.arrays[k], a)
            assert att.arrays[k].dtype == a.dtype and not att.arrays[k].flags.writeable
        seg.array("ids")[0] = 9
        assert int(att.arrays["ids"][0]) == 9
        att.close()
    assert not _own_segments()


def _exploding_copyto(monkeypatch):
    calls = []
    orig = np.copyto

    def copyto(dst, src, **kw):
        calls.append(1)
        if len(calls) == 3:  # part-way through populating the segment
            raise RuntimeError("disk full, or something")
        return orig(dst, src, **kw)

    monkeypatch.setattr(shm.np, "copyto", copyto)


@pytest.mark.parametrize("case", ["object-dtype", "populate", "arena-table", "context"])
def test_failed_create_leaves_no_segment(case, monkeypatch):
    g, _ = _mag()
    if case == "object-dtype":
        with pytest.raises(ValueError, match="object dtype"):
            shm.share_graph(g, tables={"paper": np.array([[object()]], dtype=object)})
    elif case == "populate":
        _exploding_copyto(monkeypatch)
        with pytest.raises(RuntimeError, match="disk full"):
            shm.share_graph(g)
        monkeypatch.undo()
    elif case == "arena-table":
        with pytest.raises(ValueError, match="num_workers"):
            shm.create_arena(_probe_fields(), num_workers=0, depth=2)
        with pytest.raises(AttributeError):
            shm.create_arena(_probe_fields(), num_workers=1, depth=1, tables={"t": object()})
    else:
        with pytest.raises(RuntimeError, match="boom"):
            with shm.share_graph(g):
                raise RuntimeError("boom")
    assert not _own_segments()


def test_reference_listing_never_sees_port_segments():
    """The port's prefix keeps its segments out of the reference's leak
    checks and janitor.  (No reference segment is made here: one would
    show in the reference's own leak checks running beside this test.)"""
    import repro.graph.shm as ref_shm

    assert not shm.SEGMENT_PREFIX.startswith(ref_shm.SEGMENT_PREFIX)
    assert not ref_shm.SEGMENT_PREFIX.startswith(shm.SEGMENT_PREFIX)
    with shm.share_arrays({"x": np.zeros(4, np.float32)}) as seg, \
            shm.create_arena(_probe_fields(), num_workers=1, depth=1) as arena:
        names = {seg.handle.segment, arena.handle.segment}
        assert all(n.startswith(OWN) for n in names)
        assert names <= set(_own_segments())
        assert not names & set(ref_shm.live_segments())
    assert not _own_segments()


def test_janitor_reaps_only_dead_owners():
    """A segment named with a pid that no longer exists is unlinked; this
    process's own segments are kept."""
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True, timeout=60)
    pid = int(dead.stdout.strip())
    try:
        os.kill(pid, 0)
        pytest.skip("the child's pid was reused at once")
    except ProcessLookupError:
        pass
    orphan = f"{shm.SEGMENT_PREFIX}{pid:x}-deadbeef"
    from multiprocessing import shared_memory

    seg = shared_memory.SharedMemory(name=orphan, create=True, size=64)
    seg.close()
    try:
        with shm.share_arrays({"x": np.zeros(4, np.float32)}) as mine:
            removed = shm.cleanup_stale_segments()
            assert orphan in removed
            assert mine.handle.segment not in removed
            assert shm.live_segments(mine.handle.segment) == [mine.handle.segment]
        assert not shm.live_segments(orphan)
    finally:
        try:
            os.unlink(os.path.join("/dev/shm", orphan))
        except FileNotFoundError:
            pass


# --------------------------------------------------------------------------
# the arena's slot ring and seqlock'd tables
# --------------------------------------------------------------------------


def test_slot_ring_generations_and_torn_reads():
    with shm.create_arena(_probe_fields(), num_workers=2, depth=2) as a:
        h = a.handle
        assert h.n_slots == 4
        # stripe item i -> worker i % 2, each cycling its own 2 slots
        assert [h.slot_for(i) for i in range(8)] == [
            (0, 0), (2, 0), (1, 0), (3, 0), (0, 1), (2, 1), (1, 1), (3, 1)]
    with shm.create_arena(_probe_fields(), num_workers=1, depth=1) as a:
        for use in range(3):
            assert a.wait_writable(0, use, timeout=1.0)
            a.begin_write(0, use)
            a.slot_views(0, writable=True)["x"][:] = float(use)
            a.end_write(0, use)
            assert float(a.resolve(0, use)["x"][0, 0]) == float(use)
            a.release(0, use)
        with pytest.raises(RuntimeError, match="generation"):
            a.resolve(0, 0)  # a descriptor that outlived two overwrites
        a.begin_write(0, 3)
        with pytest.raises(RuntimeError, match="write_seq"):
            a.resolve(0, 3)  # mid-write
        a.poison_slot(0)
        with pytest.raises(RuntimeError, match="invalidated"):
            a.resolve(0, 3)


def test_backpressure_and_stop():
    with shm.create_arena(_probe_fields(), num_workers=1, depth=1) as a:
        a.begin_write(0, 0)
        a.end_write(0, 0)
        t0 = time.perf_counter()
        assert not a.wait_writable(0, 1, timeout=0.05)  # gen 0 not consumed
        assert time.perf_counter() - t0 >= 0.05
        stop = threading.Event()
        threading.Timer(0.02, stop.set).start()
        t0 = time.perf_counter()
        assert not a.wait_writable(0, 1, stop=stop, timeout=5.0)
        assert time.perf_counter() - t0 < 4.0  # left on stop, not timeout
        threading.Timer(0.02, a.release, args=(0, 0)).start()
        assert a.wait_writable(0, 1, timeout=5.0)


def test_seqlock_tables():
    tab = np.arange(12, dtype=np.float32).reshape(3, 4)
    with shm.create_arena(_probe_fields(), num_workers=1, depth=1,
                          tables={"paper": tab}) as a:
        views, ver = a.read_tables()
        assert ver == 0 and not views["paper"].flags.writeable  # a view, not a copy
        np.testing.assert_array_equal(views["paper"], tab)
        with pytest.raises(RuntimeError, match="immutable"):
            a.publish_tables({"paper": tab})
    tab = np.zeros((256, 32), np.float32)
    with shm.create_arena(_probe_fields(), num_workers=1, depth=1, tables={"t": tab},
                          tables_mutable=True) as a:
        a.publish_tables({"t": np.full_like(tab, 7.0)})
        out, ver = a.read_tables()
        assert ver == 2 and np.all(out["t"] == 7.0) and out["t"].flags.writeable
        stop = threading.Event()

        def writer():
            v = 0.0
            while not stop.is_set():
                v += 1.0
                a.publish_tables({"t": np.full_like(tab, v)})

        w = threading.Thread(target=writer)
        w.start()
        try:
            deadline = time.monotonic() + 0.5
            reads = 0
            while time.monotonic() < deadline:
                out, ver = a.read_tables()
                assert ver % 2 == 0  # never mid-publish
                assert len(np.unique(out["t"])) == 1, "torn read"
                reads += 1
            assert reads > 0
        finally:
            stop.set()
            w.join(timeout=5.0)


def test_arena_writer_stall_raises_named_error():
    """A consumer that never releases fails the writer after its timeout
    instead of hanging it."""
    g, spec = _mag()
    serial = NeighborSampler(g, spec, 8, seed=0)
    store = shm.share_graph(g, include_features=False)
    arena = shm.create_arena(arena_fields(serial.batch_at(0, epoch_seed=0)),
                             num_workers=1, depth=1)
    task = SampleStageTask(handle=store.handle, spec=spec, batch_size=8, sampler_seed=0,
                           schedule=EpochSchedule(0, serial.steps_per_epoch()),
                           arena=arena.handle, write_timeout_s=0.1)
    try:
        task.bind_worker(0, 0)
        task.setup()
        ref = task(0)
        assert (ref.slot, ref.use) == (0, 0)
        with pytest.raises(shm.ArenaStalledError, match="not writable"):
            task(1)  # the same slot's next generation, never released
    finally:
        task.teardown()
        arena.unlink()
        store.unlink()
    assert not _own_segments()


# --------------------------------------------------------------------------
# slot packing, and the arena's fields against the reference's
# --------------------------------------------------------------------------


def _plans_and_tables():
    """The port's and the reference's stacked plans for the same graph and
    config, and one set of feature tables."""
    from repro.core import raf_spmd as ref_spmd
    from repro.core.hgnn import HGNNConfig as RefHGNNConfig
    from repro.core.meta_partition import meta_partition as ref_meta_partition
    from repro.core.raf import assign_branches as ref_assign
    from repro.graph.sampler import SampleSpec as RefSpec
    from repro.graph.synthetic import ogbn_mag_like as ref_mag
    from repro_torch.core import raf_spmd
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.core.meta_partition import meta_partition
    from repro_torch.core.raf import assign_branches

    out = []
    for mag, mp_fn, spec_cls, assign, cfg_cls, mod in (
            (ogbn_mag_like, meta_partition, SampleSpec, assign_branches, HGNNConfig, raf_spmd),
            (ref_mag, ref_meta_partition, RefSpec, ref_assign, RefHGNNConfig, ref_spmd)):
        g = mag(scale=0.002)
        mp_ = mp_fn(g, 2, num_layers=2)
        spec = spec_cls.from_metatree(mp_.metatree, [3, 2])
        cfg = cfg_cls(model="rgcn", hidden=32, num_layers=2, num_heads=4,
                      num_classes=g.num_classes, learnable_dim=16)
        feat_dims = {t: g.feat_dim(t) for t in g.num_nodes if g.feat_dim(t)}
        plan = mod.build_plan(spec, assign(spec, mp_), cfg, feat_dims)
        out.append((g, spec, mod.stack_recipe(plan)))
    g = out[0][0]
    rng = np.random.default_rng(0)
    tables = {t: (g.features[t].astype(np.float32) if t in g.features
                  else rng.standard_normal((g.num_nodes[t], 16)).astype(np.float32))
              for t in g.num_nodes}
    return out, tables


def test_pack_unpack_and_fields_match_reference():
    from repro.data import staging as ref_staging
    from repro.graph.sampler import NeighborSampler as RefSampler

    ((g, spec, recipe), (g_ref, spec_ref, recipe_ref)), tables = _plans_and_tables()
    batch = NeighborSampler(g, spec, 8, seed=5).batch_at(0, epoch_seed=3)
    ref_batch = RefSampler(g_ref, spec_ref, 8, seed=5).batch_at(0, epoch_seed=3)
    for rec, rrec, tabs in ((None, None, None), (recipe, recipe_ref, tables)):
        fields = arena_fields(batch, recipe=rec, tables=tabs)
        ref_fields = ref_staging.arena_fields(ref_batch, recipe=rrec, tables=tabs)
        assert list(fields) == list(ref_fields)
        for k, a in ref_fields.items():
            assert (fields[k].shape, fields[k].dtype) == (a.shape, a.dtype), k
            np.testing.assert_array_equal(fields[k], a)
        assert any(k.startswith(HOST_PREFIX) for k in fields) == (rec is not None)
        assert all(k.startswith((BATCH_PREFIX, HOST_PREFIX)) for k in fields)
        with shm.create_arena(fields, num_workers=1, depth=1) as a:
            a.begin_write(0, 0)
            views = a.slot_views(0, writable=True)
            pack_batch_into(views, batch)
            if rec is not None:
                stack_batch_host(rec, batch, tabs, out=views, prefix=HOST_PREFIX)
            a.end_write(0, 0)
            got, host = unpack_slot(a.resolve(0, 0), spec)
            _assert_batches_equal(got, batch)
            for k, v in pack_batch_arrays(batch).items():
                np.testing.assert_array_equal(a.resolve(0, 0)[k], v)
            if rec is None:
                assert host is None
            else:
                want = stack_batch_host(rec, batch, tabs)
                assert set(host) == set(want)
                for k, v in want.items():
                    np.testing.assert_array_equal(host[k], v)  # bit for bit
                    assert host[k].dtype == v.dtype
            del got, host
    assert not _own_segments()
