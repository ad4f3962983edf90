"""The port's sampler worker pool (``repro_torch.data.worker_pool``) and
its fault supervision, against the JAX package where the two meet.

  * stripe order, finite stop, exception propagation, close joins;
  * batches from ``SampleStageTask`` workers (W in {1, 2}, with and without
    the batch arena) equal the reference's ``NeighborSampler.batch_at``
    under the same ``EpochSchedule``, array for array;
  * supervision: a killed worker's stripe is replayed bit-identical, an
    exhausted budget raises with the exit code, an injected raise
    propagates without a respawn, a poisoned slot resolves loudly;
  * the pooled §6 hotness sweep equals the serial sweep and the
    reference's.

The task classes live at module level so spawned workers can unpickle
them, and this module imports neither torch nor the reference at module
level: a worker that unpickles a task imports this module, and must stay
a numpy process.  Every pool bounds its waits (``close`` has a timeout, and
no test iterates an open-ended pool without a count).
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

from repro_torch.core.metatree import build_metatree
from repro_torch.data.faults import KILL_EXIT_CODE, FaultPlan, FaultSpec, InjectedFault
from repro_torch.data.staging import arena_fields, unpack_slot
from repro_torch.data.worker_pool import (
    EpochSchedule,
    SampleStageTask,
    SlotRef,
    WorkerDiedError,
    WorkerPool,
)
from repro_torch.graph.sampler import NeighborSampler, SampleSpec
from repro_torch.graph.shm import attach_arena, create_arena, live_segments, share_graph
from repro_torch.graph.synthetic import ogbn_mag_like

pytestmark = pytest.mark.skipif(
    not os.path.isdir("/dev/shm"), reason="the worker pool relies on /dev/shm"
)

# this process's own segments: the port's prefix and its pid (never a
# global listing — other test processes share /dev/shm)
OWN = f"heta-tshm-{os.getpid():x}-"


# --------------------------------------------------------------------------
# pool tasks (module level, so spawn can unpickle them)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SquareTask:
    def setup(self):
        pass

    def __call__(self, i):
        return i * i

    def teardown(self):
        pass


@dataclasses.dataclass
class FailAtTask:
    fail_at: int

    def setup(self):
        pass

    def __call__(self, i):
        if i == self.fail_at:
            raise ZeroDivisionError(f"boom at {i}")
        return i

    def teardown(self):
        pass


@dataclasses.dataclass
class BadSetupTask:
    def setup(self):
        raise OSError("no graph for you")

    def __call__(self, i):  # pragma: no cover — setup always fails
        return i

    def teardown(self):
        pass


@dataclasses.dataclass
class ChaosTask:
    """A minimal task with the SampleStageTask fault hooks."""

    faults: FaultPlan

    def setup(self):
        pass

    def bind_worker(self, wid, attempt):
        self._wid, self._attempt = wid, attempt

    def __call__(self, i):
        if self.faults.kill_at(self._wid, self._attempt, i):
            os._exit(KILL_EXIT_CODE)  # a silent death: no queue message
        if self.faults.raise_at(self._wid, self._attempt, i):
            raise InjectedFault(f"scheduled raise at {i}")
        return i * i

    def teardown(self):
        pass


@dataclasses.dataclass
class CrashAfterWriteTask:
    """Writes one arena slot, then dies hard mid-stripe."""

    arena: object
    crash_at: int = 1

    def setup(self):
        self._a = attach_arena(self.arena)

    def bind_stop(self, stop):
        self._stop = stop

    def __call__(self, i):
        if i == self.crash_at:
            os._exit(13)  # hard crash: no teardown, no atexit
        slot, use = self._a.handle.slot_for(i)
        if not self._a.wait_writable(slot, use, stop=self._stop, timeout=30):
            return None
        self._a.begin_write(slot, use)
        self._a.slot_views(slot, writable=True)["x"][:] = float(i)
        self._a.end_write(slot, use)
        return SlotRef(step=i, slot=slot, use=use, host_s=0.0)

    def teardown(self):
        self._a.close()


def _mag():
    g = ogbn_mag_like(scale=0.002)
    tree = build_metatree(g.metagraph(), g.target_type, 2)
    return g, SampleSpec.from_metatree(tree, [3, 2])


def _ref_sampler(seed, batch=8):
    """The reference's sampler over the reference's graph (same seed, same
    synthetic dataset)."""
    from repro.core.metatree import build_metatree as ref_build_metatree
    from repro.graph.sampler import NeighborSampler as RefSampler
    from repro.graph.sampler import SampleSpec as RefSpec
    from repro.graph.synthetic import ogbn_mag_like as ref_mag

    g = ref_mag(scale=0.002)
    tree = ref_build_metatree(g.metagraph(), g.target_type, 2)
    return RefSampler(g, RefSpec.from_metatree(tree, [3, 2]), batch, seed=seed)


def _assert_batches_equal(a, b):
    for x, y in ((a.seeds, b.seeds), (a.labels, b.labels)):
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        for x, y in ((la.nids, lb.nids), (la.mask, lb.mask)):
            np.testing.assert_array_equal(x, y)
            assert np.asarray(x).dtype == np.asarray(y).dtype


def _own_segments():
    return live_segments(OWN)


# --------------------------------------------------------------------------
# the pool: order, failures, lifecycle
# --------------------------------------------------------------------------


@pytest.mark.parametrize("num_workers", [1, 2, 3])
def test_strict_order_and_finite_stop(num_workers):
    with WorkerPool(SquareTask(), num_workers=num_workers, depth=2, num_items=7) as pool:
        assert list(pool) == [i * i for i in range(7)]
        with pytest.raises(StopIteration):
            next(pool)


@pytest.mark.parametrize("task,exc,match,prefix", [
    (FailAtTask(fail_at=3), ZeroDivisionError, "boom at 3", [0, 1, 2]),
    (BadSetupTask(), OSError, "no graph for you", []),
])
def test_worker_failure_propagates_and_pool_closes(task, exc, match, prefix):
    pool = WorkerPool(task, num_workers=2, depth=1, num_items=10)
    got = []
    with pytest.raises(exc, match=match):
        for x in pool:
            got.append(x)
    assert got == prefix  # everything before the failure, in order
    assert all(not p.is_alive() for p in pool._procs)
    with pytest.raises(RuntimeError, match="closed"):
        next(pool)


def test_close_joins_and_is_idempotent():
    pool = WorkerPool(SquareTask(), num_workers=2, depth=1)  # open-ended stripe
    assert next(pool) == 0
    pool.close(timeout=5.0)
    assert all(not p.is_alive() for p in pool._procs)
    pool.close(timeout=5.0)  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        next(pool)


def test_validation():
    with pytest.raises(ValueError, match="num_workers"):
        WorkerPool(SquareTask(), num_workers=0)
    with pytest.raises(ValueError, match="depth"):
        WorkerPool(SquareTask(), num_workers=1, depth=0)
    with pytest.raises(ValueError, match="max_restarts"):
        WorkerPool(SquareTask(), num_workers=1, max_restarts=-1)


# --------------------------------------------------------------------------
# batches against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arena", [False, True], ids=["pickled", "arena"])
@pytest.mark.parametrize("num_workers", [1, 2])
def test_pool_batches_equal_reference_batch_at(num_workers, arena):
    """The stripe decomposition is invisible: every pooled batch equals the
    reference sampler's batch at the same position, array for array (the
    arena's slot views included), and arena queue items are descriptors
    under 1 KiB."""
    g, spec = _mag()
    ref = _ref_sampler(seed=5)
    E = NeighborSampler(g, spec, 8, seed=5).steps_per_epoch()
    assert E == ref.steps_per_epoch()
    sched = EpochSchedule(77, E)
    n = min(E + 2, 9)  # cross each sub-ring's wrap-around
    store = share_graph(g, include_features=False)
    a = None
    try:
        if arena:
            probe = NeighborSampler(g, spec, 8, seed=5).batch_at(0, epoch_seed=77)
            a = create_arena(arena_fields(probe), num_workers=num_workers, depth=2)
        task = SampleStageTask(handle=store.handle, spec=spec, batch_size=8,
                               sampler_seed=5, schedule=sched,
                               arena=a.handle if a is not None else None)
        with WorkerPool(task, num_workers=num_workers, depth=2, num_items=n) as pool:
            for i, item in enumerate(pool):
                if arena:
                    assert isinstance(item, SlotRef) and len(pickle.dumps(item)) < 1024
                    assert (item.slot, item.use) == a.handle.slot_for(i)
                    batch, host = unpack_slot(a.resolve(item.slot, item.use), spec)
                else:
                    batch, host, host_s = item
                    assert host_s >= 0.0
                assert host is None
                seed, idx = sched.seed_and_index(i)
                _assert_batches_equal(batch, ref.batch_at(idx, epoch_seed=seed))
                if arena:
                    del batch  # the slot's views die before its release
                    a.release(item.slot, item.use)
            assert i == n - 1
    finally:
        store.unlink()
        if a is not None:
            a.unlink()
    assert not _own_segments()


def test_pooled_hotness_equals_serial_and_reference():
    from repro.embed.profiler import presample_hotness as ref_presample
    from repro_torch.embed.profiler import presample_hotness, presample_hotness_pooled

    g, spec = _mag()
    serial = presample_hotness(g, spec, 16, epochs=2, seed=3)
    pooled = presample_hotness_pooled(g, spec, 16, num_workers=2, epochs=2, seed=3)
    ref = ref_presample(_ref_sampler(seed=3, batch=16).graph,
                        _ref_sampler(seed=3, batch=16).spec, 16, epochs=2, seed=3)
    assert serial.counts.keys() == pooled.counts.keys() == ref.counts.keys()
    for t in serial.counts:
        np.testing.assert_array_equal(pooled.counts[t], serial.counts[t])
        np.testing.assert_array_equal(pooled.counts[t], ref.counts[t])
    assert sum(c.sum() for c in pooled.counts.values()) > 0
    assert not _own_segments()


# --------------------------------------------------------------------------
# supervision and fault injection
# --------------------------------------------------------------------------


def test_fault_spec_and_plan_queries():
    with pytest.raises(ValueError, match="kind"):
        FaultSpec("segfault", step=0)
    with pytest.raises(ValueError, match="step"):
        FaultSpec("kill_worker", step=-1)
    with pytest.raises(ValueError, match="count"):
        FaultSpec("fail_flush", step=0, count=0)
    plan = FaultPlan((
        FaultSpec("kill_worker", step=5, worker=1),
        FaultSpec("raise_item", step=2),
        FaultSpec("poison_slot", step=4, first_attempt_only=False),
        FaultSpec("fail_flush", step=3, count=2),
        FaultSpec("delay_flush", step=0, delay_s=0.25),
    ))
    assert plan.kill_at(1, 0, 5) and not plan.kill_at(0, 0, 5) and not plan.kill_at(1, 1, 5)
    assert plan.raise_at(0, 0, 2) and not plan.raise_at(0, 1, 2)
    assert plan.poison_at(0, 3, 4)
    assert plan.flush_fault(2) is None and plan.flush_fault(4) is not None
    assert plan.flush_delay(0) == 0.25 and plan.flush_delay(1) == 0.0
    assert FaultPlan.from_json(plan.to_json()) == plan
    assert not FaultPlan()


def test_respawn_replays_stripe_and_calls_death_hook():
    """Killing worker 1 mid-stripe: the death hook runs, the supervisor
    respawns it from the consumer's position and the ordered stream still
    arrives in full."""
    deaths = []
    task = ChaosTask(FaultPlan((FaultSpec("kill_worker", step=5, worker=1),)))
    with WorkerPool(task, num_workers=2, depth=2, num_items=12, max_restarts=2,
                    restart_backoff_s=0.01, on_worker_death=deaths.append) as pool:
        assert list(pool) == [i * i for i in range(12)]
        assert len(pool.restarts) == 1
        ev = pool.restarts[0]
        assert ev["wid"] == 1 and ev["exitcode"] == KILL_EXIT_CODE and ev["attempt"] == 1
        assert ev["item"] in (1, 3, 5) and ev["downtime_s"] >= 0.0
    assert deaths == [1]


@pytest.mark.parametrize("spec,restarts,match", [
    (FaultSpec("kill_worker", step=3), 0, r"code 73.*restarts used: 0/0"),
    (FaultSpec("kill_worker", step=2, first_attempt_only=False), 1, r"restarts used: 1/1"),
])
def test_exhausted_restart_budget_raises_with_exit_code(spec, restarts, match):
    pool = WorkerPool(ChaosTask(FaultPlan((spec,))), num_workers=2, depth=1, num_items=8,
                      max_restarts=restarts, restart_backoff_s=0.01)
    got = []
    with pytest.raises(WorkerDiedError, match=match):
        for x in pool:
            got.append(x)
    assert got == [i * i for i in range(len(got))]  # the prefix stayed ordered
    assert len(pool.restarts) == restarts
    assert all(not p.is_alive() for p in pool._procs)


def test_injected_raise_propagates_without_respawn():
    task = ChaosTask(FaultPlan((FaultSpec("raise_item", step=2),)))
    pool = WorkerPool(task, num_workers=2, depth=1, num_items=8, max_restarts=2)
    with pytest.raises(InjectedFault, match="scheduled raise at 2"):
        list(pool)
    assert pool.restarts == []
    assert all(not p.is_alive() for p in pool._procs)


@pytest.mark.parametrize("arena", [False, True], ids=["pickled", "arena"])
def test_sampler_kill_replays_stripe_bit_identical_to_reference(arena):
    """A killed SampleStageTask worker's stripe is replayed by its
    replacement (the arena's sub-ring poisoned first): every delivered
    batch still equals the reference sampler's."""
    g, spec = _mag()
    ref = _ref_sampler(seed=5)
    E = ref.steps_per_epoch()
    sched = EpochSchedule(77, E)
    store = share_graph(g, include_features=False)
    a = None
    try:
        if arena:
            probe = NeighborSampler(g, spec, 8, seed=5).batch_at(0, epoch_seed=77)
            a = create_arena(arena_fields(probe), num_workers=2, depth=2)
        task = SampleStageTask(
            handle=store.handle, spec=spec, batch_size=8, sampler_seed=5, schedule=sched,
            arena=a.handle if a is not None else None,
            faults=FaultPlan((FaultSpec("kill_worker", step=3),)))
        with WorkerPool(task, num_workers=2, depth=2, num_items=6, max_restarts=1,
                        restart_backoff_s=0.01,
                        on_worker_death=a.invalidate_worker_slots if arena else None) as pool:
            for i, item in enumerate(pool):
                if arena:
                    batch, _ = unpack_slot(a.resolve(item.slot, item.use), spec)
                else:
                    batch = item[0]
                seed, idx = sched.seed_and_index(i)
                _assert_batches_equal(batch, ref.batch_at(idx, epoch_seed=seed))
                if arena:
                    del batch
                    a.release(item.slot, item.use)
            assert len(pool.restarts) == 1
            assert pool.restarts[0]["exitcode"] == KILL_EXIT_CODE
    finally:
        store.unlink()
        if a is not None:
            a.unlink()
    assert not _own_segments()


def _probe_fields():
    return {"x": np.zeros((4, 3), np.float32), "y": np.zeros(4, np.int64)}


def test_poisoned_slot_resolves_loudly():
    """A scheduled poison_slot: the write completes, then the stamp is
    corrupted, and the consumer's resolve raises instead of returning the
    payload; invalidating a dead worker's sub-ring does the same."""
    g, spec = _mag()
    E = NeighborSampler(g, spec, 8, seed=5).steps_per_epoch()
    store = share_graph(g, include_features=False)
    probe = NeighborSampler(g, spec, 8, seed=5).batch_at(0, epoch_seed=77)
    a = create_arena(arena_fields(probe), num_workers=1, depth=2)
    try:
        task = SampleStageTask(
            handle=store.handle, spec=spec, batch_size=8, sampler_seed=5,
            schedule=EpochSchedule(77, E), arena=a.handle,
            faults=FaultPlan((FaultSpec("poison_slot", step=1),)))
        with WorkerPool(task, num_workers=1, depth=2, num_items=2) as pool:
            ref0 = next(pool)
            a.resolve(ref0.slot, ref0.use)  # item 0 is whole
            ref1 = next(pool)
            with pytest.raises(RuntimeError, match="invalidated"):
                a.resolve(ref1.slot, ref1.use)
        a.invalidate_worker_slots(0)
        with pytest.raises(RuntimeError, match="invalidated"):
            a.resolve(ref0.slot, ref0.use)
        with pytest.raises(ValueError, match="wid"):
            a.invalidate_worker_slots(1)
    finally:
        store.unlink()
        a.unlink()
    assert not _own_segments()


def test_worker_crash_surfaces_and_leaks_no_segments():
    a = create_arena(_probe_fields(), num_workers=1, depth=2)
    try:
        pool = WorkerPool(CrashAfterWriteTask(arena=a.handle), num_workers=1, depth=2,
                          num_items=4)
        got = []
        with pytest.raises(WorkerDiedError, match="exited"):
            for ref in pool:
                got.append(ref)
                a.release(ref.slot, ref.use)
        assert [r.step for r in got] in ([], [0])
        assert all(not p.is_alive() for p in pool._procs)
    finally:
        a.unlink()
    assert not _own_segments()  # the owner's unlink survives the worker's death
