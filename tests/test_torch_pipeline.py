"""The port's asynchronous host pipeline of HGNN training
(``repro_torch.data.prefetch``, ``repro_torch.data.sample_stream`` and the
pipelined ``Heta.fit`` / ``evaluate``) on the CPU.

  * the ``Prefetcher`` lifecycle contract (the reference's
    ``tests/test_data_pipeline.py``);
  * ``SampleStream`` batches equal the reference's ``batch_at`` under the
    same schedule; the ``"fresh"`` policy stages on the consumer;
  * pipeline on against off: thread and pool (with and without the batch
    arena), frozen tables, ``"fresh"`` learnable tables, and the dense
    executors give the serial losses bit for bit; ``"stale"`` stays within
    5e-2 with descriptor-sized queue items; one pool serves consecutive
    fits and respawns after a serial ``step()``; pooled and threaded
    ``evaluate`` equal the serial one; a killed worker is replayed
    bit-identically and an exhausted budget raises;
  * the slice against the JAX package: a pooled port fit (2 workers,
    ``"fresh"``) on the reference's initial weights gives the reference's
    serial losses within 1e-5.

Sizes: ogbn-mag at scale 0.002, batch 16, hidden 32.  Every pool bounds
its waits; the leak checks list only this process's segments.
"""

import gc
import os
import threading
import time
import warnings

import numpy as np
import pytest

from repro_torch.api import Heta, HetaConfig
from repro_torch.core.metatree import build_metatree
from repro_torch.data import Prefetcher, SampleStream, WorkerDiedError
from repro_torch.data.faults import KILL_EXIT_CODE, FaultPlan, FaultSpec
from repro_torch.graph.sampler import NeighborSampler, SampleSpec
from repro_torch.graph.shm import live_segments
from repro_torch.graph.synthetic import ogbn_mag_like

OWN = f"heta-tshm-{os.getpid():x}-"


# --------------------------------------------------------------------------
# Prefetcher — the shared producer (lifecycle contract)
# --------------------------------------------------------------------------


def test_prefetcher_order_and_finite_stop():
    with Prefetcher(lambda i: i * i, depth=2, num_items=5) as pf:
        assert list(pf) == [0, 1, 4, 9, 16]
        with pytest.raises(StopIteration):  # exhausted stays exhausted
            next(pf)


def test_prefetcher_close_joins_and_next_raises():
    pf = Prefetcher(lambda i: i, depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        next(pf)
    pf.close()  # idempotent


def test_prefetcher_producer_exception_propagates():
    def make(i):
        if i == 2:
            raise ZeroDivisionError("boom at 2")
        return i

    pf = Prefetcher(make, depth=1)
    assert next(pf) == 0 and next(pf) == 1
    with pytest.raises(ZeroDivisionError, match="boom at 2"):
        for _ in range(10):
            next(pf)
    assert not pf._thread.is_alive()  # the failure also shut the producer down
    with pytest.raises(RuntimeError, match="closed"):
        next(pf)


def test_prefetcher_close_unblocks_full_queue_producer():
    pf = Prefetcher(lambda i: i, depth=1)
    time.sleep(0.1)  # the producer fills the queue and blocks on put
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_idempotent_after_producer_failure():
    def make(i):
        raise ValueError("dead on arrival")

    pf = Prefetcher(make, depth=1)
    with pytest.raises(ValueError, match="dead on arrival"):
        next(pf)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pf.close()
        pf.close(warn=False)
        pf.__del__()  # the GC path never raises or warns
    assert not pf._thread.is_alive()


def test_prefetcher_del_mid_run_is_quiet():
    pf = Prefetcher(lambda i: i, depth=1)
    assert next(pf) == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        del pf
        gc.collect()


def test_prefetcher_runs_in_background_thread():
    tids = []

    def make(i):
        tids.append(threading.get_ident())
        return i

    with Prefetcher(make, depth=1, num_items=2) as pf:
        list(pf)
    assert tids and all(t != threading.get_ident() for t in tids)


# --------------------------------------------------------------------------
# SampleStream — thread mode against the reference's batch_at
# --------------------------------------------------------------------------


def _mag_sampler(seed=2, batch=8):
    g = ogbn_mag_like(scale=0.002)
    tree = build_metatree(g.metagraph(), g.target_type, 2)
    return NeighborSampler(g, SampleSpec.from_metatree(tree, [3, 2]), batch, seed=seed)


def test_sample_stream_batches_equal_reference_batch_at():
    from repro.core.metatree import build_metatree as ref_build_metatree
    from repro.graph.sampler import NeighborSampler as RefSampler
    from repro.graph.sampler import SampleSpec as RefSpec
    from repro.graph.synthetic import ogbn_mag_like as ref_mag

    s = _mag_sampler()
    rg = ref_mag(scale=0.002)
    ref = RefSampler(rg, RefSpec.from_metatree(
        ref_build_metatree(rg.metagraph(), rg.target_type, 2), [3, 2]), 8, seed=2)
    with SampleStream(lambda i: s.batch_at(i, epoch_seed=7), lambda b: int(b.seeds.sum()),
                      num_steps=4, depth=2) as stream:
        got = list(stream)
    assert len(got) == 4
    for i, (batch, arrays, host_s) in enumerate(got):
        want = ref.batch_at(i, epoch_seed=7)
        for a, b in [(batch.seeds, want.seeds), (batch.labels, want.labels)] + [
                (x, y) for la, lb in zip(batch.levels, want.levels)
                for x, y in ((la.nids, lb.nids), (la.mask, lb.mask))]:
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype
        assert arrays == int(want.seeds.sum()) and host_s >= 0.0


def test_sample_stream_defer_stage_and_failures():
    s = _mag_sampler()
    tids = []

    def staged(b):
        tids.append(threading.get_ident())
        return 0

    with SampleStream(lambda i: s.batch_at(i, epoch_seed=7), staged, num_steps=2,
                      depth=2, defer_stage=True) as stream:
        list(stream)
    assert tids and all(t == threading.get_ident() for t in tids)  # "fresh": consumer

    def bad_stage(b):
        raise RuntimeError("stage failed")

    stream = SampleStream(lambda i: s.batch_at(i, epoch_seed=7), bad_stage, num_steps=4)
    with pytest.raises(RuntimeError, match="stage failed"):
        list(stream)
    assert not stream._prefetcher._thread.is_alive()
    with pytest.raises(ValueError, match="worker_task"):
        SampleStream(lambda i: i, lambda b: b, num_workers=2)
    with pytest.raises(ValueError, match="make_batch"):
        SampleStream(stage=lambda b: b, num_workers=0)
    with pytest.raises(ValueError, match="num_workers"):
        SampleStream(lambda i: i, lambda b: b, num_workers=-1)


# --------------------------------------------------------------------------
# pipelined sessions against the serial loop
# --------------------------------------------------------------------------


def _config(executor="raf_spmd", model="rgcn", learn=False, steps=3, pipeline=None):
    c = HetaConfig().updated(
        data=dict(dataset="ogbn-mag", scale=0.002, fanouts=(3, 2), batch_size=16),
        partition=dict(num_partitions=2),
        model=dict(model=model, hidden=32, train_learnable=learn),
        run=dict(executor=executor, steps=steps, lr=1e-2, seed=0),
        faults=dict(worker_backoff_s=0.01))
    return c if pipeline is None else c.updated(pipeline=dict(enabled=True, **pipeline))


def _run(cfg, fault_plan=None):
    sess = Heta(cfg, device="cpu")
    sess.fault_plan = fault_plan
    try:
        res = sess.run()
        res["restarts"] = (list(sess._pool_cache[2].restarts)
                           if sess._pool_cache is not None else [])
        res["republish_times"] = list(sess.republish_times)
        return res
    finally:
        sess.close_pipeline()


_SERIAL = {}


def _serial(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _SERIAL:
        _SERIAL[key] = _run(_config(**kw))["losses"]
    return _SERIAL[key]


@pytest.mark.parametrize("executor,model,learn,pipeline", [
    ("raf_spmd", "rgcn", False, dict()),
    ("raf_spmd", "rgcn", False, dict(num_workers=2)),
    ("raf_spmd", "rgcn", False, dict(num_workers=1, arena=False)),
    ("raf_spmd", "rgcn", True, dict(snapshot="fresh")),
    ("raf_spmd", "rgcn", True, dict(num_workers=2, snapshot="fresh")),
    ("raf_spmd", "rgat", False, dict()),
    ("raf_spmd", "hgt", False, dict()),
    ("vanilla", "rgcn", False, dict()),
    ("vanilla", "rgcn", False, dict(num_workers=2)),
    ("raf", "rgcn", False, dict()),
    ("raf", "hgt", False, dict(num_workers=2)),
], ids=lambda v: v if isinstance(v, str) else (
    ("learn" if v else "frozen") if isinstance(v, bool) else
    "-".join(f"{k}={x}" for k, x in v.items()) or "thread"))
def test_pipeline_matches_serial_bit_for_bit(executor, model, learn, pipeline):
    """Frozen tables, the ``"fresh"`` policy and the dense executors: the
    pipelined losses are the serial ones, bit for bit, at any worker
    count."""
    kw = dict(executor=executor, model=model, learn=learn)
    res = _run(_config(pipeline=pipeline, **kw))
    assert res["losses"] == _serial(**kw)
    w = pipeline.get("num_workers", 0)
    assert res["pipeline"] and res["sampler_workers"] == w
    assert res["samples_per_s"] > 0 and 0.0 <= res["overlap_fraction"] < 1.0
    if w and pipeline.get("arena", True):
        assert 0 < res["queue_bytes_per_step"] < 1024  # descriptors, not arrays
    elif w:
        assert res["queue_bytes_per_step"] > 1024
    else:
        assert res["queue_bytes_per_step"] == 0.0
    assert not live_segments(OWN)


@pytest.mark.parametrize("pipeline", [dict(snapshot="stale"),
                                      dict(num_workers=2, snapshot="stale")],
                         ids=["thread", "pool"])
def test_stale_snapshot_stays_within_bound(pipeline):
    """Under ``"stale"`` staging reads tables at most the queue (thread) or
    ring (pool) depth behind: the losses track the serial ones within the
    reference's 5e-2; pooled workers stage against the tables the session
    republishes after every step, and the queue carries descriptors."""
    serial = _serial(learn=True, steps=4)
    res = _run(_config(learn=True, steps=4, pipeline=pipeline))
    assert len(res["losses"]) == 4 and np.all(np.isfinite(res["losses"]))
    np.testing.assert_allclose(res["losses"], serial, atol=5e-2, rtol=0)
    if pipeline.get("num_workers"):
        assert 0 < res["queue_bytes_per_step"] < 1024
        assert len(res["republish_times"]) == 4
    else:
        assert res["republish_times"] == []
    assert not live_segments(OWN)


def test_pool_persists_across_fits_and_respawns_after_step():
    serial = _serial(steps=6)
    sess = Heta(_config(steps=6, pipeline=dict(num_workers=2)), device="cpu")
    try:
        sess.build_graph(), sess.partition(), sess.profile_and_cache(), sess.compile()
        sess.fit(2)
        pool = sess._pool_cache[2]
        sess.fit(2)
        assert sess._pool_cache[2] is pool  # reused, not respawned
        sess.step()  # a serial step moves the stripe position...
        sess.fit(1)
        assert sess._pool_cache[2] is not pool  # ...so the pool respawned
        assert pool._closed
        assert sess.losses == serial
    finally:
        sess.close_pipeline()
    assert sess._pool_cache is None
    sess.close_pipeline()  # idempotent
    assert not live_segments(OWN)


@pytest.mark.parametrize("pipeline", [dict(), dict(num_workers=2)], ids=["thread", "pool"])
def test_evaluate_matches_serial(pipeline):
    def build(p):
        sess = Heta(_config(steps=0, pipeline=p), device="cpu")
        sess.run()
        return sess

    ref = build(None).evaluate(num_batches=2)
    got = build(pipeline).evaluate(num_batches=2)
    assert got["loss"] == ref["loss"] and got["num_batches"] == ref["num_batches"] == 2
    assert not live_segments(OWN)


def test_pooled_fit_survives_worker_kill_bit_identical():
    """A pooled fit that loses the worker owning item 5 (worker 1 of 2)
    respawns it, replays the stripe against the poisoned sub-ring, and
    gives the serial losses."""
    res = _run(_config(steps=8, pipeline=dict(num_workers=2)),
               fault_plan=FaultPlan((FaultSpec("kill_worker", step=5),)))
    assert res["losses"] == _serial(steps=8)
    assert len(res["restarts"]) == 1
    ev = res["restarts"][0]
    assert ev["wid"] == 1 and ev["exitcode"] == KILL_EXIT_CODE and ev["attempt"] == 1
    assert not live_segments(OWN)


def test_pooled_fit_budget_exhaustion_is_loud():
    """With respawn disabled the same drill raises the named error, and the
    session tears its pool down: no fallback to the serial loop."""
    sess = Heta(_config(steps=8, pipeline=dict(num_workers=2)).updated(
        faults=dict(max_worker_restarts=0)), device="cpu")
    sess.fault_plan = FaultPlan((FaultSpec("kill_worker", step=5),))
    with pytest.raises(WorkerDiedError, match="code 73"):
        sess.run()
    assert sess._pool_cache is None and len(sess.losses) < 8
    assert not live_segments(OWN)


def test_pooled_fit_matches_reference_serial_fit():
    """The slice as a whole: the reference's serial fit and a pooled port
    fit (2 workers, ``"fresh"``, learnable tables) from the same initial
    weights, carried over with ``repro_torch.convert``."""
    from repro.api import CacheConfig, DataConfig, Heta as RefHeta, HetaConfig as RefConfig
    from repro.api import KernelConfig, ModelConfig, RunConfig
    from repro_torch.convert import stacks_from_reference

    ref_cfg = RefConfig(
        data=DataConfig(dataset="ogbn-mag", scale=0.002, fanouts=(3, 2), batch_size=8),
        model=ModelConfig(train_learnable=True), run=RunConfig(steps=3, seed=0),
        cache=CacheConfig(cache_mb=1), kernels=KernelConfig(enabled=False))
    ref = RefHeta(ref_cfg)
    ref.build_graph(), ref.partition(), ref.profile_and_cache(), ref.compile()
    stacks = {layer: {leaf: np.asarray(v) for leaf, v in entry.items()}
              for layer, entry in ref.state["stacks"].items()}
    d = ref_cfg.to_dict()
    d["kernels"] = {}
    d["pipeline"] = dict(d["pipeline"], enabled=True, num_workers=2, snapshot="fresh")
    port = Heta(HetaConfig.from_dict(d), device="cpu")
    try:
        port.build_graph(), port.partition(), port.profile_and_cache()
        port.compile(state={"stacks": stacks_from_reference(stacks, "cpu")})
        got = port.fit()
    finally:
        port.close_pipeline()
    want = ref.fit()
    assert got["sampler_workers"] == 2 and 0 < got["queue_bytes_per_step"] < 1024
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5, rtol=0)
    assert port.engine.steps == ref.engine.steps
    assert not live_segments(OWN)


def test_executor_without_the_staged_protocol_stays_serial():
    """An executor that overrides only the composed ``step`` trains on the
    serial path, and a pipelined fit refuses it by name."""
    from repro_torch.api import HetaStageError, executors

    class ComposedOnly(executors.Executor):
        name = "composed-only"

        def step(self, sess, plan, state, batch):
            return state, 1.5, 0.001

    sess = Heta(_config(steps=2), device="cpu")
    sess.build_graph(), sess.partition(), sess.profile_and_cache(), sess.compile()
    sess.executor = ComposedOnly()
    assert sess.fit(2)["losses"] == [1.5, 1.5] and sess.host_times[0] >= 0.0
    sess.config = sess.config.updated(pipeline=dict(enabled=True))
    with pytest.raises(HetaStageError, match="staged-step protocol"):
        sess.fit(1)
