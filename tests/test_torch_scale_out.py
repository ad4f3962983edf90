"""The port's data-parallel tier (``repro_torch.data.dp_trainer``,
``repro_torch.graph.mmap_store``, DESIGN.md §13) on the CPU.

  * the reference's ``tests/test_scale_out.py`` for the port: hierarchy
    ownership, mmap attach parity and node-type order, the shm handle's
    ``num_nodes`` order, the janitor, ``mag240m_stream``, the exchange's
    fixed-order reduction, a template mismatch failing fast, the 0-d leaf
    round trip, the trainer rebuild and the refusals;
  * the port against the reference, both numpy: hierarchy ownership and
    ``mag240m_stream``'s arrays are equal bit for bit;
  * a 2-rank ``"global"`` fit bit-identical to the single-process fit over
    both stores, then ``evaluate`` and ``results()["scale"]``; its losses
    within 1e-5 of the reference's serial fit from the same initial
    weights; a 2-rank ``"local"`` run (the port's ``_dp_loop_local`` for
    both ranks in threads, from the reference's initial weights) with
    ranks bit-identical to each other and within 1e-5 of the reference's
    2-rank ``"local"`` fit;
  * an exchange wait whose peer never comes raises ``DPError`` inside its
    own bound.

Sizes: ogbn-mag at scale 0.002, hidden 16, batch 16.  Spawned ranks run on
the CPU (``device="cpu"``); every wait has its own bound (60 s for a fit,
1 s for the exchange); the leak checks list only this process's segments
and stores.
"""

import functools
import multiprocessing as mp
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import Heta as RefHeta
from repro.api import HetaConfig as RefHetaConfig
from repro.core.meta_partition import hierarchical_partition as ref_hierarchical_partition
from repro.graph.synthetic import mag240m_stream as ref_mag240m_stream
from repro_torch.api import Heta, HetaConfig
from repro_torch.api.session import HetaStageError
from repro_torch.core.meta_partition import hierarchical_partition
from repro_torch.data import dp_trainer
from repro_torch.data.dp_trainer import (DPError, _adopt, _host_leaves, attach_exchange,
                                         create_exchange, state_sha)
from repro_torch.graph import mmap_store as ms
from repro_torch.graph.shm import attach, live_segments, share_graph
from repro_torch.graph.synthetic import mag240m_stream, ogbn_mag_like

pytestmark = pytest.mark.skipif(
    not os.path.isdir("/dev/shm"), reason="no /dev/shm on this platform"
)

OWN_SEGMENTS = f"heta-tshm-{os.getpid():x}-"
OWN_STORES = f"heta-tmmap-{os.getpid():x}-"
FIT_TIMEOUT_S = 60.0


def _cfg_dict(steps=3, **scale):
    d = dict(
        data=dict(dataset="ogbn-mag", scale=0.002, fanouts=(3, 2), batch_size=16),
        model=dict(hidden=16, num_heads=2, train_learnable=False),
        run=dict(executor="raf_spmd", steps=steps, seed=11, log_every=0),
        pipeline=dict(num_workers=0),
    )
    if scale:
        d["scale"] = scale
    return d


def _quick_cfg(steps=3, **scale):
    return HetaConfig.from_dict(_cfg_dict(steps, **scale))


def _ref_cfg(steps=3, **scale):
    d = _cfg_dict(steps, **scale)
    d["kernels"] = dict(enabled=False)  # the plain path; the port's CPU path is plain too
    return RefHetaConfig.from_dict(d)


def _built(cfg, stacks=None):
    sess = Heta(cfg, device="cpu")
    sess.build_graph(), sess.partition(), sess.profile_and_cache()
    sess.compile(state=None if stacks is None else {"stacks": stacks})
    return sess


def _ref_built(cfg):
    sess = RefHeta(cfg)
    sess.build_graph(), sess.partition(), sess.profile_and_cache(), sess.compile()
    return sess


def _ref_stacks(ref):
    """The reference session's parameter stacks as port tensors, taken before
    any step (its jitted step donates its buffers)."""
    from repro_torch.convert import stacks_from_reference

    return stacks_from_reference(
        {layer: {leaf: np.asarray(v) for leaf, v in entry.items()}
         for layer, entry in ref.state["stacks"].items()}, "cpu")


@pytest.fixture
def bounded_fit(monkeypatch):
    """``Heta.fit`` hands a scale-out fit to ``run_dp_fit``; bound its waits
    at FIT_TIMEOUT_S instead of the 300 s a real fit's rank startup needs."""
    monkeypatch.setattr(dp_trainer, "run_dp_fit",
                        functools.partial(dp_trainer.run_dp_fit, timeout_s=FIT_TIMEOUT_S))


def _no_leaks():
    assert not live_segments(OWN_SEGMENTS)
    assert not ms.live_stores(prefix=OWN_STORES)


# --------------------------------------------------------------------------
# hierarchy ownership
# --------------------------------------------------------------------------


def test_hierarchy_ownership_invariant_and_reference_parity():
    """Every train node owned by exactly one rank; rank seed slices are
    disjoint and cover train_nodes; the ownership is the reference's."""
    g = ogbn_mag_like(scale=0.002)
    hier = hierarchical_partition(g, num_groups=2, trainers_per_group=2,
                                  num_layers=2, seed=3)
    hier.validate_ownership(g)
    slices = [hier.trainer_train_nodes(g, r) for r in range(hier.num_trainers)]
    allid = np.concatenate(slices)
    assert len(allid) == len(g.train_nodes) == len(np.unique(allid))
    assert np.array_equal(np.sort(allid), np.sort(g.train_nodes))
    for r, s in enumerate(slices):
        assert (hier.rank_of(g.target_type, s) == r).all()
    from repro.graph.synthetic import ogbn_mag_like as ref_ogbn_mag_like

    rg = ref_ogbn_mag_like(scale=0.002)
    ref = ref_hierarchical_partition(rg, num_groups=2, trainers_per_group=2,
                                     num_layers=2, seed=3)
    for r, s in enumerate(slices):
        np.testing.assert_array_equal(s, ref.trainer_train_nodes(rg, r))
    with pytest.raises(ValueError):
        hier.trainer_train_nodes(g, 4)


# --------------------------------------------------------------------------
# mmap store: attach parity, num_nodes order, janitor, mag240m_stream
# --------------------------------------------------------------------------


def test_mmap_attach_parity_and_order():
    """The attached twin is bit-equal and iterates node types in the source
    graph's insertion order (type-arena offsets depend on it); the store is
    named with the port's prefix and gone after unlink."""
    g = ogbn_mag_like(scale=0.002)
    store = ms.mmap_share_graph(g, include_features=True)
    name = os.path.basename(store.handle.path)
    try:
        assert name.startswith(OWN_STORES) and name in ms.live_stores()
        att = ms.attach_any(store.handle)
        assert list(att.graph.num_nodes) == list(g.num_nodes)
        assert att.graph.num_nodes == g.num_nodes
        for r, csr in g.relations.items():
            np.testing.assert_array_equal(csr.indptr, att.graph.relations[r].indptr)
            np.testing.assert_array_equal(csr.indices, att.graph.relations[r].indices)
        for t, f in g.features.items():
            np.testing.assert_array_equal(f, att.graph.features[t])
        np.testing.assert_array_equal(g.train_nodes, att.graph.train_nodes)
        np.testing.assert_array_equal(g.labels, att.graph.labels)
        att.close()
    finally:
        store.unlink()
    assert name not in ms.live_stores()


def test_shm_handle_preserves_num_nodes_order():
    g = ogbn_mag_like(scale=0.002)
    with share_graph(g, include_features=False) as store:
        att = ms.attach_any(store.handle)  # dispatches to shm.attach
        assert list(att.graph.num_nodes) == list(g.num_nodes)
        att.close()
        att = attach(store.handle)
        assert list(att.graph.num_nodes) == list(g.num_nodes)
        att.close()
    with pytest.raises(TypeError, match="not a graph store handle"):
        ms.attach_any(object())


def test_mmap_janitor_reaps_dead_owner_store_only(tmp_path):
    """A dead owner's ``heta-tmmap-`` store is reaped; a live owner's and the
    reference's ``heta-mmap-`` names are left alone."""
    g = ogbn_mag_like(scale=0.002)
    root = str(tmp_path)
    store = ms.mmap_share_graph(g, include_features=False, root=root)
    name = os.path.basename(store.handle.path)
    foreign = os.path.join(root, "heta-mmap-3ffffffe-00000000")
    os.makedirs(foreign)
    try:
        assert ms.cleanup_stale_stores(root=root) == []  # alive owner: never reaped
        dead = name.replace(f"{os.getpid():x}", "3ffffffe", 1)
        os.rename(store.handle.path, os.path.join(root, dead))
        assert ms.cleanup_stale_stores(root=root) == [dead]
        assert ms.live_stores(root=root) == []
        assert os.path.isdir(foreign)  # the reference's prefix: not the port's to sweep
    finally:
        store.unlink()


def test_mag240m_stream_tiny_attaches_and_equals_reference(tmp_path):
    """The chunk-wise generator commits a well-formed store at tiny scale, and
    every array equals the reference's at the same seed and chunking."""
    store = mag240m_stream(scale=1e-6, chunk_edges=128, root=str(tmp_path))
    ref_store = ref_mag240m_stream(scale=1e-6, chunk_edges=128, root=str(tmp_path))
    try:
        att = ms.attach_any(store.handle)
        g = att.graph
        assert g.target_type == "paper" and g.name == "mag240m-stream"
        assert set(g.num_nodes) == {"paper", "author", "institution"}
        for csr in g.relations.values():
            assert csr.indptr[0] == 0 and (np.diff(csr.indptr) >= 0).all()
        assert os.path.basename(store.handle.path).startswith(OWN_STORES)
        assert [(k, r.offset, r.shape, r.dtype) for k, r in store.handle.arrays] == [
            (k, r.offset, r.shape, r.dtype) for k, r in ref_store.handle.arrays]
        assert store.handle.num_nodes == ref_store.handle.num_nodes
        assert store.handle.relations == ref_store.handle.relations
        from repro.graph.mmap_store import attach_any as ref_attach_any

        ref_att = ref_attach_any(ref_store.handle)
        for key, _ in store.handle.arrays:
            kind, _, rest = key.partition("/")
            if kind == "rel":
                i, part = rest.split("/")
                rel = store.handle.relations[int(i)]
                mine = getattr(att.graph.relations[_rel(g, rel)], part)
                theirs = getattr(ref_att.graph.relations[_rel(ref_att.graph, rel)], part)
            elif kind == "feat":
                mine, theirs = att.graph.features[rest], ref_att.graph.features[rest]
            else:
                mine, theirs = getattr(att.graph, key), getattr(ref_att.graph, key)
            np.testing.assert_array_equal(mine, theirs, err_msg=key)
        att.close()
        ref_att.close()
    finally:
        store.unlink()
        ref_store.unlink()


def _rel(graph, triple):
    return next(r for r in graph.relations if (r.src, r.etype, r.dst) == tuple(triple))


# --------------------------------------------------------------------------
# DP exchange protocol (threads stand in for processes; same Condition)
# --------------------------------------------------------------------------


def test_dp_exchange_fixed_order_reduction():
    leaves = [np.zeros((4, 3), np.float32), np.zeros((2,), np.float64)]
    cond = mp.get_context("spawn").Condition()
    ex0 = create_exchange(leaves, num_ranks=2, cond=cond, depth=2, timeout_s=30.0)
    ex1 = attach_exchange(ex0.handle, cond, rank=1, template_leaves=leaves, timeout_s=30.0)
    steps, got = 5, {}

    def rank_main(ex, rank):
        rng = np.random.default_rng(100 + rank)
        out = []
        for k in range(steps):
            mine = [rng.standard_normal((4, 3)).astype(np.float32),
                    rng.standard_normal(2)]
            ex.contribute(k, mine, order=rank, num_contrib=2,
                          loss=float(rank + k), batch_size=8)
            red, loss_row, bs_row = ex.consume(k)
            out.append((mine, red, loss_row.copy(), bs_row.copy()))
        got[rank] = out

    try:
        t = threading.Thread(target=rank_main, args=(ex1, 1), daemon=True)
        t.start()
        rank_main(ex0, 0)
        t.join(timeout=30)
        assert not t.is_alive()
        for k in range(steps):
            m0, r0, l0, b0 = got[0][k]
            m1, r1, _, _ = got[1][k]
            # fixed order: rank 0 copies, then rank 1 adds; both read one sum
            for i in range(2):
                np.testing.assert_array_equal(r0[i], m0[i] + m1[i])
                np.testing.assert_array_equal(r1[i], m0[i] + m1[i])
            assert list(l0) == [float(k), float(1 + k)]
            assert list(b0) == [8, 8]
    finally:
        ex1.close()
        ex0.unlink()
    _no_leaks()


def test_dp_exchange_template_mismatch_fails_fast():
    leaves = [np.zeros((4, 3), np.float32)]
    cond = mp.get_context("spawn").Condition()
    ex0 = create_exchange(leaves, num_ranks=2, cond=cond, timeout_s=1.0)
    try:
        with pytest.raises(DPError, match="mismatch"):
            attach_exchange(ex0.handle, cond, rank=1,
                            template_leaves=[np.zeros((3, 4), np.float32)])
        with pytest.raises(DPError, match="mismatch"):
            attach_exchange(ex0.handle, cond, rank=1,
                            template_leaves=[np.zeros((4, 3), np.float64)])
        with pytest.raises(DPError, match="leaves"):
            attach_exchange(ex0.handle, cond, rank=1,
                            template_leaves=[np.zeros((4, 3), np.float32)] * 2)
    finally:
        ex0.unlink()


def test_dp_exchange_wait_for_absent_peer_raises_in_bound():
    """A publication that never comes, and a peer that is gone, each raise
    DPError inside the exchange's own bound (1 s), not after a hang."""
    leaves = [np.zeros((3,), np.float32)]
    cond = mp.get_context("spawn").Condition()
    ex = create_exchange(leaves, num_ranks=2, cond=cond, timeout_s=1.0)
    try:
        t0 = time.monotonic()
        with pytest.raises(DPError, match="timed out after 1s waiting for publication of step 0"):
            ex.consume(0)
        assert time.monotonic() - t0 < 3.0

        def gone():
            raise DPError("trainer process(es) died: ['dp-trainer-1']")

        ex.alive = gone
        t0 = time.monotonic()
        with pytest.raises(DPError, match="dp-trainer-1"):
            ex.contribute(0, leaves, order=1, num_contrib=2, loss=0.0, batch_size=1)
        assert time.monotonic() - t0 < 3.0
    finally:
        ex.unlink()
    _no_leaks()


def test_dp_exchange_scalar_leaf_roundtrip():
    """0-d leaves (Adam's int32 step) survive the at-least-1-d wire shape
    and come back as their predecessor's dtype and device."""
    tree = {"w": torch.ones((2, 2)), "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    host = _host_leaves(tree)
    assert [h.shape for h in host] == [(1,), (2, 2)]  # sorted keys: opt/step, w
    assert all(h.ndim >= 1 for h in host)
    back = _adopt(tree, [h * 2 for h in host])
    assert back["opt"]["step"].shape == () and back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 6
    assert back["w"].dtype == torch.float32 and back["w"].device == tree["w"].device
    torch.testing.assert_close(back["w"], torch.full((2, 2), 2.0), rtol=0, atol=0)
    assert state_sha(back) != state_sha(tree) and state_sha(tree) == state_sha(
        {"opt": {"step": torch.tensor(3, dtype=torch.int32)}, "w": torch.ones((2, 2))})


# --------------------------------------------------------------------------
# rebuild, refusals, fits
# --------------------------------------------------------------------------


def test_trainer_rebuild_bit_identity():
    """A trainer's deterministic rebuild (config dict round trip plus the
    attached store) reproduces the parent's state and a step's loss bit
    for bit: the premise of both DP modes."""
    parent = _built(_quick_cfg())
    store = share_graph(parent.graph, include_features=True)
    try:
        att = ms.attach_any(store.handle)
        child = Heta(HetaConfig.from_dict(parent.config.to_dict())
                     .updated(pipeline=dict(num_workers=0)), device="cpu")
        child.build_graph(graph=att.graph)
        child.partition(), child.profile_and_cache(), child.compile()
        assert state_sha(parent.state) == state_sha(child.state)
        assert parent.step() == child.step()
        assert state_sha(parent.state) == state_sha(child.state)
        del child
        att.close()
    finally:
        store.unlink()
    _no_leaks()


def test_dp_fit_refuses_learnable_tables_and_local_off_raf_spmd():
    cfg = _quick_cfg(steps=2, num_trainers=2, mode="local").updated(
        model=dict(train_learnable=True))
    with pytest.raises(HetaStageError, match="frozen"):
        _built(cfg).fit()
    cfg = _quick_cfg(steps=2, num_trainers=2, mode="local").updated(
        run=dict(executor="vanilla"))
    with pytest.raises(HetaStageError, match="raf_spmd"):
        _built(cfg).fit()
    _no_leaks()


@pytest.mark.parametrize("store", ["shm", "mmap"])
def test_dp_fit_global_bit_identical_to_single(store, bounded_fit):
    """Two ranks under the stripe discipline reproduce the single-process
    losses and final state bit for bit; evaluate() and results() work on
    the DP session afterwards; no segment or store is left."""
    single = _built(_quick_cfg(steps=4))
    single.fit()
    dp = _built(_quick_cfg(steps=4, num_trainers=2, mode="global", store=store))
    res = dp.fit()
    assert dp.losses == single.losses and res["losses"] == single.losses
    assert state_sha(dp.state) == state_sha(single.state)
    sc = res["scale"]
    assert (sc["num_trainers"], sc["mode"], sc["store"], sc["hierarchy"]) == (
        2, "global", store, [1, 2])
    assert sc["state_sha"] == state_sha(dp.state)
    assert set(sc["trainer_wall_s"]) == {1} and sc["startup_s"][1] > 0
    rep = sc["trainer_reports"][1]
    assert rep["ok"] and rep["state_sha"] == sc["state_sha"] and "losses" not in rep
    assert set(rep["kernel_launches"]) >= {"stacked_mean_linear", "stacked_mean_linear_dh"}
    assert dp._steps_done == 4 and len(dp.step_times) == 2  # rank 0 ran steps 0 and 2
    assert dp.evaluate(num_batches=2) == single.evaluate(num_batches=2)
    assert dp.results()["losses"] == single.losses
    _no_leaks()


def test_dp_fit_global_matches_reference_serial_fit(bounded_fit):
    """The slice against the JAX package: a 2-rank port fit whose rank 0
    starts from the reference's initial stacks (rank 1 adopts rank 0's
    state after step 0) gives the reference's serial losses within 1e-5."""
    ref = _ref_built(_ref_cfg(steps=4))
    stacks = _ref_stacks(ref)
    want = ref.fit()["losses"]
    port = _built(_quick_cfg(steps=4, num_trainers=2, mode="global"), stacks=stacks)
    got = port.fit()["losses"]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    _no_leaks()


def _ref_dp_fit(ref, monkeypatch):
    """The reference's own 2-rank fit (its run_dp_fit spawns rank 1), with
    its waits bounded like the port's.  Its store and exchange segments get
    a prefix of this test's own: the reference's leak checks list every
    ``heta-shm-`` segment in ``/dev/shm``, so under that prefix they would
    fail in another test process that runs while this fit does."""
    from repro.data.dp_trainer import run_dp_fit
    from repro.graph import shm as ref_shm

    monkeypatch.setattr(ref_shm, "SEGMENT_PREFIX", "heta-xshm-")
    res = run_dp_fit(ref, ref.config.run.steps, timeout_s=FIT_TIMEOUT_S)
    assert res["scale"]["mode"] == ref.config.scale.mode
    assert not ref_shm.live_segments(f"heta-xshm-{os.getpid():x}-")
    return res["losses"]


def test_dp_local_matches_reference_local_fit(monkeypatch):
    """``"local"`` mode: the port's ``_dp_loop_local`` for both ranks in
    threads of this process, each from the reference's initial stacks,
    gives ranks bit-identical to each other (losses and state) and the
    reference's 2-rank ``"local"`` losses within 1e-5."""
    ref = _ref_built(_ref_cfg(steps=3, num_trainers=2, mode="local"))
    stacks = _ref_stacks(ref)
    want = _ref_dp_fit(ref, monkeypatch)
    sessions = [_built(_quick_cfg(steps=3, num_trainers=2, mode="local"), stacks=stacks)
                for _ in range(2)]
    cond = mp.get_context("spawn").Condition()
    template = _host_leaves(sessions[0].state["stacks"])
    ex0 = create_exchange(template, 2, cond, timeout_s=FIT_TIMEOUT_S)
    ex1 = attach_exchange(ex0.handle, cond, 1, template_leaves=template,
                          timeout_s=FIT_TIMEOUT_S)
    got, errors = {}, []

    def rank_main(rank, ex):
        try:
            got[rank] = dp_trainer._dp_loop_local(sessions[rank], ex, rank, 2, 0, 3, True)
        except BaseException as e:  # surfaced below
            errors.append(e)

    try:
        t = threading.Thread(target=rank_main, args=(1, ex1), daemon=True)
        t.start()
        rank_main(0, ex0)
        t.join(timeout=FIT_TIMEOUT_S)
        assert not t.is_alive() and not errors, errors
    finally:
        ex1.close()
        ex0.unlink()
    assert got[0] == got[1] and len(got[0]) == 3
    assert state_sha(sessions[0].state) == state_sha(sessions[1].state)
    np.testing.assert_allclose(got[0], want, atol=1e-5, rtol=0)
    _no_leaks()


def test_dp_fit_local_runs_through_fit(bounded_fit):
    """``Heta.fit`` in ``"local"`` mode spawns rank 1; run_dp_fit's own
    cross-rank check (losses and state hash, bit for bit) holds; the
    losses are finite and the session's books follow."""
    dp = _built(_quick_cfg(steps=3, num_trainers=2, mode="local"))
    res = dp.fit()
    assert res["scale"]["mode"] == "local" and len(dp.losses) == 3
    assert all(np.isfinite(dp.losses)) and dp._steps_done == 3
    assert res["scale"]["trainer_reports"][1]["state_sha"] == state_sha(dp.state)
    _no_leaks()
