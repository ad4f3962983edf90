"""The serving slice of the PyTorch/CUDA port against the JAX reference.

A reference session (rgcn, ogbn-mag at scale 0.002, in-degree capped at 4,
exhaustive fanouts — ``tests/test_serve_full_graph.py``'s ``_session``) is
built once with kernels off and once with the Pallas kernels in interpret
mode.  Its parameter stacks and feature tables go through
``repro_torch.convert`` into the port, which runs on the CPU (its plain
PyTorch path).  Tolerance: fp32, atol 1e-5 / rtol 1e-5 — the port sums slot
outputs and contractions in PyTorch's order, not XLA's.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.api import DataConfig as RefDataConfig
from repro.api import Heta as RefHeta
from repro.api import HetaConfig as RefHetaConfig
from repro.api import KernelConfig as RefKernelConfig
from repro.api import ModelConfig as RefModelConfig
from repro.api import RunConfig as RefRunConfig
from repro.core import raf_spmd as ref_spmd
from repro.core.hgnn import init_hgnn_params as ref_init_hgnn_params
from repro.embed.cache import CacheAllocation as RefCacheAllocation
from repro.embed.cache import FeatureCache as RefFeatureCache
from repro.embed.profiler import HotnessProfile as RefHotnessProfile
from repro.serve import full_graph as ref_fg
from repro.serve.server import EmbeddingServer as RefEmbeddingServer
from repro_torch.api import Heta, HetaConfig, HetaStageError
from repro_torch.convert import stacks_from_reference, tables_from_reference
from repro_torch.core import raf_spmd
from repro_torch.embed.cache import CacheAllocation, FeatureCache
from repro_torch.embed.profiler import HotnessProfile
from repro_torch.graph.synthetic import make_dataset
from repro_torch.kernels.build import KernelBuildError
from repro_torch.kernels.ops import KernelLaunchError
from repro_torch.serve import full_graph as fg
from repro_torch.serve.server import EmbeddingServer, MicroBatcher

TOL = dict(atol=1e-5, rtol=1e-5)
REF_KERNELS = {
    "kernels_off": RefKernelConfig(enabled=False),
    "interpret": RefKernelConfig(interpret=True),
}


def _ref_session(kernels, cap=4, scale=0.002, seed=0):
    base = RefHetaConfig(
        data=RefDataConfig(dataset="ogbn-mag", scale=scale, fanouts=(2, 2),
                           batch_size=8),
        model=RefModelConfig(model="rgcn", hidden=16, num_heads=2, learnable_dim=12),
        run=RefRunConfig(executor="raf_spmd", steps=0, seed=seed, mesh_shape=(1, 1)),
        kernels=kernels,
    )
    s0 = RefHeta(base)
    g = ref_fg.bounded_graph(s0.build_graph(), cap)
    s0.partition()
    sess = RefHeta(base.updated(data=dict(fanouts=ref_fg.exhaustive_fanouts(g, s0.spec))))
    sess.build_graph(g)
    sess.partition()
    sess.profile_and_cache()
    sess.compile()
    return sess, g


def _port_config(ref_sess) -> HetaConfig:
    d = ref_sess.config.to_dict()
    d["kernels"] = {}  # the port's default: kernel ops on (plain on the CPU)
    return HetaConfig.from_dict(d)


def _stacks_np(ref_sess):
    return {layer: {leaf: np.asarray(v) for leaf, v in entry.items()}
            for layer, entry in ref_sess.state["stacks"].items()}


@pytest.fixture(scope="module", params=sorted(REF_KERNELS))
def pair(request):
    """(reference session, its graph, port session on the CPU, its graph)."""
    ref, g_ref = _ref_session(REF_KERNELS[request.param])
    sess = Heta(_port_config(ref), device="cpu")
    g = fg.bounded_graph(make_dataset("ogbn-mag", scale=0.002, seed=0), 4)
    sess.build_graph(g)
    sess.partition()
    sess.profile_and_cache()
    sess.compile(state={"stacks": stacks_from_reference(_stacks_np(ref), "cpu")})
    return ref, g_ref, sess, g


def test_port_graph_and_tables_are_the_reference_bits(pair):
    ref, g_ref, sess, g = pair
    assert g.num_nodes == g_ref.num_nodes
    port_rels = {(r.src, r.etype, r.dst): csr for r, csr in g.relations.items()}
    assert len(port_rels) == len(g_ref.relations)
    for rel, csr in g_ref.relations.items():
        np.testing.assert_array_equal(port_rels[rel.src, rel.etype, rel.dst].indptr, csr.indptr)
        np.testing.assert_array_equal(port_rels[rel.src, rel.etype, rel.dst].indices,
                                      csr.indices)
    ref_tables = ref.engine.tables_snapshot()
    port_tables = sess.engine.tables_snapshot()
    assert set(port_tables) == set(ref_tables)
    for t, a in ref_tables.items():  # learnable rows drawn with the same numpy
        np.testing.assert_array_equal(port_tables[t], a)
    assert sess.spec.fanouts == ref.spec.fanouts


def test_infer_all_matches_reference(pair):
    ref, g_ref, sess, g = pair
    ref_tables = ref.engine.tables_snapshot()
    ref_store = ref_fg.infer_all(g_ref, ref.plan.plan, ref.state["stacks"], ref_tables,
                                 node_block=64, kernels=ref.config.kernels)
    port_store = fg.infer_all(g, sess.plan.plan, sess.state["stacks"],
                              tables_from_reference(ref_tables), node_block=64,
                              kernels=sess.config.kernels, device="cpu")
    assert set(port_store.embeddings) == set(ref_store.embeddings)
    assert port_store.layer_of == ref_store.layer_of
    for t, a in ref_store.embeddings.items():
        assert port_store.embeddings[t].shape == a.shape
        np.testing.assert_allclose(port_store.embeddings[t], a, **TOL)
    ids = np.arange(g.num_nodes[g.target_type])
    np.testing.assert_allclose(port_store.scores(ids), ref_store.scores(ids), **TOL)
    # the session stage is the same computation over the engine's tables
    staged = sess.infer_all(node_block=64)
    for t, a in port_store.embeddings.items():
        np.testing.assert_array_equal(staged.embeddings[t], a)
    assert set(staged.timings) >= {"host_gather_s", "h2d_s", "compute_s", "d2h_s"}
    sess.close_serving()


def test_server_answers_match_store_and_reference_counters(pair):
    ref, g_ref, sess, g = pair
    ref_store = ref_fg.infer_all(g_ref, ref.plan.plan, ref.state["stacks"],
                                 ref.engine.tables_snapshot(), node_block=64,
                                 kernels=ref.config.kernels)
    store = sess.infer_all(node_block=64)
    rng = np.random.default_rng(5)
    n_target = g.num_nodes[g.target_type]
    queries = [rng.integers(0, n_target, 4) for _ in range(24)]
    queries += [rng.integers(0, g.num_nodes["author"], 3) for _ in range(4)]
    types = [g.target_type] * 24 + ["author"] * 4
    counters = []
    for cls, st, kw in ((RefEmbeddingServer, ref_store, dict(kernels=ref.config.kernels)),
                        (EmbeddingServer, store, dict(kernels=sess.config.kernels))):
        with cls(st, cache_mb=1, max_batch=8, max_wait_ms=1, **kw) as srv:
            for nids, t in zip(queries, types):
                res = srv.query(nids, t)
                np.testing.assert_array_equal(res.embeddings, st.embeddings[t][nids])
                if cls is EmbeddingServer:
                    w, b = st.head["w"].astype(np.float64), st.head["b"]
                    if t == g.target_type:
                        plain = np.maximum(st.embeddings[t][nids], 0) @ w + b
                        np.testing.assert_allclose(res.scores, plain, **TOL)
                        np.testing.assert_allclose(res.scores, ref_store.scores(nids), **TOL)
                    else:
                        assert res.scores is None
            stats = srv.stats()
            assert stats.degraded == stats.retries == stats.breaker_trips == 0
            counters.append({t: (c.hits, c.misses) for t, c in srv.cache.caches.items()})
    assert counters[0] == counters[1]
    sess.close_serving()


def test_plan_and_stacks_match_reference(pair):
    ref, g_ref, sess, g = pair
    # unfolded (4 partitions) and folded (1 shard, what the executor runs)
    for fold in (None, 1):
        ra = ref.assignment if fold is None else ref.assignment.fold(fold, ref.spec)
        pa = sess.assignment if fold is None else sess.assignment.fold(fold, sess.spec)
        np.testing.assert_array_equal(np.concatenate(pa.owner), np.concatenate(ra.owner))
        rp = ref_spmd.build_plan(ref.spec, ra, ref.hgnn_cfg, ref.feat_dims)
        pp = raf_spmd.build_plan(sess.spec, pa, sess.hgnn_cfg, sess.feat_dims)
        assert pp.d_pad == rp.d_pad and pp.num_shards == rp.num_shards
        assert pp.scope_keys == rp.scope_keys
        assert pp.src_types == rp.src_types and pp.dst_types == rp.dst_types
        for a, b in zip(pp.levels, rp.levels):
            assert (a.depth, a.layer, a.fanout, a.d_in) == (b.depth, b.layer, b.fanout, b.d_in)
            np.testing.assert_array_equal(a.slot_branch, b.slot_branch)
            np.testing.assert_array_equal(a.parent_local, b.parent_local)
            assert a.slot_u.keys() == b.slot_u.keys()
            for scope in a.slot_u:
                np.testing.assert_array_equal(a.slot_u[scope], b.slot_u[scope])
        for key, grp in rp.slot_groups.items():
            np.testing.assert_array_equal(pp.slot_groups[key], grp)
        import jax

        params = ref_init_hgnn_params(jax.random.PRNGKey(0), ref.hgnn_cfg, ref.spec,
                                      ref.feat_dims)
        params_np = jax.tree.map(np.asarray, params)
        ref_stacks = ref_spmd.stack_params_from_dict(rp, params)
        port_stacks = raf_spmd.stack_params_from_dict(pp, params_np, device="cpu")
        assert port_stacks.keys() == ref_stacks.keys()
        for layer, entry in ref_stacks.items():
            for leaf, v in entry.items():
                np.testing.assert_array_equal(port_stacks[layer][leaf].numpy(), np.asarray(v))


def test_feature_cache_mixed_path_matches_reference():
    """Partial hits, misses and online re-admission: rows and counters
    equal the reference cache's for the same requests."""
    rng = np.random.default_rng(3)
    tables = {"a": rng.standard_normal((200, 6)).astype(np.float32),
              "b": rng.standard_normal((50, 3)).astype(np.float32)}
    counts = {t: rng.random(a.shape[0]) for t, a in tables.items()}
    rows = {"a": 80, "b": 0}
    bytes_ = {t: rows[t] * tables[t].shape[1] * 4 for t in tables}
    ref = RefFeatureCache(tables, {}, RefCacheAllocation(rows, bytes_, 1 << 20, "t"),
                          RefHotnessProfile(counts))
    port = FeatureCache(tables, {}, CacheAllocation(rows, bytes_, 1 << 20, "t"),
                        HotnessProfile(counts), device="cpu")
    hot_a = HotnessProfile(counts).hottest("a", 80)
    requests = [{"a": rng.integers(0, 200, 9), "b": rng.integers(0, 50, 4)},
                {"a": hot_a[:7]}, {"a": np.array([], np.int64), "b": np.arange(3)}]
    for req in requests:
        r_out, p_out = ref.fetch_many(req), port.fetch_many(req)
        assert r_out.keys() == p_out.keys()
        for t in r_out:
            np.testing.assert_array_equal(p_out[t].numpy(), np.asarray(r_out[t]))
    assert port.hit_rates() == ref.hit_rates()
    for t, a in ref.take_access_counts().items():
        np.testing.assert_array_equal(port.take_access_counts(reset=False)[t], a)
    new_counts = {t: rng.random(a.shape[0]) for t, a in tables.items()}
    new_rows = {"a": 60, "b": 20}
    new_bytes = {t: new_rows[t] * tables[t].shape[1] * 4 for t in tables}
    moves_r = ref.update_residency(RefCacheAllocation(new_rows, new_bytes, 1 << 20, "t"),
                                   RefHotnessProfile(new_counts))
    moves_p = port.update_residency(CacheAllocation(new_rows, new_bytes, 1 << 20, "t"),
                                    HotnessProfile(new_counts))
    assert moves_p == moves_r
    req = {"a": rng.integers(0, 200, 12), "b": rng.integers(0, 50, 12)}
    r_out, p_out = ref.fetch_many(req), port.fetch_many(req)
    for t in r_out:
        np.testing.assert_array_equal(p_out[t].numpy(), np.asarray(r_out[t]))
    port.reset_stats()
    assert all(r == 0.0 for r in port.hit_rates().values())


def _toy_store(n=32, hidden=8, classes=5, seed=0):
    rng = np.random.default_rng(seed)
    emb = {t: rng.normal(size=(n, hidden)).astype(np.float32) for t in ("paper", "author")}
    return fg.EmbeddingStore(
        target_type="paper", num_classes=classes, hidden=hidden, embeddings=emb,
        layer_of={t: 2 for t in emb},
        head={"w": rng.normal(size=(hidden, classes)).astype(np.float32),
              "b": np.zeros(classes, np.float32)}, device="cpu")


def test_server_breaker_degrades_and_recovers():
    """A failing device path is retried, trips the breaker, answers from
    the numpy bypass (exact rows, same scores), and a half-open probe
    closes it again once the path heals."""
    store = _toy_store()
    with EmbeddingServer(store, max_batch=8, max_wait_ms=1, flush_retries=1,
                         retry_backoff_ms=0.1, breaker_threshold=2,
                         breaker_cooldown_ms=50) as srv:
        healthy = srv.cache.fetch_many

        def broken(requests):
            raise RuntimeError("injected device failure")

        srv.cache.fetch_many = broken
        for k in range(3):
            res = srv.query([k, k + 1])
            np.testing.assert_array_equal(res.embeddings, store.embedding("paper", [k, k + 1]))
            np.testing.assert_allclose(res.scores, store.scores([k, k + 1]), **TOL)
        stats = srv.stats()
        assert stats.count == 3 and stats.degraded == 3
        assert stats.breaker_trips == 1 and stats.breaker_state == "open"
        assert stats.retries == 2
        srv.cache.fetch_many = healthy
        time.sleep(0.12)
        res = srv.query([5, 6])
        np.testing.assert_array_equal(res.embeddings, store.embedding("paper", [5, 6]))
        stats = srv.stats()
        assert stats.breaker_state == "closed" and stats.breaker_recoveries == 1


@pytest.mark.parametrize("fault", [KernelLaunchError, KernelBuildError])
def test_server_kernel_fault_reaches_caller_not_breaker(fault):
    """A kernel that fails to launch or build inside fetch_many is raised
    to the callers of that flush: no retry, no trip, no degraded answer."""
    store = _toy_store()
    with EmbeddingServer(store, max_batch=8, max_wait_ms=1, flush_retries=2,
                         retry_backoff_ms=0.1, breaker_threshold=1) as srv:
        healthy = srv.cache.fetch_many

        def broken(requests):
            raise fault("injected kernel fault")

        srv.cache.fetch_many = broken
        for k in range(2):
            with pytest.raises(fault, match="injected"):
                srv.query([k, k + 1], timeout=30)
        stats = srv.stats()
        assert stats.degraded == stats.retries == stats.breaker_trips == 0
        assert stats.breaker_state == "closed" and stats.count == 0
        srv.cache.fetch_many = healthy
        res = srv.query([3, 4], timeout=30)
        np.testing.assert_array_equal(res.embeddings, store.embedding("paper", [3, 4]))


def test_server_coalesces_and_readmits():
    store = _toy_store(n=4096, hidden=64)
    with EmbeddingServer(store, max_batch=16, max_wait_ms=20, cache_mb=1,
                         readmit_every=2) as srv:
        results = {}

        def client(k):
            results[k] = srv.query([k, k + 1])

        threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for k, res in results.items():
            np.testing.assert_array_equal(res.embeddings, store.embedding("paper", [k, k + 1]))
        for _ in range(4):
            srv.query([4000, 4001])
        stats = srv.stats()
        assert stats.count == 10 and stats.flushes < 10
        assert srv.readmits >= 1
        with pytest.raises(KeyError, match="no materialized"):
            srv.query([0], ntype="venue")


def test_microbatcher_propagates_flush_errors_to_that_flush_only():
    calls = []

    def process(items):
        calls.append(list(items))
        if "bad" in items:
            raise ValueError("boom")
        return [x * 2 for x in items]

    with MicroBatcher(process, max_batch=4, max_wait_ms=1) as mb:
        assert mb(3, timeout=5) == 6
        with pytest.raises(ValueError, match="boom"):
            mb("bad", timeout=5)
        assert mb(4, timeout=5) == 8
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(1)


def test_session_stage_guards_and_unported_options():
    sess = Heta(HetaConfig(), device="cpu")
    with pytest.raises(HetaStageError, match="build_graph"):
        sess.partition()
    with pytest.raises(HetaStageError, match="infer_all"):
        sess.serve()
    with pytest.raises(NotImplementedError, match="shm"):
        fg.infer_all(None, None, {}, {}, shm=True)
    with pytest.raises(NotImplementedError, match="worker pool"):
        s = Heta(HetaConfig().updated(pipeline=dict(enabled=True, num_workers=2)),
                 device="cpu")
        s.build_graph(fg.bounded_graph(make_dataset("ogbn-mag", scale=0.002), 4))
        s.partition()
        s.profile_and_cache()
