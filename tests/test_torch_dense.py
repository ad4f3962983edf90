"""The dict-form executors of the PyTorch/CUDA port against the JAX reference.

Covers the ``relation_agg`` op (kernel 6's plain version and closed-form
backward), the dict-form model (``hgnn_forward``, ``raf_forward``), the
``raf`` executor's sessions, the §4 communication accounting, checkpoints of
bundle state, the executor registry and the CLI.  Reference sessions run
ogbn-mag at scale 0.002 with 2 partitions, fanouts (3, 2), batch 16 and
hidden 32, with the Pallas kernels in interpret mode; their initial bundles
go through ``repro_torch.convert.bundle_from_reference`` into port sessions
on the CPU, which run the kernels' plain versions through the same autograd
``Function``s the card runs.  Tolerances are the reference's: kernel 6
within atol/rtol 1e-5 (bf16 5e-2), logits within 2e-5, gradients and 3-step
losses within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Heta as RefHeta
from repro.api import HetaConfig as RefHetaConfig
from repro.api import executors as ref_executors
from repro.checkpoint.ckpt import _path_key
from repro.core import hgnn as ref_hgnn
from repro.core import raf as ref_raf
from repro.kernels.ops import KernelOptions
from repro.kernels.relation_agg import relation_agg as ref_relation_agg
from repro_torch.api import Heta, HetaConfig, HetaStageError
from repro_torch.api import executors
from repro_torch.checkpoint.ckpt import _items
from repro_torch.convert import bundle_from_reference
from repro_torch.core import hgnn, raf
from repro_torch.kernels.relation_agg import relation_agg, relation_agg_ref
from repro_torch.optim.adam import global_norm, tree_leaves, tree_map

ATOL = 1e-5
MODELS = ("rgcn", "rgat", "hgt")

# tests/test_kernels.py's AGG_SHAPES: (n, f, d_in, d_out)
AGG_SHAPES = [
    (200, 25, 128, 64),
    (64, 20, 64, 64),
    (64, 4, 789, 64),
    (128, 20, 64, 349),
    (5, 3, 7, 16),
    (256, 10, 1024, 64),
]


def _agg_case(n, f, di, do, seed, all_masked=False):
    r = np.random.default_rng(seed)
    h = r.standard_normal((n, f, di)).astype(np.float32)
    m = np.zeros((n, f), bool) if all_masked else r.random((n, f)) > 0.3
    w = (r.standard_normal((di, do)) * 0.1).astype(np.float32)
    b = (r.standard_normal(do) * 0.1).astype(np.float32)
    return h, m, w, b


def _agg_pair(h, m, w, b):
    """Output and the sum-of-squares gradients (dh, dw, db) of the reference
    op in interpret mode and of the port's op on CPU tensors.  Both
    backwards take the same cotangent, ``2 * out`` of the reference's
    forward: the check is of the closed-form backward against the
    reference's custom VJP, and the forwards' own rounding (held to 1e-5
    apart) would otherwise be amplified by the loss into dw, a sum over
    rows."""
    def loss(h_, w_, b_):
        return jnp.sum(ref_relation_agg(h_, jnp.asarray(m), w_, b_, interpret=True) ** 2)

    ref_out = np.asarray(ref_relation_agg(jnp.asarray(h), jnp.asarray(m), jnp.asarray(w),
                                          jnp.asarray(b), interpret=True))
    ref_g = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))]
    th, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (h, w, b))
    out = relation_agg(th, torch.from_numpy(m), tw, tb)
    got_g = [g.numpy() for g in torch.autograd.grad(out, (th, tw, tb),
                                                     torch.from_numpy(2 * ref_out))]
    return ref_out, out.detach().numpy(), ref_g, got_g


# --------------------------------------------------------------------------
# kernel 6's op: plain version + closed-form backward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,f,di,do", AGG_SHAPES)
def test_relation_agg_matches_reference(n, f, di, do):
    ref_out, out, ref_g, got_g = _agg_pair(*_agg_case(n, f, di, do, seed=n + di))
    np.testing.assert_allclose(out, ref_out, atol=ATOL, rtol=ATOL)
    for name, a, c in zip(("dh", "dw", "db"), got_g, ref_g):
        np.testing.assert_allclose(a, c, atol=ATOL, rtol=ATOL, err_msg=name)


def test_relation_agg_all_masked_rows_give_the_bias():
    h, m, w, b = _agg_case(16, 5, 32, 8, seed=3, all_masked=True)
    ref_out, out, ref_g, got_g = _agg_pair(h, m, w, b)
    np.testing.assert_allclose(out, np.broadcast_to(b, out.shape), atol=1e-6)
    np.testing.assert_allclose(out, ref_out, atol=ATOL, rtol=ATOL)
    assert not got_g[0].any()  # no neighbour, no gradient into h
    for a, c in zip(got_g, ref_g):
        np.testing.assert_allclose(a, c, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("n,f,di,do", AGG_SHAPES)
def test_relation_agg_plain_version_bf16(n, f, di, do):
    """The reference's bf16 case, for the plain version (the kernel takes
    fp32 only): bf16 rounds at other places in the two frameworks."""
    h, m, w, b = _agg_case(n, f, di, do, seed=7 * n + do)
    ref = ref_relation_agg(*(jnp.asarray(a, jnp.bfloat16) for a in (h,)), jnp.asarray(m),
                           jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                           interpret=True)
    got = relation_agg(*(torch.from_numpy(a).to(torch.bfloat16) for a in (h,)),
                       torch.from_numpy(m), torch.from_numpy(w).to(torch.bfloat16),
                       torch.from_numpy(b).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(got.float().numpy(), relation_agg_ref(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (h,)), torch.from_numpy(m),
        torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    ).float().numpy())


def test_trees_with_lists_flatten_as_jax_does():
    """tree_map/tree_leaves and the checkpoint's path keys walk lists as
    ``jax.tree_util`` does (dict keys sorted, lists in order, indices as
    path keys), so a raf bundle's global norm and checkpoint keys match."""
    r = np.random.default_rng(0)
    tree = {"parts": [{"rel": {"b@1": {"w": r.standard_normal((2, 3))}}, "etype": {}},
                      {"rel": {"a@1": {"w": r.standard_normal(4)}}}],
            "head": {"w": r.standard_normal((3, 2)), "b": r.standard_normal(2)},
            "embed": {"author": r.standard_normal((5, 2))}}
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    ours = tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)), tree)
    assert [k for k, _ in _items(ours)] == [_path_key(p) for p, _ in want]
    assert "parts/1/rel/a@1/w" in dict(_items(ours))
    for a, (_, b) in zip(tree_leaves(ours), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))
    ref_norm = float(np.sqrt(sum(np.sum(np.square(np.asarray(b, np.float32)))
                                 for _, b in want)))
    np.testing.assert_allclose(float(global_norm(ours)), ref_norm, rtol=1e-6)
    pair = tree_map(lambda a, b: a + b, ours, ours)
    assert isinstance(pair["parts"], list) and len(pair["parts"]) == 2


# --------------------------------------------------------------------------
# the dict-form model
# --------------------------------------------------------------------------


def _ref_config(model, executor="raf", placement="meta", steps=3,
                kernels=dict(interpret=True), **extra):
    return RefHetaConfig().updated(
        data=dict(dataset="ogbn-mag", scale=0.002, fanouts=(3, 2), batch_size=16),
        model=dict(model=model, hidden=32, num_heads=4),
        partition=dict(num_partitions=2, placement=placement),
        run=dict(steps=steps, seed=0, executor=executor), cache=dict(cache_mb=1),
        kernels=kernels, **extra)


def _port_config(ref_cfg) -> HetaConfig:
    d = ref_cfg.to_dict()
    d["kernels"] = {}  # the port's default: kernel ops on
    return HetaConfig.from_dict(d)


def _bundle_np(ref):
    return jax.tree_util.tree_map(np.asarray, ref.state["bundle"])


def _pair(ref_cfg, compile_ref=True):
    """A compiled reference session and a port session on the CPU holding
    the reference's initial bundle."""
    ref = RefHeta(ref_cfg)
    ref.build_graph(), ref.partition(), ref.profile_and_cache()
    port = Heta(_port_config(ref_cfg), device="cpu")
    port.build_graph(), port.partition(), port.profile_and_cache()
    if compile_ref:
        ref.compile()
        port.compile(state={"bundle": bundle_from_reference(_bundle_np(ref), "cpu")})
    return ref, port


@pytest.mark.parametrize("model", MODELS)
def test_dict_form_logits_and_gradients_match_reference(model):
    """hgnn_forward (the vanilla oracle, no kernels) and raf_forward (the
    kernels on) on the same bundle and sampled batch: logits within 2e-5,
    every bundle gradient within 1e-5."""
    ref, port = _pair(_ref_config(model))
    batch = ref._batch_for_step(0)
    rarr = ref_hgnn.batch_to_arrays(batch)
    parr = hgnn.batch_to_arrays(batch, "cpu")
    full = ref_executors._init_full_params(ref)
    full["embed"] = ref_executors._engine_embed(ref)
    rbundle = ref.state["bundle"]
    P = ref.assignment.num_partitions
    kern = KernelOptions(interpret=True)

    def ref_parts(b):
        return [{**b["parts"][p], "embed": b["embed"], "head": b["head"]} for p in range(P)]

    def port_parts(b):
        return [{**b["parts"][p], "embed": b["embed"], "head": b["head"]} for p in range(P)]

    cases = {
        "vanilla": (
            full, lambda prm: ref_hgnn.hgnn_forward(ref.hgnn_cfg, prm, ref.fixed_tables, rarr,
                                                    ref.spec),
            lambda prm: hgnn.hgnn_forward(port.hgnn_cfg, prm, port.fixed_tables, parr,
                                          port.spec)),
        "raf": (
            rbundle, lambda b: ref_raf.raf_forward(ref.hgnn_cfg, ref_parts(b), ref.fixed_tables,
                                                   rarr, ref.spec, ref.assignment, kern),
            lambda b: raf.raf_forward(port.hgnn_cfg, port_parts(b), port.fixed_tables, parr,
                                      port.spec, port.assignment, port.config.kernels)),
    }
    labels = jnp.asarray(batch.labels)
    for name, (prm, ref_fwd, port_fwd) in cases.items():
        def ref_loss(p):
            logp = jax.nn.log_softmax(ref_fwd(p), axis=-1)
            return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))

        ref_logits = np.asarray(ref_fwd(prm))
        ref_grads = jax.grad(ref_loss)(prm)
        tp = tree_map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(True),
                      jax.tree_util.tree_map(np.asarray, prm))
        logits = port_fwd(tp)
        np.testing.assert_allclose(logits.detach().numpy(), ref_logits, atol=2e-5, rtol=0,
                                   err_msg=name)
        loss = hgnn.nll_loss(logits, parr.labels)
        leaves = tree_leaves(tp)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        want = jax.tree_util.tree_leaves(ref_grads)
        assert len(want) == len(leaves)
        for (key, _), g, w in zip(_items(tp), got, want):
            g = np.zeros(np.shape(w), np.float32) if g is None else g.numpy()
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0,
                                       err_msg=f"{name} {key}")


def test_init_embed_tables_cover_the_featureless_types():
    """One learnable table per featureless node type, learnable_dim wide,
    std 0.1, each a pure function of (seed, type name)."""
    ref = RefHeta(_ref_config("rgcn"))
    g = ref.build_graph()
    cfg = hgnn.HGNNConfig(num_classes=g.num_classes)
    feat = {t: g.feat_dim(t) for t in g.num_nodes if g.feat_dim(t)}
    tables = hgnn.init_embed_tables(0, cfg, g.num_nodes, feat)
    want = ref_hgnn.init_embed_tables(jax.random.PRNGKey(0), ref.hgnn_cfg, g.num_nodes, feat)
    assert tables.keys() == want.keys() == set(g.num_nodes) - set(feat)
    for t, a in tables.items():
        assert a.shape == want[t].shape == (g.num_nodes[t], cfg.learnable_dim)
        assert a.dtype == torch.float32 and abs(float(a.std()) - 0.1) < 0.01
    again = hgnn.init_embed_tables(0, cfg, {t: g.num_nodes[t] for t in reversed(g.num_nodes)},
                                   feat)
    assert all(torch.equal(again[t], a) for t, a in tables.items())


# --------------------------------------------------------------------------
# the raf executor's sessions
# --------------------------------------------------------------------------


def _record_adam_grads(monkeypatch, module):
    """Wrap ``module.adam_update`` to log the gradient tree of every step as
    ``{path key: numpy array}``."""
    calls = []
    update = module.adam_update

    def recorded(cfg, params, grads, state, *args, **kw):
        if torch.is_tensor(tree_leaves(grads)[0]):
            calls.append({k: g.numpy() for k, g in _items(grads)})
        else:
            calls.append({_path_key(p): np.asarray(g)
                          for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]})
        return update(cfg, params, grads, state, *args, **kw)

    monkeypatch.setattr(module, "adam_update", recorded)
    return calls


def assert_bundles_match(port, ref, port_grads, ref_grads):
    """The trained bundles agree within 1e-5, gradients at every step too.
    Adam divides by sqrt(v) + eps, so an entry whose gradient lands within a
    few eps of zero turns the fp32 rounding of that gradient into an update
    difference of up to 2 * lr per step (ROADMAP.md §3): exempt from 1e-5 are
    exactly the entries whose two gradients differ at a step where either
    lies within 8 eps of zero.  Returns the exempt entries by leaf."""
    near_zero = 8 * ref.adam_cfg.eps
    assert len(port_grads) == len(ref_grads) == ref.config.run.steps
    exempt = {}
    for gp, gr in zip(port_grads, ref_grads):
        assert gp.keys() == gr.keys()
        for key in gp:
            np.testing.assert_allclose(gp[key], gr[key], atol=ATOL, rtol=0, err_msg=key)
            near = ((np.minimum(np.abs(gp[key]), np.abs(gr[key])) <= near_zero)
                    & (gp[key] != gr[key]))
            exempt[key] = exempt.get(key, False) | near
    want = dict(_items(jax.tree_util.tree_map(np.asarray, ref.state["bundle"])))
    out = {}
    for key, a in _items(port.state["bundle"]):
        diff = np.abs(a.detach().numpy() - want[key])
        ex = np.broadcast_to(exempt[key], diff.shape)
        assert diff[~ex].max(initial=0.0) <= ATOL, key
        assert diff.max() <= 2 * ref.adam_cfg.lr * ref.config.run.steps, key
        if (diff[ex] > ATOL).any():
            out[key] = int((diff[ex] > ATOL).sum())
    return out


@pytest.mark.parametrize("model", MODELS)
def test_raf_sessions_match_reference(model, monkeypatch):
    """3 steps of the raf executor from the reference's bundle, learnable
    tables training in the bundle: losses within 1e-5, gradients within 1e-5
    at every step, and every entry of the trained bundle within 1e-5 bar the
    Adam-eps exemption (see :func:`assert_bundles_match`); no learnable-table
    entry needs it."""
    from repro.optim import adam as ref_adam
    from repro_torch.optim import adam as port_adam

    ref, port = _pair(_ref_config(model))
    ref_grads = _record_adam_grads(monkeypatch, ref_adam)
    port_grads = _record_adam_grads(monkeypatch, port_adam)
    want = ref.fit()["losses"]
    got = port.fit()["losses"]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert port.results()["executor"] == "raf"
    assert isinstance(port.state["bundle"]["parts"], list)
    assert set(port.state["bundle"]["embed"]) == set(port.engine.learnable_types)
    exempted = assert_bundles_match(port, ref, port_grads, ref_grads)
    assert not any(k.startswith("embed/") for k in exempted), exempted


# --------------------------------------------------------------------------
# communication accounting
# --------------------------------------------------------------------------


@pytest.mark.parametrize("placement", ["meta", "naive"])
def test_comm_report_equals_reference(placement):
    ref, port = _pair(_ref_config("rgcn", placement=placement), compile_ref=False)
    assert port.comm_report() == ref.comm_report()
    assert port.comm_report(bytes_per_elem=4, hidden=64, include_topology=False) == \
        ref.comm_report(bytes_per_elem=4, hidden=64, include_topology=False)
    rp, pp = ref.partition(), port.partition()
    for style in ("designated", "allreduce"):
        assert pp.raf_bytes(16, 32, style=style) == rp.raf_bytes(16, 32, style=style)
        assert pp.raf_bytes(1024, 64, 4, style) == rp.raf_bytes(1024, 64, 4, style)
    rep = port.comm_report()
    assert rep["raf_meta"] <= rep["raf_naive"] and rep["raf_meta"] > 0


def test_hierarchical_comm_report_equals_reference():
    """With scale.hierarchy set the hier_* keys ride along, their gradient
    bytes those of the compiled bundle."""
    cfg = _ref_config("hgt", scale=dict(num_trainers=2, hierarchy=(2, 1)))
    ref, port = _pair(cfg)
    want, got = ref.comm_report(), port.comm_report()
    assert got == want
    assert want["hier_level0_grad"] > 0 and "hier_total_wire" in got


# --------------------------------------------------------------------------
# checkpoints of bundle state
# --------------------------------------------------------------------------


def test_raf_resume_is_bit_identical(tmp_path):
    cfg = _port_config(_ref_config("rgcn"))
    a = Heta(cfg, device="cpu")
    a.run()
    a.save(str(tmp_path))
    tail_a = [a.step() for _ in range(2)]
    b = Heta(cfg, device="cpu")
    assert b.restore(str(tmp_path)) == 3
    tail_b = [b.step() for _ in range(2)]
    assert tail_a == tail_b
    for (ka, va), (kb, vb) in zip(_items(a.state), _items(b.state)):
        assert ka == kb and torch.equal(va, vb), ka


def test_reference_raf_checkpoint_restores_into_port(tmp_path):
    # default kernel sections on both sides, so the config fingerprints agree
    cfg = _ref_config("rgcn", kernels={})
    ref = RefHeta(cfg)
    ref.run()
    ref.save(str(tmp_path))
    want = [ref.step() for _ in range(2)]
    port = Heta(HetaConfig.from_dict(cfg.to_dict()), device="cpu")
    assert port.config_fingerprint() == ref.config_fingerprint()
    assert port.restore(str(tmp_path)) == 3
    assert "parts" in port.state["bundle"]
    got = [port.step() for _ in range(2)]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# --------------------------------------------------------------------------
# registry, CLI, serve executor
# --------------------------------------------------------------------------


def test_executor_registry_equals_reference():
    assert set(executors.available()) == set(ref_executors.available())
    assert executors.available() == ("raf", "raf_spmd", "serve", "vanilla")
    with pytest.raises(KeyError, match="available"):
        executors.get("bogus")


def test_train_cli_runs_the_raf_executor_on_the_cpu(capsys):
    from repro_torch.launch import train

    metrics = train.main(["--device", "cpu", "--executor", "raf", "--scale", "0.002",
                          "--steps", "2"])
    assert metrics["executor"] == "raf" and len(metrics["losses"]) == 2
    assert np.isfinite(metrics["losses"]).all()
    assert "final loss" in capsys.readouterr().out


def test_serve_executor_answers_after_infer_all():
    from repro_torch.serve import bounded_graph

    sess = Heta(_port_config(_ref_config("rgcn", executor="raf_spmd", steps=2)), device="cpu")
    sess.build_graph(bounded_graph(sess.build_graph(), 8))  # in-degree <= 8: a quick infer_all
    sess.partition(), sess.profile_and_cache()
    with pytest.raises(HetaStageError, match="infer_all"):
        sess.compile(executor="serve")
    sess.compile(executor="raf_spmd")
    sess.fit()
    sess.infer_all()
    sess.compile(executor="serve")
    batch = sess._batch_for_step(0)
    loss, metrics = sess.executor.loss_and_metrics(sess, sess.plan, sess.state, batch)
    assert np.isfinite(loss) and metrics["latency_ms"] >= 0 and "hit_rates" in metrics
    with pytest.raises(HetaStageError, match="inference-only"):
        sess.step()
    ev = sess.evaluate(num_batches=1)
    assert np.isfinite(ev["loss"])
    sess.close_serving()
    dense = Heta(_port_config(_ref_config("rgcn", executor="vanilla", steps=1)), device="cpu")
    dense.run()
    with pytest.raises(HetaStageError, match="raf_spmd"):
        dense.infer_all()
