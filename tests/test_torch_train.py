"""The training slice of the PyTorch/CUDA port against the JAX reference.

Reference sessions run R-GCN at the default width (hidden 64, learnable_dim
64, 2 layers) on ogbn-mag at scale 0.002 with batch 8 and fanouts (3, 2),
once with kernels off and once with the Pallas kernels in interpret mode.
Their initial parameter stacks go through ``repro_torch.convert`` into a
port session on the CPU (its plain PyTorch path through the same autograd
``Function`` the card runs).  Tolerances are the ROADMAP's: stack
gradients and 3-step losses within atol 1e-5, logits within 2e-5 — the
port sums in PyTorch's order, not XLA's.
"""

import os

import numpy as np
import pytest
import torch

from repro.api import CacheConfig as RefCacheConfig
from repro.api import DataConfig as RefDataConfig
from repro.api import Heta as RefHeta
from repro.api import HetaConfig as RefHetaConfig
from repro.api import KernelConfig as RefKernelConfig
from repro.api import ModelConfig as RefModelConfig
from repro.api import PartitionConfig as RefPartitionConfig
from repro.api import RunConfig as RefRunConfig
from repro.core import raf_spmd as ref_spmd
from repro.optim import adam as ref_adam
from repro.serve.full_graph import spmd_logits_for_batch
from repro_torch.api import Heta, HetaConfig, NoGPUError
from repro_torch.checkpoint import (
    CheckpointError,
    latest_step,
    load_checkpoint,
    read_manifest,
    save_checkpoint,
)
from repro_torch.convert import stacks_from_reference
from repro_torch.core import raf_spmd
from repro_torch.optim import adam

ATOL = 1e-5
REF_KERNELS = {
    "kernels_off": RefKernelConfig(enabled=False),
    "interpret": RefKernelConfig(interpret=True),
}


def _ref_config(kernels, learnable=True, cache_mb=1, steps=3, placement="meta"):
    return RefHetaConfig(
        data=RefDataConfig(dataset="ogbn-mag", scale=0.002, fanouts=(3, 2), batch_size=8),
        model=RefModelConfig(train_learnable=learnable),
        partition=RefPartitionConfig(placement=placement),
        run=RefRunConfig(steps=steps, seed=0),
        cache=RefCacheConfig(cache_mb=cache_mb),
        kernels=kernels,
    )


def _port_config(ref_cfg, kernels=None) -> HetaConfig:
    d = ref_cfg.to_dict()
    d["kernels"] = {} if kernels is None else kernels  # default: kernel ops on
    return HetaConfig.from_dict(d)


def _stacks_np(ref):
    return {layer: {leaf: np.asarray(v) for leaf, v in entry.items()}
            for layer, entry in ref.state["stacks"].items()}


def _pair(ref_cfg):
    """A compiled reference session and a compiled port session on the CPU
    holding the reference's initial parameter stacks (taken before any
    step: the reference's jitted step donates its buffers)."""
    ref = RefHeta(ref_cfg)
    ref.build_graph(), ref.partition(), ref.profile_and_cache(), ref.compile()
    port = Heta(_port_config(ref_cfg), device="cpu")
    port.build_graph(), port.partition(), port.profile_and_cache()
    port.compile(state={"stacks": stacks_from_reference(_stacks_np(ref), "cpu")})
    return ref, port


def _counters(sess):
    return {t: (c.hits, c.misses) for t, c in sess.engine.cache.caches.items()}


def _record_row_grads(engine):
    """Wrap ``engine.apply_row_grads`` on this instance to log every call as
    (type, unique ids, per-row summed gradient), the rows sparse Adam sees."""
    calls = []
    apply = engine.apply_row_grads

    def recorded(ntype, nids, grads):
        nids = np.asarray(nids)
        uniq, inv = np.unique(nids, return_inverse=True)
        g = np.zeros((len(uniq), grads.shape[-1]), np.float32)
        np.add.at(g, inv, np.asarray(grads, np.float32).reshape(len(nids), -1))
        calls.append((ntype, uniq, g))
        return apply(ntype, nids, grads)

    engine.apply_row_grads = recorded
    return calls


# --------------------------------------------------------------------------
# (e) Adam from its formulas
# --------------------------------------------------------------------------


def _trees(seed):
    r = np.random.default_rng(seed)
    params = {"layer1": {"w": r.standard_normal((2, 3, 5, 4)), "b": r.standard_normal((2, 3, 4))},
              "head": {"w": r.standard_normal((4, 6)), "b": r.standard_normal(6)}}
    params = {k: {l: v.astype(np.float32) for l, v in e.items()} for k, e in params.items()}
    grads = [{k: {l: (r.standard_normal(v.shape) * 0.3).astype(np.float32)
                  for l, v in e.items()} for k, e in params.items()} for _ in range(3)]
    return params, grads


def _to_torch(tree):
    return adam.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("grad_clip,weight_decay", [(0.0, 0.0), (0.5, 0.0), (0.0, 0.01),
                                                    (0.05, 0.1)])
def test_adam_update_matches_reference(grad_clip, weight_decay):
    import jax
    import jax.numpy as jnp

    params, grads = _trees(int(grad_clip * 100 + weight_decay * 1000))
    rcfg = ref_adam.AdamConfig(lr=5e-3, grad_clip=grad_clip, weight_decay=weight_decay)
    pcfg = adam.AdamConfig(lr=5e-3, grad_clip=grad_clip, weight_decay=weight_decay)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_adam.adam_init(rp)
    pp = _to_torch(params)
    ps = adam.adam_init(pp)
    for g in grads:
        rp, rs = ref_adam.adam_update(rcfg, rp, jax.tree.map(jnp.asarray, g), rs)
        pp, ps = adam.adam_update(pcfg, pp, _to_torch(g), ps)
    assert int(ps["step"]) == int(rs["step"]) == 3 and ps["step"].dtype == torch.int32
    for name, a, b in (("params", pp, rp), ("m", ps["m"], rs["m"]), ("v", ps["v"], rs["v"])):
        for x, y in zip(adam.tree_leaves(a), jax.tree.leaves(b)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-7, rtol=1e-6,
                                       err_msg=name)
    np.testing.assert_allclose(float(adam.global_norm(_to_torch(grads[0]))),
                               float(ref_adam.global_norm(jax.tree.map(jnp.asarray, grads[0]))),
                               rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 7])
def test_sparse_adam_rows_matches_reference(step):
    import jax.numpy as jnp

    r = np.random.default_rng(step)
    rows, g = (r.standard_normal((9, 5)).astype(np.float32) for _ in range(2))
    m = (r.standard_normal((9, 5)) * 0.1).astype(np.float32)
    v = np.abs(r.standard_normal((9, 5)) * 0.01).astype(np.float32)
    want = ref_adam.sparse_adam_rows(ref_adam.AdamConfig(lr=5e-3), *(jnp.asarray(a) for a in
                                                                    (rows, g, m, v)),
                                     jnp.asarray(step))
    got = adam.sparse_adam_rows(adam.AdamConfig(lr=5e-3),
                                *(torch.from_numpy(a) for a in (rows, g, m, v)), step)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)


# --------------------------------------------------------------------------
# (c) stack gradients and logits against make_grad_step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("placement,ref_kernels", [
    ("meta", "kernels_off"), ("meta", "interpret"), ("naive", "kernels_off")])
def test_stack_gradients_and_logits_match_reference(placement, ref_kernels):
    import jax

    ref, port = _pair(_ref_config(REF_KERNELS[ref_kernels], placement=placement))
    local = placement == "meta"
    batch = ref._batch_for_step(0)
    tables = ref.engine.tables_snapshot()
    arrays = ref.executor.stage(ref, ref.plan, batch)
    grad = ref_spmd.make_grad_step(ref.plan.plan, ref.plan.mesh, local_combine=local,
                                   kernels=ref.config.kernels)
    loss, grads = grad(ref.state["stacks"], arrays)
    # the feature gradients the reference's learnable step routes to the cache
    loss_fn, split = ref_spmd._build_loss_fn(ref.plan.plan, ref.plan.mesh, "model",
                                             ("data",), local, ref.config.kernels)
    feats, rest = split(arrays)
    _, (_, gf) = jax.value_and_grad(loss_fn, argnums=(0, 1))(ref.state["stacks"], feats, rest)

    p_arrays = port.executor.stage(port, port.plan, port._batch_for_step(0))
    p_loss, p_grads, p_gf = raf_spmd.grad_step(
        port.plan.plan, port.state["stacks"], p_arrays, local_combine=local,
        kernels=port.config.kernels, learn_feats=True)
    assert abs(float(p_loss) - float(loss)) <= ATOL
    assert p_grads.keys() == grads.keys()
    for layer, entry in grads.items():
        assert p_grads[layer].keys() == entry.keys()
        for leaf, g in entry.items():
            np.testing.assert_allclose(p_grads[layer][leaf].numpy(), np.asarray(g), atol=ATOL,
                                       rtol=0, err_msg=f"{layer}/{leaf}")
    assert p_gf.keys() == gf.keys() == {"hfeat2", "qfeat1", "qfeat2"}
    for key, g in gf.items():
        np.testing.assert_allclose(p_gf[key].numpy(), np.asarray(g), atol=ATOL, rtol=0,
                                   err_msg=key)
    assert not p_gf["qfeat1"].any()  # R-GCN reads no qfeat: zeros, as JAX returns

    if ref.plan.plan.num_shards == 1:
        want = spmd_logits_for_batch(ref.plan.plan, ref.state["stacks"], batch, tables,
                                     kernels=ref.config.kernels)
        with torch.no_grad():
            got = raf_spmd.raf_spmd_logits(port.plan.plan, port.state["stacks"], p_arrays,
                                           local_combine=local, kernels=port.config.kernels)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("placement", ["meta", "naive"])
def test_sharded_forward_matches_one_shard(placement):
    """Two shards on one device (the shard loop, the root-partial sum and,
    for naive placement, the global-parent exchange) give the one-shard
    loss and logits."""
    out = []
    for shards in (1, 2):
        sess = Heta(HetaConfig().updated(
            data=dict(scale=0.002, fanouts=(3, 2), batch_size=8),
            partition=dict(placement=placement), run=dict(mesh_shape=(1, shards))),
            device="cpu")
        sess.build_graph(), sess.partition(), sess.profile_and_cache(), sess.compile()
        assert sess.plan.plan.num_shards == shards
        arrays = sess.executor.stage(sess, sess.plan, sess._batch_for_step(0))
        with torch.no_grad():
            out.append(raf_spmd.raf_spmd_logits(
                sess.plan.plan, sess.state["stacks"], arrays,
                local_combine=sess.plan.local_combine).numpy())
    np.testing.assert_allclose(out[1], out[0], atol=2e-5, rtol=0)


# --------------------------------------------------------------------------
# (d) three-step fit against the reference session
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ref_kernels", sorted(REF_KERNELS))
@pytest.mark.parametrize("learnable", [False, True], ids=["frozen", "learnable"])
def test_fit_matches_reference(learnable, ref_kernels):
    ref, port = _pair(_ref_config(REF_KERNELS[ref_kernels], learnable=learnable, cache_mb=1))
    assert port.plan.learn_feats == ref.plan.learn_feats == learnable
    ref_calls, port_calls = _record_row_grads(ref.engine), _record_row_grads(port.engine)
    want, got = ref.fit(), port.fit()
    assert len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["losses"], atol=ATOL, rtol=0)
    # the sparse path: the same Adam steps per table (R-GCN's zero-gradient
    # qfeat steps included) and the same cache hits and misses
    assert port.engine.steps == ref.engine.steps
    assert _counters(port) == _counters(ref)
    assert got["hit_rates"] == want["hit_rates"]
    if not learnable:
        assert all(s == 0 for s in port.engine.steps.values())
        return
    assert all(port.engine.steps[t] > 0 for t in port.engine.learnable_types)
    # Adam divides by sqrt(v) + eps: an entry whose gradient lands within a
    # few eps of zero turns the fp32 rounding of that gradient into an update
    # difference of up to 2 * lr per step.  Exempt from 1e-5 are exactly the
    # entries whose two gradients differ at a step where either lies within
    # near_zero of zero; every other entry is held to 1e-5.
    eps = ref.engine.adam.eps
    near_zero = 8 * eps
    assert [(t, ids.tolist()) for t, ids, _ in port_calls] == \
        [(t, ids.tolist()) for t, ids, _ in ref_calls]
    exempt = {t: np.zeros_like(a, dtype=bool) for t, a in port.engine.tables_snapshot().items()}
    for (t, ids, g_port), (_, _, g_ref) in zip(port_calls, ref_calls):
        np.testing.assert_allclose(g_port, g_ref, atol=ATOL, rtol=0, err_msg=t)
        exempt[t][ids] |= ((np.minimum(np.abs(g_port), np.abs(g_ref)) <= near_zero)
                           & (g_port != g_ref))
    got_t, want_t = port.engine.tables_snapshot(), ref.engine.tables_snapshot()
    for t in port.engine.learnable_types:
        diff = np.abs(got_t[t] - want_t[t])
        assert diff[~exempt[t]].max() <= ATOL, t
        assert diff.max() <= 2 * ref.adam_cfg.lr * ref.config.run.steps, t


def test_engine_row_update_matches_reference():
    """Fed the same row gradients, the port's cache engine (fetch_states,
    sparse Adam, write_learnable, hit and miss rows) moves every learnable
    row, moment and counter as the reference's does."""
    ref, port = _pair(_ref_config(REF_KERNELS["kernels_off"], cache_mb=1))
    r = np.random.default_rng(3)
    for _ in range(3):
        for t in sorted(port.engine.learnable_types):
            ids = r.integers(0, port.graph.num_nodes[t], 40)  # duplicates included
            g = (r.standard_normal((40, 64)) * 0.01).astype(np.float32)
            ref.engine.apply_row_grads(t, ids, g)
            port.engine.apply_row_grads(t, ids, g)
    assert port.engine.steps == ref.engine.steps
    assert _counters(port) == _counters(ref)
    got, want = port.engine.state_snapshot(), ref.engine.state_snapshot()
    for key in ("tables", "m", "v"):
        for t in port.engine.learnable_types:
            np.testing.assert_allclose(got[key][t], want[key][t], atol=ATOL, rtol=0,
                                       err_msg=f"{key}/{t}")
    assert port.engine.adam.lr == ref.engine.adam.lr == ref.config.run.lr


# --------------------------------------------------------------------------
# (f) checkpoints
# --------------------------------------------------------------------------


def test_reference_checkpoint_restores_into_port(tmp_path):
    cfg = _ref_config(RefKernelConfig(), steps=3)  # same config dict on both sides
    ref = RefHeta(cfg)
    ref.run()
    ref.save(str(tmp_path))
    saved_steps = dict(ref.engine.steps)
    want = [ref.step() for _ in range(2)]
    port = Heta(HetaConfig.from_dict(cfg.to_dict()), device="cpu")
    assert port.config_fingerprint() == ref.config_fingerprint()
    assert port.restore(str(tmp_path)) == 3
    assert port.engine.steps == saved_steps
    got = [port.step() for _ in range(2)]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _port_session(**run):
    cfg = HetaConfig().updated(data=dict(scale=0.002, fanouts=(3, 2), batch_size=8),
                               cache=dict(cache_mb=1), run=dict(steps=3, **run))
    return Heta(cfg, device="cpu")


def test_port_resume_is_bit_identical(tmp_path):
    a = _port_session()
    a.run()
    path = a.save(str(tmp_path))
    assert path.endswith("ckpt_00000003.npz") and latest_step(str(tmp_path)) == 3
    manifest = read_manifest(str(tmp_path), 3)
    assert "state/opt/step" in manifest["keys"] and "embed/steps/author" in manifest["keys"]
    assert manifest["dtypes"]["state/opt/step"] == "int32"
    tail_a = [a.step() for _ in range(2)]  # the uninterrupted run, steps 3-4
    b = _port_session()
    assert b.restore(str(tmp_path)) == 3
    tail_b = [b.step() for _ in range(2)]
    assert tail_a == tail_b
    for layer, entry in a.state["stacks"].items():
        for leaf, v in entry.items():
            assert torch.equal(b.state["stacks"][layer][leaf], v)
    ta, tb = a.engine.tables_snapshot(), b.engine.tables_snapshot()
    for t in ta:
        np.testing.assert_array_equal(ta[t], tb[t])
    assert a.engine.steps == b.engine.steps


def test_periodic_checkpoints_prune_and_fingerprint(tmp_path):
    d = str(tmp_path)
    sess = _port_session()
    sess.config = sess.config.updated(checkpoint=dict(every_steps=1, dir=d, keep=2))
    sess.run()
    steps = sorted(int(f[5:13]) for f in os.listdir(d) if f.endswith(".npz"))
    assert steps == [2, 3]
    other = Heta(sess.config.updated(run=dict(lr=1e-3)), device="cpu")
    with pytest.raises(CheckpointError, match="different HetaConfig"):
        other.restore(d)
    with pytest.raises(CheckpointError, match="no committed checkpoint"):
        _port_session().restore(str(tmp_path / "empty"))


def test_checkpoint_files_refuse_corruption(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"ids": np.arange(4, dtype=np.int64), "step": torch.zeros((), dtype=torch.int32)}}
    save_checkpoint(d, 1, tree, extra={"seed": 0})
    got = load_checkpoint(d, 1, {"w": torch.zeros(2, 3), "nested": {
        "ids": np.zeros(4, np.int64), "step": torch.ones((), dtype=torch.int32)}})
    assert torch.equal(got["w"], tree["w"]) and got["nested"]["step"].dtype == torch.int32
    np.testing.assert_array_equal(got["nested"]["ids"], tree["nested"]["ids"])
    with pytest.raises(CheckpointError, match="key mismatch"):
        load_checkpoint(d, 1, {"w": torch.zeros(2, 3)})
    open(d + "/ckpt_00000002.npz", "wb").close()  # payload without a manifest
    assert latest_step(d) == 1
    # a payload whose bytes no longer match the manifest's hashes
    with open(d + "/ckpt_00000001.npz", "wb") as f:
        np.savez(f, **{"w": np.ones((2, 3), np.float32), "nested/ids": np.arange(4),
                       "nested/step": np.zeros((), np.int32)})
    with pytest.raises(CheckpointError, match="sha256"):
        load_checkpoint(d, 1, tree)


# --------------------------------------------------------------------------
# (g) the CLI, (h) the named errors
# --------------------------------------------------------------------------


def test_train_cli_runs_on_the_cpu_and_refuses_without_a_gpu(monkeypatch, capsys):
    from repro_torch.launch import train

    metrics = train.main(["--device", "cpu", "--scale", "0.002", "--steps", "2"])
    assert len(metrics["losses"]) == 2 and np.isfinite(metrics["losses"]).all()
    assert "final loss" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoGPUError):
        train.main(["--scale", "0.002", "--steps", "2"])


def test_later_slices_raise_named_errors():
    """Every executor the reference registers compiles (an unknown name
    raises the named KeyError listing them); the data-parallel tier, a
    later slice, raises a named NotImplementedError, while the host
    pipeline (ported) trains and evaluates."""
    sess = _port_session()
    sess.build_graph(), sess.partition(), sess.profile_and_cache()
    with pytest.raises(KeyError, match="available: \\('raf', 'raf_spmd', 'serve', 'vanilla'\\)"):
        sess.compile(executor="bogus")
    sess.compile(executor="vanilla")
    assert sess.executor.name == "vanilla" and "bundle" in sess.state
    sess.compile()
    sess.config = sess.config.updated(scale=dict(num_trainers=2))
    with pytest.raises(NotImplementedError, match="scale.enabled"):
        sess.fit()
    with pytest.raises(NotImplementedError, match="scale.enabled"):
        sess.evaluate()
    sess.config = _port_session().config
    res = sess.fit(2)
    assert len(res["losses"]) == 2 and res["step_time_s"] > 0
    ev = sess.evaluate(num_batches=2)
    assert ev["num_batches"] == 2 and np.isfinite(ev["loss"])
    sess.config = sess.config.updated(pipeline=dict(enabled=True))
    res = sess.fit(1)
    assert res["pipeline"] and len(res["losses"]) == 3
    assert np.isfinite(sess.evaluate()["loss"])
