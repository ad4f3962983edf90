"""R-GAT and HGT sessions of the PyTorch/CUDA port against the JAX reference.

Reference sessions run each attention model at hidden 32, 4 heads, on
ogbn-mag at scale 0.002 with 2 partitions, fanouts (3, 2) and batch 16, with
kernels off (the gather-then-vmap oracle; ``tests/test_torch_attention.py``
holds the fused Pallas path against it).  Their initial parameter stacks go
through ``repro_torch.convert`` into a port session on the CPU, which runs
the fused path's plain PyTorch versions through the same autograd
``Function`` the card runs.  Tolerances are the ROADMAP's: stack gradients
and 3-step losses within atol 1e-5, logits within 2e-5, ``infer_all``
embeddings within atol/rtol 1e-5 — the port sums in PyTorch's order, not
XLA's.
"""

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
from repro.serve import full_graph as ref_fg
from repro.serve.full_graph import spmd_logits_for_batch
from repro_torch.api import Heta, HetaConfig, KernelConfig
from repro_torch.convert import stacks_from_reference, tables_from_reference
from repro_torch.core import raf_spmd
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kops
from repro_torch.kernels.stacked_relation_agg import ops as sra
from repro_torch.serve import full_graph as fg

ATOL = 1e-5
MODELS = ("rgat", "hgt")


def _ref_config(model, learnable=True, steps=3, kernels=None):
    return RefHetaConfig(
        data=RefDataConfig(dataset="ogbn-mag", scale=0.002, fanouts=(3, 2), batch_size=16),
        model=RefModelConfig(model=model, hidden=32, num_heads=4, train_learnable=learnable),
        partition=RefPartitionConfig(num_partitions=2),
        run=RefRunConfig(steps=steps, seed=0),
        cache=RefCacheConfig(cache_mb=1),
        kernels=RefKernelConfig(enabled=False) if kernels is None else kernels,
    )


def _port_config(ref_cfg) -> HetaConfig:
    d = ref_cfg.to_dict()
    d["kernels"] = {}  # the port's default: kernel ops on, fused epilogue
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
    stacks = _stacks_np(ref)
    port.compile(state={"stacks": stacks_from_reference(stacks, "cpu")})
    return ref, port, stacks


@pytest.mark.parametrize("model", MODELS)
def test_attention_stacks_carry_over_from_reference(model):
    """``stacks_from_reference`` carries every rgat/hgt leaf (the
    destination-typed ``w_dst``/``wq`` padded to d_pad included) bit for
    bit, and the port's own init gives the same tree of shapes."""
    ref, port, stacks = _pair(_ref_config(model))
    leaves = {"rgat": {"w", "w_dst", "a_src", "a_dst", "b"},
              "hgt": {"wk", "wv", "wq", "w_att", "w_msg"}}[model]
    own = Heta(_port_config(ref.config), device="cpu")
    own.build_graph(), own.partition(), own.profile_and_cache(), own.compile()
    assert port.state["stacks"].keys() == stacks.keys() == own.state["stacks"].keys()
    for layer, entry in stacks.items():
        if layer != "head":
            assert set(entry) == leaves
        for leaf, v in entry.items():
            got = port.state["stacks"][layer][leaf]
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), v)
            assert own.state["stacks"][layer][leaf].shape == got.shape


@pytest.mark.parametrize("model", MODELS)
def test_attention_stack_gradients_and_logits_match_reference(model):
    import jax

    ref, port, _ = _pair(_ref_config(model))
    batch = ref._batch_for_step(0)
    tables = ref.engine.tables_snapshot()
    arrays = ref.executor.stage(ref, ref.plan, batch)
    # the raw stack gradients (make_grad_step's) and the feature gradients
    # the reference's learnable step routes to the cache, in one pass
    loss_fn, split = ref_spmd._build_loss_fn(ref.plan.plan, ref.plan.mesh, "model",
                                             ("data",), True, ref.config.kernels)
    feats, rest = split(arrays)
    loss, (grads, gf) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        ref.state["stacks"], feats, rest)

    p_arrays = port.executor.stage(port, port.plan, port._batch_for_step(0))
    p_loss, p_grads, p_gf = raf_spmd.grad_step(
        port.plan.plan, port.state["stacks"], p_arrays, local_combine=True,
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
    # the attention models read their destinations' features: the q side's
    # gradient is real, unlike R-GCN's zeros
    assert p_gf["qfeat1"].abs().max() > 0 and p_gf["qfeat2"].abs().max() > 0

    assert ref.plan.plan.num_shards == 1
    want = spmd_logits_for_batch(ref.plan.plan, ref.state["stacks"], batch, tables,
                                 kernels=ref.config.kernels)
    with torch.no_grad():
        got = raf_spmd.raf_spmd_logits(port.plan.plan, port.state["stacks"], p_arrays,
                                       kernels=port.config.kernels)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


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


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("learnable", [False, True], ids=["frozen", "learnable"])
def test_attention_fit_matches_reference(model, learnable):
    ref, port, _ = _pair(_ref_config(model, learnable=learnable))
    assert port.plan.learn_feats == ref.plan.learn_feats == learnable
    ref_calls, port_calls = _record_row_grads(ref.engine), _record_row_grads(port.engine)
    want, got = ref.fit(), port.fit()
    assert len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["losses"], atol=ATOL, rtol=0)
    assert port.engine.steps == ref.engine.steps
    assert got["hit_rates"] == want["hit_rates"]
    if not learnable:
        assert all(s == 0 for s in port.engine.steps.values())
        return
    assert all(port.engine.steps[t] > 0 for t in port.engine.learnable_types)
    # the row gradients sparse Adam sees, then the rows it wrote: every entry
    # within 1e-5 (no entry here needs ROADMAP §3's Adam-eps exemption)
    assert [(t, ids.tolist()) for t, ids, _ in port_calls] == \
        [(t, ids.tolist()) for t, ids, _ in ref_calls]
    for (t, ids, g_port), (_, _, g_ref) in zip(port_calls, ref_calls):
        np.testing.assert_allclose(g_port, g_ref, atol=ATOL, rtol=0, err_msg=t)
    got_t, want_t = port.engine.tables_snapshot(), ref.engine.tables_snapshot()
    for t in port.engine.learnable_types:
        np.testing.assert_allclose(got_t[t], want_t[t], atol=ATOL, rtol=0, err_msg=t)


@pytest.mark.parametrize("model", MODELS)
def test_attention_infer_all_matches_reference(model):
    """Layer-wise inference over every node (in-degree capped at 8, so a
    group's fanout stays small) at the reference's initial weights."""
    ref_cfg = _ref_config(model)
    ref = RefHeta(ref_cfg)
    g_ref = ref_fg.bounded_graph(ref.build_graph(), 8)
    ref.build_graph(g_ref), ref.partition(), ref.profile_and_cache(), ref.compile()
    port = Heta(_port_config(ref_cfg), device="cpu")
    g = fg.bounded_graph(port.build_graph(), 8)
    port.build_graph(g), port.partition(), port.profile_and_cache()
    port.compile(state={"stacks": stacks_from_reference(_stacks_np(ref), "cpu")})
    ref_tables = ref.engine.tables_snapshot()
    want = ref_fg.infer_all(g_ref, ref.plan.plan, ref.state["stacks"], ref_tables,
                            node_block=256, kernels=ref.config.kernels)
    kops.reset_launch_counts()
    got = fg.infer_all(g, port.plan.plan, port.state["stacks"],
                       tables_from_reference(ref_tables), node_block=256,
                       kernels=port.config.kernels, device="cpu")
    assert all(info.launches == 0 for info in kops.KERNELS.values())  # the CPU runs plain
    assert set(got.embeddings) == set(want.embeddings) and got.layer_of == want.layer_of
    for t, a in want.embeddings.items():
        assert got.embeddings[t].shape == a.shape
        np.testing.assert_allclose(got.embeddings[t], a, atol=ATOL, rtol=ATOL, err_msg=t)
    ids = np.arange(g.num_nodes[g.target_type])
    np.testing.assert_allclose(got.scores(ids), want.scores(ids), atol=ATOL, rtol=ATOL)


def test_reference_rgat_checkpoint_restores_into_port(tmp_path):
    cfg = _ref_config("rgat", kernels=RefKernelConfig())
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


def test_attention_clis_run_on_the_cpu(capsys):
    from repro_torch.launch import serve, train

    metrics = train.main(["--device", "cpu", "--model", "hgt", "--scale", "0.002",
                          "--steps", "2", "--batch-size", "16"])
    assert len(metrics["losses"]) == 2 and np.isfinite(metrics["losses"]).all()
    assert "final loss" in capsys.readouterr().out
    serve.main(["--device", "cpu", "--model", "rgat", "--scale", "0.002", "--steps", "2",
                "--requests", "16", "--max-degree", "8"])
    out = capsys.readouterr().out
    assert "infer_all:" in out and "served 16 requests" in out


def test_unfused_attention_raises_on_cuda_tensors(monkeypatch):
    """``fuse_epilogue=False`` runs the attn_parts path: plain PyTorch on the
    CPU, the same logits as the fused path; and on CUDA tensors it reaches
    kernel 3's launch (``stacked_softmax_combine``) once per level, never
    its plain version and no NotImplementedError.  The CUDA-tensor check is
    patched here, as no card is present, and the launch is a stand-in that
    fills the output from the plain version of the operands."""
    sess = Heta(HetaConfig().updated(
        model=dict(model="rgat", hidden=32), data=dict(scale=0.002, fanouts=(3, 2),
                                                       batch_size=16),
        kernels=dict(fuse_epilogue=False), run=dict(steps=1)), device="cpu")
    sess.build_graph(), sess.partition(), sess.profile_and_cache(), sess.compile()
    fused = Heta(sess.config.updated(kernels=dict(fuse_epilogue=True)), device="cpu")
    fused.build_graph(), fused.partition(), fused.profile_and_cache(), fused.compile()
    arrays = sess.executor.stage(sess, sess.plan, sess._batch_for_step(0))
    with torch.no_grad():
        plain = raf_spmd.raf_spmd_logits(sess.plan.plan, sess.state["stacks"], arrays,
                                         kernels=sess.config.kernels)
        want = raf_spmd.raf_spmd_logits(fused.plan.plan, fused.state["stacks"], arrays,
                                         kernels=fused.config.kernels)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), atol=2e-5, rtol=0)
    ref_version = sra.stacked_softmax_combine_ref
    launched = []

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA-routed call")

    def fake_launch(e, mask_u8, v, out, rows, depth):  # 0, 0: the kernel's own rule
        launched.append(tuple(v.shape))
        out.copy_(ref_version(e, mask_u8.bool(), v))

    monkeypatch.setattr(sra, "_is_cuda", lambda t: True)
    monkeypatch.setattr(sra, "stacked_softmax_combine_ref", refuse)
    monkeypatch.setattr(sra, "launch_softmax_combine", fake_launch)
    monkeypatch.setattr(sra, "softmax_combine_layout", lambda nh, dh, rows, depth:
                        autotune.softmax_combine_choose(nh, dh, rows, depth)[:2])
    kops.reset_launch_counts()
    sess.fit(1)
    assert np.isfinite(sess.losses[-1])
    assert len(launched) == 2 == kops.KERNELS["stacked_softmax_combine"].launches
    assert kops.KERNELS["stacked_attn_epilogue"].launches == 0
