"""Kernel 3 (the masked softmax + combine) and the unfused attention path of
the PyTorch/CUDA port against the JAX reference, and the ``vanilla``
executor's sessions.

The op ``stacked_softmax_combine`` is held against the reference's Pallas
kernel in interpret mode at the reference's own cases
(``tests/test_stacked_kernels.py``), row 0 fully masked.  Sessions run
ogbn-mag at scale 0.002 with 2 partitions, fanouts (3, 2), batch 16 and
hidden 32; the reference's initial parameters go through
``repro_torch.convert`` into port sessions on the CPU, which run the
kernels' plain versions through the same autograd ``Function``s the card
runs.  Tolerances are the reference's: kernel 3 forward within 1e-6 and its
gradients within 1e-5, 3-step losses and ``infer_all`` embeddings within
1e-5.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Heta as RefHeta
from repro.api import HetaConfig as RefHetaConfig
from repro.kernels.stacked_relation_agg import stacked_softmax_combine as ref_combine
from repro_torch.api import Heta, HetaConfig
from repro_torch.convert import bundle_from_reference, stacks_from_reference
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kops
from repro_torch.kernels.stacked_relation_agg import ops as sra
from repro_torch.kernels.stacked_relation_agg import stacked_softmax_combine
from repro_torch.serve import bounded_graph

ATOL = 1e-5
MODELS = ("rgcn", "rgat", "hgt")


# --------------------------------------------------------------------------
# kernel 3's op: plain version + closed-form backward
# --------------------------------------------------------------------------


def _combine_case(rb, n, f, nh, dh, seed):
    r = np.random.default_rng(seed)
    e = r.standard_normal((rb, n, f, nh)).astype(np.float32)
    v = r.standard_normal((rb, n, f, nh, dh)).astype(np.float32)
    mask = r.random((rb, n, f)) > 0.3
    mask[0, 0, :] = False  # a fully masked row gives zeros, not NaN
    return e, mask, v


@pytest.mark.parametrize("rb,n,f,nh,dh", [(3, 21, 4, 2, 5), (1, 1, 1, 1, 1), (5, 130, 3, 4, 16),
                                           (2, 9, 1000, 4, 16), (3, 21, 4, 2, 6),
                                           (2, 33, 3, 8, 40)])
def test_stacked_softmax_combine_matches_reference(rb, n, f, nh, dh):
    """Forward within 1e-6 of the reference's Pallas kernel; the gradients
    into e and v within 1e-5 of its custom VJP.  Both backwards take the
    same cotangent (``2 * out`` of the reference's forward, the
    sum-of-squares loss), so the check is of the closed form alone."""
    e, mask, v = _combine_case(rb, n, f, nh, dh, seed=n)
    ref_out, vjp = jax.vjp(lambda e_, v_: ref_combine(e_, jnp.asarray(mask), v_, interpret=True),
                           jnp.asarray(e), jnp.asarray(v))
    ref_de, ref_dv = vjp(2 * ref_out)
    te, tv = (torch.from_numpy(a).requires_grad_(True) for a in (e, v))
    out = stacked_softmax_combine(te, torch.from_numpy(mask), tv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-6, rtol=1e-6)
    assert not out[0, 0].any() and torch.isfinite(out).all()
    de, dv = torch.autograd.grad(out, (te, tv), torch.from_numpy(2 * np.asarray(ref_out)))
    np.testing.assert_allclose(de.numpy(), np.asarray(ref_de), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(ref_dv), atol=ATOL, rtol=ATOL)


# --------------------------------------------------------------------------
# sessions
# --------------------------------------------------------------------------


def _ref_config(model, executor, steps=3, **kernels):
    return RefHetaConfig().updated(
        data=dict(dataset="ogbn-mag", scale=0.002, fanouts=(3, 2), batch_size=16),
        model=dict(model=model, hidden=32, num_heads=4),
        partition=dict(num_partitions=2),
        run=dict(steps=steps, seed=0, executor=executor), cache=dict(cache_mb=1),
        kernels=dict(interpret=True, **kernels))


def _port_config(ref_cfg, **kernels) -> HetaConfig:
    d = ref_cfg.to_dict()
    d["kernels"] = kernels  # the port's defaults, bar the named toggles
    return HetaConfig.from_dict(d)


def _ready(sess):
    sess.build_graph(), sess.partition(), sess.profile_and_cache()
    return sess


@pytest.mark.parametrize("model", MODELS)
def test_vanilla_sessions_match_reference(model, monkeypatch):
    """3 steps of the vanilla oracle from the reference's bundle, learnable
    tables training in the bundle: losses, per-step gradients and the
    trained bundle within 1e-5 (bar the Adam-eps exemption of
    ``tests/test_torch_dense.py``)."""
    from repro.optim import adam as ref_adam
    from repro_torch.optim import adam as port_adam
    from test_torch_dense import _record_adam_grads, assert_bundles_match

    cfg = _ref_config(model, "vanilla")
    ref = _ready(RefHeta(cfg))
    ref.compile()
    port = _ready(Heta(_port_config(cfg), device="cpu"))
    port.compile(state={"bundle": bundle_from_reference(
        jax.tree_util.tree_map(np.asarray, ref.state["bundle"]), "cpu")})
    ref_grads = _record_adam_grads(monkeypatch, ref_adam)
    port_grads = _record_adam_grads(monkeypatch, port_adam)
    want, got = ref.fit()["losses"], port.fit()["losses"]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    exempted = assert_bundles_match(port, ref, port_grads, ref_grads)
    assert not any(k.startswith("embed/") for k in exempted), exempted


@pytest.mark.parametrize("model", MODELS)
def test_port_vanilla_and_raf_follow_one_loss_curve(model):
    """Prop 1 in the port, from its own name-seeded init, with no kernel
    launched on the CPU.  The first step's loss (the forward) agrees for
    every model.  Trained, the simulated RAF executor follows the vanilla
    oracle step for step (``tests/test_api.py``'s contract) where every
    partition holds its own leaves (R-GCN, R-GAT: relation scope).  HGT's
    node- and edge-type leaves are copied into every partition that reads
    them, as the reference's ``raf`` does, and each copy takes only its
    partition's gradient through Adam, so its curve leaves vanilla's after
    the first step."""
    cfg = _port_config(_ref_config(model, "vanilla"))
    kops.reset_launch_counts()
    lv = Heta(cfg, device="cpu").run()["losses"]
    rs = Heta(cfg.updated(run=dict(executor="raf")), device="cpu")
    lr = rs.run()["losses"]
    assert len(lv) == 3 and np.isfinite(lv).all() and np.isfinite(lr).all()
    assert all(info.launches == 0 for info in kops.KERNELS.values())
    shared = [set(part[c]) for part in rs.state["bundle"]["parts"] for c in ("ntype", "etype")]
    copied = set.intersection(*shared[0::2]) | set.intersection(*shared[1::2])
    assert bool(copied) == (model == "hgt"), copied
    np.testing.assert_allclose(lr[:1] if copied else lr, lv[:1] if copied else lv,
                               atol=ATOL, rtol=0)


def _stacks_np(ref):
    return {layer: {leaf: np.asarray(v) for leaf, v in entry.items()}
            for layer, entry in ref.state["stacks"].items()}


@pytest.mark.parametrize("model", ["rgat", "hgt"])
def test_unfused_attention_sessions_match_reference_and_fused(model):
    """raf_spmd with fuse_epilogue=False (the attn_parts projections, then
    stacked_softmax_combine): 3-step losses within 1e-5 of the reference's
    unfused run (its Pallas softmax + combine in interpret mode) and of the
    port's fused run, all from the reference's initial stacks."""
    cfg = _ref_config(model, "raf_spmd", fuse_epilogue=False)
    ref = _ready(RefHeta(cfg))
    ref.compile()
    stacks = _stacks_np(ref)
    runs = {}
    for fuse in (False, True):
        port = _ready(Heta(_port_config(cfg, fuse_epilogue=fuse), device="cpu"))
        port.compile(state={"stacks": stacks_from_reference(stacks, "cpu")})
        runs[fuse] = port.fit()["losses"]
    want = ref.fit()["losses"]
    np.testing.assert_allclose(runs[False], want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(runs[False], runs[True], atol=ATOL, rtol=0)


@pytest.mark.parametrize("model", ["rgat", "hgt"])
def test_unfused_infer_all_matches_fused(model):
    """infer_all through stacked_softmax_combine (fuse_epilogue=False) gives
    the fused store's embeddings within atol/rtol 1e-5, on one trained
    state."""
    cfg = _port_config(_ref_config(model, "raf_spmd", steps=2))
    sess = Heta(cfg, device="cpu")
    sess.build_graph(bounded_graph(sess.build_graph(), 8))
    sess.partition(), sess.profile_and_cache(), sess.compile()
    sess.fit()
    fused = sess.infer_all()
    sess.config = sess.config.updated(kernels=dict(fuse_epilogue=False))
    unfused = sess.infer_all()
    assert fused.embeddings.keys() == unfused.embeddings.keys()
    for t, a in fused.embeddings.items():
        np.testing.assert_allclose(unfused.embeddings[t], a, atol=ATOL, rtol=ATOL, err_msg=t)


def test_unfused_path_reaches_kernel_3_on_cuda_tensors(monkeypatch):
    """With the CUDA-tensor check patched (no card here), the unfused
    forward reaches kernel 3's launch, once per level, and never its plain
    version; the fake launch fills the output from the plain version of the
    original operands."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA-routed call")

    plain = sra.stacked_softmax_combine_ref
    launched = []

    def fake_launch(*args, **kwargs):
        # the operands and the layout: 0, 0 is the entry point's own rule
        assert not kwargs and len(args) == 6, (len(args), sorted(kwargs))
        e, mask_u8, v, out, rows, depth = args
        assert (rows, depth) == (0, 0)
        launched.append((tuple(v.shape), v.is_contiguous()))
        out.copy_(plain(e, mask_u8.bool(), v))

    sess = Heta(_port_config(_ref_config("hgt", "raf_spmd", steps=1), fuse_epilogue=False),
                device="cpu")
    sess.run()
    params = list(inspect.signature(sra.launch_softmax_combine).parameters)
    monkeypatch.setattr(sra, "_is_cuda", lambda t: True)
    monkeypatch.setattr(sra, "stacked_softmax_combine_ref", refuse)
    monkeypatch.setattr(sra, "launch_softmax_combine", fake_launch)
    # the entry point's layout query, for the record: its restatement (the
    # card holds the two equal)
    monkeypatch.setattr(sra, "softmax_combine_layout", lambda nh, dh, rows, depth:
                        autotune.softmax_combine_choose(nh, dh, rows, depth)[:2])
    kops.reset_launch_counts()
    sess.step()
    assert len(launched) == 2 == kops.KERNELS["stacked_softmax_combine"].launches
    assert params == ["e", "mask_u8", "v", "out", "rows", "depth"]
    for shape, lay in kops.KERNELS["stacked_softmax_combine"].layouts:  # the rule's
        rows, depth, _ = autotune.softmax_combine_choose(shape[3], shape[4], 0, 0)
        assert lay == (rows, 1024, depth)
    assert not hasattr(sra, "softmax_combine_rows")
    # HGT's values reach the launch as the einsum's head-major view: no copy
    assert not any(contiguous for _, contiguous in launched)
