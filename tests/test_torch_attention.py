"""The attention ops of the PyTorch/CUDA port (R-GAT, HGT) against the JAX
reference, at the module and kernel level.

On the CPU each op runs its plain PyTorch version; the same numpy inputs go
through the reference's ``stacked_agg`` with its Pallas kernels in interpret
mode (fused epilogue, and the ``attn_parts`` factoring) and its
gather-then-vmap oracle ``stacked_agg_ref``.  The cases and thresholds are
``tests/test_stacked_kernels.py``'s: forward atol/rtol 1e-5; gradients of the
stacks and of h atol 2e-5 / rtol 1e-5 (the port sums over the fanout, the
contraction and the slots sharing a stack row in PyTorch's order, not
XLA's).  The CUDA kernels themselves run only on a GPU
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.relmod import ShapeCtx as RefShapeCtx
from repro.core.relmod import get_relation_module as ref_module
from repro.core.relmod import masked_softmax as ref_masked_softmax
from repro.kernels.ops import KernelOptions, pad_to
from repro.kernels.stacked_relation_agg import stacked_agg as jax_stacked_agg
from repro.kernels.stacked_relation_agg import stacked_agg_ref as jax_stacked_agg_ref
from repro.kernels.stacked_relation_agg.kernel import (
    stacked_attn_dh_pallas,
    stacked_attn_epilogue_pallas,
)
from repro_torch.api.config import KernelConfig
from repro_torch.core.relmod import get_relation_module, masked_softmax
from repro_torch.kernels import ops as kops
from repro_torch.kernels.stacked_relation_agg import (
    FanoutTooWideError,
    attn_epilogue_forward,
    attn_slots,
    segment_sum,
    stacked_agg,
    stacked_attn_dh,
    stacked_attn_dh_ref,
    stacked_attn_epilogue_ref,
    take_slots,
)
from repro_torch.kernels.stacked_relation_agg.ops import attn_max_fanout

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=1e-5)
JAX_ON = KernelOptions(interpret=True)
JAX_PARTS = KernelOptions(interpret=True, fuse_epilogue=False)
PORT_PATHS = {"fused": None, "attn_parts": KernelConfig(fuse_epilogue=False),
              "oracle": KernelConfig(enabled=False)}


def _module_case(model, rb, n, f, di=23, dd=17, hidden=32, nh=4, seed=0):
    """``tests/test_stacked_kernels.py``'s ``_module_case``, as numpy."""
    r = np.random.default_rng(seed)
    mod = ref_module(model)
    sc = RefShapeCtx(hidden, nh, hidden // nh, di, dd)
    U_of = {s: u for s, u in zip(mod.scopes, (3, 2, 5, 4))}
    stacks = {s.name: (r.standard_normal((U_of[s.scope],) + tuple(s.shape(sc))) * 0.1
                       ).astype(np.float32) for s in mod.specs}
    slot_u = {s: r.integers(0, U_of[s], rb) for s in mod.scopes}
    h = r.standard_normal((rb, n, f, di)).astype(np.float32)
    q = r.standard_normal((rb, n, dd)).astype(np.float32)
    mask = r.random((rb, n, f)) > 0.3
    mask[0, 1, :] = False  # an all-masked row
    return mod, stacks, slot_u, h, q, mask


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _port_grads(model, stacks, slot_u, h, q, mask, opts):
    ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in stacks.items()}
    th = torch.from_numpy(h).requires_grad_(True)
    out = stacked_agg(get_relation_module(model), ts, slot_u, th, torch.from_numpy(q),
                      torch.from_numpy(mask), opts=opts)
    grads = torch.autograd.grad((out ** 2).sum(), list(ts.values()) + [th])
    return out.detach().numpy(), dict(zip(ts, (g.numpy() for g in grads[:-1]))), \
        grads[-1].numpy()


@pytest.mark.parametrize("path", sorted(PORT_PATHS))
@pytest.mark.parametrize("model", ["rgat", "hgt"])
@pytest.mark.parametrize("rb,n,f", [(5, 19, 4), (3, 130, 3)])
def test_attention_stacked_agg_matches_reference(model, rb, n, f, path):
    """Each of the port's paths against the reference's fused epilogue, its
    attn_parts factoring and its oracle — forward and gradients, with stack
    rows shared by two slots and an all-masked row."""
    mod, stacks, slot_np, h, q, mask = _module_case(model, rb, n, f, seed=rb * n)
    slot_np = {s: np.where(np.arange(rb) < 2, 0, v) for s, v in slot_np.items()}
    jargs = (_jax(stacks), _jax(slot_np), jnp.asarray(h), jnp.asarray(q), jnp.asarray(mask))
    want = np.asarray(jax_stacked_agg_ref(mod, *jargs))
    fused = np.asarray(jax_stacked_agg(mod, *jargs, opts=JAX_ON))
    parts = np.asarray(jax_stacked_agg(mod, *jargs, opts=JAX_PARTS))

    def loss(st, h_):
        return jnp.sum(jax_stacked_agg_ref(mod, st, jargs[1], h_, jargs[3], jargs[4]) ** 2)

    g_st, g_h = jax.grad(loss, argnums=(0, 1))(jargs[0], jargs[2])
    out, gs, gh = _port_grads(model, stacks, slot_np, h, q, mask, PORT_PATHS[path])
    assert out.shape == want.shape == (rb, n, 32)
    for ref in (want, fused, parts):
        np.testing.assert_allclose(out, ref, **FWD)
    assert gs.keys() == g_st.keys()
    for leaf, g in gs.items():
        np.testing.assert_allclose(g, np.asarray(g_st[leaf]), **GRAD, err_msg=leaf)
    np.testing.assert_allclose(gh, np.asarray(g_h), **GRAD)


@pytest.mark.parametrize("model", ["rgat", "hgt"])
def test_block_fields_change_no_attention_result(model):
    """kernels.block_* reach no launch on the attention path either (the
    q side's stacked_mean_linear and stacked_attn_dh have fixed tiles):
    outputs and gradients are the same bit for bit with them set."""
    mod, stacks, slot_u, h, q, mask = _module_case(model, 3, 13, 4, seed=4)
    plain = _port_grads(model, stacks, slot_u, h, q, mask, KernelConfig())
    sized = _port_grads(model, stacks, slot_u, h, q, mask,
                        KernelConfig(block_n=8, block_out=16, block_in=32))
    np.testing.assert_array_equal(sized[0], plain[0])
    for leaf, g in plain[1].items():
        np.testing.assert_array_equal(sized[1][leaf], g, err_msg=leaf)
    np.testing.assert_array_equal(sized[2], plain[2])


@pytest.mark.parametrize("fields", [dict(block_n=64), dict(block_out=64, block_in=64),
                                    dict(block_n=1, block_out=1, block_in=1),
                                    dict(block_n=512, block_out=512, block_in=512)],
                         ids=["n", "out-in", "ones", "large"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("model", ["rgat", "hgt"])
def test_block_fields_change_no_attention_output_or_gradient(model, fuse, fields):
    """No kernels.block_* setting reaches the epilogue (whose tile is fixed
    in its source, rows per block from the fanout alone): R-GAT's and HGT's
    outputs and the gradients of every stack, of h and of q are the ones
    without the fields, bit for bit, fused and unfused."""
    mod, stacks, slot_u, h, q, mask = _module_case(model, 4, 11, 16, seed=7)
    res = []
    for opts in (KernelConfig(fuse_epilogue=fuse), KernelConfig(fuse_epilogue=fuse, **fields)):
        ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in stacks.items()}
        th, tq = (torch.from_numpy(a).requires_grad_(True) for a in (h, q))
        out = stacked_agg(get_relation_module(model), ts, slot_u, th, tq,
                          torch.from_numpy(mask), opts=opts)
        res.append([out.detach()] + list(torch.autograd.grad((out ** 2).sum(),
                                                             [*ts.values(), th, tq])))
    for name, a, b in zip(["out", *stacks, "h", "q"], *res):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("model", ["rgat", "hgt"])
def test_attention_grad_lands_in_stack_rows(model):
    """Slots sharing a stack row sum into it; rows no slot references get
    exactly zero gradient (the contract sync_stack_grads relies on)."""
    mod, stacks, _, h, q, mask = _module_case(model, 4, 11, 3, di=12, dd=10, hidden=16,
                                              seed=9)
    slot_u = {s: np.array([0, 0, 1, 1]) for s in mod.scopes}
    ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in stacks.items()}
    out = stacked_agg(get_relation_module(model), ts, slot_u, torch.from_numpy(h),
                      torch.from_numpy(q), torch.from_numpy(mask))
    grads = dict(zip(ts, torch.autograd.grad(out.sum(), list(ts.values()))))
    for leaf, g in grads.items():
        assert bool((g[2:] == 0).all()), f"{leaf}: an unused stack row got a gradient"
        assert float(g[:2].abs().max()) > 0, leaf


def test_masked_softmax_matches_reference():
    r = np.random.default_rng(4)
    e = (r.standard_normal((6, 5, 3)) * 3).astype(np.float32)
    mask = r.random((6, 5, 1)) > 0.4
    mask[0] = False  # a fully masked group
    mask[1, :, 0] = True
    g = r.standard_normal((6, 5, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: ref_masked_softmax(x, jnp.asarray(mask), axis=1),
                        jnp.asarray(e))
    te = torch.from_numpy(e).requires_grad_(True)
    got = masked_softmax(te, torch.from_numpy(mask), axis=1)
    (de,) = torch.autograd.grad(got, te, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got.detach().numpy()[0], 0.0)
    np.testing.assert_allclose(de.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6,
                               rtol=1e-6)


# the kernel level: (rb, n, f, d_in, nh, dh, U) including ragged sizes
KERNEL_SHAPES = [(5, 19, 4, 23, 4, 8, 3), (3, 130, 3, 129, 4, 16, 2), (2, 7, 16, 37, 2, 8, 2)]


def _epilogue_case(rb, n, f, di, nh, dh, U, variant, seed):
    """Operands of the fused epilogue in one of the two variants: R-GAT (eb,
    slope 0.2, values shared with the logits projection, a per-slot qv
    expanded over the destinations) or HGT (separate wv, pe/pv transforms,
    materialized qv, scale 1/sqrt(dh))."""
    r = np.random.default_rng(seed)
    H = nh * dh
    t = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32) * 0.3)
    h = t(rb, n, f, di)
    mask = torch.from_numpy(r.random((rb, n, f)) > 0.3)
    mask[0, 0] = False
    slots = [r.integers(0, U, rb) for _ in range(3)]
    slots[0][: min(rb, 2)] = 0  # shared stack rows
    if variant == "rgat":
        ops = dict(qv=t(rb, 1, H).expand(rb, n, H), eb=t(rb, n, nh), we=t(U, di, H), wv=None,
                   pe=None, pv=None)
        kw = dict(scale=1.0, slope=0.2)
    else:
        ops = dict(qv=t(rb, n, H), eb=None, we=t(U, di, H), wv=t(U, di, H),
                   pe=t(U, nh, dh, dh), pv=t(U, nh, dh, dh))
        kw = dict(scale=float(1 / np.sqrt(dh)), slope=None)
    us = attn_slots(*slots, (U, U, U), rb, "cpu")
    return h, mask, ops, us, kw


def _jax_epilogue(h, mask, ops, us, nh, dh, kw, with_residuals):
    """The reference's Pallas epilogue in interpret mode, padded and sliced
    as its op does."""
    rb, n, f, di = h.shape
    bn = 8
    J = lambda x: None if x is None else jnp.asarray(np.ascontiguousarray(x.numpy()))
    res = stacked_attn_epilogue_pallas(
        pad_to(J(h), 1, bn), pad_to(J(mask), 1, bn), pad_to(J(ops["qv"]), 1, bn),
        None if ops["eb"] is None else pad_to(J(ops["eb"]), 1, bn), J(ops["we"]),
        J(ops["wv"]), J(ops["pe"]), J(ops["pv"]), J(us), num_heads=nh, head_dim=dh,
        with_residuals=with_residuals, block_n=bn, block_in=di, interpret=True, **kw)
    if not with_residuals:
        return (np.asarray(res)[:, :n],)
    return tuple(np.asarray(x)[:, :n] for x in res)


@pytest.mark.parametrize("variant", ["rgat", "hgt"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_attn_epilogue_matches_pallas(shape, variant):
    rb, n, f, di, nh, dh, U = shape
    h, mask, ops, us, kw = _epilogue_case(*shape, variant, seed=n + f)
    for with_res in (False, True):
        want = _jax_epilogue(h, mask, ops, us, nh, dh, kw, with_res)
        got = attn_epilogue_forward(h, mask, **ops, us=us, num_heads=nh, head_dim=dh,
                                    with_residuals=with_res, **kw)
        got = got if with_res else (got,)
        plain = stacked_attn_epilogue_ref(h, mask, **ops, us=us, num_heads=nh,
                                          head_dim=dh, with_residuals=with_res, **kw)
        plain = plain if with_res else (plain,)
        for a, b, c in zip(got, plain, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())  # CPU: the plain version
            np.testing.assert_allclose(a.numpy(), c, **FWD)
        if with_res and variant == "rgat":
            assert got[2] is got[1]  # shared values: v0 is z0


@pytest.mark.parametrize("variant", ["rgat", "hgt"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_attn_dh_matches_pallas(shape, variant):
    rb, n, f, di, nh, dh, U = shape
    _, _, ops, us, _ = _epilogue_case(*shape, variant, seed=rb + di)
    r = np.random.default_rng(f)
    dz = torch.from_numpy(r.standard_normal((rb, n, f, nh * dh)).astype(np.float32))
    dv = None if variant == "rgat" else torch.from_numpy(
        r.standard_normal((rb, n, f, nh * dh)).astype(np.float32))
    J = lambda x: None if x is None else jnp.asarray(x.numpy())
    want = np.asarray(stacked_attn_dh_pallas(J(dz), J(dv), J(ops["we"]), J(ops["wv"]), J(us),
                                             block_n=n, block_in=di, interpret=True))
    got = stacked_attn_dh(dz, dv, ops["we"], ops["wv"], us).numpy()
    assert got.shape == want.shape == (rb, n, f, di)
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_array_equal(got, stacked_attn_dh_ref(dz, dv, ops["we"], ops["wv"],
                                                            us).numpy())


@pytest.mark.parametrize("model", ["rgat", "hgt"])
def test_attention_cpu_path_launches_no_kernel_and_skips_residuals(model, monkeypatch):
    """On the CPU no kernel launches; without a gradient to take, the
    epilogue is asked for no residuals."""
    from repro_torch.kernels.stacked_relation_agg import ops as sra

    asked = []
    fwd = sra.attn_epilogue_forward
    monkeypatch.setattr(sra, "attn_epilogue_forward",
                        lambda *a, **k: asked.append(k.get("with_residuals", False)) or fwd(*a, **k))
    kops.reset_launch_counts()
    mod, stacks, slot_u, h, q, mask = _module_case(model, 3, 9, 4, seed=2)
    args = (get_relation_module(model), {k: torch.from_numpy(v) for k, v in stacks.items()},
            slot_u, torch.from_numpy(h), torch.from_numpy(q), torch.from_numpy(mask))
    with torch.no_grad():
        stacked_agg(*args)
    th = args[3].requires_grad_(True)
    stacked_agg(*args[:3], th, *args[4:]).sum().backward()
    assert asked == [False, True]
    assert all(info.launches == 0 for info in kops.KERNELS.values())


def test_take_slots_backward_is_the_slot_sum():
    r = np.random.default_rng(1)
    stack = torch.from_numpy(r.standard_normal((4, 3, 2)).astype(np.float32))
    stack.requires_grad_(True)
    u = np.array([2, 0, 2, 2, 1])
    g = torch.from_numpy(r.standard_normal((5, 3, 2)).astype(np.float32))
    rows = take_slots(stack, u)
    assert torch.equal(rows, stack.detach()[torch.from_numpy(u)])
    (got,) = torch.autograd.grad(rows, stack, g)
    want = torch.zeros((4, 3, 2)).index_add_(0, torch.from_numpy(u), g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert torch.equal(got, segment_sum(g, torch.from_numpy(u), 4))
    assert bool((got[3] == 0).all())
    with pytest.raises(IndexError):
        take_slots(stack, np.array([4]))


def test_attn_rows_shrink_with_fanout_and_refuse_what_cannot_fit():
    """The widest row the attention epilogue takes, whose shared memory
    decides FanoutTooWideError.  The rows per block shrink with f in the C
    entry point's layout alone (checked on the card:
    tests/test_torch_cuda.py::test_cuda_attn_rows_shrink_with_fanout)."""
    # the fanout limits stay the first version's: 392 for HGT, 792 for R-GAT
    # at 4 heads x 16
    assert attn_max_fanout(4, 16, two=True, post=True) == 392
    assert attn_max_fanout(4, 16, two=False, post=False) == 792
    # a wider H or a second projection leaves room for fewer neighbours
    assert attn_max_fanout(4, 16, two=True, post=False) == 392
    assert attn_max_fanout(4, 16, two=False, post=True) == 791
    assert attn_max_fanout(8, 64, two=True, post=True) == 49
    assert attn_max_fanout(2, 4, two=True, post=True) == 2882
    # the limit is the first version's arithmetic, 4 * floats <= 227 KB
    for nh, dh, two, post in ((4, 16, True, True), (4, 16, False, False), (3, 24, True, True),
                              (8, 64, False, False), (1, 1000, False, False)):
        H, k, q = nh * dh, 1 + two, 1 + post
        need = lambda f: 4 * (f * (H * k + nh) + H * q + 64 * 33 + 32 * 64 * k)  # noqa: E731
        f = attn_max_fanout(nh, dh, two, post)
        assert need(f) <= 232448 < need(f + 1), (nh, dh, two, post)


def test_attention_ops_refuse_bad_operands():
    h, mask, ops, us, kw = _epilogue_case(2, 5, 3, 6, 2, 4, 2, "hgt", seed=0)
    with pytest.raises(ValueError, match="shapes"):
        attn_epilogue_forward(h, mask, **{**ops, "pv": None}, us=us, num_heads=2,
                              head_dim=4, **kw)
    with pytest.raises(ValueError, match="shapes"):
        attn_epilogue_forward(h, mask, **ops, us=us, num_heads=4, head_dim=2, **kw)
    with pytest.raises(ValueError, match="us must be"):
        attn_epilogue_forward(h, mask, **ops, us=us.long(), num_heads=2, head_dim=4, **kw)
    with pytest.raises(ValueError, match="shapes"):
        stacked_attn_dh(torch.zeros(2, 5, 3, 8), torch.zeros(2, 5, 3, 8), ops["we"], None, us)
    with pytest.raises(IndexError):
        attn_slots(np.array([0, 2]), np.array([0, 1]), np.array([0, 1]), (2, 2, 2), 2, "cpu")
