"""Kernel ops of the PyTorch/CUDA port against the JAX reference.

On the CPU each op runs its plain PyTorch version; the same numpy inputs go
through the reference's oracle and its Pallas kernel in interpret mode.
Tolerance: fp32, atol 1e-5 / rtol 1e-5 — the plain version sums over the
fanout and the contraction in PyTorch's order, not XLA's; the stack-form
weight gradients also sum slots sharing a stack row in another order.  The CUDA kernels
themselves run only on a GPU: ``tests/test_torch_cuda.py`` (no JAX import,
so it runs on the GPU host) and ``chip_smoke.py`` hold them against their
plain versions on the card.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.relmod import get_relation_module as ref_module
from repro.kernels.gather_rows.kernel import gather_rows_pallas
from repro.kernels.gather_rows.ref import gather_rows_ref as jax_gather_rows_ref
from repro.kernels.stacked_relation_agg import stacked_agg_ref as jax_stacked_agg_ref
from repro.kernels.ops import pad_axes, pad_to
from repro.kernels.stacked_relation_agg import stacked_mean_linear as jax_stacked_mean_linear
from repro.kernels.stacked_relation_agg.kernel import stacked_mean_linear_dh_pallas
from repro.kernels.stacked_relation_agg.ops import stacked_mean_linear_blocks
from repro_torch.api.config import KernelConfig
from repro_torch.core.relmod import get_relation_module
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_cfg, gather_rows_ref
from repro_torch.kernels.stacked_relation_agg import (
    stacked_agg,
    segment_sum,
    stacked_agg_ref,
    stacked_attn_dh,
    stacked_mean_linear,
    stacked_mean_linear_dh,
    stacked_mean_linear_dh_ref,
    stacked_mean_linear_ref,
    stage_slot_u,
)

TOL = dict(atol=1e-5, rtol=1e-5)

# tests/test_stacked_kernels.py's ML_SHAPES (rb, n, f, d_in, d_out, U) plus
# donor's 789-wide features, which the TPU kernel splits across d_in chunks
ML_SHAPES = [
    (5, 17, 4, 37, 24, 3),
    (1, 1, 1, 1, 1, 1),
    (8, 130, 3, 129, 65, 8),
    (12, 64, 25, 128, 64, 6),
    (3, 200, 7, 789, 349, 2),
]


def _mean_linear_case(rb, n, f, di, do, U, seed):
    r = np.random.default_rng(seed)
    w = (r.standard_normal((U, di, do)) * 0.1).astype(np.float32)
    b = (r.standard_normal((U, do)) * 0.1).astype(np.float32)
    h = r.standard_normal((rb, n, f, di)).astype(np.float32)
    q = r.standard_normal((rb, n, di)).astype(np.float32)
    mask = r.random((rb, n, f)) > 0.3
    mask[0, 0, :] = False  # an all-False row (empty neighborhood)
    slot_u = r.integers(0, U, rb)
    return h, q, mask, w, b, slot_u


@pytest.mark.parametrize("rb,n,f,di,do,U", ML_SHAPES)
def test_stacked_mean_linear_matches_reference(rb, n, f, di, do, U):
    h, q, mask, w, b, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=rb * n + di)
    oracle = np.asarray(jax_stacked_agg_ref(
        ref_module("rgcn"), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        {"relation": jnp.asarray(slot_u)}, jnp.asarray(h), jnp.asarray(q),
        jnp.asarray(mask)))
    pallas = np.asarray(jax_stacked_mean_linear(
        jnp.asarray(h), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(slot_u), interpret=True))
    th, tm, tw, tb = (torch.from_numpy(a) for a in (h, mask, w, b))
    plain = stacked_mean_linear_ref(th, tm, tw, tb, slot_u).numpy()
    wrapped = stacked_mean_linear(th, tm, tw, tb, slot_u).numpy()
    dispatched = stacked_agg(get_relation_module("rgcn"), {"w": tw, "b": tb},
                             {"relation": slot_u}, th, torch.from_numpy(q), tm).numpy()
    assert plain.shape == oracle.shape == (rb, n, do)
    np.testing.assert_allclose(plain, oracle, **TOL)
    np.testing.assert_allclose(plain, pallas, **TOL)
    # the CPU wrapper and the dispatch are the plain version, bit for bit
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_array_equal(dispatched, plain)


@pytest.mark.parametrize("rb,n,f,di,do,U", ML_SHAPES[:3])
def test_stacked_agg_oracle_path_matches_kernel_path(rb, n, f, di, do, U):
    """Kernels off: the gather-then-vmap oracle agrees with the op."""
    h, q, mask, w, b, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=3)
    mod = get_relation_module("rgcn")
    args = (mod, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            {"relation": slot_u}, torch.from_numpy(h), torch.from_numpy(q),
            torch.from_numpy(mask))
    off = stacked_agg(*args, opts=KernelConfig(enabled=False)).numpy()
    np.testing.assert_array_equal(off, stacked_agg_ref(*args).numpy())
    np.testing.assert_allclose(off, stacked_agg(*args).numpy(), **TOL)


def test_block_override_leaves_the_dh_kernel_at_its_defaults(monkeypatch):
    """kernels.block_* reach no launch: the forward and the backward ask for
    their ops with no block sizes (both kernels' tiles are fixed), and the
    outputs and gradients with the fields set are the ones without, bit for
    bit."""
    from repro_torch.kernels.stacked_relation_agg import ops as sml

    calls = []
    for name in ("stacked_mean_linear", "stacked_mean_linear_dh"):
        fn = getattr(sml, name)
        monkeypatch.setattr(sml, name, lambda *a, _fn=fn, _name=name, **k:
                            calls.append((_name, len(a), k)) or _fn(*a, **k))
    h, q, mask, w, b, slot_u = _mean_linear_case(6, 20, 3, 128, 64, 6, seed=5)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((6, 20, 64)).astype(np.float32))
    results = []
    for opts in (None, KernelConfig(block_n=64, block_in=128)):
        th, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (h, w, b))
        out = stacked_agg(get_relation_module("rgcn"), {"w": tw, "b": tb},
                          {"relation": slot_u}, th, torch.from_numpy(q),
                          torch.from_numpy(mask), opts=opts)
        results.append((out.detach(), *torch.autograd.grad(out, (th, tw, tb), g)))
    assert calls == [("stacked_mean_linear", 5, {}), ("stacked_mean_linear_dh", 4, {})] * 2
    for a, c in zip(*results):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("fields", [dict(block_n=8), dict(block_out=16, block_in=32),
                                    dict(block_n=512, block_out=512, block_in=512)])
def test_block_fields_change_no_result(fields):
    """Any kernels.block_* setting leaves R-GCN's outputs and gradients
    bit for bit where they are without one."""
    h, q, mask, w, b, slot_u = _mean_linear_case(5, 17, 4, 37, 24, 3, seed=8)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((5, 17, 24)).astype(np.float32))
    results = []
    for opts in (KernelConfig(), KernelConfig(**fields)):
        th, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (h, w, b))
        out = stacked_agg(get_relation_module("rgcn"), {"w": tw, "b": tb},
                          {"relation": slot_u}, th, torch.from_numpy(q),
                          torch.from_numpy(mask), opts=opts)
        results.append((out.detach(), *torch.autograd.grad(out, (th, tw, tb), g)))
    for a, c in zip(*results):
        assert torch.equal(a, c)


def test_kernels_take_no_block_sizes():
    """Kernels 2 and 5 have fixed tiles: their wrappers take no block_*.
    Kernel 1's takes the layout of a CUDA launch and, on CPU tensors, reads
    none of it: any value gives the plain version's answer."""
    h, q, mask, w, b, slot_u = _mean_linear_case(2, 3, 4, 5, 6, 2, seed=1)
    args = [torch.from_numpy(a) for a in (h, mask, w, b)]
    plain = stacked_mean_linear(*args, slot_u)
    for kw in (dict(block_n=64), dict(block_out=64), dict(block_in=32),
               dict(block_n=7, block_out=1, block_in=3)):
        assert torch.equal(stacked_mean_linear(*args, slot_u, **kw), plain)
    g = torch.zeros((2, 3, 6))
    with pytest.raises(TypeError):
        stacked_mean_linear_dh(g, args[1], args[2], slot_u, block_n=64)
    dz = torch.zeros((2, 3, 4, 6))
    us = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        stacked_attn_dh(dz, None, args[2], None, us, block_in=32)
    assert stacked_attn_dh(dz, None, torch.zeros((1, 5, 6)), None, us).shape == (2, 3, 4, 5)


@pytest.mark.parametrize("rows,d,n,idx_dtype", [
    (50, 64, 256, np.int64), (50, 64, 7, np.int32), (9, 37, 20, np.int64),
    (3, 1, 5, np.int32), (10, 8, 0, np.int64)])
def test_gather_rows_matches_reference(rows, d, n, idx_dtype):
    r = np.random.default_rng(rows * d + n)
    table = r.standard_normal((rows, d)).astype(np.float32)
    idx = r.integers(0, rows, n).astype(idx_dtype)
    ref = np.asarray(jax_gather_rows_ref(jnp.asarray(table), jnp.asarray(idx)))
    got = gather_rows(torch.from_numpy(table), idx).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(gather_rows_ref(torch.from_numpy(table),
                                                  torch.from_numpy(idx)).numpy(), ref)
    if n:  # a grid of zero steps is not a Pallas call
        pallas = np.asarray(gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx),
                                               interpret=True))
        np.testing.assert_array_equal(got, pallas)
    off = gather_rows_cfg(torch.from_numpy(table), idx, KernelConfig(gather=False))
    np.testing.assert_array_equal(off.numpy(), ref)


@pytest.mark.parametrize("rows,d,n,idx_dtype", [
    (9, 37, 40, np.int64), (9, 37, 40, np.int32), (3, 1, 12, np.int32), (50, 64, 30, np.int64)])
def test_gather_rows_gradient_matches_reference_vjp(rows, d, n, idx_dtype):
    """The gather's gradient into the table, with duplicate indices, equals
    the reference's: its custom_vjp backward (the scatter-add ``_vjp_bwd``)
    applied to the cotangent, after its forward (the Pallas kernel in
    interpret mode), and jax.grad through its plain path.  Under this jax,
    jax.grad through the custom_vjp itself raises: its forward keeps
    ``table.dtype`` among the residuals, which is not a JAX type (ROADMAP.md
    §C, R5), so the test calls the backward rule directly.  Tolerance 1e-6:
    each row of the gradient sums the same few values, possibly in another
    order."""
    from repro.kernels.gather_rows import ops as jax_gather_ops

    r = np.random.default_rng(rows + d + n)
    table = r.standard_normal((rows, d)).astype(np.float32)
    idx = r.integers(0, rows, n).astype(idx_dtype)
    assert len(np.unique(idx)) < n  # duplicates: the scatter-add must sum them
    g = r.standard_normal((n, d)).astype(np.float32)
    jt, ji, jg = jnp.asarray(table), jnp.asarray(idx), jnp.asarray(g)
    out, res = jax_gather_ops._vjp_fwd(True, jt, ji)
    want = np.asarray(jax_gather_ops._vjp_bwd(True, res, jg)[0])
    plain = np.asarray(jax.grad(lambda t: jnp.sum(
        jax_gather_ops.gather_rows(t, ji, use_pallas=False) * jg))(jt))
    np.testing.assert_array_equal(want, plain)
    tt = torch.from_numpy(table).requires_grad_(True)
    got = gather_rows(tt, idx)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    (dt,) = torch.autograd.grad(got, tt, torch.from_numpy(g))
    np.testing.assert_allclose(dt.numpy(), want, atol=1e-6, rtol=1e-6)


def test_gather_rows_rejects_bad_indices():
    table = torch.zeros((4, 3))
    with pytest.raises(IndexError):
        gather_rows(table, np.array([0, 4]))
    with pytest.raises(IndexError):
        gather_rows(table, np.array([-1]))
    with pytest.raises(ValueError):
        gather_rows(table, np.array([[0]]))
    with pytest.raises(ValueError):
        gather_rows(table, np.array([0.5]))


def test_stacked_mean_linear_rejects_bad_operands():
    h = torch.zeros((2, 3, 4, 5))
    mask = torch.ones((2, 3, 4), dtype=torch.bool)
    w, b = torch.zeros((2, 5, 6)), torch.zeros((2, 6))
    with pytest.raises(IndexError):
        stacked_mean_linear(h, mask, w, b, np.array([0, 2]))
    with pytest.raises(ValueError):
        stacked_mean_linear(h, mask, w, b, np.array([0]))
    with pytest.raises(ValueError):
        stacked_mean_linear(h, mask[:, :, :3], w, b, np.array([0, 1]))
    with pytest.raises(ValueError):
        stacked_mean_linear(h, mask, torch.zeros((2, 4, 6)), b, np.array([0, 1]))


@pytest.mark.parametrize("rb,n,f,di,do,U", ML_SHAPES[:3])
def test_stacked_mean_linear_takes_staged_slots(rb, n, f, di, do, U):
    """Slots staged once (as infer_all does per group) give the host
    slots' answer, and are range-checked when staged."""
    h, q, mask, w, b, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=11)
    args = [torch.from_numpy(a) for a in (h, mask, w, b)]
    staged = stage_slot_u(slot_u, U, "cpu")
    assert staged.dtype == torch.int32 and staged.shape == (rb,)
    np.testing.assert_array_equal(stacked_mean_linear(*args, staged).numpy(),
                                  stacked_mean_linear(*args, slot_u).numpy())
    with pytest.raises(IndexError):
        stage_slot_u(np.full(rb, U), U, "cpu")
    with pytest.raises(ValueError, match="shape"):
        stacked_mean_linear(*args, stage_slot_u(np.zeros(rb + 1, np.int64), U, "cpu"))


def test_kernel_options_policy():
    assert kops.kernel_choice(None, "gather")
    assert not kops.kernel_choice(KernelConfig(enabled=False), "gather")
    assert not kops.kernel_choice(KernelConfig(gather=False), "gather")
    assert kops.kernel_choice(KernelConfig(gather=False), "stacked_agg")
    with pytest.raises(ValueError, match="interpret"):
        kops.kernel_choice(KernelConfig(interpret=True), "gather")
    # autotune=True runs: on CPU tensors the plain version, with no table or
    # block_* read (the resolution is never asked), the answer autotune=False
    # gives, bit for bit
    assert not hasattr(kops, "refuse_autotune")
    h, q, mask, w, b, slot_u = _mean_linear_case(2, 5, 3, 4, 6, 2, seed=1)
    outs = []
    for opts in (KernelConfig(), KernelConfig(autotune=True),
                 KernelConfig(autotune=True, block_n=7, block_out=1, block_in=3)):
        outs.append(stacked_agg(get_relation_module("rgcn"), {"w": torch.from_numpy(w),
                                                              "b": torch.from_numpy(b)},
                                {"relation": slot_u}, torch.from_numpy(h),
                                torch.from_numpy(q), torch.from_numpy(mask), opts=opts))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert set(kops.KERNELS) >= {"stacked_mean_linear", "stacked_mean_linear_dh",
                                 "gather_rows"}
    # the layout of a CUDA launch resolves in the reference's order, with the
    # shape's rule (None) in place of its DEFAULT_BLOCKS
    assert not hasattr(kops, "DEFAULT_BLOCKS")
    assert kops.resolve_blocks(None, "stacked_mean_linear", 1024, 3, 128, 64) == \
        (None, None, None)
    assert kops.resolve_blocks(KernelConfig(block_n=64), "stacked_mean_linear", 1024, 3, 128,
                               64) == (64, None, None)


def test_launch_path_names_missing_raw_queries(monkeypatch):
    """The launch path's stream and device come from PyTorch's private raw
    queries; a PyTorch without them (as a CPU-only build) gets a named error
    at the first launch, not an AttributeError."""
    for name in ("_RAW_STREAM", "_RAW_DEVICE"):
        with monkeypatch.context() as m:
            m.setattr(kops, name, None)
            with pytest.raises(RuntimeError, match="_cuda_getCurrentRawStream"):
                kops.cuda_stream(torch.device("cuda", 0))
    monkeypatch.setattr(kops, "_RAW_DEVICE", None)
    with pytest.raises(RuntimeError, match="raw queries"):
        kops.on_device(torch.device("cuda", 0))


def test_cpu_path_launches_no_kernel():
    kops.reset_launch_counts()
    h, q, mask, w, b, slot_u = _mean_linear_case(2, 5, 3, 4, 6, 2, seed=1)
    th = torch.from_numpy(h).requires_grad_(True)
    out = stacked_mean_linear(th, *(torch.from_numpy(a) for a in (mask, w, b)), slot_u)
    out.sum().backward()
    gather_rows(torch.zeros((4, 2)), np.array([1, 2]))
    assert all(info.launches == 0 for info in kops.KERNELS.values())


def test_kernel_sources_declare_c_entry_points():
    from repro_torch.kernels import build

    assert set(build.SOURCES) == {"stacked_mean_linear", "stacked_mean_linear_dh",
                                  "gather_rows", "stacked_attn_epilogue", "stacked_attn_dh",
                                  "relation_agg", "stacked_softmax_combine",
                                  "flash_attention"}
    for name, entry in (("stacked_mean_linear", "stacked_mean_linear_fwd"),
                        ("stacked_mean_linear_dh", "stacked_mean_linear_dh"),
                        ("gather_rows", "gather_rows_f32"),
                        ("stacked_attn_epilogue", "stacked_attn_epilogue"),
                        ("stacked_attn_dh", "stacked_attn_dh"),
                        ("relation_agg", "relation_agg_fwd"),
                        ("stacked_softmax_combine", "stacked_softmax_combine_fwd"),
                        ("flash_attention", "flash_attention_fwd")):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {entry}(' in text
        # the launch may sit in a header of csrc/ that the source includes
        # (kernels 1 and 6 share mean_linear.cuh's)
        for header in re.findall(r'#include "([^"]+)"', text):
            text += (build.CSRC / header).read_text()
        assert "return (int)cudaGetLastError();" in text
        assert build.library_path(name).name.startswith(f"lib{name}-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    """An edited header gives every source a new library path, so a stale
    library built against the old header is never loaded."""
    from repro_torch.kernels import build

    for name in ("stacked_mean_linear.cu", "relation_agg.cu"):
        assert '#include "mean_linear.cuh"' in (build.CSRC / name).read_text()
    assert '#include "fp32_tile.cuh"' in (build.CSRC / "mean_linear.cuh").read_text()
    (tmp_path / "k.cu").write_text('#include "core.cuh"\n')
    (tmp_path / "core.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("k")
    assert build.library_path("k") == before
    (tmp_path / "core.cuh").write_text("// two\n")
    assert build.library_path("k") != before


# --------------------------------------------------------------------------
# the backward: dh kernel's plain version and the autograd seam
# --------------------------------------------------------------------------


def _jax_dh_pallas(g, mask, w, slot_u):
    """The reference's dh Pallas kernel in interpret mode, padded and
    sliced as its custom VJP does (``ops.py:_ml_vjp_bwd``)."""
    rb, n, do = g.shape
    f, di = mask.shape[2], w.shape[1]
    bn, bo, bc = stacked_mean_linear_blocks(n, f, di, do, 128, 128, 512)
    out = stacked_mean_linear_dh_pallas(
        pad_axes(jnp.asarray(g), {1: bn, 2: bo}), pad_to(jnp.asarray(mask), 1, bn),
        pad_axes(jnp.asarray(w), {1: bc, 2: bo}), jnp.asarray(slot_u, jnp.int32),
        block_n=bn, block_out=bo, block_in=bc, interpret=True)
    return np.asarray(out)[:, :n, :, :di]


@pytest.mark.parametrize("rb,n,f,di,do,U", ML_SHAPES)
def test_stacked_mean_linear_dh_matches_reference(rb, n, f, di, do, U):
    h, q, mask, w, b, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=rb + di)
    g = np.random.default_rng(n).standard_normal((rb, n, do)).astype(np.float32)
    ref = _jax_dh_pallas(g, mask, w, slot_u)
    tg, tm, tw = (torch.from_numpy(a) for a in (g, mask, w))
    plain = stacked_mean_linear_dh_ref(tg, tm, tw, slot_u).numpy()
    assert plain.shape == ref.shape == (rb, n, f, di)
    np.testing.assert_allclose(plain, ref, **TOL)
    # the CPU wrapper is the plain version, bit for bit
    np.testing.assert_array_equal(stacked_mean_linear_dh(tg, tm, tw, slot_u).numpy(), plain)
    np.testing.assert_array_equal(
        stacked_mean_linear_dh(tg, tm, tw, stage_slot_u(slot_u, U, "cpu")).numpy(), plain)


@pytest.mark.parametrize("rb,n,f,di,do,U", ML_SHAPES)
def test_stacked_mean_linear_grads_match_reference_vjp(rb, n, f, di, do, U):
    """dh / dw / db of the port's autograd Function (stack-form weight
    gradients) against ``jax.vjp`` of the reference's custom-VJP op, with
    slots sharing stack rows."""
    h, q, mask, w, b, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=di)
    slot_u[: min(rb, 2)] = 0  # at least two slots on stack row 0 when rb > 1
    g = np.random.default_rng(do).standard_normal((rb, n, do)).astype(np.float32)
    _, vjp = jax.vjp(lambda h_, w_, b_: jax_stacked_mean_linear(
        h_, jnp.asarray(mask), w_, b_, jnp.asarray(slot_u), interpret=True),
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    th, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (h, w, b))
    out = stacked_mean_linear(th, torch.from_numpy(mask), tw, tb, slot_u)
    got = torch.autograd.grad(out, (th, tw, tb), torch.from_numpy(g))
    for name, a, c in zip(("dh", "dw", "db"), got, ref):
        assert a.shape == c.shape, name
        np.testing.assert_allclose(a.numpy(), c, **TOL, err_msg=name)


def test_segment_sum_is_index_add_and_deterministic():
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((7, 5, 3)).astype(np.float32))
    seg = torch.tensor([0, 2, 2, 0, 4, 2, 0])
    got = segment_sum(x, seg, 6)
    want = torch.zeros((6, 5, 3)).index_add_(0, seg, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert torch.equal(got[[1, 3, 5]], torch.zeros((3, 5, 3)))
    assert torch.equal(got, segment_sum(x, seg, 6))
