"""Kernel ops of the PyTorch/CUDA port against the JAX reference.

On the CPU each op runs its plain PyTorch version; the same numpy inputs go
through the reference's oracle and its Pallas kernel in interpret mode.
Tolerance: fp32, atol 1e-5 / rtol 1e-5 — the plain version sums over the
fanout and the contraction in PyTorch's order, not XLA's.  The CUDA kernels
themselves run only on a GPU: ``tests/test_torch_cuda.py`` (no JAX import,
so it runs on the GPU host) and ``chip_smoke.py`` hold them against their
plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.relmod import get_relation_module as ref_module
from repro.kernels.gather_rows.kernel import gather_rows_pallas
from repro.kernels.gather_rows.ref import gather_rows_ref as jax_gather_rows_ref
from repro.kernels.stacked_relation_agg import stacked_agg_ref as jax_stacked_agg_ref
from repro.kernels.stacked_relation_agg import stacked_mean_linear as jax_stacked_mean_linear
from repro_torch.api.config import KernelConfig
from repro_torch.core.relmod import get_relation_module
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_cfg, gather_rows_ref
from repro_torch.kernels.stacked_relation_agg import (
    stacked_agg,
    stacked_agg_ref,
    stacked_mean_linear,
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
    assert kops.resolve_blocks(None, "stacked_mean_linear") == \
        kops.DEFAULT_BLOCKS["stacked_mean_linear"]
    assert kops.resolve_blocks(KernelConfig(block_n=8, block_in=32),
                               "stacked_mean_linear")[::2] == (8, 32)
    with pytest.raises(NotImplementedError):
        kops.resolve_blocks(KernelConfig(autotune=True), "stacked_mean_linear")
    assert set(kops.KERNELS) >= {"stacked_mean_linear", "gather_rows"}


def test_cpu_path_launches_no_kernel():
    kops.reset_launch_counts()
    h, q, mask, w, b, slot_u = _mean_linear_case(2, 5, 3, 4, 6, 2, seed=1)
    stacked_mean_linear(*(torch.from_numpy(a) for a in (h, mask, w, b)), slot_u)
    gather_rows(torch.zeros((4, 2)), np.array([1, 2]))
    assert all(info.launches == 0 for info in kops.KERNELS.values())


def test_kernel_sources_declare_c_entry_points():
    from repro_torch.kernels import build

    assert set(build.SOURCES) == {"stacked_mean_linear", "gather_rows"}
    for name, entry in (("stacked_mean_linear", "stacked_mean_linear_fwd"),
                        ("gather_rows", "gather_rows_f32")):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {entry}(' in text
        assert "return (int)cudaGetLastError();" in text
        assert build.library_path(name).name.startswith(f"lib{name}-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
