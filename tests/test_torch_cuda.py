"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device
(the hand-written kernels have no CPU mode).  The file imports no JAX, so
it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: fp32, atol 1e-5 / rtol 1e-5 for the aggregation and its
backward (the kernels sum the fanout and the contraction in their own
order); the gather is exact.
TF32 is switched off so the plain version's matmul runs in full fp32.
"""

import numpy as np
import pytest
import torch

from repro_torch.api.config import KernelConfig
from repro_torch.core.relmod import get_relation_module
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_ref
from repro_torch.kernels.stacked_relation_agg import (
    stacked_agg,
    stacked_mean_linear,
    stacked_mean_linear_dh,
    stacked_mean_linear_dh_ref,
    stacked_mean_linear_ref,
    stage_slot_u,
)

TOL = dict(atol=1e-5, rtol=1e-5)

# (rb, n, f, d_in, d_out, U): tests/test_stacked_kernels.py's ragged shapes,
# donor's 789-wide features, and the serving path's layer-1 and layer-2 blocks
ML_SHAPES = [
    (5, 17, 4, 37, 24, 3),
    (1, 1, 1, 1, 1, 1),
    (8, 130, 3, 129, 65, 8),
    (12, 64, 25, 128, 64, 6),
    (3, 200, 7, 789, 349, 2),
    (3, 1024, 16, 128, 64, 3),
    (3, 1024, 16, 64, 64, 3),
]


def _mean_linear_case(rb, n, f, di, do, U, seed):
    r = np.random.default_rng(seed)
    w = (r.standard_normal((U, di, do)) * 0.1).astype(np.float32)
    b = (r.standard_normal((U, do)) * 0.1).astype(np.float32)
    h = r.standard_normal((rb, n, f, di)).astype(np.float32)
    mask = r.random((rb, n, f)) > 0.3
    mask[0, 0, :] = False  # an all-False row (empty neighborhood)
    slot_u = r.integers(0, U, rb)
    return h, mask, w, b, slot_u



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rb,n,f,di,do,U", ML_SHAPES)
def test_cuda_stacked_mean_linear_matches_plain(cuda_device, rb, n, f, di, do, U):
    h, mask, w, b, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=rb + n)
    args = [torch.from_numpy(a).to(cuda_device) for a in (h, mask, w, b)]
    before = kops.KERNELS["stacked_mean_linear"].launches
    got = stacked_mean_linear(*args, slot_u)
    torch.cuda.synchronize()
    assert kops.KERNELS["stacked_mean_linear"].launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               stacked_mean_linear_ref(*args, slot_u).cpu().numpy(), **TOL)
    staged = stacked_mean_linear(*args, stage_slot_u(slot_u, U, cuda_device))
    assert torch.equal(staged, got)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,n,idx_dtype", [
    (73638, 64, 256, np.int64), (50, 37, 9, np.int32), (5, 1, 3, np.int64)])
def test_cuda_gather_rows_matches_plain(cuda_device, rows, d, n, idx_dtype):
    r = np.random.default_rng(rows + n)
    table = torch.from_numpy(r.standard_normal((rows, d)).astype(np.float32)).to(cuda_device)
    idx = r.integers(0, rows, n).astype(idx_dtype)
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  gather_rows_ref(table, torch.from_numpy(idx)).cpu().numpy())


@pytest.mark.cuda
def test_cuda_kernels_refuse_what_they_do_not_take(cuda_device):
    h = torch.zeros((2, 3, 4, 5), device=cuda_device)
    mask = torch.ones((2, 3, 4), dtype=torch.bool, device=cuda_device)
    w = torch.zeros((2, 5, 6), device=cuda_device)
    b = torch.zeros((2, 6), device=cuda_device)
    with pytest.raises(ValueError):
        stacked_mean_linear(h.double(), mask, w, b, np.array([0, 1]))
    with pytest.raises(ValueError):
        stacked_mean_linear(torch.zeros((2, 3, 5, 4), device=cuda_device).transpose(2, 3),
                            mask, w, b, np.array([0, 1]))
    with pytest.raises(ValueError):
        stacked_mean_linear(h, mask, w.cpu(), b, np.array([0, 1]))
    with pytest.raises(ValueError):
        stacked_mean_linear(h, mask, w, b, np.array([0, 1]), block_n=64, block_out=128)
    with pytest.raises(ValueError, match="int32"):
        stacked_mean_linear(h, mask, w, b, torch.tensor([0, 1], device=cuda_device))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((4, 3), device=cuda_device).t(), np.array([0]))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((4, 3), device=cuda_device), torch.zeros(1, dtype=torch.long,
                                                                          device=cuda_device))


# (rb, n, f, d_in, d_out, U) of the backward: the ragged shapes above and
# the training path's two levels at batch 1024 (leaf: d_in = d_pad = 128)
DH_SHAPES = ML_SHAPES[:5] + [(3, 1024, 4, 64, 64, 3), (6, 4096, 3, 128, 64, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("rb,n,f,di,do,U", DH_SHAPES)
def test_cuda_stacked_mean_linear_dh_matches_plain(cuda_device, rb, n, f, di, do, U):
    _, mask, w, _, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=rb * n)
    g = np.random.default_rng(do).standard_normal((rb, n, do)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (g, mask, w)]
    before = kops.KERNELS["stacked_mean_linear_dh"].launches
    got = stacked_mean_linear_dh(*args, slot_u)
    torch.cuda.synchronize()
    assert kops.KERNELS["stacked_mean_linear_dh"].launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               stacked_mean_linear_dh_ref(*args, slot_u).cpu().numpy(), **TOL)
    staged = stacked_mean_linear_dh(*args, stage_slot_u(slot_u, U, cuda_device))
    assert torch.equal(staged, got)


@pytest.mark.cuda
@pytest.mark.parametrize("rb,n,f,di,do,U", ML_SHAPES[:4])
def test_cuda_autograd_matches_cpu(cuda_device, rb, n, f, di, do, U):
    """dh / dw / db through the autograd Function on the card (both
    kernels) against the same Function on the CPU (plain versions)."""
    h, mask, w, b, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=n)
    g = np.random.default_rng(rb).standard_normal((rb, n, do)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        th, tw, tb = (torch.from_numpy(a).to(dev).requires_grad_(True) for a in (h, w, b))
        out = stacked_mean_linear(th, torch.from_numpy(mask).to(dev), tw, tb, slot_u)
        grads.append([x.cpu().numpy() for x in torch.autograd.grad(
            out, (th, tw, tb), torch.from_numpy(g).to(dev))])
    for name, a, c in zip(("dh", "dw", "db"), grads[1], grads[0]):
        np.testing.assert_allclose(a, c, **TOL, err_msg=name)


@pytest.mark.cuda
def test_cuda_dh_refuses_what_it_does_not_take(cuda_device):
    g = torch.zeros((2, 3, 6), device=cuda_device)
    mask = torch.ones((2, 3, 4), dtype=torch.bool, device=cuda_device)
    w = torch.zeros((2, 5, 6), device=cuda_device)
    with pytest.raises(ValueError):
        stacked_mean_linear_dh(g.double(), mask, w, np.array([0, 1]))
    with pytest.raises(ValueError):
        stacked_mean_linear_dh(g, mask, w.cpu(), np.array([0, 1]))
    with pytest.raises(ValueError, match="divide"):
        stacked_mean_linear_dh(g, mask, w, np.array([0, 1]), block_in=48)
    with pytest.raises(ValueError):
        stacked_mean_linear_dh(g, mask, w, np.array([0, 1]), block_n=4096, block_in=256)
    with pytest.raises(IndexError):
        stacked_mean_linear_dh(g, mask, w, np.array([0, 2]))


@pytest.mark.cuda
def test_cuda_block_override_reaches_only_the_forward(cuda_device):
    """kernels.block_* overrides that the forward kernel takes but the dh
    kernel would refuse (block_n 64 at block_in 128) train as the defaults do:
    the backward launches the dh kernel at its own default blocks."""
    rb, n, f, di, do, U = 6, 200, 3, 128, 64, 6
    h, mask, w, b, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=11)
    g = np.random.default_rng(12).standard_normal((rb, n, do)).astype(np.float32)
    grads = []
    for opts in (None, KernelConfig(block_n=64, block_in=128)):
        th, tw, tb = (torch.from_numpy(a).to(cuda_device).requires_grad_(True)
                      for a in (h, w, b))
        before = kops.KERNELS["stacked_mean_linear_dh"].launches
        out = stacked_agg(get_relation_module("rgcn"), {"w": tw, "b": tb},
                          {"relation": slot_u}, th, None,
                          torch.from_numpy(mask).to(cuda_device), opts=opts)
        grads.append([x.cpu().numpy() for x in torch.autograd.grad(
            out, (th, tw, tb), torch.from_numpy(g).to(cuda_device))])
        torch.cuda.synchronize()
        assert kops.KERNELS["stacked_mean_linear_dh"].launches == before + 1
    for name, a, c in zip(("dh", "dw", "db"), grads[1], grads[0]):
        np.testing.assert_allclose(a, c, **TOL, err_msg=name)
