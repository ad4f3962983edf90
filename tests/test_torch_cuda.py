"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device
(the hand-written kernels have no CPU mode).  The file imports no JAX, so
it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: fp32, atol 1e-5 / rtol 1e-5 for the aggregation (the kernel sums
the fanout and the contraction in its own order); the gather is exact.
TF32 is switched off so the plain version's matmul runs in full fp32.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_ref
from repro_torch.kernels.stacked_relation_agg import (
    stacked_mean_linear,
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
