"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device
(the hand-written kernels have no CPU mode).  The file imports no JAX, so
it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: fp32, atol 1e-5 / rtol 1e-5 for the aggregations and their
backwards (the kernels sum the fanout and the contraction in their own
order; the attention epilogue also applies HGT's per-head transforms once
per row instead of once per neighbour); the gather is exact, and its
gradient (a scatter-add over duplicate indices) within 1e-5 of the CPU's.  Flash
attention (kernel 8): the reference's tolerances, fp32 2e-5 and bf16 3e-2
(the kernel keeps fp32 logits, the plain version rounds them to bf16); the
reduced LMs on the card within 1e-4 of the CPU (jamba block by block).
TF32 is switched off so the plain version's matmul runs in full fp32.
"""

import numpy as np
import pytest
import torch

from repro_torch.api.config import KernelConfig
from repro_torch.core.relmod import get_relation_module
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_ref
from repro_torch.kernels.relation_agg import ops as ra_ops
from repro_torch.kernels.stacked_relation_agg import ops as sra
from repro_torch.kernels.stacked_relation_agg import (
    FanoutTooWideError,
    attn_epilogue_forward,
    attn_slots,
    stacked_agg,
    stacked_attn_dh,
    stacked_attn_dh_ref,
    stacked_attn_epilogue_ref,
    stacked_mean_linear,
    stacked_mean_linear_dh,
    stacked_mean_linear_dh_ref,
    stacked_mean_linear_ref,
    stacked_softmax_combine,
    stacked_softmax_combine_ref,
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


# kernel 7's sweep: d (the parametrization) x n in {1, 7, 874, 100000} x
# int32 / int64 indices, also into an output 4 bytes off the 16-byte grid
GATHER_D = (1, 3, 4, 63, 64, 65, 128, 200)


@pytest.mark.cuda
@pytest.mark.parametrize("d", GATHER_D)
def test_cuda_gather_rows_sweep_is_exact(cuda_device, d):
    from repro_torch.kernels.gather_rows.ops import launch_kernel

    for n in (1, 7, 874, 100000):
        for idx_dtype in (np.int32, np.int64):
            r = np.random.default_rng(d * n)
            table = torch.from_numpy(r.standard_normal((5000, d)).astype(np.float32)).to(
                cuda_device)
            idx = r.integers(0, 5000, n).astype(idx_dtype)
            want = gather_rows_ref(table, torch.from_numpy(idx))
            got = gather_rows(table, idx)
            off = torch.empty(n * d + 1, device=cuda_device)[1:].view(n, d)
            launch_kernel(table, torch.from_numpy(idx).to(cuda_device), off)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, idx_dtype)
            assert torch.equal(off, want), (n, idx_dtype, "unaligned out")


@pytest.mark.cuda
def test_cuda_stream_is_the_capture_stream_under_graph_capture(cuda_device):
    """Every ctypes launch takes its stream from kops.cuda_stream: the
    current stream, and inside torch.cuda.graph the capture stream, so a
    captured launch lands in the graph (and replays the gather)."""
    assert kops.cuda_stream(cuda_device) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert kops.cuda_stream(cuda_device) == side.cuda_stream
    table = torch.arange(40, dtype=torch.float32, device=cuda_device).reshape(10, 4)
    idx = torch.tensor([3, 1, 3], device=cuda_device)
    out = torch.zeros((3, 4), device=cuda_device)
    from repro_torch.kernels.gather_rows.ops import launch_kernel

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        inside = kops.cuda_stream(cuda_device)
        capture = torch.cuda.current_stream().cuda_stream
        launch_kernel(table, idx, out)
    assert inside == capture != torch.cuda.default_stream().cuda_stream
    assert not bool(out.any())  # captured, not run
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, table[idx])


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
    with pytest.raises(TypeError):  # the kernel's tile is fixed: no block sizes
        stacked_mean_linear(h, mask, w, b, np.array([0, 1]), block_n=64, block_out=128)
    with pytest.raises(ValueError, match="int32"):
        stacked_mean_linear(h, mask, w, b, torch.tensor([0, 1], device=cuda_device))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((4, 3), device=cuda_device).t(), np.array([0]))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((4, 3), device=cuda_device), torch.zeros(1, dtype=torch.long,
                                                                          device=cuda_device))
    # the gather's positions are 32-bit: an output of 2^32 - 256 floats or
    # more is refused before any launch (a stride-0 view stands in for it)
    from repro_torch.kernels.gather_rows.ops import launch_kernel

    wide = torch.zeros((1, 1 << 20), device=cuda_device)
    for n in (4096, 4097):
        big = torch.empty(1, device=cuda_device).expand(n, 1 << 20)
        with pytest.raises(kops.KernelLaunchError):
            launch_kernel(wide, torch.zeros(n, dtype=torch.int32, device=cuda_device), big)
    # the attention epilogue's tile is fixed in its source: its raw launch
    # takes no rows per block and no d_in chunk
    h4, mask4, ops4, us4, kw4 = _attn_case(2, 5, 3, 6, 2, 4, 2, "hgt", 0, cuda_device)
    out4 = torch.empty((2, 5, 8), device=cuda_device)
    raw = (h4, mask4.view(torch.uint8), ops4["qv"], None, ops4["we"], ops4["wv"], ops4["pe"],
           ops4["pv"], us4, out4, None, None, 2, 4, kw4["scale"], None)
    for extra in (dict(rows=1), dict(block_in=32), dict(rows=1, block_in=32)):
        with pytest.raises(TypeError):
            sra.launch_attn_epilogue(*raw, **extra)
    sra.launch_attn_epilogue(*raw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out4.cpu().numpy(), stacked_attn_epilogue_ref(
        h4, mask4, **ops4, us=us4, num_heads=2, head_dim=4, **kw4).cpu().numpy(), **TOL)
    # kernel 3 picks its rows per block from the head width itself: its raw
    # launch takes the operands and nothing else
    e3 = torch.zeros((2, 5, 3, 2), device=cuda_device)
    v3 = torch.ones((2, 5, 3, 2, 4), device=cuda_device)
    m3 = torch.ones((2, 5, 3), dtype=torch.uint8, device=cuda_device)
    out3 = torch.empty((2, 5, 8), device=cuda_device)
    with pytest.raises(TypeError):
        sra.launch_softmax_combine(e3, m3, v3, out3, 32)
    with pytest.raises(TypeError):
        sra.launch_softmax_combine(e3, m3, v3, out3, rows=32)
    sra.launch_softmax_combine(e3, m3, v3, out3)
    torch.cuda.synchronize()
    assert torch.equal(out3, torch.ones_like(out3))  # equal logits: the mean of ones
    with pytest.raises(ValueError, match="float32"):
        sra.softmax_combine_forward(e3.double(), m3, v3.double())
    with pytest.raises(ValueError, match="unit stride"):
        sra.softmax_combine_forward(
            e3, m3, torch.zeros((2, 5, 3, 4, 2), device=cuda_device).transpose(3, 4))
    with pytest.raises(ValueError, match="contiguous"):
        sra.softmax_combine_forward(e3, torch.ones((2, 3, 5), dtype=torch.uint8,
                                                   device=cuda_device).transpose(1, 2), v3)


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
    with pytest.raises(ValueError, match="uint8"):
        stacked_mean_linear_dh(g, mask.float(), w, np.array([0, 1]))
    with pytest.raises(ValueError, match="shapes"):
        stacked_mean_linear_dh(g, mask[:, :2], w, np.array([0, 1]))
    with pytest.raises(ValueError, match="does not match"):
        stacked_mean_linear_dh(g, mask, w[..., :5], np.array([0, 1]))
    with pytest.raises(ValueError, match="int32"):
        stacked_mean_linear_dh(g, mask, w, torch.tensor([0, 1], device=cuda_device))
    with pytest.raises(TypeError):  # the kernel's tile is fixed: no block sizes
        stacked_mean_linear_dh(g, mask, w, np.array([0, 1]), block_in=128)
    with pytest.raises(IndexError):
        stacked_mean_linear_dh(g, mask, w, np.array([0, 2]))


# kernel 2's ragged cases: n x d_in, each over d_out in {1, 65, 100} and
# f in {1, 3, 16}; five slots on two stack rows (shared rows), every 7th row
# fully masked
DH_RAGGED_N = (1, 1000, 4097)
DH_RAGGED_DIN = (33, 100, 128, 789)


@pytest.mark.cuda
@pytest.mark.parametrize("n", DH_RAGGED_N)
@pytest.mark.parametrize("di", DH_RAGGED_DIN)
def test_cuda_dh_ragged_matches_plain(cuda_device, n, di):
    for do in (1, 65, 100):
        for f in (1, 3, 16):
            r = np.random.default_rng(n * di + do * f)
            g = torch.from_numpy(r.standard_normal((5, n, do)).astype(np.float32)).to(cuda_device)
            mask = r.random((5, n, f)) > 0.3
            mask[:, ::7, :] = False
            mask = torch.from_numpy(mask).to(cuda_device)
            w = torch.from_numpy((r.standard_normal((2, di, do)) * 0.1).astype(np.float32)).to(
                cuda_device)
            slot_u = np.array([0, 1, 1, 0, 1])
            want = stacked_mean_linear_dh_ref(g, mask, w, slot_u)
            got = stacked_mean_linear_dh(g, mask, w, slot_u)
            staged = stacked_mean_linear_dh(g, mask, w, stage_slot_u(slot_u, 2, cuda_device))
            torch.cuda.synchronize()
            assert torch.equal(got, staged), (n, di, do, f)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL,
                                       err_msg=str((n, di, do, f)))


@pytest.mark.cuda
def test_cuda_dh_is_the_same_bit_for_bit(cuda_device):
    """No atomics: two launches on the same inputs agree bit for bit."""
    _, mask, w, _, slot_u = _mean_linear_case(6, 4096, 3, 128, 64, 6, seed=3)
    g = np.random.default_rng(4).standard_normal((6, 4096, 64)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (g, mask, w)]
    assert torch.equal(stacked_mean_linear_dh(*args, slot_u), stacked_mean_linear_dh(*args, slot_u))


@pytest.mark.cuda
def test_cuda_block_override_reaches_only_the_forward(cuda_device):
    """kernels.block_* reach no launch on the card: both kernels' tiles are
    fixed (their wrappers take no block sizes), and the outputs and
    gradients with the fields set equal those without, bit for bit."""
    rb, n, f, di, do, U = 6, 200, 3, 128, 64, 6
    h, mask, w, b, slot_u = _mean_linear_case(rb, n, f, di, do, U, seed=11)
    g = np.random.default_rng(12).standard_normal((rb, n, do)).astype(np.float32)
    dev = [torch.from_numpy(a).to(cuda_device) for a in (h, mask, w, b, g)]
    with pytest.raises(TypeError):
        stacked_mean_linear_dh(dev[4], dev[1], dev[2], slot_u, block_n=64)
    with pytest.raises(TypeError):
        stacked_mean_linear(*dev[:4], slot_u, block_in=64)
    results = []
    for opts in (None, KernelConfig(block_n=64, block_in=128)):
        th, tw, tb = (torch.from_numpy(a).to(cuda_device).requires_grad_(True)
                      for a in (h, w, b))
        before = {k: kops.KERNELS[k].launches
                  for k in ("stacked_mean_linear", "stacked_mean_linear_dh")}
        out = stacked_agg(get_relation_module("rgcn"), {"w": tw, "b": tb},
                          {"relation": slot_u}, th, None, dev[1], opts=opts)
        results.append([out.detach()] + list(torch.autograd.grad(out, (th, tw, tb), dev[4])))
        torch.cuda.synchronize()
        for k, v in before.items():
            assert kops.KERNELS[k].launches == v + 1, k
    for name, a, c in zip(("out", "dh", "dw", "db"), results[1], results[0]):
        assert torch.equal(a, c), name


def _ragged_mean_linear_case(n, f, di, do, seed, device):
    """Kernel 1's ragged case: five slots on two stack rows, every 7th row
    fully masked; h drawn on the card from the seed (up to 1 GB)."""
    r = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((5, n, f, di), generator=gen, device=device)
    mask = r.random((5, n, f)) > 0.3
    mask[:, ::7, :] = False
    w = torch.from_numpy((r.standard_normal((2, di, do)) * 0.1).astype(np.float32)).to(device)
    b = torch.from_numpy((r.standard_normal((2, do)) * 0.1).astype(np.float32)).to(device)
    return h, torch.from_numpy(mask).to(device), w, b, np.array([0, 1, 1, 0, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", DH_RAGGED_N)
@pytest.mark.parametrize("di", DH_RAGGED_DIN)
def test_cuda_mean_linear_ragged_matches_plain(cuda_device, n, di):
    """Kernel 1 at n x d_in, each over d_out in {1, 65, 100} and f in
    {1, 3, 16} (the f = 1 and f > 1 paths, every rows-per-block choice)."""
    for do in (1, 65, 100):
        for f in (1, 3, 16):
            h, mask, w, b, slot_u = _ragged_mean_linear_case(n, f, di, do, n * di + do * f,
                                                             cuda_device)
            want = stacked_mean_linear_ref(h, mask, w, b, slot_u)
            got = stacked_mean_linear(h, mask, w, b, slot_u)
            staged = stacked_mean_linear(h, mask, w, b, stage_slot_u(slot_u, 2, cuda_device))
            torch.cuda.synchronize()
            assert torch.equal(got, staged), (n, di, do, f)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL,
                                       err_msg=str((n, di, do, f)))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 16])
def test_cuda_mean_linear_is_the_same_bit_for_bit(cuda_device, f):
    """No atomics: two launches on the same inputs agree bit for bit (the
    q-side leaf at f = 1, R-GCN's leaf at f = 3, a serving block at f = 16)."""
    rb, n = (6, 4096) if f < 16 else (3, 1024)
    h, mask, w, b, slot_u = _mean_linear_case(rb, n, f, 128, 64, rb, seed=f)
    args = [torch.from_numpy(a).to(cuda_device) for a in (h, mask, w, b)]
    assert torch.equal(stacked_mean_linear(*args, slot_u), stacked_mean_linear(*args, slot_u))


# --------------------------------------------------------------------------
# the attention kernels (R-GAT, HGT)
# --------------------------------------------------------------------------

# (rb, n, f, d_in, nh, dh, U): ragged n and d_in (789: donor's features),
# f in {1, 3, 16, 64, 100}, H = 72 (two column passes), the training leaf
# and the serving block
ATTN_SHAPES = [
    (5, 19, 4, 23, 4, 8, 3),
    (4, 33, 1, 789, 4, 16, 3),
    (3, 130, 3, 129, 4, 16, 2),
    (2, 7, 16, 37, 2, 8, 2),
    (3, 45, 64, 100, 4, 16, 2),
    (2, 9, 100, 33, 4, 16, 2),
    (3, 50, 5, 70, 3, 24, 2),
    (6, 4096, 3, 128, 4, 16, 6),
    (2, 1024, 16, 128, 4, 16, 2),
]


def _attn_case(rb, n, f, di, nh, dh, U, variant, seed, device):
    """R-GAT operands (eb, slope 0.2, values shared with the logits
    projection, a per-slot qv expanded over the destinations) or HGT's
    (separate wv, pe/pv transforms, materialized qv, scale 1/sqrt(dh)),
    with shared stack rows and fully masked rows."""
    r = np.random.default_rng(seed)
    H = nh * dh
    t = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (r.standard_normal(s) * sc).astype(np.float32)).to(device)
    h = t(rb, n, f, di)
    mask = r.random((rb, n, f)) > 0.3
    mask[0, 0] = False
    mask[-1, n // 2] = False
    slots = [r.integers(0, U, rb) for _ in range(3)]
    slots[0][: min(rb, 2)] = 0
    if variant == "rgat":
        ops = dict(qv=t(rb, 1, H, sc=0.1).expand(rb, n, H), eb=t(rb, n, nh), we=t(U, di, H, sc=0.1),
                   wv=None, pe=None, pv=None)
        kw = dict(scale=1.0, slope=0.2)
    else:
        ops = dict(qv=t(rb, n, H, sc=0.3), eb=None, we=t(U, di, H, sc=0.1),
                   wv=t(U, di, H, sc=0.1), pe=t(U, nh, dh, dh, sc=0.3),
                   pv=t(U, nh, dh, dh, sc=0.3))
        kw = dict(scale=float(1 / np.sqrt(dh)), slope=None)
    us = attn_slots(*slots, (U, U, U), rb, device)
    return h, torch.from_numpy(mask).to(device), ops, us, kw


@pytest.mark.cuda
@pytest.mark.parametrize("with_res", [False, True], ids=["out", "residuals"])
@pytest.mark.parametrize("variant", ["rgat", "hgt"])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_cuda_attn_epilogue_matches_plain(cuda_device, shape, variant, with_res):
    rb, n, f, di, nh, dh, U = shape
    h, mask, ops, us, kw = _attn_case(*shape, variant, n + f, cuda_device)
    before = kops.KERNELS["stacked_attn_epilogue"].launches
    got = attn_epilogue_forward(h, mask, **ops, us=us, num_heads=nh, head_dim=dh,
                                with_residuals=with_res, **kw)
    torch.cuda.synchronize()
    assert kops.KERNELS["stacked_attn_epilogue"].launches == before + 1
    want = stacked_attn_epilogue_ref(h, mask, **ops, us=us, num_heads=nh, head_dim=dh,
                                     with_residuals=with_res, **kw)
    got, want = (got, want) if with_res else ((got,), (want,))
    for name, a, b in zip(("out", "z0", "v0"), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL, err_msg=name)
    if with_res and variant == "rgat":
        assert got[2] is got[1]


@pytest.mark.cuda
@pytest.mark.parametrize("with_res", [False, True], ids=["out", "residuals"])
@pytest.mark.parametrize("variant,f", [("hgt", 392), ("rgat", 792)])
def test_cuda_attn_epilogue_at_the_fanout_limits(cuda_device, variant, f, with_res):
    """The widest rows the kernel promises at H = 64, nh = 4 (the lean
    layout: one row a block, 16-pair passes) match the plain version; one
    neighbour more raises FanoutTooWideError before any launch."""
    h, mask, ops, us, kw = _attn_case(2, 5, f, 128, 4, 16, 2, variant, f, cuda_device)
    got = attn_epilogue_forward(h, mask, **ops, us=us, num_heads=4, head_dim=16,
                                with_residuals=with_res, **kw)
    want = stacked_attn_epilogue_ref(h, mask, **ops, us=us, num_heads=4, head_dim=16,
                                     with_residuals=with_res, **kw)
    torch.cuda.synchronize()
    got, want = (got, want) if with_res else ((got,), (want,))
    for name, a, b in zip(("out", "z0", "v0"), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL, err_msg=name)
    h2, mask2, ops2, us2, kw2 = _attn_case(1, 1, f + 1, 128, 4, 16, 2, variant, 0, cuda_device)
    before = kops.KERNELS["stacked_attn_epilogue"].launches
    with pytest.raises(FanoutTooWideError, match=f"fanout {f + 1}"):
        attn_epilogue_forward(h2, mask2, **ops2, us=us2, num_heads=4, head_dim=16, **kw2)
    assert kops.KERNELS["stacked_attn_epilogue"].launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["rgat", "hgt"])
@pytest.mark.parametrize("nh,dh", [(1, 16), (3, 8), (5, 8), (2, 20), (3, 24), (8, 16)])
def test_cuda_attn_epilogue_ragged_heads_match_plain(cuda_device, variant, nh, dh):
    """H = 16 to 128, H not a multiple of 64 (column passes with a ragged
    last one) and H > 64, at ragged n, f and d_in, with residuals."""
    for n, f, di in ((37, 3, 70), (9, 16, 128), (5, 70, 33)):
        h, mask, ops, us, kw = _attn_case(3, n, f, di, nh, dh, 2, variant, nh * dh + f,
                                          cuda_device)
        got = attn_epilogue_forward(h, mask, **ops, us=us, num_heads=nh, head_dim=dh,
                                    with_residuals=True, **kw)
        want = stacked_attn_epilogue_ref(h, mask, **ops, us=us, num_heads=nh, head_dim=dh,
                                         with_residuals=True, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "z0", "v0"), got, want):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL,
                                       err_msg=f"{name} n={n} f={f} d_in={di}")


@pytest.mark.cuda
@pytest.mark.parametrize("with_res", [False, True], ids=["out", "residuals"])
@pytest.mark.parametrize("variant", ["rgat", "hgt"])
def test_cuda_attn_epilogue_is_the_same_bit_for_bit(cuda_device, variant, with_res):
    """No atomics: two launches at the serving block and at the training
    leaf agree bit for bit, outputs and residuals."""
    for shape in ((2, 1024, 16, 128, 4, 16, 2), (6, 4096, 3, 128, 4, 16, 6)):
        h, mask, ops, us, kw = _attn_case(*shape, variant, 9, cuda_device)
        a, b = (attn_epilogue_forward(h, mask, **ops, us=us, num_heads=4, head_dim=16,
                                      with_residuals=with_res, **kw) for _ in range(2))
        a, b = (a, b) if with_res else ((a,), (b,))
        for x, y in zip(a, b):
            assert torch.equal(x, y), shape


@pytest.mark.cuda
def test_cuda_attn_rows_shrink_with_fanout(cuda_device):
    """The rows per block the C entry point's layout takes (exported as
    stacked_attn_epilogue_rows): 64 // f whole rows in the fixed 64-pair
    tile, one row in the lean layout where the tile's shared memory binds,
    and 0 (refused) exactly past the wrapper's attn_max_fanout."""
    import ctypes

    from repro_torch.kernels.build import load

    fn = load("stacked_attn_epilogue").stacked_attn_epilogue_rows
    fn.argtypes = [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    for (f, d_in, nh, dh, two), want in (
            ((1, 789, 4, 16, 0), 64), ((3, 128, 4, 16, 0), 21), ((3, 128, 4, 16, 1), 21),
            ((4, 64, 4, 16, 1), 16), ((16, 128, 4, 16, 1), 4), ((100, 128, 4, 16, 1), 1),
            ((392, 128, 4, 16, 1), 1), ((393, 128, 4, 16, 1), 0),
            ((792, 128, 4, 16, 0), 1), ((793, 128, 4, 16, 0), 0),
            ((16, 128, 8, 64, 1), 1)):  # the lean layout: the tile's memory binds
        assert fn(f, d_in, nh, dh, two, two) == want, (f, d_in, nh, dh, two)
    for f in (1, 2, 3, 4, 5, 16, 17, 33, 49, 50, 64, 65, 100, 300, 392, 393, 792, 793, 2000):
        for d_in in (1, 33, 64, 128, 129, 789):
            for nh, dh in ((4, 16), (2, 4), (8, 64), (3, 24)):
                for two, post in ((False, False), (True, True)):
                    fits = f <= sra.attn_max_fanout(nh, dh, two, post)
                    assert (fn(f, d_in, nh, dh, int(two), int(post)) > 0) == fits, \
                        (f, d_in, nh, dh, two)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["rgat", "hgt"])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_cuda_attn_dh_matches_plain(cuda_device, shape, variant):
    rb, n, f, di, nh, dh, U = shape
    _, _, ops, us, _ = _attn_case(*shape, variant, rb + di, cuda_device)
    r = np.random.default_rng(f)
    g = lambda: torch.from_numpy(  # noqa: E731
        r.standard_normal((rb, n, f, nh * dh)).astype(np.float32)).to(cuda_device)
    dz, dv = g(), (None if variant == "rgat" else g())
    before = kops.KERNELS["stacked_attn_dh"].launches
    got = stacked_attn_dh(dz, dv, ops["we"], ops["wv"], us)
    torch.cuda.synchronize()
    assert kops.KERNELS["stacked_attn_dh"].launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), stacked_attn_dh_ref(
        dz, dv, ops["we"], ops["wv"], us).cpu().numpy(), **TOL)


# kernel 5's ragged cases: (n, f) with n * f in {1, 3000, 12291} x d_in,
# each over H in {15, 64, 72, 130}, with and without dv; five slots sharing
# stack rows
ADH_RAGGED_NF = [(1, 1), (1000, 3), (4097, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("nf", ADH_RAGGED_NF)
@pytest.mark.parametrize("di", DH_RAGGED_DIN)
def test_cuda_attn_dh_ragged_matches_plain(cuda_device, nf, di):
    n, f = nf
    for H in (15, 64, 72, 130):
        for two in (False, True):
            r = np.random.default_rng(n * di + H + two)
            t = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
                (r.standard_normal(s) * sc).astype(np.float32)).to(cuda_device)
            dz, dv = t(5, n, f, H), (t(5, n, f, H) if two else None)
            we, wv = t(2, di, H, sc=0.1), (t(3, di, H, sc=0.1) if two else None)
            us = attn_slots(np.array([0, 0, 1, 0, 1]), np.array([2, 0, 2, 1, 0]) % (2 + two),
                            np.zeros(5, np.int64), (2, 2 + two, 1), 5, cuda_device)
            got = stacked_attn_dh(dz, dv, we, wv, us)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(),
                                       stacked_attn_dh_ref(dz, dv, we, wv, us).cpu().numpy(),
                                       **TOL, err_msg=str((n, f, di, H, two)))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["rgat", "hgt"])
def test_cuda_attn_dh_is_the_same_bit_for_bit(cuda_device, variant):
    """No atomics: two launches at the training leaf agree bit for bit."""
    _, _, ops, us, _ = _attn_case(6, 4096, 3, 128, 4, 16, 6, variant, 5, cuda_device)
    r = np.random.default_rng(6)
    g = lambda: torch.from_numpy(  # noqa: E731
        r.standard_normal((6, 4096, 3, 64)).astype(np.float32)).to(cuda_device)
    dz, dv = g(), (None if variant == "rgat" else g())
    assert torch.equal(stacked_attn_dh(dz, dv, ops["we"], ops["wv"], us),
                       stacked_attn_dh(dz, dv, ops["we"], ops["wv"], us))


def _module_inputs(model, rb, n, f, di, dd, seed):
    from repro_torch.core.relmod import ShapeCtx

    r = np.random.default_rng(seed)
    mod = get_relation_module(model)
    sc = ShapeCtx(64, 4, 16, di, dd)
    U_of = {s: u for s, u in zip(mod.scopes, (3, 2, 5))}
    stacks = {s.name: (r.standard_normal((U_of[s.scope],) + tuple(s.shape(sc))) * 0.1
                       ).astype(np.float32) for s in mod.specs}
    slot_u = {s: np.where(np.arange(rb) < 2, 0, r.integers(0, U_of[s], rb))
              for s in mod.scopes}
    h = r.standard_normal((rb, n, f, di)).astype(np.float32)
    q = r.standard_normal((rb, n, dd)).astype(np.float32)
    mask = r.random((rb, n, f)) > 0.3
    mask[0, 1] = False
    return mod, stacks, slot_u, h, q, mask


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rgat", "hgt"])
@pytest.mark.parametrize("rb,n,f,di,dd", [(5, 19, 4, 23, 17), (6, 700, 3, 128, 128)])
def test_cuda_attention_autograd_matches_cpu(cuda_device, model, rb, n, f, di, dd):
    """The fused path's forward and every gradient (stacks, h, q) through
    _StackedAttnEpilogue on the card (kernels 4 and 5, the q side through
    kernels 1 and 2) against the same Function on the CPU (plain versions)."""
    mod, stacks, slot_u, h, q, mask = _module_inputs(model, rb, n, f, di, dd, seed=rb * f)
    g = np.random.default_rng(n).standard_normal((rb, n, 64)).astype(np.float32)
    res = []
    for dev in ("cpu", cuda_device):
        ts = {k: torch.from_numpy(v).to(dev).requires_grad_(True) for k, v in stacks.items()}
        th, tq = (torch.from_numpy(a).to(dev).requires_grad_(True) for a in (h, q))
        out = stacked_agg(mod, ts, slot_u, th, tq, torch.from_numpy(mask).to(dev))
        grads = torch.autograd.grad(out, [*ts.values(), th, tq], torch.from_numpy(g).to(dev))
        res.append([out.detach().cpu().numpy()] + [x.cpu().numpy() for x in grads])
    # the stack gradients are reductions over every (row, neighbour) pair
    # (2100 at the larger shape) that torch runs on both devices, in
    # cuBLAS's order on the card; their fp32 rounding grows with the terms'
    # magnitude, so each array is held to 1e-5 of its largest entry
    names = ["out", *stacks, "h", "q"]
    for name, a, c in zip(names, res[1], res[0]):
        np.testing.assert_allclose(a, c, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(1.0, float(np.abs(c).max())),
                                   err_msg=name)


@pytest.mark.cuda
def test_cuda_attention_kernels_refuse_what_they_do_not_take(cuda_device):
    h, mask, ops, us, kw = _attn_case(2, 5, 3, 6, 2, 4, 2, "hgt", 0, cuda_device)

    def call(**k):
        args = {"h": h, "mask": mask, **ops, "us": us, **k}
        return attn_epilogue_forward(**args, num_heads=2, head_dim=4, **kw)

    with pytest.raises(ValueError, match="float32"):
        call(h=h.double())
    with pytest.raises(ValueError, match="contiguous"):
        call(h=torch.zeros((2, 5, 6, 3), device=cuda_device).transpose(2, 3))
    with pytest.raises(ValueError, match="unit stride"):
        call(qv=torch.zeros((2, 8, 5), device=cuda_device).transpose(1, 2))
    with pytest.raises(ValueError):
        call(we=ops["we"].cpu())
    with pytest.raises(ValueError, match="us must be"):
        call(us=us.cpu())
    with pytest.raises(ValueError, match="us must be"):
        call(us=us.long())
    # one row of 3000 neighbours at 2 heads x 4 needs 4 * (3000 * 18 + 16) bytes
    # beside the staging tiles: over the 227 KB of one block
    with pytest.raises(FanoutTooWideError):
        attn_epilogue_forward(torch.zeros((1, 1, 3000, 6), device=cuda_device),
                              torch.ones((1, 1, 3000), dtype=torch.bool, device=cuda_device),
                              qv=torch.zeros((1, 1, 8), device=cuda_device), eb=None,
                              we=ops["we"], wv=ops["wv"], pe=ops["pe"], pv=ops["pv"],
                              us=us[:, :1].contiguous(), num_heads=2, head_dim=4)
    dz = torch.zeros((2, 5, 3, 8), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        stacked_attn_dh(dz.double(), None, ops["we"], None, us)
    with pytest.raises(ValueError, match="contiguous"):
        stacked_attn_dh(torch.zeros((2, 5, 8, 3), device=cuda_device).transpose(2, 3), None,
                        ops["we"], None, us)
    with pytest.raises(ValueError, match="shapes"):
        stacked_attn_dh(dz, dz, ops["we"], None, us)
    with pytest.raises(IndexError):
        attn_slots(np.array([0, 2]), np.array([0, 1]), np.array([0, 1]), (2, 2, 2), 2,
                   cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rgat", "hgt"])
def test_cuda_attention_never_reaches_a_plain_version(cuda_device, model, monkeypatch):
    """With every plain version made to raise, the fused path's forward and
    backward on CUDA tensors still run (through kernels 1, 2, 4 and 5), and
    so do fuse_epilogue=False's (through kernel 3, launched once)."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("stacked_attn_epilogue_ref", "stacked_attn_dh_ref", "stacked_mean_linear_ref",
                 "stacked_mean_linear_dh_ref", "stacked_softmax_combine_ref", "stacked_agg_ref"):
        monkeypatch.setattr(sra, name, refuse)
    mod, stacks, slot_u, h, q, mask = _module_inputs(model, 4, 50, 3, 40, 40, seed=3)
    ts = {k: torch.from_numpy(v).to(cuda_device).requires_grad_(True) for k, v in stacks.items()}
    th, tq = (torch.from_numpy(a).to(cuda_device).requires_grad_(True) for a in (h, q))
    tm = torch.from_numpy(mask).to(cuda_device)
    kops.reset_launch_counts()
    out = stacked_agg(mod, ts, slot_u, th, tq, tm)
    torch.autograd.grad(out.sum(), [*ts.values(), th, tq])
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kops.KERNELS.items()}
    assert launches["stacked_attn_epilogue"] == 1 and launches["stacked_attn_dh"] == 1
    assert launches["stacked_mean_linear"] == 1 and launches["stacked_mean_linear_dh"] == 1
    kops.reset_launch_counts()
    out = stacked_agg(mod, ts, slot_u, th, tq, tm, opts=KernelConfig(fuse_epilogue=False))
    torch.autograd.grad(out.sum(), [*ts.values(), th, tq])
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kops.KERNELS.items()}
    assert launches["stacked_softmax_combine"] == 1
    assert launches["stacked_attn_epilogue"] == 0 and launches["stacked_attn_dh"] == 0


# --------------------------------------------------------------------------
# kernel 6 (relation_agg) and kernel 3 (stacked_softmax_combine)
# --------------------------------------------------------------------------

# (n, f, d_in, d_out): tests/test_kernels.py's AGG_SHAPES, one row, and the
# dict-form raf executor's R-GCN shapes at batch 1024
AGG_SHAPES = [(200, 25, 128, 64), (64, 20, 64, 64), (64, 4, 789, 64), (128, 20, 64, 349),
              (5, 3, 7, 16), (256, 10, 1024, 64), (1, 1, 1, 1), (1024, 4, 64, 64),
              (4096, 3, 128, 64), (4096, 3, 64, 64)]


def _relation_agg_case(n, f, di, do, device, misaligned=False):
    """(h, mask, w, b) on ``device``, row 0 all-masked; ``misaligned``: h a
    contiguous view whose base is 4 bytes off the 16-byte grid."""
    r = np.random.default_rng(n + di)
    ha = r.standard_normal((n, f, di)).astype(np.float32)
    if misaligned:
        h = torch.empty(ha.size + 1, device=device)[1:].view(n, f, di)
        h.copy_(torch.from_numpy(ha))
    else:
        h = torch.from_numpy(ha).to(device)
    m = r.random((n, f)) > 0.3
    m[0] = False
    w = torch.from_numpy((r.standard_normal((di, do)) * 0.1).astype(np.float32)).to(device)
    b = torch.from_numpy((r.standard_normal(do) * 0.1).astype(np.float32)).to(device)
    return h, torch.from_numpy(m).to(device), w, b


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,di,do", AGG_SHAPES)
def test_cuda_relation_agg_matches_plain(cuda_device, n, f, di, do):
    h, mask, w, b = _relation_agg_case(n, f, di, do, cuda_device)  # row 0 all-masked: b
    kops.reset_launch_counts()
    got = ra_ops.relation_agg(h, mask, w, b)
    torch.cuda.synchronize()
    assert ra_ops.INFO.launches == 1 and ra_ops.INFO.shapes[(n, f, di, do)] == 1
    want = ra_ops.relation_agg_ref(h, mask, w, b)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    np.testing.assert_allclose(got[0].cpu().numpy(), b.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,di,do", AGG_SHAPES)
def test_cuda_relation_agg_reads_a_misaligned_h(cuda_device, n, f, di, do):
    """h's base off the 16-byte grid: the kernel's 4-byte copies, and the
    same outputs as from an aligned copy of h, bit for bit."""
    h, mask, w, b = _relation_agg_case(n, f, di, do, cuda_device, misaligned=True)
    assert h.data_ptr() % 16 != 0 and h.is_contiguous()
    got = ra_ops.relation_agg(h, mask, w, b)
    aligned = ra_ops.relation_agg(h.clone(), mask, w, b)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)
    np.testing.assert_allclose(got.cpu().numpy(),
                               ra_ops.relation_agg_ref(h, mask, w, b).cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,di,do", AGG_SHAPES)
def test_cuda_relation_agg_repeats_and_equals_kernel_1_at_one_slot(cuda_device, n, f, di, do):
    """Kernel 6 is mean_linear.cuh's template at one slot: two launches
    give the same bits, and so does stacked_mean_linear at rb = 1."""
    h, mask, w, b = _relation_agg_case(n, f, di, do, cuda_device)
    first = ra_ops.relation_agg(h, mask, w, b)
    again = ra_ops.relation_agg(h, mask, w, b)
    stacked = stacked_mean_linear(h[None], mask[None], w[None], b[None], np.zeros(1, np.int32))
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first, stacked[0])


@pytest.mark.cuda
def test_cuda_relation_agg_refuses_what_it_does_not_take(cuda_device):
    h = torch.zeros((4, 3, 8), device=cuda_device)
    mask = torch.ones((4, 3), dtype=torch.bool, device=cuda_device)
    w, b = torch.zeros((8, 5), device=cuda_device), torch.zeros(5, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ra_ops.relation_agg(h.double(), mask, w.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        ra_ops.relation_agg(torch.zeros((4, 8, 3), device=cuda_device).transpose(1, 2), mask,
                            w, b)
    with pytest.raises(ValueError):
        ra_ops.relation_agg(h, mask, w.cpu(), b)
    with pytest.raises(ValueError, match="shapes"):
        ra_ops.relation_agg(h, mask, w.t().contiguous(), b)


# (rb, n, f, nh, dh): tests/test_stacked_kernels.py's cases, the fanouts the
# paths take (f = 16 on the serving path) and beyond (f = 1000: the logits
# in chunks), ragged n, dh = 5 and 6 (4-byte loads; 4-column chunks that
# straddle heads), H > 256 and H > 1024 (a row over two blocks)
SC_SHAPES = [(3, 21, 4, 2, 5), (1, 1, 1, 1, 1), (5, 130, 3, 4, 16), (2, 7, 16, 4, 16),
             (3, 45, 64, 4, 16), (2, 9, 100, 4, 16), (3, 50, 5, 3, 24), (2, 33, 3, 8, 40),
             (6, 4096, 3, 4, 16), (3, 1024, 4, 4, 16), (2, 1024, 16, 4, 16),
             (2, 9, 1000, 4, 16), (3, 21, 4, 2, 6), (2, 5, 20, 13, 80)]


def _combine_case(rb, n, f, nh, dh, device, layout="contiguous"):
    """(e, mask, v) on ``device``, row 0 of slot 0 fully masked.  Layouts:
    contiguous; ``misaligned`` (v a contiguous view 4 bytes off the 16-byte
    grid); ``head-major`` (e and v as HGT's einsums return them, views of
    [rb, nh, n, f(, dh)] buffers)."""
    r = np.random.default_rng(rb * n + f)
    e = r.standard_normal((rb, n, f, nh)).astype(np.float32)
    v = r.standard_normal((rb, n, f, nh, dh)).astype(np.float32)
    m = r.random((rb, n, f)) > 0.3
    m[0, 0] = False  # a fully masked row gives zeros
    if layout == "head-major":
        te = torch.from_numpy(np.ascontiguousarray(e.transpose(0, 3, 1, 2))).to(device)
        tv = torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2, 4))).to(device)
        te, tv = te.permute(0, 2, 3, 1), tv.permute(0, 2, 3, 1, 4)
    else:
        te = torch.from_numpy(e).to(device)
        if layout == "misaligned":
            tv = torch.empty(v.size + 1, device=device)[1:].view(v.shape)
            tv.copy_(torch.from_numpy(v))
        else:
            tv = torch.from_numpy(v).to(device)
    return te, torch.from_numpy(m).to(device), tv


@pytest.mark.cuda
@pytest.mark.parametrize("rb,n,f,nh,dh", SC_SHAPES)
def test_cuda_softmax_combine_matches_plain(cuda_device, rb, n, f, nh, dh):
    e, mask, v = _combine_case(rb, n, f, nh, dh, cuda_device)
    kops.reset_launch_counts()
    got = stacked_softmax_combine(e, mask, v)
    torch.cuda.synchronize()
    assert kops.KERNELS["stacked_softmax_combine"].launches == 1
    want = stacked_softmax_combine_ref(e, mask, v)
    assert torch.isfinite(got).all() and not got[0, 0].any()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["misaligned", "head-major"])
@pytest.mark.parametrize("rb,n,f,nh,dh", SC_SHAPES)
def test_cuda_softmax_combine_reads_its_operands_where_they_lie(cuda_device, rb, n, f, nh,
                                                                dh, layout):
    """v off the 16-byte grid (4-byte loads) and e and v as head-major
    views (read through their strides, no copy): the same bits as from
    contiguous copies, within 1e-5 of the plain version."""
    e, mask, v = _combine_case(rb, n, f, nh, dh, cuda_device, layout)
    if layout == "misaligned":
        assert v.data_ptr() % 16 != 0
    kops.reset_launch_counts()
    got = stacked_softmax_combine(e, mask, v)
    torch.cuda.synchronize()
    assert kops.KERNELS["stacked_softmax_combine"].launches == 1
    assert torch.equal(got, stacked_softmax_combine(e.contiguous(), mask, v.clone()))
    np.testing.assert_allclose(got.cpu().numpy(),
                               stacked_softmax_combine_ref(e, mask, v).cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rb,n,f,nh,dh", SC_SHAPES)
def test_cuda_softmax_combine_repeats_bit_for_bit(cuda_device, rb, n, f, nh, dh):
    e, mask, v = _combine_case(rb, n, f, nh, dh, cuda_device)
    first = stacked_softmax_combine(e, mask, v)
    again = stacked_softmax_combine(e, mask, v)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_cuda_raf_executor_never_reaches_a_plain_version(cuda_device, monkeypatch):
    """The raf executor's R-GCN step on the card, its forward and backward,
    with relation_agg's plain version made to raise: every branch of the
    metatree launches kernel 6 once a step, and the losses follow the same
    session on the CPU within 1e-5."""
    from repro_torch.api import Heta, HetaConfig

    cfg = HetaConfig().updated(data=dict(scale=0.002, fanouts=(3, 2), batch_size=16),
                               partition=dict(num_partitions=2), cache=dict(cache_mb=1),
                               run=dict(steps=3, executor="raf"))
    cpu = Heta(cfg, device="cpu").run()["losses"]

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(ra_ops, "relation_agg_ref", refuse)
    sess = Heta(cfg, device=cuda_device)
    sess.build_graph(), sess.partition(), sess.profile_and_cache(), sess.compile()
    kops.reset_launch_counts()
    got = sess.fit()["losses"]
    branches = sum(len(lv) for lv in sess.spec.levels)
    assert ra_ops.INFO.launches == 3 * branches
    np.testing.assert_allclose(got, cpu, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# kernel 8: flash attention, and the LM workbench on the card
# --------------------------------------------------------------------------

# (b, h, hk, sq, sk, d, causal, window, q_offset): the reference's ATTN_CASES,
# the R3 case (rows with no visible key), ragged non-causal, sq = 1 decode
# shapes, and llama3.2-3b's heads (24:8, d = 128) at s = 2048
FLASH_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, 0),
    (1, 8, 8, 300, 300, 64, True, None, 0),
    (1, 4, 4, 256, 256, 128, True, 64, 0),
    (2, 4, 2, 1, 512, 64, True, None, 511),
    (1, 2, 2, 1, 1024, 64, True, 256, 1023),
    (1, 2, 2, 128, 128, 64, False, None, 0),
    (1, 16, 16, 160, 160, 80, False, None, 0),
    (1, 2, 2, 16, 16, 32, False, 4, 10),
    (2, 6, 3, 77, 131, 64, False, None, 0),
    (1, 6, 2, 100, 37, 32, False, 9, 0),
    (4, 24, 8, 1, 2049, 128, True, None, 2048),
    (1, 24, 8, 2048, 2048, 128, True, None, 0),
]
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


def _flash_inputs(case, dtype, device, seed):
    b, h, hk, sq, sk, d = case[:6]
    r = np.random.default_rng(seed)

    def draw(*shape):  # the model's [b, s, h, d] layout, handed over as views
        t = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
        return t.to(device=device, dtype=dtype).transpose(1, 2)

    return draw(b, sq, h, d), draw(b, sk, hk, d), draw(b, sk, hk, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    causal, window, off = case[6:]
    q, k, v = _flash_inputs(case, dtype, cuda_device, sum(case[:6]))
    kops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert kops.KERNELS["flash_attention"].launches == 1
    assert got.dtype == dtype and got.shape == q.shape and torch.isfinite(got).all()
    want = attention_ref(q, k, v, causal, window, off)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **FLASH_TOL[dtype])
    if dtype == torch.bfloat16:  # also against fp32 attention of the same inputs
        want32 = attention_ref(q.float(), k.float(), v.float(), causal, window, off)
        np.testing.assert_allclose(got.float().cpu().numpy(), want32.cpu().numpy(),
                                   **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.zeros(1, 2, 8, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, torch.zeros(1, 2, 64, 8, device=cuda_device).transpose(2, 3))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(*(torch.zeros(1, 2, 8, 48, device=cuda_device),) * 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(*(q.half(),) * 3)
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        flash_attention(q, q.bfloat16(), q)
    odd = torch.zeros(1, 2, 8, 65, device=cuda_device, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(odd, odd, odd)
    odd32 = torch.ones(1, 2, 8, 65, device=cuda_device)[..., 1:]  # fp32 takes any stride
    torch.testing.assert_close(flash_attention(odd32, odd32, odd32), odd32)


# kernel 8's ragged cases: every (sq, sk) in {1, 129, 1000, 2047}^2 at every
# head dim, each with one of six settings in turn: GQA 24:8 or 4:1,
# causal or not, a window, a q_offset, and rows that see no key
FLASH_RAGGED_S = (1, 129, 1000, 2047)
FLASH_SETTINGS = [  # (h, hk, causal, window, q_offset)
    (24, 8, True, None, 0), (4, 1, False, None, 0), (24, 8, True, 100, 0),
    (4, 1, True, None, 37), (4, 1, False, 64, 0), (4, 1, False, 4, 3000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80, 128])
@pytest.mark.parametrize("sq", FLASH_RAGGED_S)
@pytest.mark.parametrize("sk", FLASH_RAGGED_S)
def test_cuda_flash_attention_ragged_matches_plain(cuda_device, d, sq, sk):
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS

    assert d in HEAD_DIMS
    i = FLASH_RAGGED_S.index(sq) * 4 + FLASH_RAGGED_S.index(sk) + d
    h, hk, causal, window, off = FLASH_SETTINGS[i % len(FLASH_SETTINGS)]
    case = (1 + i % 2, h, hk, sq, sk, d)
    q, k, v = _flash_inputs(case, torch.bfloat16, cuda_device, i)
    got = flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    plain = attention_ref(q, k, v, causal, window, off)
    exact = attention_ref(q.float(), k.float(), v.float(), causal, window, off)
    for want in (plain, exact):
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **FLASH_TOL[torch.bfloat16],
                                   err_msg=str((case, causal, window, off)))
    # |out| is about sqrt(e / keys), near the 3e-2 above at long rows: the
    # kernel's Frobenius error against fp32 attention stays within 1.5x the
    # plain bf16 path's own
    k_err = float((got.float() - exact).norm())
    p_err = float((plain.float() - exact).norm())
    assert k_err <= 1.5 * p_err + 1e-6 * float(exact.norm()), (case, k_err, p_err)
    if off == 3000:  # no query sees a key: the kernel gives 0, as the oracle does (R3)
        assert not got.any()


@pytest.mark.cuda
def test_cuda_flash_attention_raises_under_grad(cuda_device):
    """The kernel has no backward: under grad with an operand that requires
    grad the op raises instead of returning a result with no grad_fn; under
    inference_mode or no_grad it runs."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _flash_inputs((1, 4, 2, 130, 130, 64), torch.bfloat16, cuda_device, 0)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.detach(), k.detach().requires_grad_(True), v)
    with torch.no_grad():
        a = flash_attention(q, k, v)
    with torch.inference_mode():
        b = flash_attention(q, k, v)
    assert torch.equal(a, b) and a.grad_fn is None
    c = flash_attention(q.detach(), k, v)  # nothing requires grad
    assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_cuda_gather_rows_gradient_matches_cpu(cuda_device, idx_dtype):
    """The CUDA gather's gradient (a scatter-add over duplicate indices)
    equals the CPU's, and is the same bit for bit over two calls."""
    r = np.random.default_rng(7)
    table = r.standard_normal((300, 64)).astype(np.float32)
    idx = r.integers(0, 300, 5000).astype(idx_dtype)
    g = r.standard_normal((5000, 64)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda_device, cuda_device):
        t = torch.from_numpy(table).to(dev).requires_grad_(True)
        out = gather_rows(t, idx)
        assert out.grad_fn is not None
        (dt,) = torch.autograd.grad(out, t, torch.from_numpy(g).to(dev))
        grads.append(dt.cpu())
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(grads[1], grads[2])
    with torch.no_grad():  # the cache's all-hit fetch: no graph, same rows
        t = torch.from_numpy(table).to(cuda_device)
        np.testing.assert_array_equal(gather_rows(t, idx).cpu().numpy(), table[idx])


@pytest.mark.cuda
def test_cuda_lm_prefill_launches_the_kernel_and_matches_the_cpu(cuda_device):
    """Reduced llama3.2-3b (fp32): prefill on the card launches kernel 8
    once per layer; logits and 8 decode steps follow the CPU within 1e-4."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, make_prefill_step, make_serve_step

    cfg = get_arch("llama3.2-3b").reduced()
    cpu = init_params(cfg, 0, "cpu")
    gpu = {k: (v.to(cuda_device) if torch.is_tensor(v) else
               {kk: {leaf: t.to(cuda_device) for leaf, t in vv.items()} for kk, vv in v.items()})
           for k, v in cpu.items()}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))
    out = {}
    for name, params in (("cpu", cpu), ("gpu", gpu)):
        kops.reset_launch_counts()
        logits, cache = make_prefill_step(cfg)(params, {"tokens": tokens[:, :32]})
        out[name + "_launches"] = kops.KERNELS["flash_attention"].launches
        cache = {k: F.pad(c, (0, 0, 0, 0, 0, 8)) for k, c in cache.items()}
        steps = [logits]
        step = make_serve_step(cfg)
        for pos in range(32, 40):
            logits, cache = step(params, cache, tokens[:, pos:pos + 1], pos)
            steps.append(logits)
        out[name] = torch.cat(steps, 1).cpu()
    assert out["gpu_launches"] == cfg.num_layers and out["cpu_launches"] == 0
    np.testing.assert_allclose(out["gpu"].numpy(), out["cpu"].numpy(), atol=1e-4, rtol=1e-4)


LM_FAMILIES = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "mamba2-1.3b",
               "jamba-1.5-large-398b", "llava-next-34b", "hubert-xlarge")


@pytest.mark.cuda
@pytest.mark.parametrize("name", LM_FAMILIES)
def test_cuda_lm_families_match_the_cpu(cuda_device, name):
    """Each reduced configuration of the rest of the LM workbench (fp32):
    prefill of 2 x 32 (the vision model's patches before them; the audio
    model's frames) and 8 decode steps on the card within 1e-4 of the CPU;
    the card's prefill launches kernel 8 once per attention layer, decode
    none.  Block by block too: every block call of the CPU's run again on
    the card, from the CPU's inputs.  Where Mamba-2 blocks carry a state
    (mamba2, jamba) only block by block: jamba's 16 layers amplify fp32
    rounding past 1e-4 (tests/test_torch_lm_families.py), and on the
    card mamba2's state left a decode step 2.9e-4 off the CPU while no block
    differed by more than 1.7e-5 (chip_smoke.py, LM_REFERENCE)."""
    import repro_torch.models.transformer as transformer
    from _lm_blocks import recorded, replay
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import pad_kv_cache
    from repro_torch.models import init_params, make_prefill_step, make_serve_step

    cfg = get_arch(name).reduced()
    cpu = init_params(cfg, 0, "cpu")

    def to(t):
        return {k: to(v) for k, v in t.items()} if isinstance(t, dict) else t.to(cuda_device)

    r = np.random.default_rng(0)
    tokens = r.integers(0, cfg.vocab, (2, 40))
    batch = {"tokens": tokens[:, :32]}
    if cfg.frontend == "audio":
        batch = {"frames": r.standard_normal((2, 32, cfg.frontend_dim)).astype(np.float32)}
    P = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    if P:
        batch["patch_embeds"] = r.standard_normal((2, P, cfg.frontend_dim)).astype(np.float32)
    out, launches = {}, {}
    for where, params in (("cpu", cpu), ("gpu", to(cpu))):
        kops.reset_launch_counts()
        with recorded(transformer) as calls:
            logits, cache = make_prefill_step(cfg)(params, batch)
            launches[where] = [kops.KERNELS["flash_attention"].launches]
            seq = [logits]
            if cfg.is_decoder:
                cache, step = pad_kv_cache(cache, 8), make_serve_step(cfg)
                for i in range(8):
                    logits, cache = step(params, cache, tokens[:, 32 + i:33 + i], P + 32 + i)
                    seq.append(logits)
        launches[where].append(kops.KERNELS["flash_attention"].launches)
        out[where] = torch.cat(seq, 1).cpu()
        out[where + "_calls"] = calls
    n_attn = cfg.n_periods * len(cfg.attn_slots)
    assert launches == {"cpu": [0, 0], "gpu": [n_attn, n_attn]}
    assert replay(out["cpu_calls"], cfg, cuda_device, 1e-4) <= 1e-4
    if not cfg.mamba_slots:
        np.testing.assert_allclose(out["gpu"].numpy(), out["cpu"].numpy(), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# the asynchronous host pipeline on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("learn,pipeline", [
    (True, dict(snapshot="fresh")),
    (True, dict(num_workers=2, snapshot="fresh")),
    (False, dict()),
    (False, dict(num_workers=2)),
], ids=["thread-fresh", "pool-fresh", "thread-frozen", "pool-frozen"])
def test_cuda_pipelined_fit_equals_serial(cuda_device, learn, pipeline):
    """Pipelined fits on the card (a producer thread staging and copying
    to the device, or two spawned sampler workers staging into the batch
    arena) give the serial fit's losses bit for bit, through the same
    kernels."""
    import os

    from repro_torch.api import Heta, HetaConfig
    from repro_torch.graph.shm import live_segments

    cfg = HetaConfig().updated(data=dict(scale=0.002, fanouts=(3, 2), batch_size=16),
                               partition=dict(num_partitions=2), cache=dict(cache_mb=1),
                               model=dict(train_learnable=learn), run=dict(steps=4))
    serial = Heta(cfg, device=cuda_device).run()["losses"]
    sess = Heta(cfg.updated(pipeline=dict(enabled=True, **pipeline)), device=cuda_device)
    try:
        sess.build_graph(), sess.partition(), sess.profile_and_cache(), sess.compile()
        kops.reset_launch_counts()
        res = sess.fit()
        launched = {k: v.launches for k, v in kops.KERNELS.items()}
    finally:
        sess.close_pipeline()
    assert res["losses"] == serial
    assert launched["stacked_mean_linear"] > 0 and launched["stacked_mean_linear_dh"] > 0
    if learn:
        assert launched["gather_rows"] > 0
    assert not live_segments(f"heta-tshm-{os.getpid():x}-")


@pytest.mark.cuda
def test_cuda_stage_from_host_copies_out_of_the_slot(cuda_device):
    """Worker-staged host arrays (read-only views into an arena slot) reach
    the card as CUDA tensors with the slot's values, and a later write into
    the slot does not reach them: nothing aliases slot memory."""
    from repro_torch.core import raf_spmd
    from repro_torch.graph.shm import create_arena

    r = np.random.default_rng(0)
    fields = {"h/qfeat1": r.standard_normal((2, 3, 16, 8)).astype(np.float32),
              "h/mask1": r.random((2, 3, 16)) > 0.5,
              "h/labels": r.integers(0, 9, 16)}
    with create_arena(fields, num_workers=1, depth=1) as arena:
        arena.begin_write(0, 0)
        views = arena.slot_views(0, writable=True)
        for k, v in fields.items():
            views[k][...] = v
        arena.end_write(0, 0)
        host = {k[2:]: v for k, v in arena.resolve(0, 0).items()}
        assert not any(v.flags.writeable for v in host.values())
        got = raf_spmd.host_to_device(host, cuda_device)
        torch.cuda.synchronize()
        for k, v in views.items():
            v[...] = 0  # the writer reuses the slot
        for k, v in fields.items():
            t = got[k[2:]]
            assert t.is_cuda and t.dtype == torch.from_numpy(v).dtype
            np.testing.assert_array_equal(t.cpu().numpy(), v)
        del host, views


# --------------------------------------------------------------------------
# the data-parallel tier on the card (two ranks time-share the one device)
# --------------------------------------------------------------------------


def _dp_config(steps, **scale):
    from repro_torch.api import HetaConfig

    cfg = HetaConfig().updated(data=dict(scale=0.002, fanouts=(3, 2), batch_size=16),
                               partition=dict(num_partitions=2), cache=dict(cache_mb=1),
                               model=dict(train_learnable=False),
                               run=dict(steps=steps, log_every=0))
    return cfg.updated(scale=scale) if scale else cfg


def _dp_fit(cuda_device, cfg):
    """A compiled session on the card, its DP fit from reset launch counts
    (waits bounded at 120 s), and rank 0's launches in that fit."""
    from repro_torch.api import Heta
    from repro_torch.data.dp_trainer import run_dp_fit

    sess = Heta(cfg, device=cuda_device)
    sess.build_graph(), sess.partition(), sess.profile_and_cache(), sess.compile()
    kops.reset_launch_counts()
    res = run_dp_fit(sess, cfg.run.steps, timeout_s=120.0)
    return sess, res, {k: v.launches for k, v in kops.KERNELS.items()}


def _assert_no_dp_leaks():
    import os

    from repro_torch.graph.mmap_store import live_stores
    from repro_torch.graph.shm import live_segments

    assert not live_segments(f"heta-tshm-{os.getpid():x}-")
    assert not live_stores(prefix=f"heta-tmmap-{os.getpid():x}-")


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["shm", "mmap"])
def test_cuda_dp_global_fit_equals_single_process(cuda_device, store):
    """Two ranks on the card under the stripe discipline give the
    single-process card fit's losses and final state bit for bit; both
    ranks launch kernels 1 and 2 for the steps they own, rank 1 in its own
    process and CUDA context."""
    from repro_torch.api import Heta
    from repro_torch.data.dp_trainer import state_sha

    single = Heta(_dp_config(4), device=cuda_device)
    want = single.run()["losses"]
    sess, res, launched = _dp_fit(cuda_device, _dp_config(4, num_trainers=2, store=store))
    assert res["losses"] == want and state_sha(sess.state) == state_sha(single.state)
    rank1 = res["scale"]["trainer_reports"][1]["kernel_launches"]
    for name in ("stacked_mean_linear", "stacked_mean_linear_dh"):
        assert launched[name] > 0 and rank1[name]["launches"] == launched[name]
    assert launched["gather_rows"] == 0  # frozen tables: no sparse update
    assert np.isfinite(sess.evaluate(num_batches=1)["loss"])
    _assert_no_dp_leaks()


@pytest.mark.cuda
def test_cuda_dp_local_fit_ranks_agree(cuda_device):
    """``"local"`` mode on the card: run_dp_fit's cross-rank check (losses
    and final state hash, bit for bit) holds, the losses are finite, and
    both ranks launch kernels 1 and 2 every step."""
    sess, res, launched = _dp_fit(cuda_device,
                                  _dp_config(3, num_trainers=2, mode="local"))
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert res["scale"]["trainer_reports"][1]["state_sha"] == res["scale"]["state_sha"]
    rank1 = res["scale"]["trainer_reports"][1]["kernel_launches"]
    for name in ("stacked_mean_linear", "stacked_mean_linear_dh"):
        assert launched[name] > 0 and rank1[name]["launches"] == launched[name]
    _assert_no_dp_leaks()
