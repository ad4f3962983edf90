"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device
(the hand-written kernels have no CPU mode).  The file imports no JAX, so
it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: fp32, atol 1e-5 / rtol 1e-5 for the aggregations and their
backwards (the kernels sum the fanout and the contraction in their own
order; the attention epilogue also applies HGT's per-head transforms once
per row instead of once per neighbour); the gather is exact.  Flash
attention (kernel 8): the reference's tolerances, fp32 2e-5 and bf16 3e-2
(the kernel keeps fp32 logits, the plain version rounds them to bf16); the
reduced LM on the card within 1e-4 of the CPU.
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,di,do", AGG_SHAPES)
def test_cuda_relation_agg_matches_plain(cuda_device, n, f, di, do):
    r = np.random.default_rng(n + di)
    h = torch.from_numpy(r.standard_normal((n, f, di)).astype(np.float32)).to(cuda_device)
    m = r.random((n, f)) > 0.3
    m[0] = False  # an all-masked row gives b
    mask = torch.from_numpy(m).to(cuda_device)
    w = torch.from_numpy((r.standard_normal((di, do)) * 0.1).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy((r.standard_normal(do) * 0.1).astype(np.float32)).to(cuda_device)
    kops.reset_launch_counts()
    got = ra_ops.relation_agg(h, mask, w, b)
    torch.cuda.synchronize()
    assert ra_ops.INFO.launches == 1 and ra_ops.INFO.shapes[(n, f, di, do)] == 1
    want = ra_ops.relation_agg_ref(h, mask, w, b)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    np.testing.assert_allclose(got[0].cpu().numpy(), b.cpu().numpy(), **TOL)


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
# paths take (f = 16 on the serving path) and beyond, ragged n, H > 256
SC_SHAPES = [(3, 21, 4, 2, 5), (1, 1, 1, 1, 1), (5, 130, 3, 4, 16), (2, 7, 16, 4, 16),
             (3, 45, 64, 4, 16), (2, 9, 100, 4, 16), (3, 50, 5, 3, 24), (2, 33, 3, 8, 40),
             (6, 4096, 3, 4, 16), (3, 1024, 4, 4, 16), (2, 1024, 16, 4, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("rb,n,f,nh,dh", SC_SHAPES)
def test_cuda_softmax_combine_matches_plain(cuda_device, rb, n, f, nh, dh):
    r = np.random.default_rng(rb * n + f)
    e = torch.from_numpy(r.standard_normal((rb, n, f, nh)).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(r.standard_normal((rb, n, f, nh, dh)).astype(np.float32)).to(cuda_device)
    m = r.random((rb, n, f)) > 0.3
    m[0, 0] = False  # a fully masked row gives zeros
    mask = torch.from_numpy(m).to(cuda_device)
    kops.reset_launch_counts()
    got = stacked_softmax_combine(e, mask, v)
    torch.cuda.synchronize()
    assert kops.KERNELS["stacked_softmax_combine"].launches == 1
    want = stacked_softmax_combine_ref(e, mask, v)
    assert torch.isfinite(got).all() and not got[0, 0].any()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


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
