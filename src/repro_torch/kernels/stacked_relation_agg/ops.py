"""Public op: stacked relation aggregation — dispatch, the mean_linear and
attention kernels and their autograd seams.

:func:`stacked_agg` runs one level's AGG_r for every branch slot.  With the
``kernels.stacked_agg`` toggle on:

  * ``fused == "mean_linear"`` (R-GCN) -> :func:`stacked_mean_linear`;
  * ``fused == "softmax_combine"`` (R-GAT, HGT) with ``kernels.fuse_epilogue``
    on (the default) -> the module's :meth:`attn_epilogue` operands, the
    query-side projection through :func:`stacked_mean_linear` at f = 1
    (:func:`_epilogue_linear`), then :func:`stacked_attn_epilogue`;
  * ``fused == "softmax_combine"`` with ``fuse_epilogue`` off -> the
    ``attn_parts`` factoring: the module's projections in torch ops on
    per-slot weights, then :func:`stacked_softmax_combine`, the masked
    softmax + head-wise combine (``csrc/stacked_softmax_combine.cu``);

and anything else, or the toggle off, goes to the gather-then-vmap oracle
(:func:`~repro_torch.kernels.stacked_relation_agg.ref.stacked_agg_ref`),
which autograd differentiates as it is.

:func:`stacked_mean_linear` runs through :class:`_StackedMeanLinear`, a
``torch.autograd.Function`` (the counterpart of the reference's
``jax.custom_vjp``, ``repro/kernels/stacked_relation_agg/ops.py:132-177``):

  * forward — the hand-written CUDA kernel ``csrc/stacked_mean_linear.cu``
    for CUDA tensors, :func:`stacked_mean_linear_ref` for CPU ones;
  * backward — ``dh`` through :func:`stacked_mean_linear_dh` (the kernel
    ``csrc/stacked_mean_linear_dh.cu`` on CUDA, its plain version on the
    CPU), reading each slot's weights from the ``[U, d_in, d_out]`` stack
    as the forward does; ``dw``/``db`` straight in stack form: per-slot
    products segment-summed over ``slot_u`` into ``[U, ...]`` rows, so slots
    sharing a stack row sum, as autodiff of the dict-form forward sums
    occurrences.  Cross-shard sharing stays ``sync_stack_grads``' job.

The slot sum is a product with a one-hot ``[U, rb]`` matrix followed by a
sum over slots (:func:`segment_sum`), not ``index_add_``: on CUDA
``index_add_`` adds atomically in a varying order, and a resumed run would
then not repeat the uninterrupted one bit for bit.  The one-hot products are
exact (by 1 or 0), so the only difference from the reference's
``segment_sum`` is the order of a sum over at most rb terms.

:func:`stacked_attn_epilogue` runs through :class:`_StackedAttnEpilogue`
(the reference's ``_stacked_ae`` custom VJP, ``ops.py:273-448``):

  * forward — the kernel ``csrc/stacked_attn_epilogue.cu`` (plain version
    :func:`stacked_attn_epilogue_ref` on the CPU), writing the projections
    ``z0``/``v0`` as residuals only when a gradient is needed;
  * backward — the closed form of the reference's ``_ae_vjp_bwd`` in torch
    ops from the residuals, ``dh`` through :func:`stacked_attn_dh`
    (``csrc/stacked_attn_dh.cu``), the projection and transform gradients
    summed into stack form with :func:`segment_sum`.  The small per-slot
    leaves (R-GAT's ``a_src``/``a_dst``/``b``) are gathered with
    :func:`take_slots`, whose backward is the same deterministic slot sum.

:func:`stacked_softmax_combine` runs through :class:`_StackedSoftmaxCombine`
(the reference's ``_stacked_sc`` custom VJP, ``ops.py:203-257``): the
forward is the kernel ``csrc/stacked_softmax_combine.cu`` (plain version
:func:`stacked_softmax_combine_ref` on the CPU), the backward the
reference's closed-form softmax Jacobian in torch ops from the recomputed
probabilities.  The JAX package has no backward kernel for it.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.relmod import leaky_relu, masked_softmax
from repro_torch.kernels.ops import (
    DEFAULT_BLOCKS,
    check_launch,
    cuda_stream,
    kernel_choice,
    register_kernel,
    resolve_blocks,
)
from repro_torch.kernels.stacked_relation_agg.ref import stacked_agg_ref

__all__ = [
    "stacked_agg",
    "stacked_agg_ref",
    "stacked_mean_linear",
    "stacked_mean_linear_ref",
    "stacked_mean_linear_dh",
    "stacked_mean_linear_dh_ref",
    "segment_sum",
    "stage_slot_u",
    "launch_kernel",
    "launch_dh_kernel",
    "stacked_attn_epilogue",
    "attn_epilogue_forward",
    "stacked_attn_epilogue_ref",
    "stacked_attn_dh",
    "stacked_attn_dh_ref",
    "stacked_softmax_combine",
    "stacked_softmax_combine_ref",
    "softmax_combine_forward",
    "attn_slots",
    "attn_rows",
    "take_slots",
    "launch_attn_epilogue",
    "launch_attn_dh",
    "launch_softmax_combine",
    "FanoutTooWideError",
    "INFO",
    "INFO_DH",
    "INFO_AE",
    "INFO_ADH",
    "INFO_SC",
]

INFO = register_kernel(
    "stacked_mean_linear",
    source="src/repro_torch/kernels/csrc/stacked_mean_linear.cu",
    replaces="src/repro/kernels/stacked_relation_agg/kernel.py:100",
)
INFO_DH = register_kernel(
    "stacked_mean_linear_dh",
    source="src/repro_torch/kernels/csrc/stacked_mean_linear_dh.cu",
    replaces="src/repro/kernels/stacked_relation_agg/kernel.py:167",
)
INFO_AE = register_kernel(
    "stacked_attn_epilogue",
    source="src/repro_torch/kernels/csrc/stacked_attn_epilogue.cu",
    replaces="src/repro/kernels/stacked_relation_agg/kernel.py:336",
)
INFO_ADH = register_kernel(
    "stacked_attn_dh",
    source="src/repro_torch/kernels/csrc/stacked_attn_dh.cu",
    replaces="src/repro/kernels/stacked_relation_agg/kernel.py:452",
)
INFO_SC = register_kernel(
    "stacked_softmax_combine",
    source="src/repro_torch/kernels/csrc/stacked_softmax_combine.cu",
    replaces="src/repro/kernels/stacked_relation_agg/kernel.py:227",
)
_FN = None
_DH_FN = None
_SC_FN = None
_AE_FN = None
_ADH_FN = None
# must match csrc/stacked_mean_linear.cu; _THREADS also stacked_softmax_combine.cu
_THREADS, _MAX_ACC = 256, 16
_DH_MAX_ROWS = 16  # must match csrc/stacked_mean_linear_dh.cu (kMaxRows)
# must match csrc/stacked_attn_epilogue.cu and csrc/stacked_attn_dh.cu:
# the fixed 64 x 64 tiles, the largest d_in / H chunk, and the opt-in
# shared memory of one block on sm_90
_ATTN_TILE, _ATTN_MAX_CHUNK, _SMEM_LIMIT = 64, 64, 232448

Blocks = Tuple[int, int, int]


def _host_slots(slot_u, num_rows: int) -> np.ndarray:
    """``slot_u`` as a checked host int32 array with values in [0, U)."""
    if torch.is_tensor(slot_u):
        if slot_u.device.type != "cpu":
            raise ValueError("slot_u must be held on the host (numpy or a CPU tensor)")
        slot_u = slot_u.numpy()
    arr = np.asarray(slot_u)
    if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"slot_u must be a 1-D integer array, got {arr.dtype} "
                         f"of shape {arr.shape}")
    if len(arr) and (int(arr.min()) < 0 or int(arr.max()) >= num_rows):
        raise IndexError(f"slot_u out of range [0, {num_rows})")
    return np.ascontiguousarray(arr, dtype=np.int32)


def stage_slot_u(slot_u, num_rows: int, device) -> torch.Tensor:
    """``slot_u`` range-checked on the host against ``[0, num_rows)`` and
    copied once to ``device`` as int32.  A caller that launches many blocks
    with the same slots stages them here and hands the tensor to
    :func:`stacked_mean_linear`, which then copies nothing per launch."""
    return torch.from_numpy(_host_slots(slot_u, num_rows)).to(device)


def _on_device(slot_u) -> bool:
    return torch.is_tensor(slot_u) and slot_u.device.type != "cpu"


def _slot_index(slot_u, num_rows: int, device) -> torch.Tensor:
    """``slot_u`` as an int64 index tensor on ``device`` (plain versions)."""
    if _on_device(slot_u):
        return slot_u.to(device=device, dtype=torch.long)
    return torch.from_numpy(_host_slots(slot_u, num_rows).astype(np.int64)).to(device)


def _slots_for(slot_u, num_rows: int, rb: int, device: torch.device, op: str):
    """The slots an op runs with: a staged int32 tensor on ``device`` is
    taken as it is, anything else is checked on the host (and copied to a
    CUDA ``device``)."""
    if _on_device(slot_u):
        if slot_u.device != device or slot_u.dtype != torch.int32:
            raise ValueError(f"{op}: a device slot_u must be int32 on {device} "
                             f"(stage_slot_u), got {slot_u.dtype} on {slot_u.device}")
        slots = slot_u
    else:
        slots = torch.from_numpy(_host_slots(slot_u, num_rows))
        if device.type != "cpu":
            slots = slots.to(device)
    if slots.shape != (rb,):
        raise ValueError(f"slot_u has shape {tuple(slots.shape)} for {rb} slots")
    return slots


def segment_sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[k] = sum of x[i] over i with seg[i] == k`` along axis 0, as a
    one-hot product and a sum over axis 0: deterministic on every device
    (see the module docstring) and differentiable.  ``seg`` is an integer
    tensor on ``x``'s device."""
    onehot = (seg.to(torch.long)[None, :]
              == torch.arange(num_segments, device=x.device)[:, None]).to(x.dtype)
    return (onehot.view(num_segments, -1, *([1] * (x.dim() - 1))) * x[None]).sum(1)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def stacked_mean_linear_ref(h, mask, w, b, slot_u) -> torch.Tensor:
    """The plain PyTorch version: masked mean over f, then a batched matmul
    with the per-slot weight rows ``w[slot_u]`` plus ``b[slot_u]``."""
    u = _slot_index(slot_u, w.shape[0], h.device)
    mw = mask.to(h.dtype)
    cnt = torch.clamp(mw.sum(dim=-1, keepdim=True), min=1.0)
    mean = torch.einsum("rnfd,rnf->rnd", h, mw) / cnt
    return torch.bmm(mean, w[u]) + b[u][:, None, :]


def stacked_mean_linear_dh_ref(g, mask, w, slot_u) -> torch.Tensor:
    """The plain PyTorch version of the ``dh`` backward:
    ``(g @ w[slot_u]^T) / max(cnt, 1)`` broadcast over f and masked."""
    u = _slot_index(slot_u, w.shape[0], g.device)
    mw = mask.to(g.dtype)
    cnt = torch.clamp(mw.sum(dim=-1, keepdim=True), min=1.0)
    dmean = torch.bmm(g, w[u].transpose(1, 2)) / cnt
    return dmean[:, :, None, :] * mw[..., None]


def _stack_form_grads(h, mask, g, slots, num_rows: int):
    """``dw`` [U, d_in, d_out] and ``db`` [U, d_out]: per-slot products
    segment-summed over ``slot_u`` (the reference's ``_ml_vjp_bwd``)."""
    mw = mask.to(h.dtype)
    cnt = torch.clamp(mw.sum(dim=-1, keepdim=True), min=1.0)
    mean = torch.einsum("rnfd,rnf->rnd", h, mw) / cnt
    pw = torch.einsum("rnd,rno->rdo", mean, g)
    seg = slots.to(device=g.device)
    return segment_sum(pw, seg, num_rows), segment_sum(g.sum(dim=1), seg, num_rows)


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import load

        fn = load("stacked_mean_linear").stacked_mean_linear_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _dh_kernel():
    global _DH_FN
    if _DH_FN is None:
        from repro_torch.kernels.build import load

        fn = load("stacked_mean_linear_dh").stacked_mean_linear_dh
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _DH_FN = fn
    return _DH_FN


def _cuda_operands(op: str, device, named, float_names, mask):
    """Check the operands of a CUDA launch; returns the mask as uint8."""
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    for name, t in named:
        if name in float_names and t.dtype != torch.float32:
            raise ValueError(f"{op} kernel takes float32 {name}, got {t.dtype}")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    elif mask.dtype != torch.uint8:
        raise ValueError(f"{op} mask must be bool or uint8, got {mask.dtype}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{op} kernel takes a contiguous {name}")
    return mask


def _mean_linear_forward(h, mask, w, b, slots, blocks: Blocks) -> torch.Tensor:
    """The forward on checked shapes: the kernel for CUDA, plain for CPU."""
    if h.device.type == "cpu":
        return stacked_mean_linear_ref(h, mask, w, b, slots)
    if h.device.type != "cuda":
        raise ValueError(f"stacked_mean_linear: unsupported device {h.device}")
    rb, n, f, d_in = h.shape
    d_out = w.shape[2]
    mask_u8 = _cuda_operands("stacked_mean_linear", h.device,
                             (("h", h), ("mask", mask), ("w", w), ("b", b)),
                             ("h", "w", "b"), mask)
    bn, bo, bc = blocks
    if bn * bo > _THREADS * _MAX_ACC:
        raise ValueError(f"block_n * block_out = {bn * bo} exceeds "
                         f"{_THREADS * _MAX_ACC} outputs per block")
    if rb > 65535:
        raise ValueError(f"stacked_mean_linear: {rb} slots exceed the grid's 65535")
    out = torch.empty((rb, n, d_out), dtype=torch.float32, device=h.device)
    if rb == 0 or n == 0 or d_out == 0:
        return out
    launch_kernel(h, mask_u8, w, b, slots, out, bn, bo, bc)
    INFO.record((rb, n, f, d_in, d_out, w.shape[0]))
    return out


def launch_kernel(h, mask_u8, w, b, slot_u_dev, out, block_n, block_out, block_in) -> None:
    """One raw forward launch on operands already checked and staged on
    ``h``'s device (``slot_u_dev`` int32, ``out`` allocated).  Not counted:
    production calls go through the wrapper; this entry exists so kernel
    time can be measured without the staging."""
    rb, n, f, d_in = h.shape
    with torch.cuda.device(h.device):
        status = _kernel()(h.data_ptr(), mask_u8.data_ptr(), w.data_ptr(), b.data_ptr(),
                           slot_u_dev.data_ptr(), out.data_ptr(), rb, n, f, d_in,
                           w.shape[2], block_n, block_out, block_in,
                           cuda_stream(h.device))
    check_launch(status, "stacked_mean_linear")


def launch_dh_kernel(g, mask_u8, w, slot_u_dev, dh, block_n, block_out, block_in) -> None:
    """One raw ``dh`` launch on operands already checked and staged on
    ``g``'s device (``dh`` allocated as ``[rb, n, f, d_in]``).  Not counted,
    like :func:`launch_kernel`."""
    rb, n, f, d_in = dh.shape
    with torch.cuda.device(g.device):
        status = _dh_kernel()(g.data_ptr(), mask_u8.data_ptr(), w.data_ptr(),
                              slot_u_dev.data_ptr(), dh.data_ptr(), rb, n, f, d_in,
                              g.shape[2], block_n, block_out, block_in,
                              cuda_stream(g.device))
    check_launch(status, "stacked_mean_linear_dh")


# --------------------------------------------------------------------------
# public ops
# --------------------------------------------------------------------------


def stacked_mean_linear_dh(
    g: torch.Tensor,  # [rb, n, d_out] float32: the gradient of the output
    mask: torch.Tensor,  # [rb, n, f] bool or uint8
    w: torch.Tensor,  # [U, d_in, d_out] float32
    slot_u,  # [rb] host integer array in [0, U), or stage_slot_u's tensor
    block_n: Optional[int] = None,
    block_out: Optional[int] = None,
    block_in: Optional[int] = None,
) -> torch.Tensor:
    """``dh[s, i, j] = (g[s, i] @ w[slot_u[s]]^T) / max(cnt[s, i], 1) *
    mask[s, i, j]`` -> ``[rb, n, f, d_in]``.

    CUDA tensors launch the kernel (raising on what it does not take); CPU
    tensors run :func:`stacked_mean_linear_dh_ref`."""
    if g.dim() != 3 or mask.dim() != 3 or mask.shape[:2] != g.shape[:2] or w.dim() != 3:
        raise ValueError(f"stacked_mean_linear_dh shapes: g {tuple(g.shape)}, mask "
                         f"{tuple(mask.shape)}, w {tuple(w.shape)}")
    rb, n, d_out = g.shape
    f = mask.shape[2]
    U, d_in = w.shape[0], w.shape[1]
    if w.shape[2] != d_out:
        raise ValueError(f"stacked_mean_linear_dh: w {tuple(w.shape)} does not match "
                         f"d_out={d_out}")
    slots = _slots_for(slot_u, U, rb, g.device, "stacked_mean_linear_dh")
    if g.device.type == "cpu":
        return stacked_mean_linear_dh_ref(g, mask, w, slots)
    if g.device.type != "cuda":
        raise ValueError(f"stacked_mean_linear_dh: unsupported device {g.device}")
    mask_u8 = _cuda_operands("stacked_mean_linear_dh", g.device,
                             (("g", g), ("mask", mask), ("w", w)), ("g", "w"), mask)
    dn, do, di = resolve_blocks(None, "stacked_mean_linear_dh")
    bn, bo, bc = block_n or dn, block_out or do, block_in or di
    if bc > _THREADS or _THREADS % bc:
        raise ValueError(f"stacked_mean_linear_dh: block_in={bc} must divide {_THREADS}")
    if bn > _DH_MAX_ROWS * (_THREADS // bc):
        raise ValueError(f"stacked_mean_linear_dh: block_n={bn} exceeds "
                         f"{_DH_MAX_ROWS * (_THREADS // bc)} rows at block_in={bc}")
    if rb > 65535 or -(-d_in // bc) > 65535:
        raise ValueError(f"stacked_mean_linear_dh: grid of {rb} slots x "
                         f"{-(-d_in // bc)} column tiles exceeds 65535")
    dh = torch.empty((rb, n, f, d_in), dtype=torch.float32, device=g.device)
    if rb == 0 or n == 0 or f == 0 or d_in == 0:
        return dh
    launch_dh_kernel(g, mask_u8, w, slots, dh, bn, bo, bc)
    INFO_DH.record((rb, n, f, d_in, d_out, U))
    return dh


class _StackedMeanLinear(torch.autograd.Function):
    """Forward kernel + stack-form backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, h, mask, w, b, slots, blocks: Blocks):
        ctx.save_for_backward(h, mask, w, slots)
        return _mean_linear_forward(h, mask, w, b, slots, blocks)

    @staticmethod
    def backward(ctx, g):
        h, mask, w, slots = ctx.saved_tensors
        g = g.contiguous()
        dh = dw = db = None
        if ctx.needs_input_grad[0]:
            dh = stacked_mean_linear_dh(g, mask, w, slots)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dw, db = _stack_form_grads(h, mask, g, slots, w.shape[0])
        return dh, None, dw, db, None, None


def stacked_mean_linear(
    h: torch.Tensor,  # [rb, n, f, d_in] float32
    mask: torch.Tensor,  # [rb, n, f] bool or uint8
    w: torch.Tensor,  # [U, d_in, d_out] float32
    b: torch.Tensor,  # [U, d_out] float32
    slot_u,  # [rb] host integer array in [0, U), or stage_slot_u's tensor
    block_n: Optional[int] = None,
    block_out: Optional[int] = None,
    block_in: Optional[int] = None,
) -> torch.Tensor:
    """``out[s] = masked_mean(h[s], mask[s]) @ w[slot_u[s]] + b[slot_u[s]]``,
    differentiable in ``h``, ``w`` and ``b`` (:class:`_StackedMeanLinear`).

    CUDA tensors launch the kernels (raising on what they do not take); CPU
    tensors run the plain versions.  ``slot_u`` is a host array, checked and
    copied to the device on each call, or an int32 tensor on ``h``'s device
    from :func:`stage_slot_u`, checked when it was staged.  The ``block_*``
    sizes are the forward kernel's; the backward launches the ``dh`` kernel
    at its own defaults (``DEFAULT_BLOCKS``), whose limits differ."""
    if h.dim() != 4 or mask.shape != h.shape[:3] or w.dim() != 3 or b.dim() != 2:
        raise ValueError(
            f"stacked_mean_linear shapes: h {tuple(h.shape)}, mask "
            f"{tuple(mask.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    rb, n, f, d_in = h.shape
    U, d_out = w.shape[0], w.shape[2]
    if w.shape[1] != d_in or b.shape != (U, d_out):
        raise ValueError(f"stacked_mean_linear: w {tuple(w.shape)} / b "
                         f"{tuple(b.shape)} do not match d_in={d_in}")
    slots = _slots_for(slot_u, U, rb, h.device, "stacked_mean_linear")
    dn, do, di = resolve_blocks(None, "stacked_mean_linear")
    blocks = (block_n or dn, block_out or do, block_in or di)
    return _StackedMeanLinear.apply(h, mask, w, b, slots, blocks)


# --------------------------------------------------------------------------
# the attention epilogue: slots, plain versions, launches, autograd seam
# --------------------------------------------------------------------------


class FanoutTooWideError(ValueError):
    """One destination row's f neighbours do not fit the shared memory of
    one block of ``csrc/stacked_attn_epilogue.cu`` (see its source note)."""


class _TakeSlots(torch.autograd.Function):
    """``stack[u]`` whose backward sums the rows' gradients back with the
    deterministic :func:`segment_sum` (not the atomics of ``index_put_``)."""

    @staticmethod
    def forward(ctx, stack, u):
        ctx.save_for_backward(u)
        ctx.rows = stack.shape[0]
        return stack.index_select(0, u)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        return segment_sum(g, u, ctx.rows), None


def take_slots(stack: torch.Tensor, slot_u) -> torch.Tensor:
    """The per-slot rows ``stack[slot_u]`` of a small leaf, differentiable
    with a deterministic backward (``slot_u`` as for :func:`stacked_mean_linear`)."""
    return _TakeSlots.apply(stack, _slot_index(slot_u, stack.shape[0], stack.device))


def attn_slots(ue, uv, ua, rows: Tuple[int, int, int], rb: int, device) -> torch.Tensor:
    """The ``[3, rb]`` int32 slot rows ``(ue, uv, ua)`` of an attention
    launch on ``device``: host arrays are range-checked against ``rows``,
    staged tensors (:func:`stage_slot_u`) are taken as they are."""
    device = torch.device(device)
    return torch.stack([_slots_for(u, U, rb, device, "stacked_attn_epilogue")
                        for u, U in zip((ue, uv, ua), rows)])


def attn_rows(f: int, num_heads: int, head_dim: int, two: bool, post: bool) -> int:
    """Destination rows per block of the epilogue kernel: ``block_n // f``
    (at least 1), shrunk until the block's shared memory fits; raises
    :class:`FanoutTooWideError` when not even one row fits.  ``two``: the
    values have their own projection; ``post``: pe/pv transforms."""
    bn, _, bc = DEFAULT_BLOCKS["stacked_attn_epilogue"]
    H, k = num_heads * head_dim, 2 if two else 1
    fixed = _ATTN_TILE * (bc + 1) + bc * _ATTN_TILE * k
    per_row = f * (H * k + num_heads) + H * (2 if post else 1)
    fit = (_SMEM_LIMIT // 4 - fixed) // per_row
    if fit < 1:
        raise FanoutTooWideError(
            f"stacked_attn_epilogue: a row of fanout {f} at {num_heads} heads x "
            f"{head_dim} needs {4 * (fixed + per_row)} bytes of shared memory, "
            f"over the {_SMEM_LIMIT} one block can hold")
    return max(1, min(bn // f, fit))


def stacked_attn_epilogue_ref(h, mask, qv, eb, we, wv, pe, pv, us, num_heads: int,
                              head_dim: int, scale: float = 1.0, slope=None,
                              with_residuals: bool = False):
    """The plain PyTorch version of the fused attention AGG_r (the
    reference's ``_attn_epilogue_kernel``, transforms applied per
    neighbour).  Returns ``out`` ``[rb, n, H]``, or ``(out, z0, v0)`` with
    residuals (``v0`` is ``z0`` when ``wv`` is None)."""
    rb, n, f, d_in = h.shape
    nh, dh = num_heads, head_dim
    u = us.to(device=h.device, dtype=torch.long)
    hf = h.reshape(rb, n * f, d_in)
    z0 = torch.bmm(hf, we[u[0]]).reshape(rb, n, f, nh * dh)
    v0 = z0 if wv is None else torch.bmm(hf, wv[u[1]]).reshape(rb, n, f, nh * dh)
    zt = z0.reshape(rb, n, f, nh, dh)
    vt = v0.reshape(rb, n, f, nh, dh)
    if pe is not None:
        zt = torch.einsum("rnfhd,rhde->rnfhe", zt, pe[u[2]])
        vt = torch.einsum("rnfhd,rhde->rnfhe", vt, pv[u[2]])
    e = torch.einsum("rnfhe,rnhe->rnfh", zt, qv.reshape(rb, n, nh, dh)) * scale
    if eb is not None:
        e = e + eb[:, :, None, :]
    if slope is not None:
        e = leaky_relu(e, slope)
    alpha = masked_softmax(e, mask.bool()[..., None], axis=2)
    out = torch.einsum("rnfh,rnfhd->rnhd", alpha, vt).reshape(rb, n, nh * dh)
    return (out, z0, v0) if with_residuals else out


def stacked_attn_dh_ref(dz, dv, we, wv, us) -> torch.Tensor:
    """The plain PyTorch version of the attention backward into h:
    ``dz @ we[us[0]]^T (+ dv @ wv[us[1]]^T)`` -> ``[rb, n, f, d_in]``."""
    rb, n, f, H = dz.shape
    u = us.to(device=dz.device, dtype=torch.long)
    dh = torch.bmm(dz.reshape(rb, n * f, H), we[u[0]].transpose(1, 2))
    if dv is not None:
        dh = dh + torch.bmm(dv.reshape(rb, n * f, H), wv[u[1]].transpose(1, 2))
    return dh.reshape(rb, n, f, we.shape[1])


def stacked_softmax_combine_ref(e, mask, v) -> torch.Tensor:
    """The plain version of ``csrc/stacked_softmax_combine.cu``: masked
    softmax over f of ``e`` ``[rb, n, f, nh]``, then the head-wise combine
    with ``v`` ``[rb, n, f, nh, dh]`` -> ``[rb, n, nh * dh]``."""
    rb, n, f, nh, dh = v.shape
    alpha = masked_softmax(e, mask.bool()[..., None], axis=2)
    return torch.einsum("rnfh,rnfhd->rnhd", alpha, v).reshape(rb, n, nh * dh)


def _ae_kernel():
    global _AE_FN
    if _AE_FN is None:
        from repro_torch.kernels.build import load

        fn = load("stacked_attn_epilogue").stacked_attn_epilogue
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4
                       + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _AE_FN = fn
    return _AE_FN


def _adh_kernel():
    global _ADH_FN
    if _ADH_FN is None:
        from repro_torch.kernels.build import load

        fn = load("stacked_attn_dh").stacked_attn_dh
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 5
                       + [ctypes.c_int] + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ADH_FN = fn
    return _ADH_FN


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch_attn_epilogue(h, mask_u8, qv, eb, we, wv, pe, pv, us, out, z0, v0,
                         num_heads, head_dim, scale, slope, rows, block_in) -> None:
    """One raw epilogue launch on operands already checked and on ``h``'s
    device (outputs allocated; ``z0``/``v0`` None without residuals).  Not
    counted: production calls go through :func:`attn_epilogue_forward`."""
    rb, n, f, d_in = h.shape
    with torch.cuda.device(h.device):
        status = _ae_kernel()(
            h.data_ptr(), mask_u8.data_ptr(), qv.data_ptr(), qv.stride(0), qv.stride(1),
            _ptr(eb), we.data_ptr(), _ptr(wv), _ptr(pe), _ptr(pv), us.data_ptr(),
            out.data_ptr(), _ptr(z0), _ptr(v0), rb, n, f, d_in, num_heads, head_dim,
            float(scale), 0.0 if slope is None else float(slope), int(slope is not None),
            rows, block_in, cuda_stream(h.device))
    check_launch(status, "stacked_attn_epilogue")


def launch_attn_dh(dz, dv, we, wv, us, dh, block_in) -> None:
    """One raw ``dh`` launch on operands already checked and on ``dz``'s
    device (``dh`` allocated).  Not counted, like :func:`launch_attn_epilogue`."""
    rb, n, f, H = dz.shape
    with torch.cuda.device(dz.device):
        status = _adh_kernel()(dz.data_ptr(), _ptr(dv), we.data_ptr(), _ptr(wv),
                               us.data_ptr(), dh.data_ptr(), rb, n, f, we.shape[1], H,
                               block_in, cuda_stream(dz.device))
    check_launch(status, "stacked_attn_dh")


def _check_us(op: str, us, rb: int, device) -> None:
    if not torch.is_tensor(us) or us.shape != (3, rb) or us.dtype != torch.int32 \
            or us.device != device:
        raise ValueError(f"{op}: us must be the [3, {rb}] int32 tensor of attn_slots on "
                         f"{device}")


def attn_epilogue_forward(h, mask, qv, eb, we, wv, pe, pv, us, *, num_heads: int,
                          head_dim: int, scale: float = 1.0, slope=None,
                          with_residuals: bool = False):
    """The fused attention AGG_r on stacked operands (see
    :func:`stacked_attn_epilogue_ref` for the function and the return).

    CUDA tensors launch ``csrc/stacked_attn_epilogue.cu`` (raising on what it
    does not take); CPU tensors run the plain version.  ``us`` comes from
    :func:`attn_slots`.  ``qv`` may have any slot and node strides (0 for a
    per-slot vector) with unit stride along H."""
    op = "stacked_attn_epilogue"
    nh, dh = num_heads, head_dim
    H = nh * dh
    if h.dim() != 4:
        raise ValueError(f"{op}: h must be [rb, n, f, d_in], got {tuple(h.shape)}")
    rb, n, f, d_in = h.shape
    post = pe is not None
    if (mask.shape != (rb, n, f) or qv.shape != (rb, n, H) or we.dim() != 3
            or we.shape[1:] != (d_in, H)
            or (wv is not None and (wv.dim() != 3 or wv.shape[1:] != (d_in, H)))
            or (eb is not None and eb.shape != (rb, n, nh))
            or post != (pv is not None)
            or (post and (pe.dim() != 4 or pe.shape[1:] != (nh, dh, dh)
                          or pv.shape != pe.shape))):
        raise ValueError(
            f"{op} shapes: h {tuple(h.shape)}, mask {tuple(mask.shape)}, qv "
            f"{tuple(qv.shape)}, we {tuple(we.shape)}, wv "
            f"{None if wv is None else tuple(wv.shape)}, eb "
            f"{None if eb is None else tuple(eb.shape)}, pe "
            f"{None if pe is None else tuple(pe.shape)}, pv "
            f"{None if pv is None else tuple(pv.shape)} at {nh} heads x {dh}")
    _check_us(op, us, rb, h.device)
    if h.device.type == "cpu":
        return stacked_attn_epilogue_ref(h, mask, qv, eb, we, wv, pe, pv, us, nh, dh,
                                         scale, slope, with_residuals)
    if h.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {h.device}")
    named = [("h", h), ("mask", mask), ("we", we)] + [
        (k, t) for k, t in (("eb", eb), ("wv", wv), ("pe", pe), ("pv", pv)) if t is not None]
    mask_u8 = _cuda_operands(op, h.device, named, ("h", "we", "eb", "wv", "pe", "pv"), mask)
    if qv.device != h.device or qv.dtype != torch.float32 or qv.stride(2) != 1:
        raise ValueError(f"{op}: qv must be float32 on {h.device} with unit stride along "
                         f"H, got {qv.dtype} on {qv.device}, strides {qv.stride()}")
    bn, bo, bc = DEFAULT_BLOCKS[op]
    if bo != _ATTN_TILE or not 1 <= bc <= _ATTN_MAX_CHUNK:
        raise ValueError(f"{op}: blocks {(bn, bo, bc)}: block_out must be "
                         f"{_ATTN_TILE} and block_in in [1, {_ATTN_MAX_CHUNK}]")
    rows = attn_rows(f, nh, dh, wv is not None, post)
    if rb > 65535:
        raise ValueError(f"{op}: {rb} slots exceed the grid's 65535")
    out = torch.empty((rb, n, H), dtype=torch.float32, device=h.device)
    z0 = v0 = None
    if with_residuals:
        z0 = torch.empty((rb, n, f, H), dtype=torch.float32, device=h.device)
        v0 = z0 if wv is None else torch.empty_like(z0)
    if min(rb, n, H) == 0:
        return (out, z0, v0) if with_residuals else out
    if f == 0 or d_in == 0:
        raise ValueError(f"{op}: f = {f} and d_in = {d_in} must be positive")
    launch_attn_epilogue(h, mask_u8, qv, eb, we, wv, pe, pv, us, out, z0,
                         None if wv is None else v0, nh, dh, scale, slope, rows, bc)
    INFO_AE.record((rb, n, f, d_in, nh, dh, we.shape[0],
                    0 if wv is None else wv.shape[0], pe.shape[0] if post else 0,
                    eb is not None, slope is not None, qv.stride(1) == 0,
                    with_residuals))
    return (out, z0, v0) if with_residuals else out


def stacked_attn_dh(dz, dv, we, wv, us) -> torch.Tensor:
    """``dh = dz @ we[us[0]]^T (+ dv @ wv[us[1]]^T)`` -> ``[rb, n, f, d_in]``:
    the attention backward into h.

    CUDA tensors launch ``csrc/stacked_attn_dh.cu`` (raising on what it does
    not take); CPU tensors run :func:`stacked_attn_dh_ref`."""
    op = "stacked_attn_dh"
    if (dz.dim() != 4 or we.dim() != 3 or we.shape[2] != dz.shape[3]
            or (dv is None) != (wv is None)
            or (dv is not None and (dv.shape != dz.shape or wv.dim() != 3
                                    or wv.shape[1:] != we.shape[1:]))):
        raise ValueError(
            f"{op} shapes: dz {tuple(dz.shape)}, dv "
            f"{None if dv is None else tuple(dv.shape)}, we {tuple(we.shape)}, wv "
            f"{None if wv is None else tuple(wv.shape)}")
    rb, n, f, H = dz.shape
    d_in = we.shape[1]
    _check_us(op, us, rb, dz.device)
    if dz.device.type == "cpu":
        return stacked_attn_dh_ref(dz, dv, we, wv, us)
    if dz.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {dz.device}")
    named = [("dz", dz), ("we", we)] + ([] if dv is None else [("dv", dv), ("wv", wv)])
    for name, t in named:
        if t.device != dz.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{op} kernel takes contiguous float32 {name} on {dz.device}, "
                             f"got {t.dtype} on {t.device}")
    bn, bo, bc = DEFAULT_BLOCKS[op]
    if (bn, bo) != (_ATTN_TILE, _ATTN_TILE) or not 1 <= bc <= _ATTN_MAX_CHUNK:
        raise ValueError(f"{op}: blocks {(bn, bo, bc)}: block_n and block_out must be "
                         f"{_ATTN_TILE}, block_in in [1, {_ATTN_MAX_CHUNK}]")
    if rb > 65535 or -(-d_in // _ATTN_TILE) > 65535:
        raise ValueError(f"{op}: grid of {rb} slots x {-(-d_in // _ATTN_TILE)} column "
                         f"tiles exceeds 65535")
    dh = torch.empty((rb, n, f, d_in), dtype=torch.float32, device=dz.device)
    if min(rb, n, f, d_in) == 0:
        return dh
    if H == 0:
        return dh.zero_()
    launch_attn_dh(dz, dv, we, wv, us, dh, bc)
    INFO_ADH.record((rb, n, f, d_in, H, we.shape[0], 0 if wv is None else wv.shape[0]))
    return dh


@dataclasses.dataclass(frozen=True)
class _AECfg:
    num_heads: int
    head_dim: int
    scale: float
    slope: Optional[float]


class _StackedAttnEpilogue(torch.autograd.Function):
    """Epilogue kernel forward with residuals + the closed-form backward of
    the reference's ``_ae_vjp_bwd`` (see the module docstring)."""

    @staticmethod
    def forward(ctx, h, mask, qv, eb, we, wv, pe, pv, us, cfg: _AECfg):
        out, z0, v0 = attn_epilogue_forward(
            h, mask, qv, eb, we, wv, pe, pv, us, num_heads=cfg.num_heads,
            head_dim=cfg.head_dim, scale=cfg.scale, slope=cfg.slope, with_residuals=True)
        ctx.save_for_backward(h, mask, qv, eb, we, wv, pe, pv, us, z0, v0)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        h, mask, qv, eb, we, wv, pe, pv, us, z0, v0 = ctx.saved_tensors
        cfg = ctx.cfg
        need = ctx.needs_input_grad
        rb, n, f, d_in = h.shape
        nh, dh = cfg.num_heads, cfg.head_dim
        H = nh * dh
        u = us.to(torch.long)
        z4 = z0.reshape(rb, n, f, nh, dh)
        v4 = v0.reshape(rb, n, f, nh, dh)
        if pe is not None:
            peg, pvg = pe.index_select(0, u[2]), pv.index_select(0, u[2])
            zt = torch.einsum("rnfhd,rhde->rnfhe", z4, peg)
            vt = torch.einsum("rnfhd,rhde->rnfhe", v4, pvg)
        else:
            zt, vt = z4, v4
        qv4 = qv.reshape(rb, n, nh, dh)
        e0 = torch.einsum("rnfhe,rnhe->rnfh", zt, qv4) * cfg.scale
        if eb is not None:
            e0 = e0 + eb[:, :, None, :]
        e = e0 if cfg.slope is None else leaky_relu(e0, cfg.slope)
        alpha = masked_softmax(e, mask.bool()[..., None], axis=2)
        gh = g.reshape(rb, n, nh, dh)
        # closed-form softmax Jacobian
        dalpha = torch.einsum("rnfhd,rnhd->rnfh", vt, gh)
        de = alpha * (dalpha - (alpha * dalpha).sum(dim=2, keepdim=True))
        dvt = torch.einsum("rnfh,rnhd->rnfhd", alpha, gh)
        if cfg.slope is not None:
            de = de * torch.where(e0 >= 0, 1.0, cfg.slope).to(de.dtype)
        deb = de.sum(dim=2) if need[3] else None
        des = de * cfg.scale
        dqv = torch.einsum("rnfh,rnfhe->rnhe", des, zt).reshape(rb, n, H) if need[2] else None
        dzt = torch.einsum("rnfh,rnhe->rnfhe", des, qv4)
        dpe = dpv = None
        if pe is not None:
            dz4 = torch.einsum("rnfhe,rhde->rnfhd", dzt, peg)
            dv4 = torch.einsum("rnfhe,rhde->rnfhd", dvt, pvg)
            if need[6]:
                dpe = segment_sum(torch.einsum("rnfhd,rnfhe->rhde", z4, dzt), u[2],
                                  pe.shape[0])
            if need[7]:
                dpv = segment_sum(torch.einsum("rnfhd,rnfhe->rhde", v4, dvt), u[2],
                                  pv.shape[0])
        else:
            dz4, dv4 = dzt, dvt
        # einsum may hand back permuted views; the dh kernel takes contiguous rows
        dz = dz4.reshape(rb, n * f, H).contiguous()
        dv = dv4.reshape(rb, n * f, H).contiguous()
        hf_t = h.reshape(rb, n * f, d_in).transpose(1, 2)
        dh_ = dwe = dwv = None
        if wv is None:
            dcomb = dz + dv
            if need[4]:
                dwe = segment_sum(torch.bmm(hf_t, dcomb), u[0], we.shape[0])
            if need[0]:
                dh_ = stacked_attn_dh(dcomb.reshape(rb, n, f, H), None, we, None, us)
        else:
            if need[4]:
                dwe = segment_sum(torch.bmm(hf_t, dz), u[0], we.shape[0])
            if need[5]:
                dwv = segment_sum(torch.bmm(hf_t, dv), u[1], wv.shape[0])
            if need[0]:
                dh_ = stacked_attn_dh(dz.reshape(rb, n, f, H), dv.reshape(rb, n, f, H),
                                      we, wv, us)
        return dh_, None, dqv, deb, dwe, dwv, dpe, dpv, None, None


def stacked_attn_epilogue(epi, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fused attention AGG_r from a module's :class:`~repro_torch.core.relmod.
    AttnEpilogue` operands, differentiable in ``h`` and every operand
    (:class:`_StackedAttnEpilogue`); without a gradient to take it launches
    the kernel with no residuals."""
    rb = h.shape[0]
    post = epi.pe is not None
    if post != (epi.pv is not None) or (post and epi.ua is None):
        raise ValueError("AttnEpilogue: pe and pv come together, with ua")
    wv_rows = (epi.we if epi.wv is None else epi.wv).shape[0]
    us = attn_slots(epi.ue, epi.ue if epi.uv is None else epi.uv,
                    epi.ua if post else np.zeros(rb, np.int64),
                    (epi.we.shape[0], wv_rows, epi.pe.shape[0] if post else 1), rb,
                    h.device)
    cfg = _AECfg(int(epi.num_heads), int(epi.head_dim), float(epi.scale),
                 None if epi.slope is None else float(epi.slope))
    # the kernel takes contiguous operands (qv through its strides); eb comes
    # out of an einsum, which may return a permuted view
    args = (h.contiguous(), mask, epi.qv, None if epi.eb is None else epi.eb.contiguous(),
            epi.we, epi.wv, epi.pe, epi.pv)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        out = _StackedAttnEpilogue.apply(*args, us, cfg)
    else:
        out = attn_epilogue_forward(*args, us, num_heads=cfg.num_heads,
                                    head_dim=cfg.head_dim, scale=cfg.scale, slope=cfg.slope)
    return out if epi.bias is None else out + epi.bias[:, None, :]


def _epilogue_linear(w_stack, u, x, *, blocks: Blocks) -> torch.Tensor:
    """Per-slot projection ``x @ w_stack[u]`` for the q side of an attention
    epilogue: :func:`stacked_mean_linear` at fanout 1 (the masked mean over
    one neighbour is the identity), so the weights are read from the stack
    and the gradient lands in stack form."""
    rb, n, _ = x.shape
    zb = torch.zeros((w_stack.shape[0], w_stack.shape[2]), dtype=w_stack.dtype,
                     device=w_stack.device)
    ones = torch.ones((rb, n, 1), dtype=torch.bool, device=x.device)
    return stacked_mean_linear(x.contiguous()[:, :, None, :], ones, w_stack, zb, u, *blocks)


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _sc_kernel():
    global _SC_FN
    if _SC_FN is None:
        from repro_torch.kernels.build import load

        fn = load("stacked_softmax_combine").stacked_softmax_combine_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 5 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _SC_FN = fn
    return _SC_FN


def softmax_combine_rows(head_width: int) -> int:
    """Destination rows per block of ``csrc/stacked_softmax_combine.cu``:
    one thread per (row, column) pair of its 256 threads, at least one row."""
    return max(1, _THREADS // head_width)


def launch_softmax_combine(e, mask_u8, v, out, rows) -> None:
    """One raw launch on operands already checked and on ``e``'s device
    (``v`` ``[rb, n, f, nh, dh]``, ``out`` allocated).  Not counted:
    production calls go through :func:`softmax_combine_forward`."""
    rb, n, f, nh, dh = v.shape
    with torch.cuda.device(e.device):
        status = _sc_kernel()(e.data_ptr(), mask_u8.data_ptr(), v.data_ptr(), out.data_ptr(),
                              rb, n, f, nh, dh, rows, cuda_stream(e.device))
    check_launch(status, "stacked_softmax_combine")


def softmax_combine_forward(e, mask, v) -> torch.Tensor:
    """The masked softmax + combine forward: the kernel for CUDA tensors
    (fp32, contiguous; anything else raises), the plain version for CPU
    ones."""
    op = "stacked_softmax_combine"
    if v.dim() != 5 or e.shape != v.shape[:4] or mask.shape != v.shape[:3]:
        raise ValueError(f"{op} shapes: e {tuple(e.shape)}, mask {tuple(mask.shape)}, "
                         f"v {tuple(v.shape)}")
    if not _is_cuda(e):
        if e.device.type != "cpu":
            raise ValueError(f"{op}: unsupported device {e.device}")
        return stacked_softmax_combine_ref(e, mask, v)
    mask_u8 = _cuda_operands(op, e.device, (("e", e), ("mask", mask), ("v", v)), ("e", "v"),
                             mask)
    rb, n, f, nh, dh = v.shape
    if rb > 65535:
        raise ValueError(f"{op}: {rb} slots exceed the grid's 65535")
    out = torch.empty((rb, n, nh * dh), dtype=torch.float32, device=e.device)
    if min(rb, n, nh * dh) == 0:
        return out
    launch_softmax_combine(e, mask_u8, v, out, softmax_combine_rows(nh * dh))
    INFO_SC.record((rb, n, f, nh, dh))
    return out


class _StackedSoftmaxCombine(torch.autograd.Function):
    """Kernel forward + the closed-form softmax Jacobian of the reference's
    ``_sc_vjp_bwd`` (probabilities recomputed, none saved)."""

    @staticmethod
    def forward(ctx, e, mask, v):
        ctx.save_for_backward(e, mask, v)
        return softmax_combine_forward(e, mask, v)

    @staticmethod
    def backward(ctx, g):
        e, mask, v = ctx.saved_tensors
        rb, n, f, nh, dh = v.shape
        alpha = masked_softmax(e, mask.bool()[..., None], axis=2)
        gh = g.reshape(rb, n, nh, dh)
        de = dv = None
        if ctx.needs_input_grad[0]:
            dalpha = torch.einsum("rnfhd,rnhd->rnfh", v, gh)
            de = alpha * (dalpha - (alpha * dalpha).sum(dim=2, keepdim=True))
        if ctx.needs_input_grad[2]:
            dv = torch.einsum("rnfh,rnhd->rnfhd", alpha, gh)
        return de, None, dv


def stacked_softmax_combine(
    e: torch.Tensor,  # [rb, n, f, nh] logits
    mask: torch.Tensor,  # [rb, n, f] bool or uint8
    v: torch.Tensor,  # [rb, n, f, nh, dh] values
) -> torch.Tensor:
    """Masked softmax over f of ``e``, then ``out[s, i, h] = sum_j alpha[s, i,
    j, h] * v[s, i, j, h]`` -> ``[rb, n, nh * dh]``, differentiable in ``e``
    and ``v`` (:class:`_StackedSoftmaxCombine`).  A fully masked row gives
    zeros.  CUDA tensors launch ``csrc/stacked_softmax_combine.cu``; CPU
    tensors run :func:`stacked_softmax_combine_ref`."""
    # the kernel takes contiguous operands; attn_parts' einsums may return
    # permuted views
    return _StackedSoftmaxCombine.apply(e.contiguous(), mask, v.contiguous())


def _attn_parts_agg(module, stacks, slot_u, h, q, mask) -> torch.Tensor:
    """The ``fuse_epilogue=False`` path: the module's ``attn_parts`` on
    per-slot weights (gathered with :func:`take_slots`, so their gradients
    sum back in a fixed order), then :func:`stacked_softmax_combine`."""
    scope_of = {s.name: s.scope for s in module.specs}
    p_slots = {name: take_slots(stacks[name], slot_u[scope_of[name]]) for name in stacks}
    e, v = torch.func.vmap(module.attn_parts)(p_slots, h, q)
    out = stacked_softmax_combine(e, mask, v)
    bias = module.attn_bias(p_slots)
    return out if bias is None else out + bias[:, None, :]


def stacked_agg(
    module,
    stacks: Dict[str, torch.Tensor],  # {leaf: [U_scope, ...]} one shard's slabs
    slot_u: Dict,  # {scope: [rb] int} per-slot stack rows (host, or staged)
    h: torch.Tensor,  # [rb, n, f, d_in]
    q: torch.Tensor,  # [rb, n, d_dst]
    mask: torch.Tensor,  # [rb, n, f]
    opts=None,
) -> torch.Tensor:
    """One level's AGG_r for every branch slot (see module docstring).
    The ``stacked_mean_linear`` forward's launch block sizes (R-GCN's
    aggregation and the attention models' q side) come from ``opts``
    (``resolve_blocks``); every other kernel keeps its defaults."""
    scope_of = {s.name: s.scope for s in module.specs}
    use = kernel_choice(opts, "stacked_agg")
    if (use and module.fused == "mean_linear" and scope_of.get("w") is not None
            and scope_of.get("w") == scope_of.get("b")):
        bn, bo, bc = resolve_blocks(opts, "stacked_mean_linear")
        return stacked_mean_linear(
            h, mask, stacks["w"], stacks["b"], slot_u[scope_of["w"]],
            block_n=bn, block_out=bo, block_in=bc,
        )
    if use and module.fused == "softmax_combine":
        if getattr(opts, "fuse_epilogue", True):
            blocks = resolve_blocks(opts, "stacked_mean_linear")
            epi = module.attn_epilogue(
                stacks, slot_u, q,
                linear=lambda w, u, x: _epilogue_linear(w, u, x, blocks=blocks),
                take=take_slots)
            if epi is not None:
                return stacked_attn_epilogue(epi, h, mask)
        return _attn_parts_agg(module, stacks, slot_u, h, q, mask)
    return stacked_agg_ref(module, stacks, slot_u, h, q, mask)
