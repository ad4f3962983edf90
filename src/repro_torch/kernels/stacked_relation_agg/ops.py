"""Public op: stacked relation aggregation — dispatch, the mean_linear kernels
and their autograd seam.

:func:`stacked_agg` runs one level's AGG_r for every branch slot.  With the
``kernels.stacked_agg`` toggle on and a module declaring
``fused == "mean_linear"`` (R-GCN), it calls :func:`stacked_mean_linear`;
anything else goes to the gather-then-vmap oracle
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
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import (
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
    "INFO",
    "INFO_DH",
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
_FN = None
_DH_FN = None
_THREADS, _MAX_ACC = 256, 16  # must match csrc/stacked_mean_linear.cu
_DH_MAX_ROWS = 16  # must match csrc/stacked_mean_linear_dh.cu (kMaxRows)

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
    The forward kernel's launch block sizes come from ``opts``
    (``resolve_blocks``); the ``dh`` kernel keeps its defaults."""
    scope_of = {s.name: s.scope for s in module.specs}
    if (kernel_choice(opts, "stacked_agg") and module.fused == "mean_linear"
            and scope_of.get("w") is not None
            and scope_of.get("w") == scope_of.get("b")):
        bn, bo, bc = resolve_blocks(opts, "stacked_mean_linear")
        return stacked_mean_linear(
            h, mask, stacks["w"], stacks["b"], slot_u[scope_of["w"]],
            block_n=bn, block_out=bo, block_in=bc,
        )
    return stacked_agg_ref(module, stacks, slot_u, h, q, mask)
