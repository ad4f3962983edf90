"""Public op: stacked relation aggregation — dispatch and the mean_linear kernel.

:func:`stacked_agg` runs one level's AGG_r for every branch slot.  With the
``kernels.stacked_agg`` toggle on and a module declaring
``fused == "mean_linear"`` (R-GCN), it calls :func:`stacked_mean_linear`,
which launches the hand-written CUDA kernel (``csrc/stacked_mean_linear.cu``)
for CUDA tensors and runs :func:`stacked_mean_linear_ref` for CPU ones;
anything else goes to the gather-then-vmap oracle
(:func:`~repro_torch.kernels.stacked_relation_agg.ref.stacked_agg_ref`).

This slice is forward-only (layer-wise inference): the stack-form backward
and its ``dh`` kernel join with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

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
    "stage_slot_u",
    "launch_kernel",
    "INFO",
]

INFO = register_kernel(
    "stacked_mean_linear",
    source="src/repro_torch/kernels/csrc/stacked_mean_linear.cu",
    replaces="src/repro/kernels/stacked_relation_agg/kernel.py:100",
)
_FN = None
_THREADS, _MAX_ACC = 256, 16  # must match csrc/stacked_mean_linear.cu


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


def stacked_mean_linear_ref(h, mask, w, b, slot_u) -> torch.Tensor:
    """The plain PyTorch version: masked mean over f, then a batched matmul
    with the per-slot weight rows ``w[slot_u]`` plus ``b[slot_u]``."""
    if _on_device(slot_u):
        u = slot_u.to(device=h.device, dtype=torch.long)
    else:
        u = torch.from_numpy(_host_slots(slot_u, w.shape[0]).astype(np.int64)).to(h.device)
    mw = mask.to(h.dtype)
    cnt = torch.clamp(mw.sum(dim=-1, keepdim=True), min=1.0)
    mean = torch.einsum("rnfd,rnf->rnd", h, mw) / cnt
    return torch.bmm(mean, w[u]) + b[u][:, None, :]


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
    """``out[s] = masked_mean(h[s], mask[s]) @ w[slot_u[s]] + b[slot_u[s]]``.

    CUDA tensors launch the kernel (raising on what it does not take); CPU
    tensors run :func:`stacked_mean_linear_ref`.  ``slot_u`` is a host
    array, checked and copied to the device on each call, or an int32
    tensor on ``h``'s device from :func:`stage_slot_u`, checked when it was
    staged."""
    if h.dim() != 4 or mask.shape != h.shape[:3] or w.dim() != 3 or b.dim() != 2:
        raise ValueError(
            f"stacked_mean_linear shapes: h {tuple(h.shape)}, mask "
            f"{tuple(mask.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    rb, n, f, d_in = h.shape
    U, d_out = w.shape[0], w.shape[2]
    if w.shape[1] != d_in or b.shape != (U, d_out):
        raise ValueError(f"stacked_mean_linear: w {tuple(w.shape)} / b "
                         f"{tuple(b.shape)} do not match d_in={d_in}")
    if _on_device(slot_u):
        if slot_u.device != h.device or slot_u.dtype != torch.int32:
            raise ValueError(f"stacked_mean_linear: a device slot_u must be int32 on "
                             f"{h.device} (stage_slot_u), got {slot_u.dtype} on "
                             f"{slot_u.device}")
        slots = slot_u
    else:
        slots = _host_slots(slot_u, U)
    if slots.shape != (rb,):
        raise ValueError(f"slot_u has shape {tuple(slots.shape)} for {rb} slots")
    if h.device.type == "cpu":
        return stacked_mean_linear_ref(h, mask, w, b, slots)
    if h.device.type != "cuda":
        raise ValueError(f"stacked_mean_linear: unsupported device {h.device}")
    for name, t in (("mask", mask), ("w", w), ("b", b)):
        if t.device != h.device:
            raise ValueError(f"stacked_mean_linear: {name} on {t.device}, h on {h.device}")
    for name, t in (("h", h), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise ValueError(f"stacked_mean_linear kernel takes float32 {name}, got {t.dtype}")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    elif mask.dtype != torch.uint8:
        raise ValueError(f"stacked_mean_linear mask must be bool or uint8, got {mask.dtype}")
    for name, t in (("h", h), ("mask", mask), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"stacked_mean_linear kernel takes a contiguous {name}")
    dn, do, di = resolve_blocks(None, "stacked_mean_linear")
    bn, bo, bc = block_n or dn, block_out or do, block_in or di
    if bn * bo > _THREADS * _MAX_ACC:
        raise ValueError(f"block_n * block_out = {bn * bo} exceeds "
                         f"{_THREADS * _MAX_ACC} outputs per block")
    if rb > 65535:
        raise ValueError(f"stacked_mean_linear: {rb} slots exceed the grid's 65535")
    out = torch.empty((rb, n, d_out), dtype=torch.float32, device=h.device)
    if rb == 0 or n == 0 or d_out == 0:
        return out
    slot_dev = slots if torch.is_tensor(slots) else torch.from_numpy(slots).to(h.device)
    launch_kernel(h, mask, w, b, slot_dev, out, bn, bo, bc)
    INFO.record((rb, n, f, d_in, d_out, U))
    return out


def launch_kernel(h, mask_u8, w, b, slot_u_dev, out, block_n, block_out, block_in) -> None:
    """One raw launch on operands :func:`stacked_mean_linear` has already
    checked and staged on ``h``'s device (``slot_u_dev`` int32, ``out``
    allocated).  Not counted: production calls go through the wrapper;
    this entry exists so kernel time can be measured without the staging."""
    rb, n, f, d_in = h.shape
    with torch.cuda.device(h.device):
        status = _kernel()(h.data_ptr(), mask_u8.data_ptr(), w.data_ptr(), b.data_ptr(),
                           slot_u_dev.data_ptr(), out.data_ptr(), rb, n, f, d_in,
                           w.shape[2], block_n, block_out, block_in,
                           cuda_stream(h.device))
    check_launch(status, "stacked_mean_linear")


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
    Launch block sizes come from ``opts`` (``resolve_blocks``)."""
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
