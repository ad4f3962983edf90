"""Public op: row gather ``out[i] = table[idx[i]]`` (the cache-hit fetch).

``gather_rows`` launches the hand-written CUDA kernel
(``csrc/gather_rows.cu``) for a CUDA table and runs :func:`gather_rows_ref`
for a CPU one (``ref.py``); :func:`gather_rows_cfg` adds the ``kernels.gather`` toggle.
The production caller is ``repro_torch.embed.cache.FeatureCache.fetch``
on all-hit fetches.  Indices come from the host (the cache keeps its slot
map in numpy): they are range-checked there before they are copied to the
device, since the kernel itself does not check them.

On CUDA the launch sits inside an autograd ``Function`` (:class:`_GatherRows`)
whose backward is the reference's VJP (``repro/kernels/gather_rows/ops.py``
``_vjp_bwd``): the transpose scatter-add ``zeros(table.shape).index_put_(
(idx,), g, accumulate=True)`` in torch ops.  The reference's backward is an
XLA scatter, not a Pallas kernel, so torch ops are its counterpart here.
CUDA's accumulating ``index_put_`` sorts the indices and sums each run of
equal indices in their original order, so the gradient is the same bit for
bit from call to call (a resumed run repeats the uninterrupted one).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.ops import (
    check_launch,
    cuda_stream,
    kernel_choice,
    on_device,
    register_kernel,
)
from repro_torch.kernels.gather_rows.ref import gather_rows_ref

__all__ = ["gather_rows", "gather_rows_cfg", "gather_rows_ref", "launch_kernel", "INFO"]

INFO = register_kernel(
    "gather_rows",
    source="src/repro_torch/kernels/csrc/gather_rows.cu",
    replaces="src/repro/kernels/gather_rows/kernel.py:33",
)
_FN = None


def _host_index(idx, rows: int) -> np.ndarray:
    """``idx`` as a checked 1-D host integer array with values in [0, rows)."""
    if torch.is_tensor(idx):
        if idx.device.type != "cpu":
            raise ValueError("gather_rows takes host indices (numpy or a CPU tensor)")
        idx = idx.numpy()
    arr = np.asarray(idx)
    if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"gather_rows indices must be a 1-D integer array, got "
                         f"{arr.dtype} of shape {arr.shape}")
    if len(arr) and (int(arr.min()) < 0 or int(arr.max()) >= rows):
        raise IndexError(f"gather_rows index out of range [0, {rows})")
    if arr.dtype not in (np.int32, np.int64):
        arr = arr.astype(np.int64)
    return np.ascontiguousarray(arr)


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import load

        fn = load("gather_rows").gather_rows_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


class _GatherRows(torch.autograd.Function):
    """The kernel's gather, differentiable in ``table`` (module docstring)."""

    @staticmethod
    def forward(ctx, table, idx_dev):
        ctx.save_for_backward(idx_dev)
        ctx.shape = table.shape
        out = torch.empty((idx_dev.shape[0], table.shape[1]), dtype=table.dtype,
                          device=table.device)
        if out.numel():
            launch_kernel(table, idx_dev, out)
            INFO.record((table.shape[0], table.shape[1], out.shape[0]))  # (rows, d, n)
        return out

    @staticmethod
    def backward(ctx, g):
        (idx_dev,) = ctx.saved_tensors
        dt = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return dt.index_put_((idx_dev.long(),), g, accumulate=True), None


def gather_rows(table: torch.Tensor, idx) -> torch.Tensor:
    """``table[idx]`` — the CUDA kernel for a CUDA table, the plain version
    for a CPU one.  ``idx`` is a host integer array (int32 or int64).  Both
    are differentiable in ``table``: the CPU through ``table[idx]``, CUDA
    through :class:`_GatherRows`."""
    if table.dim() != 2:
        raise ValueError(f"gather_rows table must be 2-D, got {tuple(table.shape)}")
    arr = _host_index(idx, table.shape[0])
    if table.device.type == "cpu":
        return gather_rows_ref(table, torch.from_numpy(arr))
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("gather_rows kernel takes a contiguous float32 table")
    return _GatherRows.apply(table, torch.from_numpy(arr).to(table.device))


def launch_kernel(table: torch.Tensor, idx_dev: torch.Tensor, out: torch.Tensor) -> None:
    """One raw launch on operands :func:`gather_rows` has already checked
    and staged on ``table``'s device (``idx_dev`` int32 or int64, ``out``
    allocated).  Not counted: production calls go through the wrapper;
    this entry exists so kernel time can be measured without the staging."""
    with on_device(table.device):
        status = _kernel()(table.data_ptr(), idx_dev.data_ptr(),
                           int(idx_dev.dtype == torch.int64), out.data_ptr(),
                           out.shape[0], out.shape[1], cuda_stream(table.device))
    check_launch(status, "gather_rows")


def gather_rows_cfg(table: torch.Tensor, idx, opts=None) -> torch.Tensor:
    """Config-gated gather: the kernel op when the ``kernels.gather`` toggle
    is on (:func:`repro_torch.kernels.ops.kernel_choice`), else the plain
    version on the table's device."""
    if not kernel_choice(opts, "gather"):
        arr = _host_index(idx, table.shape[0])
        return gather_rows_ref(table, torch.from_numpy(arr))
    return gather_rows(table, idx)
