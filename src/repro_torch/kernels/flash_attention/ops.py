"""Public op: flash attention with GQA, ragged lengths and backend dispatch.

``flash_attention(q, k, v, ...)`` takes ``[b, h, s, d]`` tensors with
possibly fewer kv heads (GQA), as the reference's op does
(``repro/kernels/flash_attention/ops.py``).  A CUDA tensor launches the
hand-written kernel ``csrc/flash_attention.cu`` (or raises: there is no
fall-back); a CPU tensor, or ``use_kernel=False``, runs
:func:`attention_ref`.

Unlike the reference's op, the kernel needs no copies around it: GQA is an
index inside the kernel (no ``repeat`` of the kv heads), ragged ``sq`` and
``sk`` are masked inside it (no padding, causal or not), and it reads
q/k/v and writes its output through strides, so the model's ``[b, s, h,
d]`` activations go in as the transposed views the model makes.  The last
dimension of each operand must be contiguous; in bf16 (the tensor-core
kernel) each operand must also be 16-byte aligned with its other strides
in multiples of 8 elements, as every tensor the model makes is.

The kernel has no backward, nor has the reference's (its LM training runs
the XLA attention path, ``make_train_step(use_pallas=False)``).  So on CUDA
the op raises :class:`RuntimeError` when grad mode is on and q, k or v
requires grad, instead of returning a result with no ``grad_fn``; under
``torch.inference_mode()`` or ``torch.no_grad()``, as every LM path of the
port calls it, nothing changes.  The CPU path differentiates through
:func:`attention_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ops import check_launch, cuda_stream, on_device, register_kernel

__all__ = ["flash_attention", "launch_kernel", "dtype_code", "HEAD_DIMS", "INFO"]

INFO = register_kernel(
    "flash_attention",
    source="src/repro_torch/kernels/csrc/flash_attention.cu",
    replaces="src/repro/kernels/flash_attention/kernel.py:104",
)
HEAD_DIMS = (32, 64, 80, 128)  # the head dims the kernel is instantiated for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def dtype_code(dtype: torch.dtype) -> int:
    """The kernel's code for ``dtype`` (0 float32, 1 bfloat16)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, got {dtype}")
    return _DTYPE_CODES[dtype]


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import load

        fn = load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch_kernel(q, k, v, out, causal: bool, window: Optional[int], q_offset: int) -> None:
    """One raw launch on operands already checked, in ``[b, s, h, d]``
    layout (views welcome, last dimension contiguous), ``out`` allocated.
    Not counted: production calls go through :func:`flash_attention`; this
    entry exists so kernel time can be measured without the checks."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    with on_device(q.device):
        status = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           dtype_code(q.dtype), b, h, hk, sq, sk, d, strides, int(causal),
                           -1 if window is None else int(window), int(q_offset),
                           1.0 / math.sqrt(d), cuda_stream(q.device))
    check_launch(status, "flash_attention")


def _kernel_bshd(q, k, v, causal, window, q_offset) -> torch.Tensor:
    """The kernel on ``[b, s, h, d]`` operands; returns ``[b, sq, h, d]``."""
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, expected {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel needs {name}'s last dimension "
                             "contiguous")
    code = dtype_code(q.dtype)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel stages tiles with 16-byte loads
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"flash_attention bf16 kernel needs {name} 16-byte aligned "
                                 "with strides in multiples of 8 elements")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {d}")
    if q_offset < 0 or (window is not None and window < 0):
        raise ValueError(f"flash_attention: q_offset {q_offset} and window {window} "
                         "must not be negative")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    launch_kernel(q, k, v, out, causal, window, q_offset)
    INFO.record((b, h, hk, sq, sk, d, int(causal), -1 if window is None else window,
                 q_offset, code))
    return out


def flash_attention(
    q: torch.Tensor,  # [b, h, sq, d]
    k: torch.Tensor,  # [b, hk, sk, d]
    v: torch.Tensor,  # [b, hk, sk, d]
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Attention of each query over the keys it may see -> ``[b, h, sq, d]``
    in q's type.  CUDA tensors launch the kernel (raising on what it does not
    take); CPU tensors, or ``use_kernel=False``, run :func:`attention_ref`."""
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or k.shape[0] != q.shape[0]
            or k.shape[3] != q.shape[3] or k.shape[1] < 1 or q.shape[1] % k.shape[1]):
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not use_kernel or q.device.type == "cpu":
        return attention_ref(q, k, v, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward; call it under "
            "torch.no_grad() / torch.inference_mode(), or use_kernel=False to "
            "differentiate through the plain version")
    out = _kernel_bshd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
                       window, q_offset)
    return out.transpose(1, 2)
