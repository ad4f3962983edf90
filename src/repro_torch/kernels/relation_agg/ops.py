"""Public op: relation aggregation of one relation, with its autograd seam.

:func:`relation_agg` runs through :class:`_RelationAgg`, a
``torch.autograd.Function`` (the counterpart of the reference's
``jax.custom_vjp``, ``repro/kernels/relation_agg/ops.py:46-81``):

  * forward — the hand-written CUDA kernel ``csrc/relation_agg.cu`` for CUDA
    tensors (fp32, contiguous; anything else raises), :func:`relation_agg_ref`
    for CPU tensors.  The kernel is the template of ``csrc/mean_linear.cuh``
    that ``stacked_mean_linear`` runs, in its single-slot form: the same
    arithmetic, so its outputs equal ``stacked_mean_linear``'s at rb = 1 bit
    for bit; it picks its tile from the shape, and takes no block sizes;
  * backward — the reference's closed form as torch ops, from the masked
    mean recomputed out of the saved ``h``: ``dh = (g @ w^T / cnt) * mask``
    broadcast over f, ``dw = mean^T @ g``, ``db = g.sum(0)``.  The JAX
    package has no backward kernel here; its two products are plain matrix
    products outside any Pallas kernel, and stay ``torch.matmul``.

The caller is the dict-form model (``repro_torch.core.hgnn.agg_relation``),
which routes R-GCN's aggregation here when ``kernels.relation_agg`` is on.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ops import check_launch, cuda_stream, on_device, register_kernel
from repro_torch.kernels.relation_agg.ref import relation_agg_ref

__all__ = ["relation_agg", "relation_agg_ref", "relation_agg_forward", "launch_kernel",
           "INFO"]

INFO = register_kernel(
    "relation_agg",
    source="src/repro_torch/kernels/csrc/relation_agg.cu",
    replaces="src/repro/kernels/relation_agg/kernel.py:64",
)
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import load

        fn = load("relation_agg").relation_agg_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch_kernel(h, mask_u8, w, b, out) -> None:
    """One raw launch on operands already checked and on ``h``'s device
    (``out`` allocated).  Not counted: production calls go through
    :func:`relation_agg`; this entry exists so kernel time can be measured
    without the checks."""
    n, f, d_in = h.shape
    with on_device(h.device):
        status = _kernel()(h.data_ptr(), mask_u8.data_ptr(), w.data_ptr(), b.data_ptr(),
                           out.data_ptr(), n, f, d_in, w.shape[1], cuda_stream(h.device))
    check_launch(status, "relation_agg")


def relation_agg_forward(h, mask, w, b) -> torch.Tensor:
    """The forward alone: the kernel for CUDA tensors, the plain version for
    CPU ones (shapes checked by :func:`relation_agg`)."""
    if h.device.type == "cpu":
        return relation_agg_ref(h, mask, w, b)
    if h.device.type != "cuda":
        raise ValueError(f"relation_agg: unsupported device {h.device}")
    for name, t in (("h", h), ("mask", mask), ("w", w), ("b", b)):
        if t.device != h.device:
            raise ValueError(f"relation_agg: {name} on {t.device}, expected {h.device}")
        if name != "mask" and t.dtype != torch.float32:
            raise ValueError(f"relation_agg kernel takes float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"relation_agg kernel takes a contiguous {name}")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    elif mask.dtype != torch.uint8:
        raise ValueError(f"relation_agg mask must be bool or uint8, got {mask.dtype}")
    n, f, d_in = h.shape
    d_out = w.shape[1]
    out = torch.empty((n, d_out), dtype=torch.float32, device=h.device)
    if n == 0 or d_out == 0:
        return out
    launch_kernel(h, mask, w, b, out)
    INFO.record((n, f, d_in, d_out))
    return out


class _RelationAgg(torch.autograd.Function):
    """Forward kernel + the reference's closed-form backward."""

    @staticmethod
    def forward(ctx, h, mask, w, b):
        ctx.save_for_backward(h, mask, w)
        return relation_agg_forward(h, mask, w, b)

    @staticmethod
    def backward(ctx, g):
        h, mask, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        mw = mask.to(h.dtype)
        cnt = torch.clamp(mw.sum(dim=-1, keepdim=True), min=1.0)
        dh = dw = db = None
        if need[0]:
            dmean = g @ w.t()
            dh = (dmean / cnt)[:, None, :] * mw[:, :, None]
        if need[2]:
            mean = torch.einsum("nfd,nf->nd", h, mw) / cnt
            dw = mean.t() @ g
        if need[3]:
            db = g.sum(dim=0)
        return dh, None, dw, db


def relation_agg(
    h: torch.Tensor,  # [n, f, d_in]
    mask: torch.Tensor,  # [n, f] bool or uint8
    w: torch.Tensor,  # [d_in, d_out]
    b: torch.Tensor,  # [d_out]
) -> torch.Tensor:
    """``masked_mean(h, mask) @ w + b`` -> ``[n, d_out]``, differentiable in
    ``h``, ``w`` and ``b`` (:class:`_RelationAgg`).

    CUDA tensors launch the kernel (raising on what it does not take); CPU
    tensors run the plain version in their own dtype."""
    if (h.dim() != 3 or mask.shape != h.shape[:2] or w.dim() != 2
            or w.shape[0] != h.shape[2] or b.shape != (w.shape[1],)):
        raise ValueError(f"relation_agg shapes: h {tuple(h.shape)}, mask "
                         f"{tuple(mask.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    return _RelationAgg.apply(h, mask, w, b)
