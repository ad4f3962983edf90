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
probabilities.  The JAX package has no backward kernel for it.  The kernel
reads ``e`` and ``v`` through their strides, as ``attn_parts``' einsums
return them (HGT's values as a head-major view), so no copy runs in front
of it.

Launch layouts (kernels 1, 3 and 4): :func:`stacked_agg` resolves each
CUDA launch's ``(block_n, block_out, block_in)`` with
:func:`~repro_torch.kernels.ops.resolve_blocks` (explicit fields, then the
tuning table when ``autotune`` is on, then ``None``: the C entry point's
shape rule), under the reference's key for that op and shape class (the
q side's kernel 1 launch under its own, f = 1).  The wrappers map it to the
entry point's launch parameter and raise :class:`ValueError`, naming what
the shape takes, on anything else; nothing is clamped:

  * kernels 1 and 4: ``block_n`` 16 or 64, the rows of their fp32 tile
    (RM = 1 or 4; kernel 4's 16-row tile is its lean layout, one row a
    block); ``block_out`` 64 and ``block_in`` 32 are fixed;
  * kernel 3: ``block_n`` rows per block (up to 256 / ceil(H / 4)) and
    ``block_in`` neighbours a chunk of logits (up to 16); ``block_out``
    1024, the columns of a block, is fixed.

Every layout computes the same function in the same order (only which
thread computes a row changes).  ``KERNELS`` records beside each launch's
shape the layout it took, as the entry point's layout query answers.  CPU
tensors run the plain versions and read no ``block_*`` and no table.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.relmod import leaky_relu, masked_softmax
from repro_torch.kernels.ops import (
    check_launch,
    cuda_stream,
    kernel_choice,
    on_device,
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
    "attn_max_fanout",
    "take_slots",
    "launch_attn_epilogue",
    "launch_attn_dh",
    "launch_softmax_combine",
    "mean_linear_layout",
    "attn_layout",
    "softmax_combine_layout",
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
# must match csrc/fp32_tile.cuh: the columns of a block of kernels 1, 2, 5,
# and the depth of a streamed chunk of A (kernels 1 and 4)
_TILE_COLS = 64
_TILE_DEPTH = 32
# must match csrc/stacked_attn_epilogue.cu: the opt-in shared memory of one
# block on sm_90, which its fanout limit is stated against
_SMEM_LIMIT = 232448
# must match csrc/stacked_softmax_combine.cu: the threads of a block (each
# 4 columns of a row) and kF, the deepest chunk of logits
_SC_THREADS = 256
_SC_DEPTH = 16
_QUERIES: Dict[str, object] = {}


def _query(lib: str, name: str, argtypes, restype):
    """A layout query exported by ``csrc/<lib>.cu`` (host code only)."""
    fn = _QUERIES.get(name)
    if fn is None:
        from repro_torch.kernels.build import load

        fn = getattr(load(lib), name)
        fn.argtypes, fn.restype = argtypes, restype
        _QUERIES[name] = fn
    return fn


@functools.lru_cache(maxsize=4096)
def mean_linear_layout(rb: int, n: int, d_out: int, rm: int) -> int:
    """The rows per thread (1 or 4) ``csrc/stacked_mean_linear.cu`` launches
    at this shape and ``rm`` (0: its shape rule), or 0 when it refuses
    ``rm``: the entry point's own answer."""
    return _query("stacked_mean_linear", "stacked_mean_linear_rm",
                  [ctypes.c_longlong] * 3 + [ctypes.c_int], ctypes.c_int)(rb, n, d_out, rm)


@functools.lru_cache(maxsize=4096)
def attn_layout(f: int, d_in: int, nh: int, dh: int, two: bool, post: bool,
                rm: int) -> Tuple[int, int]:
    """``(rows per thread, destination rows per block)`` of a
    ``csrc/stacked_attn_epilogue.cu`` launch at this shape and ``rm`` (0:
    its shape rule; 4 the 64-pair tile, 1 the lean layout), or ``(0, 0)``
    when the entry point refuses it."""
    args = (f, d_in, nh, dh, int(two), int(post), rm)
    types = [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
    return (_query("stacked_attn_epilogue", "stacked_attn_epilogue_rm", types,
                   ctypes.c_int)(*args),
            _query("stacked_attn_epilogue", "stacked_attn_epilogue_rows", types,
                   ctypes.c_longlong)(*args))


@functools.lru_cache(maxsize=4096)
def softmax_combine_layout(nh: int, dh: int, rows: int, depth: int) -> Tuple[int, int]:
    """``(rows per block, chunk depth)`` of a
    ``csrc/stacked_softmax_combine.cu`` launch at this head shape (0 each:
    its rule), or ``(0, 0)`` when the entry point refuses them."""
    types = [ctypes.c_longlong] * 4
    return (_query("stacked_softmax_combine", "stacked_softmax_combine_rows", types,
                   ctypes.c_longlong)(nh, dh, rows, depth),
            _query("stacked_softmax_combine", "stacked_softmax_combine_depth", types,
                   ctypes.c_longlong)(nh, dh, rows, depth))


def _fixed_tile(op: str, block_out, block_in, cols: int, depth: Optional[int]) -> None:
    if block_out is not None and block_out != cols:
        raise ValueError(f"{op}: block_out={block_out} cannot launch; the kernel's column "
                         f"tile is fixed at {cols}")
    if depth is not None and block_in is not None and block_in != depth:
        raise ValueError(f"{op}: block_in={block_in} cannot launch; the kernel's chunk "
                         f"depth is fixed at {depth}")


def _tile_rm(op: str, blocks, takes=(16, 64)) -> int:
    """Rows per thread of a kernel 1 or 4 launch from ``blocks`` (0: the
    rule); ``takes``: the ``block_n`` values the shape can launch."""
    block_n, block_out, block_in = blocks
    _fixed_tile(op, block_out, block_in, _TILE_COLS, _TILE_DEPTH)
    if block_n is None:
        return 0
    if block_n not in takes:
        raise ValueError(f"{op}: block_n={block_n} cannot launch at this shape; it takes "
                         f"block_n {' or '.join(map(str, takes)) or 'none'} (the rows of "
                         f"its tile)")
    return block_n // 16


def _sc_params(nh: int, dh: int, blocks) -> Tuple[int, int]:
    """Rows per block and chunk depth of a kernel 3 launch from ``blocks``
    (0 each: the rule)."""
    op = "stacked_softmax_combine"
    block_n, block_out, block_in = blocks
    _fixed_tile(op, block_out, None, 4 * _SC_THREADS, None)
    rows, depth = block_n or 0, block_in or 0
    named = [x for x in (block_n, block_in) if x is not None]
    if named and (min(named) < 1 or softmax_combine_layout(nh, dh, rows, depth)[0] == 0):
        chunks = -(-nh * dh // 4)
        most = 1 if chunks >= _SC_THREADS else _SC_THREADS // chunks
        raise ValueError(
            f"{op}: block_n={block_n}, block_in={block_in} cannot launch at {nh} heads x "
            f"{dh}; it takes block_n (rows per block) 1 to {most} and block_in (neighbours "
            f"a chunk of logits) 1 to {_SC_DEPTH}, within {_SMEM_LIMIT} bytes of shared "
            f"memory")
    return rows, depth


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
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _dh_kernel():
    global _DH_FN
    if _DH_FN is None:
        from repro_torch.kernels.build import load

        fn = load("stacked_mean_linear_dh").stacked_mean_linear_dh
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
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


def _mean_linear_forward(h, mask, w, b, slots, blocks=(None, None, None)) -> torch.Tensor:
    """The forward on checked shapes: the kernel for CUDA, in the layout of
    ``blocks`` (module docstring), plain for CPU."""
    if h.device.type == "cpu":
        return stacked_mean_linear_ref(h, mask, w, b, slots)
    if h.device.type != "cuda":
        raise ValueError(f"stacked_mean_linear: unsupported device {h.device}")
    rb, n, f, d_in = h.shape
    d_out = w.shape[2]
    mask_u8 = _cuda_operands("stacked_mean_linear", h.device,
                             (("h", h), ("mask", mask), ("w", w), ("b", b)),
                             ("h", "w", "b"), mask)
    if rb > 65535 or -(-d_out // _TILE_COLS) > 65535:
        raise ValueError(f"stacked_mean_linear: grid of {rb} slots x "
                         f"{-(-d_out // _TILE_COLS)} column tiles exceeds 65535")
    rm = _tile_rm("stacked_mean_linear", blocks)
    out = torch.empty((rb, n, d_out), dtype=torch.float32, device=h.device)
    if rb == 0 or n == 0 or d_out == 0:
        return out
    launch_kernel(h, mask_u8, w, b, slots, out, rm)
    INFO.record((rb, n, f, d_in, d_out, w.shape[0]),
                (16 * mean_linear_layout(rb, n, d_out, rm), _TILE_COLS, _TILE_DEPTH))
    return out


def launch_kernel(h, mask_u8, w, b, slot_u_dev, out, rm: int = 0) -> None:
    """One raw forward launch on operands already checked and staged on
    ``h``'s device (``slot_u_dev`` int32, ``out`` allocated), at ``rm`` rows
    per thread (0: the entry point's shape rule; 1 or 4; anything else raises
    :class:`~repro_torch.kernels.ops.KernelLaunchError`).  Not counted:
    production calls go through the wrapper; this entry exists so kernel
    time can be measured without the staging."""
    rb, n, f, d_in = h.shape
    with on_device(h.device):
        status = _kernel()(h.data_ptr(), mask_u8.data_ptr(), w.data_ptr(), b.data_ptr(),
                           slot_u_dev.data_ptr(), out.data_ptr(), rb, n, f, d_in,
                           w.shape[2], rm, cuda_stream(h.device))
    check_launch(status, "stacked_mean_linear")


def launch_dh_kernel(g, mask_u8, w, slot_u_dev, dh) -> None:
    """One raw ``dh`` launch on operands already checked and staged on
    ``g``'s device (``dh`` allocated as ``[rb, n, f, d_in]``).  Not counted,
    like :func:`launch_kernel`."""
    rb, n, f, d_in = dh.shape
    with on_device(g.device):
        status = _dh_kernel()(g.data_ptr(), mask_u8.data_ptr(), w.data_ptr(),
                              slot_u_dev.data_ptr(), dh.data_ptr(), rb, n, f, d_in,
                              g.shape[2], cuda_stream(g.device))
    check_launch(status, "stacked_mean_linear_dh")


# --------------------------------------------------------------------------
# public ops
# --------------------------------------------------------------------------


def stacked_mean_linear_dh(
    g: torch.Tensor,  # [rb, n, d_out] float32: the gradient of the output
    mask: torch.Tensor,  # [rb, n, f] bool or uint8
    w: torch.Tensor,  # [U, d_in, d_out] float32
    slot_u,  # [rb] host integer array in [0, U), or stage_slot_u's tensor
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
    if rb > 65535 or -(-d_in // _TILE_COLS) > 65535:
        raise ValueError(f"stacked_mean_linear_dh: grid of {rb} slots x "
                         f"{-(-d_in // _TILE_COLS)} column tiles exceeds 65535")
    dh = torch.empty((rb, n, f, d_in), dtype=torch.float32, device=g.device)
    if rb == 0 or n == 0 or f == 0 or d_in == 0:
        return dh
    launch_dh_kernel(g, mask_u8, w, slots, dh)
    INFO_DH.record((rb, n, f, d_in, d_out, U))
    return dh


class _StackedMeanLinear(torch.autograd.Function):
    """Forward kernel + stack-form backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, h, mask, w, b, slots, blocks):
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
    *,
    block_n: Optional[int] = None,
    block_out: Optional[int] = None,
    block_in: Optional[int] = None,
) -> torch.Tensor:
    """``out[s] = masked_mean(h[s], mask[s]) @ w[slot_u[s]] + b[slot_u[s]]``,
    differentiable in ``h``, ``w`` and ``b`` (:class:`_StackedMeanLinear`).

    CUDA tensors launch the kernels (raising on what they do not take); CPU
    tensors run the plain versions.  ``slot_u`` is a host array, checked and
    copied to the device on each call, or an int32 tensor on ``h``'s device
    from :func:`stage_slot_u`, checked when it was staged.  ``block_*``
    choose the forward kernel's layout on CUDA (``block_n`` 16 or 64; the
    module docstring); the backward kernel's tile is fixed."""
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
    return _StackedMeanLinear.apply(h, mask, w, b, slots, (block_n, block_out, block_in))


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


def attn_max_fanout(num_heads: int, head_dim: int, two: bool, post: bool) -> int:
    """The widest row ``csrc/stacked_attn_epilogue.cu`` takes: the largest f
    with ``4 * (f * (H * (1 + two) + nh) + H * (1 + post) + 64 * 33 + 32 * 64
    * (1 + two))`` bytes within one block's shared memory (its first
    version's arithmetic, kept as the contract): 392 for HGT and 792 for
    R-GAT at 4 heads x 16.  ``two``: the values have their own projection;
    ``post``: pe/pv transforms.  How many rows a block holds is the C entry
    point's choice alone.  At H near 1000 its lean layout binds first and
    the entry point also refuses some f within this limit (the launch then
    raises :class:`~repro_torch.kernels.ops.KernelLaunchError`)."""
    H, k, q = num_heads * head_dim, 2 if two else 1, 2 if post else 1
    return (_SMEM_LIMIT // 4 - H * q - 64 * 33 - 32 * 64 * k) // (H * k + num_heads)


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
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _AE_FN = fn
    return _AE_FN


def _adh_kernel():
    global _ADH_FN
    if _ADH_FN is None:
        from repro_torch.kernels.build import load

        fn = load("stacked_attn_dh").stacked_attn_dh
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ADH_FN = fn
    return _ADH_FN


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch_attn_epilogue(h, mask_u8, qv, eb, we, wv, pe, pv, us, out, z0, v0,
                         num_heads, head_dim, scale, slope, rm: int = 0) -> None:
    """One raw epilogue launch on operands already checked and on ``h``'s
    device (outputs allocated; ``z0``/``v0`` None without residuals), in the
    layout of ``rm`` (0: the entry point's shape rule; 4 the 64-pair tile, 1
    the lean layout; one the shape cannot take raises
    :class:`~repro_torch.kernels.ops.KernelLaunchError`).  Not counted:
    production calls go through :func:`attn_epilogue_forward`."""
    rb, n, f, d_in = h.shape
    with on_device(h.device):
        status = _ae_kernel()(
            h.data_ptr(), mask_u8.data_ptr(), qv.data_ptr(), qv.stride(0), qv.stride(1),
            _ptr(eb), we.data_ptr(), _ptr(wv), _ptr(pe), _ptr(pv), us.data_ptr(),
            out.data_ptr(), _ptr(z0), _ptr(v0), rb, n, f, d_in, num_heads, head_dim,
            float(scale), 0.0 if slope is None else float(slope), int(slope is not None),
            rm, cuda_stream(h.device))
    check_launch(status, "stacked_attn_epilogue")


def launch_attn_dh(dz, dv, we, wv, us, dh) -> None:
    """One raw ``dh`` launch on operands already checked and on ``dz``'s
    device (``dh`` allocated).  Not counted, like :func:`launch_attn_epilogue`."""
    rb, n, f, H = dz.shape
    with on_device(dz.device):
        status = _adh_kernel()(dz.data_ptr(), _ptr(dv), we.data_ptr(), _ptr(wv),
                               us.data_ptr(), dh.data_ptr(), rb, n, f, we.shape[1], H,
                               cuda_stream(dz.device))
    check_launch(status, "stacked_attn_dh")


def _check_us(op: str, us, rb: int, device) -> None:
    if not torch.is_tensor(us) or us.shape != (3, rb) or us.dtype != torch.int32 \
            or us.device != device:
        raise ValueError(f"{op}: us must be the [3, {rb}] int32 tensor of attn_slots on "
                         f"{device}")


def attn_epilogue_forward(h, mask, qv, eb, we, wv, pe, pv, us, *, num_heads: int,
                          head_dim: int, scale: float = 1.0, slope=None,
                          with_residuals: bool = False, block_n: Optional[int] = None,
                          block_out: Optional[int] = None, block_in: Optional[int] = None):
    """The fused attention AGG_r on stacked operands (see
    :func:`stacked_attn_epilogue_ref` for the function and the return).

    CUDA tensors launch ``csrc/stacked_attn_epilogue.cu`` (raising on what it
    does not take) in the layout ``block_*`` name (``block_n`` 16 or 64; the
    module docstring); CPU tensors run the plain version.  ``us`` comes from
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
    two = wv is not None
    limit = attn_max_fanout(nh, dh, two, post)
    if f > limit:
        raise FanoutTooWideError(
            f"{op}: a row of fanout {f} at {nh} heads x {dh} does not fit the shared "
            f"memory of one block; the kernel takes f <= {limit}")
    takes = (16, 64) if block_n is None else tuple(
        16 * rm for rm in (1, 4) if attn_layout(f, d_in, nh, dh, two, post, rm)[0])
    rm = _tile_rm(op, (block_n, block_out, block_in), takes)
    launch_attn_epilogue(h, mask_u8, qv, eb, we, wv, pe, pv, us, out, z0,
                         None if wv is None else v0, nh, dh, scale, slope, rm)
    INFO_AE.record((rb, n, f, d_in, nh, dh, we.shape[0],
                    0 if wv is None else wv.shape[0], pe.shape[0] if post else 0,
                    eb is not None, slope is not None, qv.stride(1) == 0,
                    with_residuals),
                   (16 * attn_layout(f, d_in, nh, dh, two, post, rm)[0], _TILE_COLS,
                    _TILE_DEPTH))
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
    if rb > 65535 or -(-d_in // _TILE_COLS) > 65535:
        raise ValueError(f"{op}: grid of {rb} slots x {-(-d_in // _TILE_COLS)} column "
                         f"tiles exceeds 65535")
    dh = torch.empty((rb, n, f, d_in), dtype=torch.float32, device=dz.device)
    if min(rb, n, f, d_in) == 0:
        return dh
    if H == 0:
        return dh.zero_()
    launch_attn_dh(dz, dv, we, wv, us, dh)
    INFO_ADH.record((rb, n, f, d_in, H, we.shape[0], 0 if wv is None else wv.shape[0]))
    return dh


@dataclasses.dataclass(frozen=True)
class _AECfg:
    num_heads: int
    head_dim: int
    scale: float
    slope: Optional[float]
    blocks: Tuple[Optional[int], Optional[int], Optional[int]] = (None, None, None)


class _StackedAttnEpilogue(torch.autograd.Function):
    """Epilogue kernel forward with residuals + the closed-form backward of
    the reference's ``_ae_vjp_bwd`` (see the module docstring)."""

    @staticmethod
    def forward(ctx, h, mask, qv, eb, we, wv, pe, pv, us, cfg: _AECfg):
        out, z0, v0 = attn_epilogue_forward(
            h, mask, qv, eb, we, wv, pe, pv, us, num_heads=cfg.num_heads,
            head_dim=cfg.head_dim, scale=cfg.scale, slope=cfg.slope, with_residuals=True,
            **dict(zip(("block_n", "block_out", "block_in"), cfg.blocks)))
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


def stacked_attn_epilogue(epi, h: torch.Tensor, mask: torch.Tensor, *,
                          block_n: Optional[int] = None, block_out: Optional[int] = None,
                          block_in: Optional[int] = None) -> torch.Tensor:
    """Fused attention AGG_r from a module's :class:`~repro_torch.core.relmod.
    AttnEpilogue` operands, differentiable in ``h`` and every operand
    (:class:`_StackedAttnEpilogue`); without a gradient to take it launches
    the kernel with no residuals.  ``block_*``: the kernel's layout on CUDA
    (:func:`attn_epilogue_forward`)."""
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
                 None if epi.slope is None else float(epi.slope),
                 (block_n, block_out, block_in))
    # the kernel takes contiguous operands (qv through its strides); eb comes
    # out of an einsum, which may return a permuted view
    args = (h.contiguous(), mask, epi.qv, None if epi.eb is None else epi.eb.contiguous(),
            epi.we, epi.wv, epi.pe, epi.pv)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        out = _StackedAttnEpilogue.apply(*args, us, cfg)
    else:
        out = attn_epilogue_forward(*args, us, num_heads=cfg.num_heads,
                                    head_dim=cfg.head_dim, scale=cfg.scale, slope=cfg.slope,
                                    block_n=block_n, block_out=block_out, block_in=block_in)
    return out if epi.bias is None else out + epi.bias[:, None, :]


def _epilogue_linear(w_stack, u, x, opts=None) -> torch.Tensor:
    """Per-slot projection ``x @ w_stack[u]`` for the q side of an attention
    epilogue: :func:`stacked_mean_linear` at fanout 1 (the masked mean over
    one neighbour is the identity), so the weights are read from the stack
    and the gradient lands in stack form.  Its layout resolves under kernel
    1's own shape class (f = 1)."""
    rb, n, d = x.shape
    zb = torch.zeros((w_stack.shape[0], w_stack.shape[2]), dtype=w_stack.dtype,
                     device=w_stack.device)
    ones = torch.ones((rb, n, 1), dtype=torch.bool, device=x.device)
    return stacked_mean_linear(
        x.contiguous()[:, :, None, :], ones, w_stack, zb, u,
        **_blocks(opts, "stacked_mean_linear", x.device, n, 1, d, w_stack.shape[2]))


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _sc_kernel():
    global _SC_FN
    if _SC_FN is None:
        from repro_torch.kernels.build import load

        fn = load("stacked_softmax_combine").stacked_softmax_combine_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 15 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _SC_FN = fn
    return _SC_FN


def launch_softmax_combine(e, mask_u8, v, out, rows: int = 0, depth: int = 0) -> None:
    """One raw launch on operands already checked and on ``e``'s device
    (``v`` ``[rb, n, f, nh, dh]`` with its last dimension contiguous, ``e``
    of any strides, ``mask_u8`` and ``out`` contiguous), at ``rows`` rows per
    block and chunk depth ``depth`` (0 each: the entry point's rule, from the
    head width; a layout it refuses raises
    :class:`~repro_torch.kernels.ops.KernelLaunchError`).  Not counted:
    production calls go through :func:`softmax_combine_forward`."""
    rb, n, f, nh, dh = v.shape
    with on_device(e.device):
        status = _sc_kernel()(e.data_ptr(), mask_u8.data_ptr(), v.data_ptr(), out.data_ptr(),
                              rb, n, f, nh, dh, *e.stride(), *v.stride()[:4], rows, depth,
                              cuda_stream(e.device))
    check_launch(status, "stacked_softmax_combine")


def softmax_combine_forward(e, mask, v, *, block_n: Optional[int] = None,
                            block_out: Optional[int] = None,
                            block_in: Optional[int] = None) -> torch.Tensor:
    """The masked softmax + combine forward: the kernel for CUDA tensors
    (fp32; ``e`` of any strides, ``v`` with its last dimension contiguous,
    as ``attn_parts``' einsums return them; anything else raises) in the
    layout ``block_*`` name (the module docstring), the plain version for
    CPU ones."""
    op = "stacked_softmax_combine"
    if v.dim() != 5 or e.shape != v.shape[:4] or mask.shape != v.shape[:3]:
        raise ValueError(f"{op} shapes: e {tuple(e.shape)}, mask {tuple(mask.shape)}, "
                         f"v {tuple(v.shape)}")
    if not _is_cuda(e):
        if e.device.type != "cpu":
            raise ValueError(f"{op}: unsupported device {e.device}")
        return stacked_softmax_combine_ref(e, mask, v)
    if v.shape[4] > 1 and v.stride(4) != 1:
        raise ValueError(f"{op} kernel takes a v whose last dimension has unit stride")
    mask_u8 = _cuda_operands(op, e.device, (("mask", mask),), (), mask)
    for name, t in (("e", e), ("v", v)):
        if t.device != e.device:
            raise ValueError(f"{op}: {name} on {t.device}, expected {e.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{op} kernel takes float32 {name}, got {t.dtype}")
    rb, n, f, nh, dh = v.shape
    if rb > 65535:
        raise ValueError(f"{op}: {rb} slots exceed the grid's 65535")
    rows, depth = _sc_params(nh, dh, (block_n, block_out, block_in))
    out = torch.empty((rb, n, nh * dh), dtype=torch.float32, device=e.device)
    if min(rb, n, nh * dh) == 0:
        return out
    launch_softmax_combine(e, mask_u8, v, out, rows, depth)
    taken = softmax_combine_layout(nh, dh, rows, depth)
    INFO_SC.record((rb, n, f, nh, dh), (taken[0], 4 * _SC_THREADS, taken[1]))
    return out


class _StackedSoftmaxCombine(torch.autograd.Function):
    """Kernel forward + the closed-form softmax Jacobian of the reference's
    ``_sc_vjp_bwd`` (probabilities recomputed, none saved)."""

    @staticmethod
    def forward(ctx, e, mask, v, blocks):
        ctx.save_for_backward(e, mask, v)
        return softmax_combine_forward(e, mask, v, **dict(
            zip(("block_n", "block_out", "block_in"), blocks)))

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
        return de, None, dv, None


def stacked_softmax_combine(
    e: torch.Tensor,  # [rb, n, f, nh] logits
    mask: torch.Tensor,  # [rb, n, f] bool or uint8
    v: torch.Tensor,  # [rb, n, f, nh, dh] values
    *,
    block_n: Optional[int] = None,
    block_out: Optional[int] = None,
    block_in: Optional[int] = None,
) -> torch.Tensor:
    """Masked softmax over f of ``e``, then ``out[s, i, h] = sum_j alpha[s, i,
    j, h] * v[s, i, j, h]`` -> ``[rb, n, nh * dh]``, differentiable in ``e``
    and ``v`` (:class:`_StackedSoftmaxCombine`).  A fully masked row gives
    zeros.  CUDA tensors launch ``csrc/stacked_softmax_combine.cu``, which
    reads ``e`` and ``v`` through their strides (HGT's einsums return
    permuted views; they reach the kernel with no copy; ``v``'s last
    dimension must have unit stride) in the layout ``block_*`` name (the
    module docstring); CPU tensors run :func:`stacked_softmax_combine_ref`."""
    return _StackedSoftmaxCombine.apply(e, mask, v, (block_n, block_out, block_in))


def _attn_parts_agg(module, stacks, slot_u, h, q, mask, opts=None) -> torch.Tensor:
    """The ``fuse_epilogue=False`` path: the module's ``attn_parts`` on
    per-slot weights (gathered with :func:`take_slots`, so their gradients
    sum back in a fixed order), then :func:`stacked_softmax_combine`."""
    scope_of = {s.name: s.scope for s in module.specs}
    p_slots = {name: take_slots(stacks[name], slot_u[scope_of[name]]) for name in stacks}
    e, v = torch.func.vmap(module.attn_parts)(p_slots, h, q)
    _, n, f, d_in = h.shape
    out = stacked_softmax_combine(e, mask, v, **_blocks(
        opts, "stacked_softmax_combine", e.device, n, f, d_in, v.shape[3] * v.shape[4]))
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
    Each CUDA launch of kernels 1, 3 and 4 takes the layout
    :func:`~repro_torch.kernels.ops.resolve_blocks` gives its op and shape
    class under ``opts`` (``block_*`` fields, then the tuning table when
    ``autotune`` is on, then the shape's rule; the reference's ``_blocks``)."""
    scope_of = {s.name: s.scope for s in module.specs}
    use = kernel_choice(opts, "stacked_agg")
    _, n, f, d_in = h.shape
    if (use and module.fused == "mean_linear" and scope_of.get("w") is not None
            and scope_of.get("w") == scope_of.get("b")):
        return stacked_mean_linear(h, mask, stacks["w"], stacks["b"], slot_u[scope_of["w"]],
                                   **_blocks(opts, "stacked_mean_linear", h.device, n, f,
                                             d_in, stacks["w"].shape[2]))
    if use and module.fused == "softmax_combine":
        if getattr(opts, "fuse_epilogue", True):
            epi = module.attn_epilogue(stacks, slot_u, q,
                                       linear=functools.partial(_epilogue_linear, opts=opts),
                                       take=take_slots)
            if epi is not None:
                return stacked_attn_epilogue(epi, h, mask, **_blocks(
                    opts, "stacked_attn_epilogue", h.device, n, f, d_in,
                    int(epi.num_heads) * int(epi.head_dim)))
        return _attn_parts_agg(module, stacks, slot_u, h, q, mask, opts)
    return stacked_agg_ref(module, stacks, slot_u, h, q, mask)


def _blocks(opts, op: str, device, n: int, f: int, d_in: int, d_out: int) -> dict:
    """The ``block_*`` keywords of a launch on ``device``: the resolved
    layout on CUDA (``None`` fields left out: the rule), none on the CPU,
    where no field and no table is read."""
    if torch.device(device).type != "cuda":
        return {}
    blocks = resolve_blocks(opts, op, n, f, d_in, d_out)
    return {k: v for k, v in zip(("block_n", "block_out", "block_in"), blocks)
            if v is not None}
