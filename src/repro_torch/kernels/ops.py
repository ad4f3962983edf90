"""Shared dispatch layer of the port's kernel tree.

Every kernel op answers the same questions the same way, so the answers
live here:

  * **whether the op is on** — :func:`kernel_choice` reads the layer
    switch and the per-op toggle off ``repro_torch.api.config.KernelConfig``
    (``None``, or a missing attribute, means the default: on).
    An op that is on launches its hand-written kernel for a CUDA tensor
    (or raises — there is no fall-back) and runs its plain PyTorch version
    for a CPU tensor; an op that is off runs the plain version wherever its
    tensors live.  There is no interpreter for CUDA kernels, so
    ``interpret=True`` is refused.
  * **launch block sizes** — :func:`resolve_blocks`: explicit ``block_*``
    overrides beat the CUDA defaults in :data:`DEFAULT_BLOCKS`.
  * **launch accounting** — each kernel registers a :class:`KernelInfo`
    in :data:`KERNELS`; its wrapper calls :meth:`KernelInfo.record` exactly
    where it launches the kernel, so a run can show which kernels its path
    went through.
  * **launch checks** — :func:`check_launch` turns a non-zero CUDA status
    returned by a launch into :class:`KernelLaunchError`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Tuple

import torch

__all__ = [
    "KernelInfo",
    "KernelLaunchError",
    "KERNELS",
    "DEFAULT_BLOCKS",
    "register_kernel",
    "reset_launch_counts",
    "kernel_choice",
    "resolve_blocks",
    "check_launch",
    "cuda_stream",
]


# CUDA launch defaults per op: (block_n, block_out, block_in)
DEFAULT_BLOCKS: Dict[str, Tuple[int, int, int]] = {
    "stacked_mean_linear": (16, 64, 64),
    # block_out is the d_out chunk of the backward's inner loop; block_in
    # must divide the kernel's 256 threads
    "stacked_mean_linear_dh": (32, 64, 64),
    # block_n is the budget of (row, neighbour) pairs per block: a block
    # holds max(1, block_n // f) destination rows; block_out is the fixed
    # 64-column pass of the projection; block_in the d_in chunk
    "stacked_attn_epilogue": (64, 64, 32),
    # (pairs, d_in columns, H chunk) of one block of dh
    "stacked_attn_dh": (64, 64, 32),
}


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a non-zero CUDA status."""


@dataclasses.dataclass
class KernelInfo:
    """One hand-written kernel: where its source lives, which TPU kernel it
    replaces, and how often (and at which shapes) it was launched."""

    name: str
    source: str  # path of the CUDA source in the repository
    replaces: str  # file:line of the Pallas kernel it replaces
    route: str = "cuda"
    launches: int = 0
    shapes: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def record(self, shape: Tuple[int, ...]) -> None:
        self.launches += 1
        self.shapes[tuple(int(x) for x in shape)] += 1

    def reset(self) -> None:
        self.launches = 0
        self.shapes.clear()


KERNELS: Dict[str, KernelInfo] = {}


def register_kernel(name: str, source: str, replaces: str) -> KernelInfo:
    info = KERNELS.setdefault(name, KernelInfo(name, source, replaces))
    return info


def reset_launch_counts() -> None:
    for info in KERNELS.values():
        info.reset()


def kernel_choice(opts, op: str) -> bool:
    """Whether op ``op`` uses its kernel path (see module docstring)."""
    if getattr(opts, "interpret", None):
        raise ValueError(
            "kernels.interpret=True is not available in the port: a CUDA "
            "kernel has no interpreter; CPU tensors run the plain PyTorch "
            "version of each op")
    return bool(getattr(opts, "enabled", True) and getattr(opts, op, True))


def resolve_blocks(opts, op: str) -> Tuple[int, int, int]:
    """The (block_n, block_out, block_in) a launch of ``op`` uses: explicit
    overrides on ``opts`` beat :data:`DEFAULT_BLOCKS`."""
    bn, bo, bc = DEFAULT_BLOCKS[op]
    if opts is not None:
        if getattr(opts, "autotune", False):
            raise NotImplementedError(
                "kernels.autotune: the port has no CUDA tuning table yet; "
                "pass explicit kernels.block_* sizes instead")
        bn = getattr(opts, "block_n", None) or bn
        bo = getattr(opts, "block_out", None) or bo
        bc = getattr(opts, "block_in", None) or bc
    return bn, bo, bc


def check_launch(status: int, name: str) -> None:
    """Raise when a kernel launch returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise KernelLaunchError(f"{name}: CUDA launch failed with cudaError_t {status}")


def cuda_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
