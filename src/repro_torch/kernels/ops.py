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
  * **launch block sizes** — none to choose: every kernel's tile is fixed
    in its source (kernels 1, 5 and 6 pick their rows per block from the
    shape in their C entry points, kernel 3 from the head width, kernel 4
    from the fanout).  ``KernelConfig.block_n/block_out/block_in`` are the
    reference's config fields, validated and kept, but no CUDA launch reads
    them; :func:`refuse_autotune` refuses ``autotune=True``, since there is
    no tuning table.
  * **launch accounting** — each kernel registers a :class:`KernelInfo`
    in :data:`KERNELS`; its wrapper calls :meth:`KernelInfo.record` exactly
    where it launches the kernel, so a run can show which kernels its path
    went through.  The counts take a lock: launches come from the trainer's
    thread and from a server's flush thread, and a count must not lose an
    increment whichever thread launches (the pipeline's producer thread
    stages on the host and launches none).
  * **launch checks** — :func:`check_launch` turns a non-zero CUDA status
    returned by a launch into :class:`KernelLaunchError`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Dict, Tuple

import torch

__all__ = [
    "KernelInfo",
    "KernelLaunchError",
    "KERNELS",
    "register_kernel",
    "reset_launch_counts",
    "kernel_choice",
    "refuse_autotune",
    "check_launch",
    "cuda_stream",
    "on_device",
]


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
        key = tuple(int(x) for x in shape)
        with _COUNT_LOCK:
            self.launches += 1
            self.shapes[key] += 1

    def reset(self) -> None:
        with _COUNT_LOCK:
            self.launches = 0
            self.shapes.clear()


_COUNT_LOCK = threading.Lock()


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


def refuse_autotune(opts) -> None:
    """Raise on ``kernels.autotune=True``: the port's kernels have fixed
    tiles and no tuning table (the ``block_*`` fields reach no launch)."""
    if getattr(opts, "autotune", False):
        raise NotImplementedError(
            "kernels.autotune: the port's CUDA kernels have fixed tiles and no "
            "tuning table")


def check_launch(status: int, name: str) -> None:
    """Raise when a kernel launch returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise KernelLaunchError(f"{name}: CUDA launch failed with cudaError_t {status}")


# PyTorch's raw current-stream and current-device queries.  They are
# private (checked against torch 2.11.0+cu128); a CPU-only build has
# neither, so they are looked up here and asked for only by a launch.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_RAW_DEVICE = getattr(torch._C, "_cuda_getDevice", None)


def _raw_queries_missing() -> RuntimeError:
    return RuntimeError(
        f"torch {torch.__version__} lacks torch._C._cuda_getCurrentRawStream or "
        f"torch._C._cuda_getDevice, the raw queries every CUDA launch of the port "
        f"takes its stream and device from (checked against torch 2.11.0+cu128)")


def cuda_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``: inside a
    ``torch.cuda.graph`` capture, the capture stream.  Asked of PyTorch's
    raw query, which builds no ``torch.cuda.Stream`` object: every ctypes
    launch of the port passes through here, and at the port's launch-sized
    shapes the host's launch path is most of a kernel's eager time."""
    if _RAW_STREAM is None or _RAW_DEVICE is None:
        raise _raw_queries_missing()
    index = device.index
    return _RAW_STREAM(_RAW_DEVICE() if index is None else index)


_NO_SWITCH = contextlib.nullcontext()


def on_device(device: torch.device):
    """The context a raw launch on ``device`` runs in: ``device`` made
    current, and nothing to do when it already is (the usual case), so a
    launch costs the host no device switch.  The caller's tensor lies on
    ``device``, so CUDA is initialised and the raw device query suffices."""
    if _RAW_DEVICE is None:
        raise _raw_queries_missing()
    if device.index is None or device.index == _RAW_DEVICE():
        return _NO_SWITCH
    return torch.cuda.device(device)
