"""Device resolution for the port's entry points.

The port is written for an NVIDIA GPU.  Its entry points (``Heta``, the
serve CLI, ``chip_smoke.py``) take ``device=None`` to mean "the GPU": with
no CUDA device that is an error, never a silent fall-back to the CPU.  The
CPU runs only when the caller asks for it by name (``device="cpu"``), as
the tests do.

:func:`resolve_device` also settles the process's CPU vector math before
any entry point computes: torch's CPU ``sqrt``, ``exp``, ``log``, ``tanh``
and their kin reach MKL's vector math library, which picks its code path
on its first call.  When that first call is a parallel one (a tensor of
several thousand elements, split over the OpenMP threads), one thread's
chunk can come back from a low-accuracy path: a ``sqrt`` good to 12 bits
(relative error up to 3e-4), in about one fresh process in thirty on a
loaded host, and never again after.  A spawned data-parallel rank whose
first such call was its first Adam update then drifted from rank 0.  One
call on a one-element tensor, made before anything else, takes the first
call off the threads.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["NoGPUError", "resolve_device", "settle_cpu_math"]

_cpu_math_settled = False


class NoGPUError(RuntimeError):
    """The GPU was asked for (explicitly or by default) and there is none."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raising :class:`NoGPUError` without one);
    anything else is taken as named, and a ``cuda`` name is checked too."""
    settle_cpu_math()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoGPUError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run its plain PyTorch path on "
            "the CPU"
        )
    return dev


def settle_cpu_math() -> None:
    """Make this process's first call into MKL's vector math a serial one
    (see the module docstring); later calls do nothing."""
    global _cpu_math_settled
    if not _cpu_math_settled:
        torch.sqrt(torch.ones(1))
        _cpu_math_settled = True
