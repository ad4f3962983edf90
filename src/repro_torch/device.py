"""Device resolution for the port's entry points.

The port is written for an NVIDIA GPU.  Its entry points (``Heta``, the
serve CLI, ``chip_smoke.py``) take ``device=None`` to mean "the GPU": with
no CUDA device that is an error, never a silent fall-back to the CPU.  The
CPU runs only when the caller asks for it by name (``device="cpu"``), as
the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["NoGPUError", "resolve_device"]


class NoGPUError(RuntimeError):
    """The GPU was asked for (explicitly or by default) and there is none."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raising :class:`NoGPUError` without one);
    anything else is taken as named, and a ``cuda`` name is checked too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoGPUError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run its plain PyTorch path on "
            "the CPU"
        )
    return dev
