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
  * **launch parameters** — kernels 1, 3 and 4 each take one layout at
    launch (kernel 1: 16 or 64 rows a tile; kernel 4: the 64-pair tile or
    the lean layout; kernel 3: rows per block and the depth of a chunk of
    logits).  :func:`resolve_blocks` picks it for a CUDA launch in the
    reference's order (``repro/kernels/ops.py``): explicit
    ``KernelConfig.block_n/block_out/block_in`` first, then the committed
    tuning table (``tuning_table.json`` beside this file, measured on an
    H100 by ``repro_torch.kernels.autotune``) when ``autotune`` is on, then
    the shape's rule, which each C entry point applies itself (``None``
    here, 0 at the entry point).  The table's key is the reference's
    :func:`shape_class`.  CPU tensors run the plain versions and read no
    ``block_*`` field and no table.
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
import functools
import json
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "KernelInfo",
    "KernelLaunchError",
    "KERNELS",
    "register_kernel",
    "reset_launch_counts",
    "kernel_choice",
    "TUNING_TABLE_PATH",
    "TUNING_TABLE_VERSION",
    "shape_class",
    "load_tuning_table",
    "lookup_blocks",
    "resolve_blocks",
    "check_launch",
    "cuda_stream",
    "on_device",
]


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a non-zero CUDA status."""


@dataclasses.dataclass
class KernelInfo:
    """One hand-written kernel: where its source lives, which TPU kernel it
    replaces, and how often (and at which shapes, in which layouts) it was
    launched."""

    name: str
    source: str  # path of the CUDA source in the repository
    replaces: str  # file:line of the Pallas kernel it replaces
    route: str = "cuda"
    launches: int = 0
    shapes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    # (shape, (block_n, block_out, block_in) the launch took): kernels 1, 3, 4
    layouts: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def record(self, shape: Tuple[int, ...], layout: Optional[Tuple[int, ...]] = None) -> None:
        key = tuple(int(x) for x in shape)
        with _COUNT_LOCK:
            self.launches += 1
            self.shapes[key] += 1
            if layout is not None:
                self.layouts[(key, tuple(int(x) for x in layout))] += 1

    def reset(self) -> None:
        with _COUNT_LOCK:
            self.launches = 0
            self.shapes.clear()
            self.layouts.clear()


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


TUNING_TABLE_PATH = Path(__file__).parent / "tuning_table.json"
TUNING_TABLE_VERSION = 1


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def shape_class(op: str, n: int, f: int, d_in: int, d_out: int,
                dtype: str = "float32") -> str:
    """The tuning table's key for one (op, shape class, dtype), the
    reference's: ``n`` bucketed to the next power of two (at least 8), the
    fanout and the feature widths exact."""
    return f"{op}/{dtype}/n{_next_pow2(max(8, n))}/f{f}/di{d_in}/do{d_out}"


@functools.lru_cache(maxsize=None)
def load_tuning_table(path: Optional[str] = None) -> Dict:
    """Load (and cache) a tuning table; a missing file is an empty table,
    another version than :data:`TUNING_TABLE_VERSION` raises."""
    p = Path(path) if path else TUNING_TABLE_PATH
    if not p.exists():
        return {"version": TUNING_TABLE_VERSION, "entries": {}}
    with open(p) as fh:
        table = json.load(fh)
    if table.get("version") != TUNING_TABLE_VERSION:
        raise ValueError(f"tuning table {p} has version {table.get('version')!r}; "
                         f"this build reads version {TUNING_TABLE_VERSION}")
    return table


Blocks = Tuple[Optional[int], Optional[int], Optional[int]]


def lookup_blocks(op: str, n: int, f: int, d_in: int, d_out: int, dtype: str = "float32",
                  path: Optional[str] = None) -> Optional[Blocks]:
    """The table's ``(block_n, block_out, block_in)`` for a shape class, or
    ``None`` on a miss (a field the entry lacks is ``None``: the rule's)."""
    entry = load_tuning_table(path).get("entries", {}).get(
        shape_class(op, n, f, d_in, d_out, dtype))
    if entry is None:
        return None
    return tuple(None if entry.get(k) is None else int(entry[k])
                 for k in ("block_n", "block_out", "block_in"))


def resolve_blocks(opts, op: str, n: int, f: int, d_in: int, d_out: int,
                   path: Optional[str] = None) -> Blocks:
    """The ``(block_n, block_out, block_in)`` a CUDA launch of ``op`` takes:
    explicit ``block_*`` fields on ``opts`` > the tuning table (when
    ``opts.autotune``) > ``None``, the shape's rule, which the C entry
    point applies.  The reference's order, with the rule in place of its
    ``DEFAULT_BLOCKS``; nothing is clamped: a value the kernel cannot
    launch raises at the launch."""
    blocks: Blocks = (None, None, None)
    if opts is not None and getattr(opts, "autotune", False):
        hit = lookup_blocks(op, n, f, d_in, d_out, path=path)
        if hit is not None:
            blocks = hit
    if opts is None:
        return blocks
    return tuple(getattr(opts, k, None) or v
                 for k, v in zip(("block_n", "block_out", "block_in"), blocks))


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
