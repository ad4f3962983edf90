"""Operations of one step or call, counted from the configuration file's
shapes, one module per kind of block (``blocks`` in the file).  Each module
has ``flops(cfg, b, s, mode)``: the floating-point operations that its
blocks' matrix products need for ``b`` sequences of ``s`` positions, in
``mode`` ``"train"`` (forward and backward: three times the forward's
products, but for an input that takes no gradient) or ``"prefill"``
(forward only).  Remat's recomputation is not counted: it is not work the
step needs.  A kind that adds a block adds a file."""

from __future__ import annotations

from pathlib import Path

from portbench.core import load_module

HERE = Path(__file__).resolve().parent


def kind(name: str):
    return load_module(HERE / f"{name}.py", f"portbench_flops_{name}")


def count(cfg: dict, b: int, s: int, mode: str) -> float:
    """Every block kind's operations, summed."""
    return float(sum(kind(k).flops(cfg, b, s, mode) for k in cfg["blocks"]))
