"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number the correctness check compared beside its limit
(also the last lines of standard error).  Exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for), when a
file is missing, or when the process holds JAX or the JAX package once the
window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import core  # noqa: E402


class Context:
    """What a driver is given: the cell, the run's arguments, the device
    and the host spans."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, kind_name: str,
                 t0: float, marks=()):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.kind_name, self.t0 = device, kind_name, t0
        self.spans = core.Spans(mark=trace)
        self.marks = list(marks)  # (phase, perf_counter at its end) of the set-up

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.perf_counter()))


def per_layer(cell, trace) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    for."""
    out = {}
    for m in cell.per_layer:
        v = cell.reader(m["name"]).read(trace)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    core.cache_env(ROOT)
    cell = core.Cell(args.workload, ROOT)
    import torch

    marks = [("import torch", time.perf_counter())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)
    marks.append(("CUDA context", time.perf_counter()))
    return execute(cell, args.seed, args.seconds, bool(args.trace), device,
                   torch.cuda.get_device_name(0), marks)


def report(ctx, out) -> None:
    """Where the set-up went and how the window's units spread, on standard
    error: the look that tells a slow host or card from a slow program."""
    t, parts = ctx.t0, []
    for phase, at in ctx.marks:
        parts.append(f"{phase} {at - t:.3f}")
        t = at
    print(f"portbench: set-up s: {', '.join(parts)}", file=sys.stderr)
    ms = out["unit_ms"]
    if ms:
        print(f"portbench: window: {len(ms)} units, median {core.nearest_rank(ms, 0.5):.3f} ms, "
              f"p95 {core.nearest_rank(ms, 0.95):.3f} ms, slowest {max(ms):.3f} ms",
              file=sys.stderr)


def execute(cell, seed: int, seconds: float, trace: bool, device, kind: str, marks=()) -> int:
    """The run after the look for a card: the driver, the import check,
    the judgement, the result line."""
    ctx = Context(cell, seed, seconds, trace, device, kind, T0, marks)
    out = cell.driver().drive(ctx)
    report(ctx, out)

    held = core.forbidden_modules()
    if held:
        print(f"portbench: the process holds {held}", file=sys.stderr)
        return 3
    correct, checks = core.judge(out["numbers"], cell.limits)
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    if trace:
        tr = out["trace"]
        metrics = per_layer(cell, tr)
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        breakdown = tr.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": out["e2e"][k], "unit": u} for k, u in units.items()}
    line = core.result_line(correct and out["failed"] == 0, out["attempted"], out["failed"],
                            metrics, dev, checks, breakdown)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
