"""The harness's fixed part: where a cell's files are, how they are loaded,
the host spans, the result line and the import check.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name in
``BENCHMARK.json``:

* ``portbench/configs/<config>.json``  the configuration as it is run;
* ``portbench/traffic/<mix>.json``     the mix's parameters; its ``kind``
  names the general driver that reads it (``portbench/drivers/<kind>.py``);
* ``portbench/limits/<cell>.json``     the limit of each number the cell's
  correctness check compares;
* ``portbench/metrics/<metric>.py``    the reader of one per-layer metric;
* ``portbench/flops/<block kind>.py``  the operations of one kind of block;
* ``portbench/adapters/<adapter>.py``  the configuration's entry into the
  program's parameter layout.

Nothing here imports torch at module level, nor anything of the program.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from portbench.reference.spec import check_run_as

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no process of the benchmark may hold: the
# JAX package the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A cell, file or name that the benchmark cannot resolve."""


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return read_json(path)


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchError(f"no {what} named {name!r}; have {[e['name'] for e in entries]}")


def load_module(path: Path, name: Optional[str] = None):
    """The module in ``path``, loaded by its file (names hold dots)."""
    if not path.is_file():
        raise BenchError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name or "portbench_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with every file it names, resolved.  The
    metrics are those of ``end_to_end`` and ``per_layer`` that apply to it:
    an entry without ``workloads`` applies to every cell."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.bench_dir = root / "portbench"
        bench = benchmark(root)
        self.entry = by_name(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg_entry = by_name(bench["configs"], self.entry["config"], "config")
        self.config = read_json(root / cfg_entry["file"])
        check_run_as(self.config)
        self.traffic = read_json(self.bench_dir / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = read_json(self.bench_dir / "limits" / f"{name}.json")

        def applies(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    def driver(self):
        return load_module(self.bench_dir / "drivers" / f"{self.traffic['kind']}.py")

    def adapter(self):
        return load_module(self.bench_dir / "adapters" / f"{self.config['adapter']}.py")

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py")


def forbidden_modules(modules=None) -> List[str]:
    """Names in ``modules`` (default ``sys.modules``) whose top-level name,
    the part before the first dot compared whole, is in FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed cache directories inside the checkout for every compiler the
    program may use (its own kernels build into ``build/repro_torch``)."""
    base = root / "build" / "portbench"
    env = {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
           "TRITON_CACHE_DIR": str(base / "triton"),
           "CUDA_CACHE_PATH": str(base / "nv"),
           "USE_FLAX": "0"}
    for k, v in env.items():
        os.environ[k] = v
    return env


class Spans:
    """Host spans ``(name, unit, start_ns, end_ns)`` on the profiler's clock
    (``time.time_ns``).  With ``mark`` each span is also a
    ``record_function`` range, so that the trace names what the host was
    doing in each of the device's idle gaps."""

    def __init__(self, mark: bool = False):
        self.rows: list = []
        self.mark = mark

    @contextlib.contextmanager
    def span(self, name: str, unit: int):
        rf = contextlib.nullcontext()
        if self.mark:
            import torch

            rf = torch.profiler.record_function(f"portbench.{name}")
        t0 = time.time_ns()
        with rf:
            yield
        self.rows.append((name, unit, t0, time.time_ns()))


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0-1) of ``values`` by nearest rank: the smallest
    value with at least ``q`` of all values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    k = max(1, -(-int(round(q * 1e6)) * len(v) // 1000000))
    return float(v[k - 1])


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks  # last: each number compared beside its limit
    return json.dumps(out)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """``(correct, checks)``: each number that ``limits`` names against its
    limit (a number at or under its limit passes; a missing or non-finite
    one fails).  Numbers without a limit are not compared."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and abs(v) != float("inf") and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
