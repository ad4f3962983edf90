"""No module of the benchmark, nor any that a run loads, has the top-level
name jax, jaxlib, flax or repro (compared whole: ``repro_torch`` is the
port); the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

from portbench import core

SRC = [p for p in (ROOT / "portbench").rglob("*.py") if "tests" not in p.parts]


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_forbidden_names_compare_whole():
    held = core.forbidden_modules({"repro_torch": 1, "repro_torch.models": 1, "jaxtyping": 1,
                                   "repro": 1, "repro.models": 1, "jax.numpy": 1, "flax": 1})
    assert held == ["flax", "jax.numpy", "repro", "repro.models"]


def test_sources_import_no_jax_or_reference_package():
    for p in SRC:
        for name in imported(p):
            assert name.split(".")[0] not in core.FORBIDDEN, (p, name)


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "portbench" / "reference").rglob("*.py"):
        for name in imported(p):
            assert name.split(".")[0] in ("torch", "math", "statistics", "typing", "__future__",
                                          "portbench"), (p, name)
            assert (name.split(".")[0] != "portbench"
                    or name.split(".")[:2] == ["portbench", "reference"]), (p, name)


def test_a_run_loads_no_jax():
    """A run's modules (the CLI, the drivers, the program's entries) in a
    fresh process: none forbidden."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import run\n"
        "from portbench import core, control, weights, window, corpus, trace, flops, peaks\n"
        "from portbench.reference import lm, compare\n"
        "for c in ('granite-moe.train', 'hubert.prefill'):\n"
        "    cell = core.Cell(c)\n"
        "    cell.driver(); cell.adapter().arch(cell.config)\n"
        "    [cell.reader(m['name']) for m in cell.per_layer]\n"
        "import repro_torch.models, repro_torch.data, repro_torch.launch.train_lm\n"
        "print(core.forbidden_modules())\n"
    ) % (str(ROOT / "portbench"), str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
