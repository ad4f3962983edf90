"""Every entry of BENCHMARK.json resolves to its files, and a new cell
needs only new files and entries."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT, drive

from portbench import core
from portbench.reference import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = core.Cell(cell, ROOT)
    assert c.driver().drive and c.adapter().arch
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    from portbench import flops
    for kind in c.config["blocks"]:
        assert callable(flops.kind(kind).flops)


def test_entries_are_consistent():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"]) == []
        spec.check_run_as(cfg)
        assert all(set(d) == {"what", "work"} for d in cfg["departures"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert w in moved.get("workloads", [w])
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir()


def test_new_cell_is_files_and_entries(checkout):
    """The checkout adds two configurations, two traffic files, four limits
    files and their entries, and edits no file of the benchmark; each new
    cell then resolves and runs."""
    for name in ("tiny-moe.train", "tiny-audio.prefill"):
        c, out = drive(checkout, name, seconds=0.2)
        correct, _ = core.judge(out["numbers"], c.limits)
        assert correct
    for f in (ROOT / "portbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts and "tests" not in f.parts:
            assert (checkout / f.relative_to(ROOT)).read_bytes() == f.read_bytes()


@pytest.mark.parametrize("change", [{"norm": "layer"}, {"params_dtype": "float16"},
                                    {"mlp": "gelu"}, {"head": "tied"}, {"frontend": "vision"},
                                    {"rope_theta": "10000"}, {"causal": 1},
                                    {"router_dtype": "float32"}, {"norm_eps": None}])
def test_run_as_refuses_what_is_not_implemented(change):
    """A configuration whose run_as has a key or a value that the adapter and
    the reference do not implement is refused by the cell, the adapter and
    the reference alike, not run as something else."""
    from portbench.adapters import lm_stack
    from portbench.reference import lm

    path = ROOT / "portbench" / "configs" / "granite-moe-1b-a400m.json"
    cfg = json.loads(path.read_text())
    spec.check_run_as(cfg)
    cfg["run_as"].update(change)
    if change.get("norm_eps", 0) is None:
        del cfg["run_as"]["norm_eps"]
    for use in (spec.check_run_as, lm_stack.arch, lm.Model):
        with pytest.raises(spec.RunAsError):
            use(cfg)
