"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout with two tiny configurations (one of each family) and
tiny traffic added as files and entries, and a context that drives a cell
there on the CPU.  No test looks for a card."""

from __future__ import annotations

import copy
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "portbench"), str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny-moe": {"base": "granite-moe-1b-a400m",
                 "set": {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                         "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 32,
                         "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 97}},
    "tiny-audio": {"base": "hubert-xlarge",
                   "set": {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                           "num_key_value_heads": 4, "head_dim": 16, "intermediate_size": 96,
                           "conv_dim_last": 24, "vocab_size": 37}},
}
TRAFFIC = {
    "train-tiny": {"base": "train", "set": {"batch": 2, "seq_len": 32, "trace_units": 1}},
    "prefill-tiny": {"base": "prefill", "set": {"batch": 2, "seq_len": 32, "pool": 3,
                                                "check_within": 4, "check_calls": 2,
                                                "trace_units": 2}},
}
# tiny fp32 runs agree with the reference to rounding
LIMITS = {"train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3},
          "prefill": {"logits_gap": 1e-4, "kv_gap": 1e-4}}


def tiny_config(name: str) -> dict:
    spec = TINY[name]
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{spec['base']}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(spec["set"], name=name)
    cfg["run_as"] = dict(cfg["run_as"], params_dtype="float32")
    return cfg


@pytest.fixture
def checkout(tmp_path):
    """A checkout holding the benchmark and the tiny cells, added as files
    and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in TINY:
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name)))
        bench["configs"].append({"name": name, "source": "tests", "file":
                                 f"portbench/configs/{name}.json", "reduced": [], "why": "tests"})
    for name, spec in TRAFFIC.items():
        tr = json.loads((ROOT / "portbench" / "traffic" / f"{spec['base']}.json").read_text())
        tr.update(spec["set"])
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    for cfg in TINY:
        for mix, spec in TRAFFIC.items():
            cell = f"{cfg}.{spec['base']}"
            lim = dict(LIMITS[spec["base"]])
            if cfg == "tiny-audio":
                lim.pop("kv_gap", None)
            if cfg == "tiny-moe" and "loss_gap" in lim:  # granite's numbers
                del lim["loss_gap"]
                lim["grad_dist"] = 1e-3
            (root / "portbench" / "limits" / f"{cell}.json").write_text(json.dumps(lim))
            bench["workloads"].append({"name": cell, "config": cfg, "traffic": mix, "chips": 1,
                                       "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kinds = {"train" if any(w.endswith("train") for w in m["workloads"]) else "",
                     "prefill" if any(w.endswith("prefill") for w in m["workloads"]) else ""}
            moe_only = all(w.startswith("granite") for w in m["workloads"])
            m["workloads"] += [f"{c}.{k}" for c in TINY for k in kinds if k
                               and (not moe_only or c == "tiny-moe")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


class Ctx:
    def __init__(self, cell, seed=2**31 + 11, seconds=0.5, trace=False):
        import torch

        from portbench import core

        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.kind_name, self.t0 = torch.device("cpu"), "NVIDIA H100 (CPU test)", \
            time.perf_counter()
        self.spans = core.Spans(mark=trace)
        self.marks = []

    def mark(self, phase):
        self.marks.append((phase, time.perf_counter()))


def drive(root: Path, cell_name: str, **kw) -> tuple:
    from portbench import core

    cell = core.Cell(cell_name, root)
    return cell, cell.driver().drive(Ctx(cell, **kw))
