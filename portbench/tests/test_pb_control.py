"""The control and the faults come out as not correct.

* The control (the reference with float8 products in the program's place)
  reads far above the program at a tiny size, and fails its limits.
* A whole run, past the look for a card, with the timed path broken
  underneath: a training step that returns its state unchanged; a step fed
  half of its batch (the mean over the rest); a prefill answer with one
  row altered.  Each prints ``correct`` false.
"""

from __future__ import annotations

import json

import pytest
from conftest import Ctx, drive

import repro_torch.models as models
from portbench import control, core


@pytest.mark.parametrize("cell", ["tiny-moe.train", "tiny-audio.train", "tiny-moe.prefill",
                                  "tiny-audio.prefill"])
def test_control_fails(checkout, cell):
    c, out = drive(checkout, cell, seconds=0.2)
    ctx = Ctx(c, seconds=0.2)
    readings = control.train_readings if c.traffic["kind"] == "train" else control.prefill_readings
    r = readings(ctx, out)
    ok, _ = core.judge(r["control"], c.limits)
    assert not ok, r["control"]
    worst = max(r["control"][k] / max(out["numbers"][k], 1e-12) for k in out["numbers"])
    assert worst > 10, (out["numbers"], r["control"])
    for fault, numbers in r.items():
        if fault != "control":
            assert not core.judge(numbers, c.limits)[0], (fault, numbers)


def unchanged(make):
    def make_step(cfg, *a, **kw):
        def step(state, batch):
            with models.transformer.torch.no_grad():
                loss = models.loss_fn(cfg, state["params"], batch)
            return state, loss
        return step
    return make_step


def half_batch(make):
    def make_step(*a, **kw):
        inner = make(*a, **kw)

        def step(state, batch):
            return inner(state, {k: v[: len(v) // 2] for k, v in batch.items()})
        return step
    return make_step


def altered(make):
    def make_step(*a, **kw):
        inner = make(*a, **kw)

        def step(params, batch):
            logits, cache = inner(params, batch)
            logits = logits.clone()
            logits[0, -1] = logits[1, -1]
            return logits, cache
        return step
    return make_step


@pytest.mark.parametrize("cell,entry,fault", [
    ("tiny-moe.train", "make_train_step", unchanged),
    ("tiny-audio.train", "make_train_step", unchanged),
    ("tiny-moe.train", "make_train_step", half_batch),
    ("tiny-audio.train", "make_train_step", half_batch),
    ("tiny-moe.prefill", "make_prefill_step", altered),
    ("tiny-audio.prefill", "make_prefill_step", altered),
])
def test_broken_path_is_not_correct(checkout, monkeypatch, capsys, cell, entry, fault):
    import torch

    import run

    monkeypatch.setattr(models, entry, fault(getattr(models, entry)))
    rc = run.execute(core.Cell(cell, checkout), 2**31 + 3, 0.2, False, torch.device("cpu"),
                     "cpu")
    out = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
    assert list(line)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check ")


def test_sound_path_is_correct(checkout, capsys):
    import torch

    import run

    rc = run.execute(core.Cell("tiny-moe.train", checkout), 2**31 + 3, 0.2, True,
                     torch.device("cpu"), "NVIDIA H100 (CPU test)")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert set(line["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}
    assert "batch_wait_ms.train" in line["metrics"] and "breakdown" in line
