"""The reference against the port on the CPU, at a tiny size of each family
and for both kinds of traffic, through the drivers the chip runs."""

from __future__ import annotations

import pytest
from conftest import drive

from portbench import core

CELLS = ["tiny-moe.train", "tiny-audio.train", "tiny-moe.prefill", "tiny-audio.prefill"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_reference(checkout, cell):
    c, out = drive(checkout, cell)
    correct, checks = core.judge(out["numbers"], c.limits)
    assert correct, checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {m["name"] for m in c.end_to_end}
    assert names == set(out["e2e"]), (names, out["e2e"])
    assert all(v > 0 for v in out["e2e"].values())
    if c.traffic["kind"] == "train":  # the whole gradient is judged only where a limit names it
        assert ("grad_dist" in out["numbers"]) == ("grad_dist" in c.limits)
