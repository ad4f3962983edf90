"""``prefill_mfu``: the operations a prefill call needs (``portbench/flops``,
from the configuration's shapes) times the units a second on the host
clock, over the window's own units (they run before the profiler, which
slows the host), as a share of the card's bf16 peak."""

from portbench import flops


def read(t):
    if t.kind != "prefill" or not t.n_units:
        return None
    b, s = int(t.traffic["batch"]), int(t.traffic["seq_len"])
    return 100.0 * flops.count(t.cfg, b, s, "prefill") * t.unit_rate() / t.peaks["bf16_flops"]
