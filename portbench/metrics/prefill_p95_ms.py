"""``prefill_p95_ms``: the 95th percentile (nearest rank) of the latency of
the window's own prefill calls (they run before the profiler), submission
to logits on the host.  The calls run back to back, above what the card
sustains at a fixed rate, so the tail swings with any slow stretch of the
card or the host: a per-layer reading beside ``prefill_tokens_per_s``."""

from portbench import core


def read(t):
    if t.kind != "prefill":
        return None
    units = t.free_units or t.units
    return core.nearest_rank([(e - s) / 1e6 for s, e in units], 0.95) if units else None
