"""``device_idle_share.prefill``: the share of the traced window in which no
kernel or copy ran on the card (the profiler's device intervals merged on
one timeline)."""


def read(t):
    if t.kind != "prefill" or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
