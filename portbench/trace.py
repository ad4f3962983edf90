"""The traced run's reading: one ``torch.profiler`` session over a few
units (steps or calls) of the window, its device events laid on one
timeline, and the ``Trace`` that each per-layer metric's reader takes.

Only the profiler's raw events are read (no per-event Python objects are
built, and nothing is written to disk)."""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

Interval = Tuple[str, int, int]  # (name, start_ns, end_ns)


class Profiler:
    """A CPU + CUDA profiler session started and stopped around the traced
    units; ``events()`` returns ``(device, host)`` interval lists."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, acc_events=False)

    def start(self):
        self._prof.__enter__()

    def stop(self):
        self._prof.__exit__(None, None, None)

    def events(self) -> Tuple[List[Interval], List[Interval]]:
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            row = (e.name(), start, start + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                # a record_function range is mirrored on the device's
                # timeline, where no operation ran
                if not e.is_user_annotation():
                    device.append(row)
            elif e.device_type() == DeviceType.CPU:
                host.append(row)
        return device, host


def merge(intervals: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the intervals, clipped to ``[lo, hi]``, as sorted
    disjoint ``(start, end)`` pairs."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals if e > lo and s < hi)
    out: List[List[int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle stretches of ``[lo, hi]`` between the merged busy pairs."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def short_name(name: str, width: int = 72) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:width]


def top_device_ops(device: List[Interval], n: int = 10) -> list:
    """``[[name, seconds], ...]``: the device operations that took the most
    time, summed by name."""
    tot: Dict[str, int] = {}
    for name, s, e in device:
        k = short_name(name)
        tot[k] = tot.get(k, 0) + (e - s)
    return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def gap_owners(idle: List[Tuple[int, int]], host: List[Interval], n: int = 10) -> list:
    """``[[name, seconds], ...]``: the idle time summed by what the host was
    doing when each gap began (the innermost host range open then)."""
    rows = sorted(host, key=lambda r: r[1])
    starts = [r[1] for r in rows]
    outer = [r for r in rows if r[0].startswith("portbench.")]
    tot: Dict[str, int] = {}
    for gs, ge in idle:
        best = None
        # the latest-started range still open at gs: scan back a little,
        # then fall back to the harness's own spans
        i = bisect.bisect_right(starts, gs) - 1
        for j in range(i, max(-1, i - 256), -1):
            if rows[j][2] >= gs:
                best = rows[j]
                break
        if best is None:
            open_ = [r for r in outer if r[1] <= gs <= r[2]]
            best = max(open_, key=lambda r: r[1]) if open_ else None
        k = short_name(best[0]) if best else "none"
        tot[k] = tot.get(k, 0) + (ge - gs)
    return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


class Trace:
    """What a per-layer metric's reader is given.

    ``kind``: the traffic's kind (``"train"`` or ``"prefill"``); ``units``:
    the traced units' ``(start_ns, end_ns)``; ``free_units``: the window's
    own units, which ran before the profiler (it slows the host); ``spans``:
    the harness's host spans in the traced units; ``device`` / ``host``:
    the profiler's intervals; ``lo``, ``hi``: the traced window; ``cfg``, ``traffic``: the cell's
    files; ``peaks``: the card's published peaks."""

    def __init__(self, kind: str, units, spans, device, host, lo: int, hi: int, cfg: dict,
                 traffic: dict, peaks: dict, free_units=()):
        self.kind, self.units, self.spans = kind, units, spans
        self.free_units = list(free_units)
        self.device, self.host = device, host
        self.lo, self.hi = lo, hi
        self.cfg, self.traffic, self.peaks = cfg, traffic, peaks

    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def unit_rate(self) -> float:
        """Units a second on the host clock, over the window's own units
        (the traced ones where there are none)."""
        units = self.free_units or self.units
        return len(units) / (sum(e - s for s, e in units) / 1e9)

    def busy_s(self) -> float:
        return sum(e - s for s, e in merge(self.device, self.lo, self.hi)) / 1e9

    def device_s(self, names) -> Optional[float]:
        """Summed device seconds of the operations whose name holds any of
        ``names``; None when none ran."""
        hit = [e - s for n, s, e in self.device if any(k in n for k in names)]
        return sum(hit) / 1e9 if hit else None

    def span_s(self, name: str) -> List[float]:
        return [(e - s) / 1e9 for n, _, s, e in self.spans if n == name]

    def breakdown(self) -> dict:
        busy = merge(self.device, self.lo, self.hi)
        return {"device_ops": top_device_ops(self.device),
                "idle_gaps": gap_owners(gaps(busy, self.lo, self.hi), self.host)}
