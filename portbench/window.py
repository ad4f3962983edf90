"""The measured window, shared by every driver: units (a step, a call) run
back to back until ``--seconds`` have passed, each timed from its start to
its result on the host.  With ``--trace 1`` the profiler then covers
``trace_units`` more units, after the window: a profiler session slows the
host while it runs and the process after it, so the window's own units stay
untraced."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

from portbench.trace import Profiler


@dataclasses.dataclass
class Window:
    units: List[Tuple[int, int]]  # (start_ns, end_ns) of each unit, time.time_ns
    seconds: float  # from the window's start to its last unit's end, perf_counter
    traced: range  # the indices of the traced units, after the window's
    profiler: Optional[Profiler]


def run(unit: Callable[[int], None], seconds: float, trace_units: int = 0) -> Window:
    """Units ``unit(0), unit(1), ...`` until ``seconds`` have passed, then
    ``trace_units`` units under the profiler.  ``unit`` returns once its
    result is on the host."""
    units: List[Tuple[int, int]] = []

    def timed(i):
        u0 = time.time_ns()
        unit(i)
        units.append((u0, time.time_ns()))

    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        timed(len(units))
        t_end = time.perf_counter()
        if t_end >= deadline:
            break
    n = len(units)
    prof = None
    if trace_units:
        prof = Profiler()
        prof.start()
        for i in range(n, n + trace_units):
            timed(i)
        prof.stop()
    return Window(units, t_end - t0, range(n, n + trace_units), prof)
