"""Traffic of kind ``train``: one trainer in a closed loop.

Batches of ``batch`` x ``seq_len`` come from the program's
``TokenPipeline`` (its prefetch thread, pinned copies to the card) over the
benchmark's corpus; each step is the program's
``make_train_step(..., use_kernel=False, donate=True)`` on one train state
built from the benchmark's weights.  Set-up drives that state through the
first ``checked_steps`` steps, through the window's own call and feed, and
reads what the check needs: each step's loss, the first gradient (from the
first moment after one step: ``m = (1 - b1) g``; its norms, and the whole
of it on the host where the cell's limits name ``grad_dist``) and each
leaf's change after the checked steps.  The window then runs steps until
``--seconds`` have passed, each ended by its loss read on the host.

End to end: ``train_step_ms``, the window's time over the steps completed
in it.  After the window the reference runs the checked steps from the same
weights on the same batches."""

from __future__ import annotations

import math
import time

from portbench import weights, window
from portbench.corpus import Corpus
from portbench.reference import compare, lm
from portbench.trace import Trace


def _to(batch: dict, device) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def leaf_norms(tree: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in tree.items()}


def drive(ctx) -> dict:
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train_lm import pinned_place
    from repro_torch.models import make_train_step
    from repro_torch.optim import AdamConfig

    ctx.mark("program imports")
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    adapter = ctx.cell.adapter()
    arch = adapter.arch(cfg)
    n_checked, b1 = int(tr["checked_steps"]), tr["adam"]["b1"]
    whole_grad = "grad_dist" in ctx.cell.limits  # copy the gradient only where it is judged
    first = None
    state = adapter.train_state(weights.draw(cfg, ctx.seed, ctx.device))

    fed = []  # the checked steps' batches as the corpus made them
    place = pinned_place(ctx.device)

    def place_fn(batch):
        if len(fed) < n_checked:
            fed.append({k: v.copy() for k, v in batch.items()})
        return place(batch)

    pipe = TokenPipeline(Corpus(cfg, tr, ctx.seed), int(tr["batch"]), prefetch=int(tr["prefetch"]),
                         place_fn=place_fn)
    step = make_train_step(arch, AdamConfig(**tr["adam"]), use_kernel=False, donate=True)
    prog = {"losses": []}
    losses = []
    ctx.mark("weights, state, pipeline")
    try:
        for i in range(n_checked):  # set-up: the checked steps warm every shape
            state, loss = step(state, next(pipe))
            prog["losses"].append(float(loss))
            if i == 0:
                m = adapter.from_port(state["opt"]["m"])
                prog["first_grad"] = {k: n / (1 - b1) for k, n in leaf_norms(m).items()}
                if whole_grad:  # the first gradient itself, judged after the window
                    first = {k: v.to("cpu", torch.float32, copy=True).div_(1 - b1)
                             for k, v in m.items()}
                del m
            ctx.mark(f"checked step {i + 1}")
        start = weights.draw(cfg, ctx.seed, ctx.device)
        now = adapter.from_port(state["params"])
        prog["change"] = {k: float((now[k].float() - start[k].float()).norm()) for k in start}
        del start, now
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        ctx.mark("change")
        setup_s = time.perf_counter() - ctx.t0

        def unit(i):
            nonlocal state
            with ctx.spans.span("next_batch", i):
                batch = next(pipe)
            with ctx.spans.span("step", i):
                state, loss = step(state, batch)
                losses.append(float(loss))

        win = window.run(unit, ctx.seconds, int(tr["trace_units"]) if ctx.trace else 0)
    finally:
        pipe.close()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del state, step
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the reference's checked steps from the same weights and batches
    lm.strict_fp32()
    ref = lm.train(cfg, weights.draw(cfg, ctx.seed, ctx.device), [_to(b, ctx.device) for b in fed],
                   tr["adam"], against=[first] if first else [])
    del first
    numbers = compare.train_numbers(prog, ref, ref["first_grad_dist"][0] if whole_grad else None)

    n = win.traced.start  # the window's own steps; traced ones follow them
    out = {"e2e": {"train_step_ms": win.seconds * 1e3 / n, "setup_s": setup_s},
           "attempted": n, "failed": sum(not math.isfinite(x) for x in losses),
           "numbers": numbers, "memory_peak_bytes": peak,
           "unit_ms": [(e - s) / 1e6 for s, e in win.units[:n]],
           "check": {"prog": prog, "ref": ref, "inputs": fed}, "trace": None}
    if win.profiler is not None:
        out["trace"] = traced(ctx, win, "train")
    return out


def traced(ctx, win, kind: str) -> Trace:
    from portbench.peaks import peaks

    device, host = win.profiler.events()
    units = [win.units[i] for i in win.traced]
    spans = [r for r in ctx.spans.rows if r[1] in win.traced]
    free = win.units[:win.traced.start]
    return Trace(kind, units, spans, device, host, units[0][0], units[-1][1], ctx.cell.config,
                 ctx.cell.traffic, peaks(ctx.kind_name), free)
