"""Traffic of kind ``prefill``: one client in a closed loop.

Calls of the program's ``make_prefill_step(arch, use_kernel=True)`` run back
to back on ``batch`` prompts of ``seq_len`` tokens (frames for an audio
model), each call ended by its logits on the host.  The prompts cycle
through a pool of ``pool`` batches drawn from the seed and put on the card
in set-up; every run does the same work.  ``warmup_calls`` calls warm the
one shape in set-up (the first run in a checkout also builds the kernels
there).

End to end: ``prefill_tokens_per_s``, the prompt tokens of every call
completed in the window over the window.

The check: ``check_calls`` calls drawn from the seed among the first
``check_within`` keep their answers (the logits on the host; a decoder's
cache on the card).  Calls past the window's end are made, untimed, until
each sampled call has answered.  After the window the reference answers
the same prompts from the same weights."""

from __future__ import annotations

import time

import numpy as np

from portbench import weights, window
from portbench.corpus import Corpus
from portbench.drivers.train import traced
from portbench.reference import compare, lm


def pool_inputs(cfg: dict, tr: dict, seed: int, device) -> list:
    """The pool's batches on ``device``: the corpus's rows without their
    labels."""
    import torch

    corpus, b, shards = Corpus(cfg, tr, seed), int(tr["batch"]), int(tr["num_shards"])
    out = []
    for j in range(int(tr["pool"])):
        rows = corpus.batch(j % shards, (j // shards) * b, b)
        out.append({k: torch.from_numpy(v).to(device) for k, v in rows.items() if k != "labels"})
    return out


def sample(tr: dict, seed: int) -> list:
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    return sorted(int(i) for i in rng.choice(int(tr["check_within"]), int(tr["check_calls"]),
                                             replace=False))


def drive(ctx) -> dict:
    import torch

    from repro_torch.models import make_prefill_step

    ctx.mark("program imports")
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    adapter = ctx.cell.adapter()
    arch = adapter.arch(cfg)
    leaves = weights.draw(cfg, ctx.seed, ctx.device)
    params = adapter.to_port(leaves)
    pool = pool_inputs(cfg, tr, ctx.seed, ctx.device)
    decoder = cfg["run_as"]["decoder"]
    step = make_prefill_step(arch, use_kernel=True)
    ctx.mark("weights, pool")
    for j in range(int(tr["warmup_calls"])):
        logits, _ = step(params, pool[0])
        logits.cpu()
        ctx.mark(f"warm-up call {j + 1}")
    del logits
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0

    checked = sample(tr, ctx.seed)
    kept = {}

    def call(i):
        logits, cache = step(params, pool[i % len(pool)])
        out = logits.cpu()
        if i in checked:
            kept[i] = (out, cache.get("k"), cache.get("v"))

    def unit(i):
        with ctx.spans.span("call", i):
            call(i)

    win = window.run(unit, ctx.seconds, int(tr["trace_units"]) if ctx.trace else 0)
    n = win.traced.start  # the window's own calls; traced ones follow them
    for i in range(len(win.units), checked[-1] + 1):  # sampled calls the window did not reach
        call(i)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del params, step
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the reference's answers to the sampled calls' prompts
    lm.strict_fp32()
    leaves32 = {k: v.float() for k, v in leaves.items()}
    del leaves
    calls = []
    for i in checked:
        ref = lm.prefill(cfg, leaves32, pool[i % len(pool)])
        out, k, v = kept.pop(i)
        kv = []
        if decoder:
            kv = [(k[l, 0], v[l, 0], rk, rv) for l, (rk, rv) in enumerate(ref["kv"])]
        calls.append({"logits": (out, ref["logits"].cpu()), "kv": kv})
    numbers = compare.prefill_numbers(calls)

    tokens = int(tr["batch"]) * int(tr["seq_len"])
    res = {"e2e": {"prefill_tokens_per_s": n * tokens / win.seconds, "setup_s": setup_s},
           "attempted": n, "failed": 0, "numbers": numbers, "memory_peak_bytes": peak,
           "unit_ms": [(e - s) / 1e6 for s, e in win.units[:n]],
           "check": {"sampled": checked, "calls": calls, "pool": pool}, "trace": None}
    if win.profiler is not None:
        res["trace"] = traced(ctx, win, "prefill")
    return res
