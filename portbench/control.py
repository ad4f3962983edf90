"""The readings that each correctness limit is set from, for one cell, in
one process on the card:

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--control-seeds 3] [--seconds 2] [--out chiprun_out/control.jsonl]

For every seed, a run of the cell's driver (a short window at the cell's
own load; training needs none) gives the program's numbers: the lower
readings.  For the first ``--control-seeds`` seeds it also reads:

* the control: the reference computed with float8 (e4m3) products, put in
  the program's place, against the float32 reference;
* the faults the cell can have, planted in the reference put in the
  program's place: training on half of each batch (the mean over the rest);
  a prefill answer with one row altered (another position's logits).  A
  training state left unchanged reads 1 on ``change_gap`` by its
  definition and needs no run.

The benchmark's own runs do not run this.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import core  # noqa: E402


def train_readings(ctx, out) -> dict:
    import torch

    from portbench import weights
    from portbench.reference import compare, lm

    cfg, adam = ctx.cell.config, ctx.cell.traffic["adam"]
    ref, fed = out["check"]["ref"], out["check"]["inputs"]

    def batches(rows=None):
        return [{k: torch.from_numpy(v[:rows]).to(ctx.device) for k, v in b.items()} for b in fed]

    ctl = lm.train(cfg, weights.draw(cfg, ctx.seed, ctx.device), batches(), adam, quant="fp8",
                   keep_first_grad=True)
    half = lm.train(cfg, weights.draw(cfg, ctx.seed, ctx.device),
                    batches(len(fed[0]["labels"]) // 2), adam, keep_first_grad=True)
    # the float32 reference again, to measure both first gradients against it
    again = lm.train(cfg, weights.draw(cfg, ctx.seed, ctx.device), batches(), adam,
                     against=[ctl.pop("first_grad_host"), half.pop("first_grad_host")])
    d_ctl, d_half = again["first_grad_dist"]
    return {"control": compare.train_numbers(ctl, ref, d_ctl),
            "half_batch": compare.train_numbers(half, ref, d_half),
            "unchanged": {"change_gap": 1.0}}


def prefill_readings(ctx, out) -> dict:
    from portbench import weights
    from portbench.reference import compare, lm

    cfg = ctx.cell.config
    pool = out["check"]["pool"]
    leaves = {k: v.float() for k, v in weights.draw(cfg, ctx.seed, ctx.device).items()}
    calls, altered = [], []
    for i, c in zip(out["check"]["sampled"], out["check"]["calls"]):
        ref_logits = c["logits"][1]
        ctl = lm.prefill(cfg, leaves, pool[i % len(pool)], quant="fp8")
        kv = [(ck, cv, rk, rv) for (ck, cv), (_, _, rk, rv) in zip(ctl["kv"], c["kv"])]
        calls.append({"logits": (ctl["logits"].cpu(), ref_logits), "kv": kv})
        bad = ref_logits.clone().reshape(-1, ref_logits.shape[-1])
        bad[0] = bad[-1]
        altered.append({"logits": (bad.reshape(ref_logits.shape), ref_logits), "kv": []})
    return {"control": compare.prefill_numbers(calls),
            "altered_answer": compare.prefill_numbers(altered)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="correctness readings of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    core.cache_env(ROOT)
    import torch

    sys.path.insert(0, str(ROOT / "portbench"))
    from run import Context

    cell = core.Cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    for j, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = Context(cell, seed, args.seconds, False, device, kind, t0)
        out = cell.driver().drive(ctx)
        rec = {"cell": cell.name, "seed": seed, "program": out["numbers"],
               "setup_s": out["e2e"]["setup_s"], "run_s": time.perf_counter() - t0}
        if j < args.control_seeds:
            readings = train_readings if cell.traffic["kind"] == "train" else prefill_readings
            rec.update(readings(ctx, out))
        if cell.traffic["kind"] == "train":
            rec["losses"] = out["check"]["prog"]["losses"]
            rec["ref_losses"] = out["check"]["ref"]["losses"]
            rec["grad_leaves"] = {k: [out["check"]["prog"]["first_grad"][k], v]
                                  for k, v in out["check"]["ref"]["first_grad"].items()}
            rec["change_leaves"] = {k: [out["check"]["prog"]["change"][k], v]
                                    for k, v in out["check"]["ref"]["change"].items()}
            if "first_grad_dist" in out["check"]["ref"]:
                rec["dist_leaves"] = out["check"]["ref"]["first_grad_dist"][0]
        rec["seconds"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
