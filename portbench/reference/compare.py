"""The numbers that decide ``correct``: the program's readings against the
reference's, each a relative gap (0 when they agree).

Training (the checked steps, taken by the worst leaf):

* ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the steps;
* ``grad_gap``: the first step's gradient as the optimizer takes it
  (clipped), the largest ``|‖g_prog‖ - ‖g_ref‖|`` of a leaf over the larger
  of that leaf's ``‖g_ref‖`` and the median leaf's;
* ``change_gap``: the parameters' change over the checked steps, the same
  gap of norms, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone);
* ``grad_dist``: the first gradient element by element, the largest
  ``‖g_prog - g_ref‖`` of a leaf over the larger of that leaf's ``‖g_ref‖``
  and the median leaf's: a gap of norms misses errors that leave a norm
  where it was (float8 products), and a cell whose losses swing with its
  routing needs it to tell them from bf16's.

Prefill (the sampled calls):

* ``logits_gap``: the relative Frobenius distance of the sampled calls'
  logits, all of them at once;
* ``row_gap``: the largest ``‖row_prog - row_ref‖ / ‖row_ref‖`` over the
  logits' rows (a position of a sequence) of every sampled call;
* ``kv_gap`` (a decoder's cache): the largest relative Frobenius distance of
  one layer's k or v over every layer of every sampled call.

A cell's limits file names the numbers it compares.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone, and its change is not compared
STILL = 1e-3


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def train_numbers(prog: dict, ref: dict, dist: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
    """The training numbers; ``dist``: each leaf's norm of the difference of
    the two first gradients (``lm.train(against=...)``)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"], strict=True))
    g_ref = ref["first_grad"]
    grad = _norm_gap(prog["first_grad"], g_ref, sorted(g_ref))
    med = statistics.median(g_ref.values())
    moving = sorted(k for k, v in g_ref.items() if v >= STILL * med)
    change = _norm_gap(prog["change"], ref["change"], moving)
    out = {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
    if dist is not None:
        out["grad_dist"] = max(dist[k] / max(g_ref[k], med, 1e-30) for k in g_ref)
    return out


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest relative distance of one row (the last axis)."""
    prog, ref = prog.float().reshape(-1, prog.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    d = (prog - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(min=1e-30)
    return float(d.max())


def rel(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float((prog.float() - ref.float()).norm() / ref.float().norm().clamp(min=1e-30))


def prefill_numbers(calls: List[dict]) -> Dict[str, float]:
    """``calls``: one ``{"logits": (prog, ref), "kv": [(prog k, prog v, ref
    k, ref v), ...]}`` a sampled call."""
    prog = torch.cat([c["logits"][0].float().reshape(-1) for c in calls])
    ref = torch.cat([c["logits"][1].float().reshape(-1) for c in calls])
    out = {"logits_gap": rel(prog, ref), "row_gap": max(row_gap(*c["logits"]) for c in calls)}
    kv = [max(rel(pk, rk), rel(pv, rv)) for c in calls for pk, pv, rk, rv in c["kv"]]
    if kv:
        out["kv_gap"] = max(kv)
    return out
