"""AdamW from its formulas (dense tensor trees + sparse row updates).

Two entry points, as in the reference package:

  * :func:`adam_update` — dense AdamW over a tree of tensors (nested dicts,
    e.g. the SPMD parameter stacks).  Denominator ``sqrt(v / b2t) + eps``,
    weight decay added to the update, optional global-norm clip.
    :func:`adam_update_` is the same step written in place into the
    caller's parameters and moments (the port's counterpart of donating the
    state to a jitted step): the same operations in the same order, a slice
    of each leaf at a time, so its bits are :func:`adam_update`'s and its
    float32 temporaries are a slice's size, never a whole leaf's.
  * :func:`sparse_adam_rows` — per-row Adam for learnable feature tables
    (paper §2.2/§6): only the rows a minibatch touched are updated, and the
    row-aligned moments travel with the rows through the cache engine.
    Bias correction with ``t = step + 1`` and denominator
    ``sqrt(vhat) + eps``.

The two forms differ on purpose (they are the reference's two formulas);
each is kept as it is.  Neither uses ``torch.optim``: the optimizer state
is a plain tree ``{"m": tree, "v": tree, "step": int32 scalar}``, so a
checkpoint holds the same keys as the reference's.  A tree is nested dicts,
lists and tuples (the ``raf`` executor's bundle holds a list of partition
dicts); leaves are visited as JAX flattens such a tree: dict keys in sorted
order, lists and tuples in order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = ["AdamConfig", "adam_init", "adam_update", "adam_update_", "sparse_adam_rows",
           "global_norm", "tree_map", "tree_leaves"]

# elements of one leaf slice that adam_update_ updates at once: its float32
# temporaries stay at 256 MB each
UPDATE_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # 0 disables clipping


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (``rest``
    share the structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of nested dicts (sorted key order), lists and tuples (in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def adam_init(params: Any) -> Dict[str, Any]:
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32),
    }


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves))) if leaves else torch.zeros(())


def _step_scalars(cfg: AdamConfig, grads: Any, state: Dict[str, Any]):
    """The new step counter, the clip factor (None without clipping) and
    the bias corrections in float32 as the reference computes them, handed
    to the leaf updates as exact Python scalars (no per-leaf device copy)."""
    step = state["step"] + 1
    scale = None
    if cfg.grad_clip > 0:
        gn = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    t = step.to(torch.float32)
    return step, scale, float(1.0 - cfg.b1 ** t), float(1.0 - cfg.b2 ** t)


def _leaf_update(cfg: AdamConfig, p, g, m, v, scale, b1t: float, b2t: float, lr: float):
    """One leaf's (or one slice's) AdamW: ``(new p, new m, new v)``."""
    if scale is not None:
        g = g * scale.to(device=g.device, dtype=g.dtype)
    g32 = g.to(torch.float32)
    m = cfg.b1 * m + (1 - cfg.b1) * g32
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
    update = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
    if cfg.weight_decay:
        update = update + cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * update).to(p.dtype), m, v


def adam_update(
    cfg: AdamConfig, params: Any, grads: Any, state: Dict[str, Any], lr_scale=1.0
) -> Tuple[Any, Dict[str, Any]]:
    """One dense AdamW step; returns ``(params, state)`` as new trees."""
    step, scale, b1t, b2t = _step_scalars(cfg, grads, state)

    def upd(p, g, m, v):
        return _leaf_update(cfg, p, g, m, v, scale, b1t, b2t, cfg.lr * lr_scale)

    # one (param, m, v) triple per leaf, in the order tree_map visits them;
    # each of the three trees is rebuilt by a second walk in that order
    triples = []
    tree_map(lambda *leaf: triples.append(upd(*leaf)), params, grads, state["m"], state["v"])

    def pick(i):
        it = iter(triples)
        return tree_map(lambda _: next(it)[i], params)

    return pick(0), {"m": pick(1), "v": pick(2), "step": step}


def adam_update_(
    cfg: AdamConfig, params: Any, grads: Any, state: Dict[str, Any], lr_scale=1.0
) -> Tuple[Any, Dict[str, Any]]:
    """:func:`adam_update` written into ``params`` and ``state`` in place;
    returns the same two objects.  The moments must be float32 already (the
    first :func:`adam_update` makes them so; ``init_train_state`` draws
    them so).  Each leaf is updated UPDATE_SLICE elements (whole rows of its
    first dimension) at a time: the update is elementwise, so the bits are
    :func:`adam_update`'s, while the clip's global norm is taken over whole
    leaves, as there."""
    step, scale, b1t, b2t = _step_scalars(cfg, grads, state)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"adam_update_ writes float32 moments in place; got {m.dtype} "
                             f"and {v.dtype} (adam_update promotes them)")
        if p.dim() == 0:
            p, g, m, v = (t.reshape(1) for t in (p, g, m, v))
        rows = max(1, UPDATE_SLICE // max(1, p[0].numel()))
        for sl in zip(*(t.split(rows) for t in (p, g, m, v))):
            for dst, new in zip((sl[0], sl[2], sl[3]),
                                _leaf_update(cfg, *sl, scale, b1t, b2t, lr)):
                dst.copy_(new)

    with torch.no_grad():
        tree_map(upd, params, grads, state["m"], state["v"])
    state["step"] = step
    return params, state


def sparse_adam_rows(
    cfg: AdamConfig,
    rows: torch.Tensor,  # [n, d] current values of the touched rows
    grads: torch.Tensor,  # [n, d]
    m: torch.Tensor,  # [n, d] row-aligned first moment
    v: torch.Tensor,  # [n, d] row-aligned second moment
    step,  # int: the table-global step count
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step on a row slice of a learnable feature table; the caller
    (the cache engine) fetched ``rows``/``m``/``v`` for the unique node ids
    of a minibatch and scatters the returned values back."""
    g32 = grads.to(torch.float32)
    t = torch.tensor(step, dtype=torch.float32) + 1.0
    m = cfg.b1 * m + (1 - cfg.b1) * g32
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
    mhat = m / float(1.0 - cfg.b1 ** t)
    vhat = v / float(1.0 - cfg.b2 ** t)
    new = rows.to(torch.float32) - cfg.lr * mhat / (torch.sqrt(vhat) + cfg.eps)
    return new.to(rows.dtype), m, v
