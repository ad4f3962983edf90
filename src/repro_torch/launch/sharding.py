"""Sharding rules: parameter, batch, and cache PartitionSpecs per arch.

The port's copy of ``repro/launch/sharding.py``; the rule tables are the
reference's, rule for rule.  Baseline layout:

  * batch over (pod, data); sequence unsharded in training.
  * tensor parallelism over "model": attention heads, FFN hidden, vocab.
  * MoE experts over "model" (expert parallelism — the RAF mapping,
    DESIGN.md §4).
  * Mamba heads over "model" (B/C projections replicated; ngroups=1).
  * decode KV caches: batch over (pod, data) when divisible, sequence over
    "model" (and over everything for the batch-1 long-context shape).

Every rule guards on divisibility and falls back to replication — a 512-way
mesh must lower every architecture, including kv-head counts smaller than
the model axis.

Where the port differs: ``PartitionSpec`` is the port's own, a tuple (one
entry per tensor dim: an axis name, a tuple of names, or None), equal as a
tuple to the reference's.  A tree's paths are its nested-dict keys joined
by ``/`` (the reference's ``_path_str`` gives the same strings, so
``"/moe/"`` matches alike).  ``named(mesh, specs)`` turns each spec into
DTensor placements (:func:`placements`): an axis naming a tensor dim is
``Shard(dim)`` on that mesh dim, a tuple of axes is ``Shard(dim)`` on each
of them (the rules give every tuple in mesh order; another order raises),
and every other mesh dim is ``Replicate()``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import MODEL_AXIS, data_axes, mesh_axes

__all__ = [
    "PartitionSpec",
    "param_pspecs",
    "state_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "placements",
    "named",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of names, or None; a
    tuple of one name is that name, as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_axes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _shard_if(mesh, dim: int, axis) -> Optional[str]:
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _leaf_spec(path: str, shape: Tuple[int, ...], mesh) -> P:
    """Sharding rule by parameter name (leaf of the params tree)."""
    m = MODEL_AXIS
    name = path.split("/")[-1]
    none = (None,) * len(shape)

    def spec_at(i: int, axis=m) -> P:
        ax = _shard_if(mesh, shape[i], axis)
        out = list(none)
        out[i] = ax
        return P(*out)

    if name == "embed":
        return spec_at(0)  # vocab-sharded embedding table
    if name == "head":
        return spec_at(1)
    if name in ("final_norm", "frontend_proj"):
        return P(*none)
    # stacked block leaves: leading dims [n_periods, n_slots, ...]
    if name in ("wq", "w1", "w3", "wz", "wx", "wdt", "conv_w"):
        return spec_at(len(shape) - 1)
    if name in ("wk", "wv"):
        return spec_at(len(shape) - 1)
    if name in ("wo", "w2"):
        return spec_at(len(shape) - 2)
    if name in ("bq", "bk", "bv", "conv_b", "gnorm", "dt_bias", "A_log", "D_skip"):
        return spec_at(len(shape) - 1)
    if name == "router":
        return P(*none)
    if name in ("norm", "b"):
        return P(*none)
    if name in ("wB", "wC"):
        return P(*none)  # ngroups=1: B/C shared across heads
    return P(*none)


def _moe_spec(path: str, shape: Tuple[int, ...], mesh) -> Optional[P]:
    """MoE expert stacks [np, ns, E, D, F]: shard the expert axis (RAF-style
    expert parallelism) — takes precedence over the dense w1/w2/w3 rules."""
    if "/moe/" not in path:
        return None
    name = path.split("/")[-1]
    if name in ("w1", "w2", "w3"):
        ax = _shard_if(mesh, shape[2], MODEL_AXIS)
        return P(None, None, ax, None, None)
    if name == "router":
        return P(None, None, None, None)
    if name == "norm":
        return P(None, None, None)
    return None


def _map_paths(fn, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over nested dicts; a path is the keys joined by
    ``/``."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_pspecs(cfg: ArchConfig, params: Any, mesh) -> Any:
    return _map_paths(
        lambda ps, leaf: _moe_spec(ps, tuple(leaf.shape), mesh)
        or _leaf_spec(ps, tuple(leaf.shape), mesh),
        params)


def state_pspecs(cfg: ArchConfig, state: Any, mesh) -> Any:
    """Train state {params, opt{m, v, step}} — optimizer moments shard with
    their parameters (ZeRO-free model parallelism: each shard's optimizer
    slice lives with its weights, as Heta co-locates optimizer states §6)."""
    pspec = param_pspecs(cfg, state["params"], mesh)
    return {
        "params": pspec,
        "opt": {
            "m": pspec,
            "v": pspec,
            "step": P(),
        },
    }


def batch_pspecs(cfg: ArchConfig, shape: InputShape, batch: Dict, mesh) -> Dict:
    dp = data_axes(mesh)
    specs = {}
    for k, v in batch.items():
        bdim = v.shape[0]
        ax = dp if bdim % _axis_size(mesh, dp) == 0 else None
        specs[k] = P(ax, *([None] * (len(v.shape) - 1)))
    return specs


def cache_pspecs(cfg: ArchConfig, cache: Dict, mesh) -> Dict:
    """Decode caches: [np, ns, B, S, KV, hd] (attn) / [np, ns, B, ...] (ssm)."""
    dp = data_axes(mesh)
    names = tuple(mesh_axes(mesh))
    specs = {}
    for k, v in cache.items():
        B = v.shape[2]
        b_ax = dp if B % _axis_size(mesh, dp) == 0 else None
        if k in ("k", "v"):
            S = v.shape[3]
            if b_ax is None:
                # batch-1 long-context: spread the sequence over every axis
                s_ax = ("pod", "data", MODEL_AXIS) if "pod" in names else ("data", MODEL_AXIS)
                s_ax = s_ax if S % _axis_size(mesh, s_ax) == 0 else _shard_if(mesh, S, MODEL_AXIS)
            else:
                s_ax = _shard_if(mesh, S, MODEL_AXIS)
            specs[k] = P(None, None, b_ax, s_ax, None, None)
        elif k == "ssm":  # [np, ns, B, nh, hp, N]
            h_ax = _shard_if(mesh, v.shape[3], MODEL_AXIS)
            specs[k] = P(None, None, b_ax, h_ax, None, None)
        elif k == "conv":  # [np, ns, B, k-1, di]
            d_ax = _shard_if(mesh, v.shape[4], MODEL_AXIS)
            specs[k] = P(None, None, b_ax, None, d_ax)
        else:
            specs[k] = P(*([None] * len(v.shape)))
    return specs


def placements(mesh, spec: P) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"{spec}: the axes {axes} of dim {dim} are not in mesh order "
                             f"{names}")
        for i in where:
            out[i] = Shard(dim)
    return out


def named(mesh, tree_specs: Any) -> Any:
    """Each spec of ``tree_specs`` (nested dicts) as its placements."""
    if isinstance(tree_specs, PartitionSpec):
        return placements(mesh, tree_specs)
    return {k: named(mesh, v) for k, v in tree_specs.items()}
