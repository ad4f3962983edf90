"""Carry weights and feature tables over from the reference package.

The port's initializer draws from ``torch.Generator``s, which cannot
reproduce the reference's jax threefry draws, so parity runs hand the
reference's parameters to the port instead.  Both functions take plain
numpy (``np.asarray`` of each leaf on the reference side), so this module
needs neither JAX nor the reference package:

    stacks_np = {layer: {leaf: np.asarray(v) for leaf, v in entry.items()}
                 for layer, entry in ref_sess.state["stacks"].items()}
    port_sess.compile(state={"stacks": stacks_from_reference(stacks_np, "cpu")})

The dict-form executors (``vanilla``, ``raf``) take a parameter bundle
instead (:func:`bundle_from_reference`), and the LM workbench a parameter
tree (:func:`lm_params_from_reference`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["stacks_from_reference", "bundle_from_reference", "tables_from_reference",
           "lm_params_from_reference"]


def stacks_from_reference(stacks_np: Dict, device=None) -> Dict:
    """``{f"layer{l}": {leaf: [P, U, ...]}, "head": {"w", "b"}}`` of numpy
    arrays -> the same tree of float32 tensors on ``device`` (``None``: the
    GPU)."""
    if "head" not in stacks_np or not any(k.startswith("layer") for k in stacks_np):
        raise ValueError(
            f"expected layer stacks and a head, got keys {sorted(stacks_np)}")
    device = resolve_device(device)
    return {
        layer: {
            leaf: torch.tensor(np.asarray(v, np.float32), device=device)
            for leaf, v in entry.items()
        }
        for layer, entry in stacks_np.items()
    }


def bundle_from_reference(bundle_np: Dict, device=None) -> Dict:
    """A dict-form parameter bundle of numpy arrays -> the same tree of
    float32 tensors on ``device`` (``None``: the GPU).  ``vanilla``'s bundle
    is ``{"rel", "ntype", "etype", "head"[, "embed"]}``; ``raf``'s is
    ``{"parts": [{"rel", "ntype", "etype"}, ...], "head"[, "embed"]}``, its
    parts a list as in the reference."""
    if "head" not in bundle_np or not ("parts" in bundle_np or "rel" in bundle_np):
        raise ValueError(f"expected a dict-form bundle, got keys {sorted(bundle_np)}")
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return torch.tensor(np.asarray(tree, np.float32), device=device)

    return conv(bundle_np)


def tables_from_reference(tables_np: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A reference feature-table snapshot -> the port's host tables
    (contiguous float32 numpy, one per node type)."""
    return {t: np.ascontiguousarray(np.asarray(a, np.float32))
            for t, a in tables_np.items()}


def _lm_leaf(a, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through float32
        t = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def lm_params_from_reference(params_np: Dict, device=None,
                             dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's LM ``init_params`` tree of numpy leaves (``{"blocks":
    {kind: {leaf: [n_periods, n_slots, ...]}}, "final_norm", "embed",
    "head"}``) -> the port's tree of tensors on ``device`` (``None``: the
    GPU), in each leaf's own type (bfloat16 kept) or in ``dtype``."""
    if "blocks" not in params_np or "head" not in params_np:
        raise ValueError(f"expected an LM parameter tree, got keys {sorted(params_np)}")
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _lm_leaf(tree, device, dtype)

    return conv(params_np)
