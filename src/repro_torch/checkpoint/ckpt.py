"""Checkpoints: a tree of nested dicts and lists flattened to one npz + a JSON
manifest.

The format, the commit order and the checks are the reference's
(``repro/checkpoint/ckpt.py``), so a checkpoint written by the reference
session restores into the port and the other way round:

  * leaves are keyed by their path, the dict keys and list indices joined
    with ``"/"`` (``state/stacks/layer1/w``, ``state/opt/step``,
    ``state/bundle/parts/0/rel/...``, ``embed/tables/author``);
  * the npz payload is written to a temp file and renamed first, then the
    manifest (temp + rename) last — the manifest's rename is the commit
    point, so a crash leaves a complete pair or junk that
    :func:`latest_step` ignores;
  * the manifest records each array's shape, logical dtype, stored dtype
    and sha256; :func:`load_checkpoint` verifies them and raises
    :class:`CheckpointError` on a missing, torn or corrupt checkpoint.

Tensors are saved from the host (``.cpu().numpy()``).  On load every leaf
comes back on the device (and with the dtype) of its template leaf, or as
numpy where the template leaf is numpy.  The port holds no bf16 state, so a
manifest that declares a bf16 leaf (the reference stores those as
``uint16`` bits) is refused rather than misread.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "read_manifest",
           "CheckpointError"]

_MANIFEST_VERSION = 2


class CheckpointError(RuntimeError):
    """A checkpoint is missing, partial, or fails integrity verification."""


def _items(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path key, leaf) of nested dicts (sorted key order), lists and tuples
    (in order, keyed by index)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _items(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in _items(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten_like(tree: Any, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, leaves, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


def _host(leaf: Any) -> np.ndarray:
    return leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def save_checkpoint(directory: str, step: int, tree: Any, name: str = "ckpt",
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write one checkpoint; returns the npz path.

    ``extra`` is a small JSON-able dict stored verbatim in the manifest
    (session metadata: config fingerprint, sampler position, seed)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}_{step:08d}.npz")
    flat = {key: _host(leaf) for key, leaf in _items(tree)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # file object: savez can't mangle the name
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    manifest = {
        "version": _MANIFEST_VERSION,
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "stored_dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "sha256": {k: _sha256(v) for k, v in flat.items()},
        "extra": extra or {},
    }
    mtmp = path + ".json.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mtmp, path + ".json")  # the commit point
    return path


def latest_step(directory: str, name: str = "ckpt") -> Optional[int]:
    """The newest *committed* step: an npz whose manifest also exists."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(directory)
        if (m := re.fullmatch(rf"{name}_(\d+)\.npz", f))
        and os.path.exists(os.path.join(directory, f + ".json"))
    ]
    return max(steps) if steps else None


def read_manifest(directory: str, step: int, name: str = "ckpt") -> Dict:
    path = os.path.join(directory, f"{name}_{step:08d}.npz.json")
    if not os.path.exists(path):
        raise CheckpointError(f"checkpoint manifest missing: {path}")
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as exc:
        raise CheckpointError(f"unreadable manifest {path}: {exc}") from exc


def _restore_leaf(arr: np.ndarray, leaf: Any) -> Any:
    if not torch.is_tensor(leaf):
        return arr
    # ascontiguousarray turns a 0-d array (Adam's step) into shape (1,)
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape)).to(
        device=leaf.device, dtype=leaf.dtype)


def load_checkpoint(directory: str, step: int, template: Any,
                    name: str = "ckpt", verify: bool = True) -> Any:
    """Restore into the structure of ``template`` (keys must match).

    With ``verify`` (the default) every array's shape and sha256 are checked
    against the manifest, so a torn or bit-rotten payload raises
    :class:`CheckpointError`."""
    path = os.path.join(directory, f"{name}_{step:08d}.npz")
    manifest = read_manifest(directory, step, name)
    if not os.path.exists(path):
        raise CheckpointError(f"checkpoint payload missing: {path}")
    try:
        data = np.load(path)
    except (OSError, ValueError, zipfile.BadZipFile) as exc:
        raise CheckpointError(f"unreadable checkpoint {path}: {exc}") from exc
    items = _items(template)
    want = {key for key, _ in items}
    have = set(manifest.get("keys", []))
    if want != have:
        raise CheckpointError(
            f"checkpoint {path} key mismatch: template-only="
            f"{sorted(want - have)[:4]} checkpoint-only={sorted(have - want)[:4]}")
    dtypes = manifest.get("dtypes", {})
    hashes = manifest.get("sha256", {})
    out = {}
    with data:
        for key, leaf in items:
            try:
                arr = data[key]
            except KeyError:
                raise CheckpointError(
                    f"checkpoint {path} payload missing array {key!r} "
                    f"(torn write?)") from None
            except (OSError, ValueError, zipfile.BadZipFile) as exc:
                raise CheckpointError(
                    f"checkpoint {path} array {key!r} unreadable: {exc}") from exc
            shape = manifest.get("shapes", {}).get(key)
            if shape is not None and list(arr.shape) != shape:
                raise CheckpointError(
                    f"checkpoint {path} array {key!r}: stored shape "
                    f"{list(arr.shape)} != manifest {shape}")
            if verify and key in hashes and _sha256(arr) != hashes[key]:
                raise CheckpointError(
                    f"checkpoint {path} array {key!r} failed sha256 verification")
            if dtypes.get(key) == "bfloat16":
                raise CheckpointError(
                    f"checkpoint {path} array {key!r} is bf16, which the port "
                    f"does not hold")
            out[key] = _restore_leaf(arr, leaf)
    return _unflatten_like(template, out)
