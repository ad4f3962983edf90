"""Shared transformer layers: RMSNorm, RoPE variants, init helpers.

The port's copy of ``repro/models/layers.py``.  The bf16 rounding sites are
the reference's: ``rms_norm`` normalizes in fp32 and rounds to x's type
before ``* scale``; ``apply_rope`` rounds cos and sin to x's type before the
rotation.  The initializers draw from an explicit ``torch.Generator``
(seeded by the caller), in fp32, and cast to the parameter type, one entry
of the leaf's ``stack`` (its period and slot axes) at a time into a
preallocated tensor of that type: the fp32 transient is one entry's size,
never the whole leaf's (qwen3-moe-30b-a3b's stacked ``w1`` is 19 GB in
bf16 and would be 39 GB in fp32).  A leaf on the ``meta`` device is
allocated and never drawn (``SHAPE_ONLY`` stands in for the generator):
``torch.Generator`` has no ``meta`` device, and the dry run needs shapes
only.

The DTensor helpers are the port's own.  Under the dry run
(``repro_torch.launch.dryrun``) the activations are DTensors: a plain
tensor made inside the model (positions, masks, RoPE tables) is lifted to
``Replicate()`` on their mesh before an op mixes the two
(``replicate_like``); a product's pending sums are reduced at the end of
each block, as tensor parallelism reduces them (``reduce_partial``); a head
count the model axis does not divide is gathered before the split
(``split_dim``) and its gradient on the way back (``grad_like``);
``constrain`` is ``with_sharding_constraint``'s counterpart
(``spec_placements`` its placements); ``local_map`` runs a function that
mixes nothing across shards on each rank's local tensors (``shard_map``'s
counterpart); ``full_local`` gathers a DTensor's whole value into a plain
tensor on every rank; ``match_placements`` puts a block's output in its
input's placements.  On plain
tensors each is the identity (``constrain`` on a one-device mesh).
"""

from __future__ import annotations

import math
import types
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["rms_norm", "apply_rope", "rope_frequencies", "he_init", "embed_init",
           "SHAPE_ONLY", "replicate_like", "reduce_partial", "split_dim", "grad_like", "mesh_axes",
           "constrain", "spec_placements", "full_local", "match_placements", "batch_axes",
           "local_map"]

# stands in for a generator on the meta device: its leaves are allocated, never drawn
SHAPE_ONLY = types.SimpleNamespace(device=torch.device("meta"))


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of
    ``repro_torch.launch.mesh.AbstractMesh``, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    sizes = mesh.shape
    if isinstance(sizes, dict):
        return {a: int(sizes[a]) for a in names}
    return dict(zip(names, (int(n) for n in sizes)))


def constrain(t: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """The counterpart of ``jax.lax.with_sharding_constraint(t, P(*spec))``:
    a DTensor is redistributed so that each mesh axis a dim of ``spec`` names
    (alone or in a tuple, in mesh order) shards that dim and every other
    axis replicates it.  A plain tensor is taken as it is on a mesh of one
    device, and refused on a larger one: there is nothing to place it with."""
    if not isinstance(t, DTensor):
        n = math.prod(mesh_axes(mesh).values())
        if n > 1:
            raise ValueError(f"a sharding constraint over a mesh of {n} devices needs "
                             "DTensor activations; got a plain tensor")
        return t
    return t.redistribute(t.device_mesh, spec_placements(t.device_mesh, spec))


def spec_placements(dm, spec: tuple) -> list:
    """The DTensor placements ``constrain`` gives ``spec`` on the
    ``DeviceMesh`` ``dm``: ``Shard(dim)`` on each mesh dim that a dim of
    ``spec`` names (alone or in a tuple), ``Replicate()`` on the others."""
    placements = []
    for name in dm.mesh_dim_names:
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return placements


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor whose placements hold pending sums (a vocab-sharded
    embedding's lookup) with the sums done (an all-reduce); anything else
    as it is."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        dm, pl = t.device_mesh, t.placements
        masked = [p for p in pl if p.is_partial() and type(p) is not Partial]
        if masked:
            # the lookup's masked partial is a plain sum of its local rows
            # (zeros where a rank holds no row); taken as one, so that its
            # gradient needs no conversion between partial kinds.  Its mask
            # is released, as reducing it would
            for p in masked:
                p.mask_buffer.release_mask()
            t = DTensor.from_local(t.to_local(), dm,
                                   [Partial() if p.is_partial() else p for p in pl],
                                   run_check=False, shape=t.shape, stride=t.stride())
        return t.redistribute(dm, [Replicate() if p.is_partial() else p for p in pl])
    return t


def split_dim(t: torch.Tensor, dim: int, sizes: Tuple[int, ...]) -> torch.Tensor:
    """``t`` with its dim ``dim`` split into ``sizes`` (a reshape).  A
    DTensor sharded on that dim over mesh dims that do not divide
    ``sizes[0]`` (24 heads, or 4 kv groups, over a model axis of 16) is
    gathered on those mesh dims first: DTensor cannot split an unevenly
    sharded dim, where GSPMD pads."""
    dim = dim % t.dim()
    if isinstance(t, DTensor):
        dm = t.device_mesh
        on = [i for i, p in enumerate(t.placements) if p.is_shard(dim)]
        if on and sizes[0] % math.prod(dm.size(i) for i in on):
            t = t.redistribute(dm, [Replicate() if i in on else p
                                    for i, p in enumerate(t.placements)])
    return t.reshape(t.shape[:dim] + tuple(sizes) + t.shape[dim + 1:])


def grad_like(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, but a DTensor's gradient is redistributed to ``t``'s own
    placements on its way back (``from_local``'s backward does that), so
    that the backward of a reshape before it finds the gradient as
    splittable as the forward found ``t``; a plain tensor as it is."""
    if isinstance(t, DTensor):
        return DTensor.from_local(t.to_local(), t.device_mesh, t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return t


def batch_axes(mesh, batch: int):
    """The mesh's data axes (all but ``"model"``) when they divide
    ``batch``; else None (the batch replicated)."""
    axes = mesh_axes(mesh)
    dp = tuple(a for a in axes if a != "model")
    return dp if dp and batch % math.prod(axes[a] for a in dp) == 0 else None


def local_map(fn, like: torch.Tensor, args, in_specs, out_specs):
    """``fn`` on this rank's local shards, the counterpart of the
    reference's ``shard_map``: each of ``args`` is placed by its spec on
    ``like``'s mesh (a plain tensor lifted replicated first) and handed to
    ``fn`` as its local tensor; each output (one tensor, or a tuple matched
    to ``out_specs``) is lifted back by its spec.  ``fn`` must mix nothing
    across the shards."""
    mesh = like.device_mesh
    out = fn(*(constrain(replicate_like(a, like), mesh, spec).to_local()
               for a, spec in zip(args, in_specs)))

    def lift(o, spec):
        return DTensor.from_local(o, mesh, spec_placements(mesh, spec), run_check=False)

    if isinstance(out, tuple):
        return tuple(lift(o, spec) for o, spec in zip(out, out_specs))
    return lift(out, out_specs)


def match_placements(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` redistributed to ``like``'s placements when both are DTensors
    (pending sums reduced, shards gathered or split as ``like`` has them);
    else ``t`` itself."""
    if isinstance(t, DTensor) and isinstance(like, DTensor):
        return t.redistribute(like.device_mesh, like.placements)
    return t


def full_local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on this rank (gathered to ``Replicate()``,
    then ``to_local``), so that an op the card's torch (2.11) gives no
    sharding rule (``index_put_``) runs on plain tensors; a plain tensor as
    it is."""
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim).to_local()
    return t


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` as a DTensor replicated on ``like``'s mesh when ``like`` is a
    DTensor (``t`` must then hold the same values on every rank); else
    ``t`` itself."""
    if isinstance(like, DTensor) and not isinstance(t, DTensor):
        mesh = like.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_frequencies(head_dim: int, fraction: float, theta: float) -> int:
    """Number of head dims that get rotated (even).  ``fraction=0.5`` is the
    ChatGLM '2d RoPE': only the first half of each head rotates."""
    rot = int(head_dim * fraction)
    return rot - (rot % 2)


def apply_rope(
    x: torch.Tensor,  # [b, s, h, hd]
    positions: torch.Tensor,  # [b, s] or [s]
    fraction: float = 1.0,
    theta: float = 500_000.0,
) -> torch.Tensor:
    b, s, h, hd = x.shape
    rot = rope_frequencies(hd, fraction, theta)
    if rot == 0:
        return x
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, s)
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # [b, s, half]
    cos = replicate_like(torch.cos(ang)[:, :, None, :].to(x.dtype), x)
    sin = replicate_like(torch.sin(ang)[:, :, None, :].to(x.dtype), x)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :half], xr[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, xp], dim=-1)


def _draw(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype, std: float,
          stack: Tuple[int, ...]) -> torch.Tensor:
    """N(0, std^2) of shape ``stack + shape`` in ``dtype`` on ``gen``'s
    device, drawn in fp32 one stack entry at a time (a leaf with no stack is
    one entry); with ``SHAPE_ONLY``, allocated on ``meta`` and not drawn."""
    out = torch.empty(stack + shape, dtype=dtype, device=gen.device)
    if gen is SHAPE_ONLY:
        return out
    for entry in out.view((-1,) + shape):
        draw = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        entry.copy_(draw * std)
    return out


def he_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
            fan_in: Optional[int] = None, stack: Tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, 1/fan) of shape ``stack + shape``.  The fan is ``shape``'s and
    keeps the reference's operator precedence: ``(fan_in or shape[-2]) if
    len(shape) >= 2 else shape[-1]``."""
    fan = fan_in or shape[-2] if len(shape) >= 2 else shape[-1]
    return _draw(gen, shape, dtype, 1.0 / float(fan) ** 0.5, stack)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return _draw(gen, shape, dtype, 0.02, ())
