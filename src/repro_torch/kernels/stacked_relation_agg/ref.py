"""Oracle for the stacked relation-aggregation family.

:func:`stacked_agg_ref` is the **gather-then-vmap oracle** of "run one
level's AGG_r for every branch slot of a shard": gather each declared
leaf's per-slot parameters through the scope index arrays (materializing a
``[rb, ...]`` copy of every leaf) and ``vmap`` the module's ``aggregate``
over the branch axis.  It is the dispatch's path when the kernel layer is
off, and the model-agnostic path for modules without a fused kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["stacked_agg_ref"]


def _scope_of(module) -> Dict[str, str]:
    return {s.name: s.scope for s in module.specs}


def stacked_agg_ref(module, stacks, slot_u, h, q, mask):
    """Gather-then-vmap oracle.

    stacks  {leaf: [U_scope, ...]}   one shard's per-scope parameter slabs
    slot_u  {scope: [rb] int}        per-slot index into that scope's slab
    h       [rb, n, f, d_in]         neighbor embeddings per slot
    q       [rb, n, d_dst]           destination input features per slot
    mask    [rb, n, f]               real-neighbor mask
    ->      [rb, n, hidden]
    """
    scope_of = _scope_of(module)
    p_slots = {
        name: stacks[name][torch.as_tensor(slot_u[scope_of[name]], dtype=torch.long,
                                           device=stacks[name].device)]
        for name in stacks
    }
    return torch.func.vmap(module.aggregate)(p_slots, h, q, mask)
