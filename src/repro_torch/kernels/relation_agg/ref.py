"""Plain PyTorch version of the relation aggregation kernel.

    out[n] = ( sum_f mask[n,f] * h[n,f,:] / max(sum_f mask[n,f], 1) ) @ w + b

This is AGG_r for R-GCN (paper Eq. 1): masked mean over the sampled
neighbours followed by the relation-specific projection.
"""

from __future__ import annotations

import torch

__all__ = ["relation_agg_ref"]


def relation_agg_ref(
    h: torch.Tensor,  # [n, f, d_in]
    mask: torch.Tensor,  # [n, f] bool
    w: torch.Tensor,  # [d_in, d_out]
    b: torch.Tensor,  # [d_out]
) -> torch.Tensor:
    mw = mask.to(h.dtype)
    s = torch.einsum("nfd,nf->nd", h, mw)
    mean = s / torch.clamp(mw.sum(dim=-1, keepdim=True), min=1.0)
    return mean @ w + b
