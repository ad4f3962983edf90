"""Host-side feature staging shared by the port's device paths.

Only the padded row gather that layer-wise inference needs lives here so
far; the stacked-batch recipe of the training pipeline joins it with the
training slice of the port.
"""

from __future__ import annotations

import numpy as np

__all__ = ["_padded_gather"]


def _padded_gather(tab: np.ndarray, nids: np.ndarray, d_pad: int) -> np.ndarray:
    """Rows ``tab[nids]`` as float32, zero-padded on the right to ``d_pad``."""
    out = np.zeros((len(nids), d_pad), np.float32)
    out[:, : tab.shape[1]] = tab[nids]
    return out
