"""The training loop's batch schedule.

Only :class:`EpochSchedule` so far: the single map from a global step to
``(epoch_seed, step-in-epoch)`` that the session's serial loop uses.  The
sampler worker pool itself (``WorkerPool``, ``SampleStageTask``, the shm
store and the batch arena) is a later slice of the port; there the same
schedule drives every worker, so pooled and serial batches stay identical.
A copy of the reference's ``repro/data/worker_pool.py:398-419``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["EpochSchedule"]


@dataclasses.dataclass(frozen=True)
class EpochSchedule:
    """Maps a global step to ``(epoch_seed, step-in-epoch)``.

    Epoch ``e`` covers global steps ``[e*E, (e+1)*E)`` and shuffles with
    ``epoch_seed_base + e*seed_stride`` — by default ``seed_stride = E``,
    the session's historical seeding.  The §6 pre-sampling sweep seeds
    epochs with ``seed + ep`` instead, which is ``seed_stride=1``."""

    epoch_seed_base: int
    steps_per_epoch: int
    start_step: int = 0
    shuffle: bool = True
    seed_stride: Optional[int] = None  # None = steps_per_epoch

    def seed_and_index(self, i: int) -> Tuple[int, int]:
        s = self.start_step + i
        e, idx = divmod(s, self.steps_per_epoch)
        stride = (self.steps_per_epoch if self.seed_stride is None
                  else self.seed_stride)
        return self.epoch_seed_base + e * stride, idx
