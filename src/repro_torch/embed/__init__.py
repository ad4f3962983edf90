from repro_torch.embed.profiler import (
    HotnessProfile,
    presample_hotness,
    measure_miss_penalty,
    analytic_miss_penalty,
    MissPenaltyProfile,
    profile_miss_penalties,
)
from repro_torch.embed.cache import CacheAllocation, allocate_cache, FeatureCache
from repro_torch.embed.engine import EmbedEngine

__all__ = [
    "HotnessProfile",
    "presample_hotness",
    "measure_miss_penalty",
    "analytic_miss_penalty",
    "MissPenaltyProfile",
    "profile_miss_penalties",
    "CacheAllocation",
    "allocate_cache",
    "FeatureCache",
    "EmbedEngine",
]
