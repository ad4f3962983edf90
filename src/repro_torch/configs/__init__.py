from repro_torch.configs.base import (
    ARCHS,
    ArchConfig,
    INPUT_SHAPES,
    InputShape,
    get_arch,
    register,
)

__all__ = ["ARCHS", "ArchConfig", "INPUT_SHAPES", "InputShape", "get_arch", "register"]
