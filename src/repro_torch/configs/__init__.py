"""Config registry: ``get_config("<arch-id>")`` plus shape cells and smoke
reductions (counterpart of ``repro.configs``)."""
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.base import (
    FULL_ATTN,
    MAMBA,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    smoke_config,
)


def get_config(name: str) -> ModelConfig:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[name]


def list_archs():
    return sorted(ALL_ARCHS)


__all__ = [
    "ALL_ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "smoke_config",
    "get_config", "list_archs", "FULL_ATTN", "MAMBA",
]
