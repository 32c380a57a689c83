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

# long_500k applicability: sub-quadratic mechanisms only.
LONG_CONTEXT_ARCHS = {
    "mamba2-1.3b",          # O(1) SSM state
    "zamba2-1.2b",          # hybrid: SSM + shared-attn KV
    "mixtral-8x7b",         # SWA 4096 — KV bounded by window
    "gemma2-27b",           # 1:1 local:global — local layers bounded
    "gemma3-4b",            # 5:1 local:global
}
LONG_SKIP_REASON = {
    "gemma-2b": "pure full attention (no windowing) — 500k KV has no sub-quadratic path",
    "starcoder2-15b": "pure full attention per assignment spec",
    "phi-3-vision-4.2b": "pure full attention; vision frontend caps practical context",
    "whisper-medium": "enc-dec audio: source is 1500 frames; 500k decode is meaningless",
    "moonshot-v1-16b-a3b": "pure full attention per assignment spec (48L global)",
}


def get_config(name: str) -> ModelConfig:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[name]


def list_archs():
    return sorted(ALL_ARCHS)


def cells():
    """All (arch, shape) dry-run cells with applicability."""
    out = []
    for arch in list_archs():
        for shape_name, shape in SHAPES.items():
            if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                out.append((arch, shape_name, False, LONG_SKIP_REASON[arch]))
            else:
                out.append((arch, shape_name, True, ""))
    return out


__all__ = [
    "ALL_ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "smoke_config",
    "get_config", "list_archs", "cells", "LONG_CONTEXT_ARCHS", "LONG_SKIP_REASON",
    "FULL_ATTN", "MAMBA",
]
