"""Config registry: ``get_arch(name)`` / ``ARCHS`` / ``SHAPES``.

Arch ids match the assignment sheet (``--arch <id>``).
"""
from __future__ import annotations

from repro_torch.configs.base import (
    GLOBAL,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    SHAPES,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
    shape_applicable,
)

from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.h2o_danube3_4b import CONFIG as _danube
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3_4b
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3_12b
from repro_torch.configs.llama32_3b import CONFIG as _llama32_3b
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.internvl2_26b import CONFIG as _internvl2
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2lite
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.resnet import RESNET18, RESNET152

ARCHS = {
    c.name: c
    for c in (
        _seamless,
        _danube,
        _gemma3_4b,
        _gemma3_12b,
        _llama32_3b,
        _hymba,
        _internvl2,
        _kimi,
        _dsv2lite,
        _falcon_mamba,
    )
}

# The paper's own models (ResNet-18/152 on FEMNIST) live outside the
# 40-cell LM grid; exposed for the paper-faithful examples/benchmarks.
PAPER_MODELS = {"resnet18": RESNET18, "resnet152": RESNET152}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}"
        ) from None


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(
            f"unknown shape {name!r}; available: {sorted(SHAPES)}"
        ) from None


def grid():
    """All 40 (arch, shape) cells with applicability flags."""
    cells = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            ok, why = shape_applicable(a, s)
            cells.append((a, s, ok, why))
    return cells


__all__ = [
    "ARCHS",
    "PAPER_MODELS",
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "MoEConfig",
    "SSMConfig",
    "MLAConfig",
    "GLOBAL",
    "get_arch",
    "get_shape",
    "grid",
    "shape_applicable",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
]
