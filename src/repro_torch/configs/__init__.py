"""Registry of assigned architectures (--arch <id>) + shape cells."""

from typing import Dict

from .base import SHAPES, ArchConfig, ShapeSpec, reduced_for_smoke, shape_applicable
from .deepseek_moe_16b import CONFIG as _deepseek_moe_16b
from .deepseek_v2_lite_16b import CONFIG as _deepseek_v2_lite_16b
from .gemma3_12b import CONFIG as _gemma3_12b
from .h2o_danube_1_8b import CONFIG as _h2o_danube_1_8b
from .internlm2_20b import CONFIG as _internlm2_20b
from .internvl2_26b import CONFIG as _internvl2_26b
from .jamba_1_5_large_398b import CONFIG as _jamba_1_5_large_398b
from .mamba2_780m import CONFIG as _mamba2_780m
from .mistral_large_123b import CONFIG as _mistral_large_123b
from .whisper_small import CONFIG as _whisper_small

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _internvl2_26b,
        _whisper_small,
        _gemma3_12b,
        _h2o_danube_1_8b,
        _mistral_large_123b,
        _internlm2_20b,
        _jamba_1_5_large_398b,
        _deepseek_v2_lite_16b,
        _deepseek_moe_16b,
        _mamba2_780m,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
