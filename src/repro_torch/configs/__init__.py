"""Architecture registry: ``--arch <id>`` resolves here (port of
``repro/configs/__init__.py``; the configs are the same data)."""
from repro_torch.configs import (
    chameleon_34b,
    gemma2_9b,
    granite_20b,
    granite_moe_1b_a400m,
    phi3_mini_3_8b,
    phi35_moe_42b_a6_6b,
    qwen3_0_6b,
    seamless_m4t_large_v2,
    xlstm_125m,
    zamba2_1_2b,
)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec

ARCHS = {
    "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b_a6_6b.CONFIG,
    "granite-20b": granite_20b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3_8b.CONFIG,
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "gemma2-9b": gemma2_9b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeSpec", "get_arch"]
