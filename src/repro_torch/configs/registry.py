"""Architecture registry: --arch <id> -> ModelConfig.

Only the architectures whose family the port runs are registered: the
dense family, gemma2's local/global pairs, the MoE family and the zamba2
hybrid. The reference's other three (rwkv6-7b, llama-3.2-vision-11b,
hubert-xlarge) come with their families.
"""
from . import (command_r_plus_104b, gemma2_27b, minicpm_2b,
               phi35_moe_42b_a66b, qwen2_7b, qwen3_moe_30b_a3b, zamba2_7b)
from .base import ModelConfig

ARCHS = {
    "zamba2-7b": zamba2_7b.CONFIG,
    "qwen2-7b": qwen2_7b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "gemma2-27b": gemma2_27b.CONFIG,
    "minicpm-2b": minicpm_2b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b_a66b.CONFIG,
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet; ported: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
