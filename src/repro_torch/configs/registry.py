"""Architecture registry: --arch <id> -> ModelConfig.

The reference's ten architectures, every one of which the port runs: the
dense family, gemma2's local/global pairs, the MoE family, the zamba2
hybrid, rwkv6, the vlm (llama-3.2-vision) and the audio encoder (hubert).
"""
from . import (command_r_plus_104b, gemma2_27b, hubert_xlarge,
               llama32_vision_11b, minicpm_2b, phi35_moe_42b_a66b,
               qwen2_7b, qwen3_moe_30b_a3b, rwkv6_7b, zamba2_7b)
from .base import SHAPES, ModelConfig

ARCHS = {
    "zamba2-7b": zamba2_7b.CONFIG,
    "qwen2-7b": qwen2_7b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "gemma2-27b": gemma2_27b.CONFIG,
    "minicpm-2b": minicpm_2b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b_a66b.CONFIG,
    "llama-3.2-vision-11b": llama32_vision_11b.CONFIG,
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def runnable_cells():
    """The 40 (arch x shape) cells minus the documented skips: a list of
    (arch, shape, runnable, reason)."""
    out = []
    for arch, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            runnable, reason = True, ""
            if cfg.encoder_only and shape.kind == "decode":
                runnable, reason = False, "encoder-only: no decode step"
            elif sname == "long_500k" and not cfg.sub_quadratic:
                runnable, reason = (False, "full attention: long_500k needs "
                                    "sub-quadratic")
            out.append((arch, sname, runnable, reason))
    return out
