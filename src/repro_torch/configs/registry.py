"""Architecture registry: --arch <id> -> ModelConfig.

Only the architectures whose family the port runs are registered; the
reference registers ten, and the other nine come with their families.
"""
from . import zamba2_7b
from .base import ModelConfig

ARCHS = {
    "zamba2-7b": zamba2_7b.CONFIG,
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet; ported: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
