"""Gradient compression (the reference's `distributed/compression.py`):
gradients rounded before the optimizer, so that a cross-device all-reduce
would move fewer bytes. bf16 is lossless enough for Adam (which
re-normalizes by sqrt(nu)); int8 uses a per-tensor scale and stochastic
rounding, so its expectation is the gradient (unbiased)."""
from __future__ import annotations

import torch

from ..training.tree import leaves, tree_map, unflatten


def compress_bf16(grads):
    """Every gradient rounded to bf16 and returned in f32."""
    return tree_map(lambda g: g.to(torch.bfloat16).to(torch.float32), grads)


def int8_round(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The reference's quantize-dequantize of one gradient given uniforms
    `u` in [0, 1) of its shape: scale = max|g| / 127 (at least 1e-12 /
    127), round g / scale down or up with probability its fraction, clip
    to [-127, 127], and scale back."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    x = g / scale
    lo = torch.floor(x)
    r = lo + (u < x - lo)
    return torch.clamp(r, -127, 127) * scale


def compress_int8_stochastic(grads, generator: torch.Generator):
    """Quantize-dequantize every gradient with stochastic rounding, the
    uniforms drawn from `generator` leaf by leaf in the reference's
    flatten order."""
    flat = leaves(grads)
    return unflatten(grads, [int8_round(g, torch.rand(
        g.shape, dtype=g.dtype, device=g.device, generator=generator))
        for g in flat])
