"""Gradient compression (the reference's `distributed/compression.py`):
gradients rounded to bf16 before the optimizer, so that a cross-device
all-reduce would move half the bytes. Only `compress_bf16` is ported; the
int8 stochastic rounding waits for the distributed modules."""
from __future__ import annotations

import torch

from ..training.tree import tree_map


def compress_bf16(grads):
    """Every gradient rounded to bf16 and returned in f32."""
    return tree_map(lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
