"""Dense MLP block: SwiGLU, plain or tensor-parallel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import init_linear, linear


def init_mlp(gen, d_model, d_ff, dtype=torch.float32, stack=()):
    return {
        "w_gate": init_linear(gen, d_model, d_ff, False, dtype, stack=stack),
        "w_up": init_linear(gen, d_model, d_ff, False, dtype, stack=stack),
        "w_down": init_linear(gen, d_ff, d_model, False, dtype, stack=stack),
    }


def mlp(params, x, activation=F.silu, tp=None):
    """x [..., d] -> [..., d]. tp (`sharding.TensorParallel`): x [B, S/M, d]
    is this rank's block of the sequence, w_gate and w_up hold its columns
    of d_ff and w_down its rows (column- then row-parallel); the sequence
    is gathered before and the partial sums reduce-scattered after, so the
    rank returns its block of the sequence. In decode (`tp.whole`) x is
    the whole token and the partial sums are all-reduced."""
    if tp is not None and not tp.whole:
        return tp.scatter_seq(mlp(params, tp.gather_seq(x), activation))
    h = activation(linear(params["w_gate"], x)) * linear(params["w_up"], x)
    if tp is not None:
        return tp.row_linear(params["w_down"], h)
    return linear(params["w_down"], h)
