"""Dense MLP block: SwiGLU."""
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


def mlp(params, x, activation=F.silu):
    return linear(params["w_down"],
                  activation(linear(params["w_gate"], x))
                  * linear(params["w_up"], x))
