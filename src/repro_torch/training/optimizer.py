"""AdamW with cosine and WSD (warmup-stable-decay, MiniCPM) schedules: the
reference's `repro/training/optimizer.py` in torch.

The state is {step, mu, nu} with mu and nu shaped like the parameters, so
the update is elementwise. The schedule and the bias corrections are
computed in float32 as the reference computes them (`b1 ** step` too); the
update is in float32 (float64 for a float64 model), each leaf updated in
place in the reference's order of operations. As in the reference, weight
decay goes by the leaf's rank: a leaf with ndim >= 2 is decayed, which
takes in a stacked norm scale [L, d] or bias [L, d_out] as well.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.layers.common import wide_dtype
from .tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # "cosine" | "wsd"
    wsd_decay_frac: float = 0.1       # last 10% of steps decay (WSD)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or an integer tensor), a float32
    scalar on the step's device, computed in float32 in the reference's
    order."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    if cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.wsd_decay_frac)
        frac = (step - decay_start) / max(cfg.total_steps - decay_start, 1.0)
        frac = torch.clamp(frac, 0.0, 1.0)
        main = cfg.peak_lr * (1.0 - (1.0 - cfg.min_lr_frac) * frac)
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        # the cosine of the f32 angle, correctly rounded to f32 (through
        # float64): torch's f32 cos can sit an ulp off it, and 1 + cos
        # near t = 1 turns that ulp into several of the rate
        cos = torch.cos((math.pi * t).double()).float()
        main = cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                              * 0.5 * (1 + cos))
    return torch.where(step < cfg.warmup_steps, warm, main)


def init_opt_state(params) -> dict:
    """{step: int32 scalar 0, mu, nu: zeros like each parameter}."""
    some = leaves(params)[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=some.device),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, each leaf in float32
    (float64 for float64), summed leaf by leaf in the reference's flatten
    order."""
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(
            leaf.to(wide_dtype(leaf.dtype))))
    return torch.sqrt(total)


def adamw_update(cfg: OptConfig, params, grads, state, gnorm=None):
    """One AdamW step. Returns (params, state, {"lr", "grad_norm"}): the
    parameters, mu and nu are updated in place and returned in the same
    trees, with the step counter advanced; grad_norm is the raw norm,
    before clipping: global_norm(grads), or `gnorm` where the caller holds
    shards and passes the whole gradient's norm."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, mu, nu):
        wide = wide_dtype(p.dtype)
        g = g.to(wide) * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_(((1 - b2) * g).mul_(g))
        del g
        upd_ = mu / bc1
        nhat = nu / bc2
        upd_.div_(nhat.sqrt_().add_(cfg.eps))
        del nhat
        if p.dim() >= 2:  # the reference decays by rank (see the module)
            upd_.add_(cfg.weight_decay * p.to(wide))
        p.sub_(upd_.mul_(lr))

    flat_p, flat_g = leaves(params), leaves(grads)
    flat_mu, flat_nu = leaves(state["mu"]), leaves(state["nu"])
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError("adamw_update: params, grads, mu and nu must have "
                         "the same leaves")
    with torch.no_grad():
        for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu):
            upd(p, g, mu, nu)
    return (params, {"step": step, "mu": state["mu"], "nu": state["nu"]},
            {"lr": lr, "grad_norm": gnorm})
