"""Train-step factory: the reference's `repro/training/train_loop.py` for
one device.

make_train_step returns (step_fn, None, None), unpacked as the reference's
(step_fn, state_shardings, batch_spec):
  state = {params, opt};  step_fn(state, batch) -> (state, metrics)

Mixed precision (f32 master parameters and Adam moments, compute in
`compute_dtype`), gradient accumulation over microbatches, optional bf16
gradient compression, and remat of every layer (`loss_fn(train=True)`).
A mesh, the shardings, `dp_axes` and `init_state_shape` come with the
launch and distributed modules.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.compression import compress_bf16
from ..models import model as MDL
from ..models.layers.common import wide_dtype
from . import optimizer as OPT
from .tree import cast_tree, leaves, tree_map, unflatten


def batch_to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors on `device`: integer fields
    (tokens, labels) as int64, floating ones in their own type."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = (t if t.is_floating_point() else t.long()).to(device)
    return out


def loss_and_grads(params, batch, cfg: ModelConfig, use_kernel="auto"):
    """(loss, metrics, grads) of loss_fn(train=True) with respect to every
    leaf of `params`, each of which gets a gradient (none may go unused):
    the parameters are taken as fresh leaves of their own type, so the
    gradients come out in that type."""
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = MDL.loss_fn(params, batch, cfg, train=True,
                                use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, leaves(params))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: OPT.OptConfig, mesh=None,
                    microbatches: int = 1, compute_dtype=torch.bfloat16,
                    grad_compression: Optional[str] = None, device=None):
    """Returns (step_fn, None, None). step_fn(state, batch) casts the
    master parameters to `compute_dtype`, takes the gradients of
    loss_fn(train=True) (accumulated in f32 over `microbatches` slices of
    the batch's leading axis, then averaged, as the loss is), compresses
    them to bf16 when `grad_compression == "bf16"`, applies adamw_update in
    place and returns (state, metrics): the model's metrics and "loss",
    "lr", "grad_norm". The batch (numpy or tensors) goes to `device`
    (None: the card)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step: a mesh (sharded state, dp_axes) is not ported "
            "yet; it comes with the launch and distributed modules "
            "(ROADMAP A5)")
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def step(state, batch):
        batch = batch_to_device(batch, resolve_device(device))
        params = state["params"]
        params_c = cast_tree(params, compute_dtype)
        if microbatches > 1:
            size = next(iter(batch.values())).shape[0]
            if size % microbatches:
                raise ValueError(f"batch of {size} does not split into "
                                 f"{microbatches} microbatches")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=wide_dtype(p.dtype), device=p.device),
                params_c)
            loss = 0.0
            for k in range(microbatches):
                mb = {key: v.reshape(microbatches, size // microbatches,
                                     *v.shape[1:])[k]
                      for key, v in batch.items()}
                mb_loss, metrics, g = loss_and_grads(params_c, mb, cfg)
                for acc, gk in zip(leaves(grads), leaves(g)):
                    acc.add_(gk)
                loss = loss + mb_loss
                del g
            for acc in leaves(grads):
                acc.div_(microbatches)
            loss = loss / microbatches
        else:
            loss, metrics, grads = loss_and_grads(params_c, batch, cfg)
        del params_c
        if grad_compression == "bf16":
            grads = compress_bf16(grads)
        new_params, new_opt, opt_metrics = OPT.adamw_update(
            opt_cfg, params, grads, state["opt"])
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return step, None, None


def init_state(cfg: ModelConfig, seed: int = 0, param_dtype=torch.float32,
               device=None) -> dict:
    """{"params": init_params(cfg, seed), "opt": init_opt_state(params)},
    on `device` (None: the card)."""
    params = MDL.init_params(cfg, seed=seed, dtype=param_dtype,
                             device=device)
    return {"params": params, "opt": OPT.init_opt_state(params)}
