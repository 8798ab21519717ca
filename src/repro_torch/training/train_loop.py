"""Train-step factory: the reference's `repro/training/train_loop.py`.

make_train_step returns (step_fn, state_shardings, batch_spec):
  state = {params, opt};  step_fn(state, batch) -> (state, metrics)
On one device (mesh=None) the two shardings are None.

Mixed precision (f32 master parameters and Adam moments, compute in
`compute_dtype`), gradient accumulation over microbatches, optional bf16
gradient compression, and remat of every layer (`loss_fn(train=True)`).

On a mesh (a DeviceMesh, see `launch.mesh`) each rank holds its shard of
params, mu and nu, laid out by the reference's rules
(`distributed.sharding`), and the step counter whole. Every rank passes
the same global batch; a rank takes its rows over `dp_axes`, microbatch by
microbatch in the reference's layout. Each rank backpropagates its loss
divided by the mesh size, and the layers' gathers sum the gradients over
the mesh into each shard (see `distributed.sharding`), which gives each
shard of the gradient of the mean loss over the whole batch. AdamW runs
on the shards with the whole gradient's norm.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import sharding as SH
from ..distributed.compression import compress_bf16
from ..models import model as MDL
from ..models.layers.common import wide_dtype
from . import optimizer as OPT
from .tree import cast_tree, leaves, leaves_with_paths, tree_map, unflatten


def batch_to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors on `device`: integer fields
    (tokens, labels) as int64, floating ones in their own type. A field
    on the meta device (the dry-run's shapes) stays there."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        t = t if t.is_floating_point() else t.long()
        out[k] = t if t.is_meta else t.to(device)
    return out


def loss_and_grads(params, batch, cfg: ModelConfig, use_kernel="auto",
                   mesh=None, dp_axes=("data",)):
    """(loss, metrics, grads) of loss_fn(train=True) with respect to every
    leaf of `params`, each of which gets a gradient (none may go unused):
    the parameters are taken as fresh leaves of their own type, so the
    gradients come out in that type.

    On a mesh, `params` are this rank's shards and `batch` its rows: the
    grads are the shards of the gradient of the mean loss over the dp
    group's rows, and the loss and "ce_loss" that mean (the MoE metrics
    are means over the mesh already)."""
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = MDL.loss_fn(params, batch, cfg, train=True,
                                use_kernel=use_kernel, mesh=mesh,
                                dp_axes=dp_axes)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is None:
        grads = torch.autograd.grad(loss, leaves(params))
        return loss.detach(), metrics, unflatten(params, grads)
    grads = torch.autograd.grad(loss / SH.mesh_size(mesh), leaves(params))
    loss = _dp_mean(loss.detach(), mesh, dp_axes)
    metrics["ce_loss"] = loss
    return loss, metrics, unflatten(params, grads)


def _dp_mean(t, mesh, dp_axes):
    sizes = SH.axis_sizes(mesh)
    n = 1
    for a in dp_axes:
        n *= sizes[a]
    return SH.all_reduce(t, dp_axes, mesh) / n


def dp_rows(size: int, mesh, dp_axes, microbatches: int = 1,
            k: int = 0) -> slice:
    """This rank's rows of microbatch k of a global batch of `size` rows:
    microbatch k is rows [k B/mb, (k+1) B/mb), split over the dp ranks in
    the order of `dp_axes` (the first outermost), as the reference lays
    out (microbatch, dp-sharded batch)."""
    sizes = SH.axis_sizes(mesh)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    if size % (microbatches * dp):
        raise ValueError(f"a batch of {size} rows does not split into "
                         f"{microbatches} microbatches over {dp} dp ranks")
    per = size // (microbatches * dp)
    start = k * (size // microbatches) + SH.block_index(mesh,
                                                        tuple(dp_axes)) * per
    return slice(start, start + per)


def _check_shards(params, specs, mesh) -> None:
    """Every leaf of `params` has the shape of its block under `specs`
    (whole shapes from the spec's own leaf shapes)."""
    want = dict(leaves_with_paths(specs))
    for path, leaf in leaves_with_paths(params):
        full, spec = want[path]
        local = SH.local_shape(full, spec, mesh)
        if tuple(leaf.shape) != local:
            raise ValueError(f"make_train_step: the state's {path} is "
                             f"{tuple(leaf.shape)}, not this rank's block "
                             f"{local} of {full} under {spec}")


def make_train_step(cfg: ModelConfig, opt_cfg: OPT.OptConfig, mesh=None,
                    dp_axes=("data",), microbatches: int = 1,
                    compute_dtype=torch.bfloat16,
                    grad_compression: Optional[str] = None, device=None):
    """Returns (step_fn, state_shardings, batch_spec). step_fn(state, batch)
    casts the master parameters to `compute_dtype`, takes the gradients of
    loss_fn(train=True) (accumulated in f32 over `microbatches` slices of
    the batch's leading axis, then averaged, as the loss is), compresses
    them to bf16 when `grad_compression == "bf16"`, applies adamw_update in
    place and returns (state, metrics): the model's metrics and "loss",
    "lr", "grad_norm". The batch (numpy or tensors) goes to `device`
    (None: the card).

    mesh=None: one device; state_shardings and batch_spec are None. On a
    mesh (on `device`'s type: NCCL on the card, gloo on the CPU), the state
    holds this rank's shards, state_shardings(params) gives the specs of a
    state whose parameters have the shapes of `params` ({"params", "opt":
    {"step": (), "mu", "nu"}}; `sharding.shard_tree` takes a rank's blocks
    by them), batch_spec is (dp_axes, None), and the loss and metrics are
    those of the whole batch on every rank."""
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    if mesh is not None:
        return _mesh_train_step(cfg, opt_cfg, mesh, tuple(dp_axes),
                                microbatches, compute_dtype,
                                grad_compression, device)

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


def state_specs(params, mesh) -> dict:
    """The specs of a train state whose parameters have the shapes of
    `params` (tensors or meta tensors): the reference's rules, validated
    on `mesh`; mu and nu as the parameters, the step counter whole."""
    specs = SH.validate_specs(params, SH.param_specs(params), mesh)
    return {"params": specs, "opt": {"step": (), "mu": specs, "nu": specs}}


def _mesh_train_step(cfg, opt_cfg, mesh, dp_axes, microbatches,
                     compute_dtype, grad_compression, device):
    sizes = SH.axis_sizes(mesh)
    dev = resolve_device(device)
    if getattr(mesh, "device_type", None) != dev.type:
        raise ValueError(f"make_train_step: the mesh is on "
                         f"{getattr(mesh, 'device_type', None)}, the step on "
                         f"{dev}")
    if not set(dp_axes) <= set(sizes):
        raise ValueError(f"make_train_step: dp_axes {dp_axes} are not all "
                         f"axes of the mesh {tuple(sizes)}")
    specs = MDL.param_layout(cfg, mesh)
    full = MDL.init_params(cfg, device="meta")
    shapes = tree_map(lambda t, sp: (tuple(t.shape), sp), full, specs)

    def step(state, batch):
        batch = batch_to_device(batch, dev)
        params = state["params"]
        _check_shards(params, shapes, mesh)
        params_c = cast_tree(params, compute_dtype)
        size = next(iter(batch.values())).shape[0]
        grads, loss = None, 0.0
        for k in range(microbatches):
            rows = dp_rows(size, mesh, dp_axes, microbatches, k)
            mb = {key: v[rows] for key, v in batch.items()}
            mb_loss, metrics, g = loss_and_grads(params_c, mb, cfg,
                                                 mesh=mesh, dp_axes=dp_axes)
            if microbatches == 1:
                grads, loss = g, mb_loss
                break
            if grads is None:
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=wide_dtype(p.dtype), device=p.device),
                    params_c)
            for acc, gk in zip(leaves(grads), leaves(g)):
                acc.add_(gk)
            loss = loss + mb_loss
            del g
        if microbatches > 1:
            for acc in leaves(grads):
                acc.div_(microbatches)
            loss = loss / microbatches
        del params_c
        if grad_compression == "bf16":
            grads = compress_bf16(grads)
        gnorm = SH.global_norm(grads, specs, mesh)
        new_params, new_opt, opt_metrics = OPT.adamw_update(
            opt_cfg, params, grads, state["opt"], gnorm=gnorm)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    def state_shardings(params_shape):
        return state_specs(params_shape, mesh)

    return step, state_shardings, SH.batch_spec("train", dp_axes)


def init_state(cfg: ModelConfig, seed: int = 0, param_dtype=torch.float32,
               device=None) -> dict:
    """{"params": init_params(cfg, seed), "opt": init_opt_state(params)},
    on `device` (None: the card)."""
    params = MDL.init_params(cfg, seed=seed, dtype=param_dtype,
                             device=device)
    return {"params": params, "opt": OPT.init_opt_state(params)}


def init_state_shape(cfg: ModelConfig, param_dtype=torch.float32) -> dict:
    """The state's shapes and types on the meta device (nothing drawn or
    allocated): the reference's eval_shape of init_state."""
    return init_state(cfg, param_dtype=param_dtype, device="meta")
