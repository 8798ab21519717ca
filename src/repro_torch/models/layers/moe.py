"""Mixture-of-Experts with sort-based (reordered) dispatch, single device.

The token->expert routing matrix is a sparse matrix, and this layer applies
the paper's machinery to it, as the reference's does:
  * `sorted` dispatch — assignments are permuted by expert id (a stable
    argsort): the reordering. Each expert's tokens form one contiguous
    segment, and the expert products run on dense [capacity, d] blocks;
  * capacity clipping — every expert gets the same number of slots, the
    nnz-balanced schedule (paper Listing 5); assignments past it are
    dropped;
  * the load-imbalance metric LI = max_load / fair_load (paper §6.1) of the
    raw routing, returned with the drop fraction and the aux loss;
  * `onehot` dispatch — the unreordered baseline: ranks from a cumulative
    sum of one-hot rows over the same flattened order, so both dispatches
    give every assignment the same rank, hence the same drops and the same
    output up to the order of the combine's sums.

The reference writes this in jnp, not Pallas, so plain torch ops are its
port. Expert parallelism (`moe_layer(mesh=)`): experts sharded over
`ep_axis` (mesh "model"), each rank routing the tokens it holds (its
block of the sequence in the tensor-parallel forward), and the dispatch
buffer moved through one `all_to_all_single` each way; at one
expert-parallel rank the same body runs with no exchange.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...distributed import sharding as SH
from .common import init_linear, truncated_normal, wide_dtype


def init_moe(gen, d_model, cfg, dtype=torch.float32, stack=()):
    """cfg: MoEConfig. Expert weights stacked on a leading E axis (after
    any `stack` axes)."""
    e, dff = cfg.num_experts, cfg.d_ff_expert
    return {
        "router": init_linear(gen, d_model, e, False, dtype, stack=stack),
        "w_gate": truncated_normal(gen, (*stack, e, d_model, dff),
                                   1.0 / math.sqrt(d_model), dtype),
        "w_up": truncated_normal(gen, (*stack, e, d_model, dff),
                                 1.0 / math.sqrt(d_model), dtype),
        "w_down": truncated_normal(gen, (*stack, e, dff, d_model),
                                   1.0 / math.sqrt(dff), dtype),
    }


def route(params, x_flat, num_experts, top_k):
    """Returns (gates [n,k], experts [n,k], probs [n,E]); the router's
    logits are f32 whatever the parameters' type. The top k come from a
    stable descending sort, so a tie goes to the lower expert index, as
    jax.lax.top_k breaks it."""
    wide = wide_dtype(x_flat.dtype)
    logits = x_flat.to(wide) @ params["router"]["w"].to(wide)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts, probs


def _aux_loss(probs, experts, num_experts):
    """Switch-style load-balancing loss + the paper's LI metric."""
    f = F.one_hot(experts[:, 0], num_experts).to(probs.dtype).mean(0)
    p = probs.mean(0)
    aux = num_experts * torch.sum(f * p)
    # bincount by scatter_add_: the same counts, and shapes that do not
    # depend on the data (the dry-run runs this on meta tensors)
    ef = experts.reshape(-1)
    counts = torch.zeros(num_experts, dtype=ef.dtype, device=ef.device
                         ).scatter_add_(0, ef, torch.ones_like(ef)
                                        ).to(torch.float32)
    li = counts.max() / torch.clamp(counts.mean(), min=1e-9)  # paper §6.1
    return aux, li


def _expert_ffn(buf, w_gate, w_up, w_down):
    """buf [E, C, d] -> [E, C, d] (SwiGLU per expert)."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def capacity(n: int, moe_cfg) -> int:
    """Slots per expert for n tokens: the reference's rounding up to 8."""
    k, e = moe_cfg.top_k, moe_cfg.num_experts
    return int(math.ceil(n * k * moe_cfg.capacity_factor / e / 8)) * 8


def _moe_body(params, x, moe_cfg, exchange=None):
    """x: [b, s, d] local tokens. Returns (y [b, s, d], metrics). exchange:
    None, or the (dispatch, combine) pair that moves the [E, C, d] slot
    buffer to the ranks holding its experts and back."""
    b, s, d = x.shape
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    n = b * s
    dev = x.device
    x_flat = x.reshape(n, d)
    gates, experts, probs = route(params, x_flat, e, k)
    aux, li = _aux_loss(probs, experts, e)
    cap = capacity(n, moe_cfg)

    ef = experts.reshape(-1)                       # [n*k]
    tok = torch.arange(n, device=dev).repeat_interleave(k)
    gf = gates.reshape(-1)
    pos = torch.arange(n * k, device=dev)
    if moe_cfg.dispatch == "sorted":
        # the reordering permutation; stable, so within an expert's segment
        # the flattened order decides which assignments pass the capacity
        order = torch.argsort(ef, stable=True)
        ef_s, tok_s, gf_s = ef[order], tok[order], gf[order]
        seg_start = torch.searchsorted(ef_s, ef_s, side="left")
        rank = pos - seg_start
    elif moe_cfg.dispatch == "onehot":
        onehot_full = F.one_hot(ef, e)
        rank = (torch.cumsum(onehot_full, dim=0) - 1)[pos, ef]
        ef_s, tok_s, gf_s = ef, tok, gf
    else:
        raise ValueError(f"unknown MoE dispatch {moe_cfg.dispatch!r}")
    keep = rank < cap
    # a dropped assignment goes to one scratch row past the experts' slots
    # (the only index written more than once)
    slot = torch.where(keep, ef_s * cap + rank,
                       torch.full_like(rank, e * cap))
    buf = x.new_zeros((e * cap + 1, d))
    buf[slot] = x_flat[tok_s]
    buf = buf[:-1].reshape(e, cap, d)

    if exchange is not None:
        buf = exchange[0](buf)             # [E/M, M*C, d]
    y_buf = _expert_ffn(buf, params["w_gate"], params["w_up"],
                        params["w_down"])
    if exchange is not None:
        y_buf = exchange[1](y_buf)         # [E, C, d]

    # combine: gather each assignment's slot output, weight, sum over k
    y_flat = torch.cat([y_buf.reshape(e * cap, d), y_buf.new_zeros((1, d))])
    contrib = y_flat[slot] * (gf_s * keep)[:, None]
    y = x.new_zeros((n, d)).index_add_(0, tok_s, contrib.to(x.dtype))

    drop_frac = 1.0 - keep.to(torch.float32).mean()
    metrics = {"aux_loss": aux, "router_li": li, "drop_frac": drop_frac}
    return y.reshape(b, s, d), metrics


class _AllToAll(torch.autograd.Function):
    """The slot buffer between token ranks and expert ranks over one mesh
    axis of M ranks: dispatch [E, C, d] -> [E/M, M*C, d] (rank m keeps its
    experts' slots from every rank, rank k's at [:, k*C:(k+1)*C]), combine
    the inverse. Each is the other's transpose."""

    @staticmethod
    def forward(ctx, buf, mesh, axis, dispatch):
        ctx.mesh, ctx.axis, ctx.dispatch = mesh, axis, dispatch
        return _exchange(buf, mesh, axis, dispatch)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, ctx.mesh, ctx.axis, not ctx.dispatch), None,
                None, None)


def _exchange(buf, mesh, axis, dispatch):
    m = SH.axis_sizes(mesh)[axis]
    group = mesh.get_group(axis)
    if dispatch:
        e, c, d = buf.shape
        src = buf.contiguous()                       # [M, E/M, C, d]
        out = torch.empty_like(src)
        torch.distributed.all_to_all_single(out, src, group=group)
        return out.reshape(m, e // m, c, d).transpose(0, 1).reshape(
            e // m, m * c, d)
    el, mc, d = buf.shape
    src = buf.reshape(el, m, mc // m, d).transpose(0, 1).contiguous()
    out = torch.empty_like(src)
    torch.distributed.all_to_all_single(out, src, group=group)
    return out.reshape(m * el, mc // m, d)


def _expert_shapes(moe_cfg, d_model: int) -> dict:
    e, dff = moe_cfg.num_experts, moe_cfg.d_ff_expert
    return {"w_gate": (e, d_model, dff), "w_up": (e, d_model, dff),
            "w_down": (e, dff, d_model)}


def expert_specs(moe_cfg, d_model: int, mesh, ep_axis: str = "model",
                 weight_stationary: bool = False):
    """The specs of the expert weights on `mesh`: experts over `ep_axis`,
    and under sharding.MOE_FSDP d_model over "data" (not when
    weight_stationary), validated against the whole shapes as the state's
    layout is."""
    fsdp = ("data" if SH.MOE_FSDP and not weight_stationary
            and "data" in SH.axis_sizes(mesh) else None)
    specs = {"w_gate": (ep_axis, fsdp, None), "w_up": (ep_axis, fsdp, None),
             "w_down": (ep_axis, None, fsdp)}
    return {k: SH.validate_spec(shape, specs[k], mesh)
            for k, shape in _expert_shapes(moe_cfg, d_model).items()}


def moe_layer(params, x, moe_cfg, mesh=None, ep_axis="model",
              dp_axes=("data",), weight_stationary=False):
    """x: [B, S, d]. Returns (y, metrics {aux_loss, router_li, drop_frac}).

    With a mesh (a DeviceMesh): x is the tokens this rank routes (in the
    tensor-parallel forward its block of the sequence of its rows; in
    decode its rows, the same on every rank of its dp group) and `params`
    this rank's shards, the router whole and each expert weight by
    `expert_specs`. Capacity is reckoned from the rank's tokens, the expert
    weights gathered over "data", and the slot buffer exchanged over
    `ep_axis` in one all_to_all each way; y holds the rank's tokens. The
    metrics are the means of the per-rank ones over `ep_axis` and
    `dp_axes`. The weights' gradients come back summed over the mesh, as
    sharding.gather gives them. weight_stationary: the expert weights
    are laid out with no "data" axis (`model.param_layout`'s)."""
    if mesh is None:
        return _moe_body(params, x, moe_cfg)
    sizes = SH.axis_sizes(mesh)
    ep = sizes[ep_axis]
    if moe_cfg.num_experts % ep:
        raise ValueError(f"moe_layer: {moe_cfg.num_experts} experts do not "
                         f"split over {ep} {ep_axis!r} ranks")
    d = x.shape[-1]
    specs = expert_specs(moe_cfg, d, mesh, ep_axis, weight_stationary)
    # experts stay on their ep rank; as in the reference, a "data" axis of
    # one rank gathers nothing
    keep = (ep_axis,) if sizes.get("data", 1) > 1 else (ep_axis, "data")
    weights = {"router": {"w": SH.gather(params["router"]["w"], (), mesh)}}
    for k, whole in _expert_shapes(moe_cfg, d).items():
        spec = specs[k]
        if tuple(params[k].shape) != SH.local_shape(whole, spec, mesh):
            raise ValueError(f"moe_layer: {k} shard {tuple(params[k].shape)}"
                             f" is not this rank's block of {whole} under "
                             f"{spec}")
        weights[k] = SH.gather(params[k], spec, mesh, keep=keep)
    exchange = None
    if ep > 1:
        exchange = (lambda t: _AllToAll.apply(t, mesh, ep_axis, True),
                    lambda t: _AllToAll.apply(t, mesh, ep_axis, False))
    y, metrics = _moe_body(weights, x, moe_cfg, exchange)
    axes = (ep_axis, *(a for a in dp_axes if a != ep_axis))
    return y, {k: SH.mesh_mean(v, mesh, axes) for k, v in metrics.items()}
