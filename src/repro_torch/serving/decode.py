"""Serving: the prefill over a prompt, serve_step (one decode token for a
batch over the cache) and a batched greedy generation loop."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import model as MDL
from ..training.tree import cast_tree


def make_serve_step(cfg: ModelConfig, mesh=None, dp_axes=("data",),
                    compute_dtype=torch.bfloat16,
                    weight_stationary: bool = False):
    """Returns serve_step(params, batch, cache, cache_spec=None) ->
    (next_tokens, cache).

    batch is {"tokens": [B, 1]}, plus {"image_embeds"} for the vlm (every
    step, as the reference passes them). Every floating parameter is taken
    in the compute type, as the reference casts it; parameters that already
    have it are used as they are, so a caller that casts once (generate)
    pays nothing per step. An encoder-only config has no decode step:
    ValueError.

    mesh: None (one device), or a DeviceMesh ("data", "model", and "pod"
    on a multi-pod mesh). On a mesh, `params` are this rank's shards under
    `model.param_layout(cfg, mesh)`; each layer gathers its weights over
    "data" only and splits its matmuls over "model" as the weights are
    stored (the decode group of `model.forward`); `batch` is this rank's
    rows over `dp_axes`, or all rows when the batch does not divide them;
    `cache` holds this rank's block of each leaf under `cache_spec`, the
    tree `launch.specs.cache_specs(..., mesh, dp_axes, kv_shard)` gave
    for the whole cache (`sharding.shard_tree` takes the blocks), and
    comes back updated in place, laid out the same way. The next tokens
    are this rank's rows'. No rank holds a KV cache or a state whole, and
    no collective moves more than one token's activations but the
    token's logits (gathered over the vocabulary) and, with head_dim
    split, the partial q.k scores (see `model.forward`).

    weight_stationary: the params are shards under `model.param_layout(cfg,
    mesh, weight_stationary=True)`, with no "data" axis, so a step gathers
    no weight over "data" (the reference's dry-run serves with this
    layout; its `constrain_weights=False` keeps weights where the caller
    sharded them, and a torch tensor carries no layout to keep)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")

    def serve_step(params, batch, cache, cache_spec=None):
        params_c = cast_tree(params, compute_dtype)
        if mesh is None:
            logits, new_cache, _ = MDL.forward(params_c, batch, cfg,
                                               cache=cache)
        else:
            where = batch["tokens"].device.type
            if where != mesh.device_type:
                raise ValueError(f"serve_step: the mesh is on "
                                 f"{mesh.device_type}, the batch on {where}")
            logits, new_cache, _ = MDL.forward(
                params_c, batch, cfg, cache=cache, mesh=mesh,
                dp_axes=tuple(dp_axes), cache_spec=cache_spec,
                weight_stationary=weight_stationary)
        next_tokens = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return next_tokens, new_cache

    return serve_step


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, use_kernel: str = "auto",
            device=None, with_metrics: bool = False):
    """The prefill cell: a forward over the prompt with no cache. batch is
    the reference's forward batch: {"tokens": [B,S]} or, for a config that
    takes embeddings in (hubert), {"embeds": [B,S,d]}, plus
    {"image_embeds": [B,T,d]} for the vlm (without them: ValueError). It is
    also the encoder's forward entry, which has no decode. Returns (argmax
    of the last position [B], logits [B,S,V] f32), and the forward's
    metrics third when `with_metrics` (the MoE family's aux_loss, router_li
    and drop_frac; {} for the others). Parameters are used in their own
    type; `device=None` is the card."""
    dev = resolve_device(device)
    params = cast_tree(params, device=dev)
    inputs = {k: torch.as_tensor(batch[k], device=dev)
              for k in ("tokens", "embeds", "image_embeds") if k in batch}
    logits, _, metrics = MDL.forward(params, inputs, cfg,
                                     use_kernel=use_kernel)
    out = logits[:, -1].argmax(dim=-1), logits
    return (*out, metrics) if with_metrics else out


@torch.no_grad()
def generate(cfg: ModelConfig, params, prompt_tokens, max_new: int,
             cache_len: int, device=None, image_embeds=None):
    """Greedy generation in f32: token-by-token prefill then decode, over
    the same cache code as serve_step. The parameters are cast to f32 once
    here, not once per step. image_embeds [B,T,d]: the vlm's, passed to
    every step (without them: ValueError). An encoder-only config has no
    generate: ValueError. Returns tokens [B, max_new] int32."""
    step = make_serve_step(cfg, compute_dtype=torch.float32)
    if cfg.cross_attn_period and image_embeds is None:
        raise ValueError(f"{cfg.name}: generate needs image_embeds")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt_tokens, device=dev)
    b, s = prompt.shape
    params = cast_tree(params, torch.float32, dev)
    extra = ({} if image_embeds is None else {"image_embeds": torch.as_tensor(
        image_embeds, dtype=torch.float32, device=dev)})
    cache = MDL.init_cache(cfg, b, cache_len, dtype=torch.float32, device=dev)
    tok = None
    for t in range(s):
        tok, cache = step(params, {"tokens": prompt[:, t:t + 1], **extra},
                          cache)
    out = [tok]
    for _ in range(max_new - 1):
        tok, cache = step(params, {"tokens": out[-1][:, None], **extra},
                          cache)
        out.append(tok)
    return torch.stack(out, dim=1)
