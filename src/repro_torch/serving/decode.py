"""Serving: the prefill over a prompt, serve_step (one decode token for a
batch over the cache) and a batched greedy generation loop."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import model as MDL


def cast_params(params, dtype=None, device=None):
    """Floating parameters in `dtype` on `device` (None keeps each). A
    tensor that already has both is returned as it is, not copied."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, device) for k, v in params.items()}
    if params.is_floating_point():
        return params.to(device=device, dtype=dtype)
    return params.to(device=device)


def make_serve_step(cfg: ModelConfig, compute_dtype=torch.bfloat16):
    """Returns serve_step(params, batch, cache) -> (next_tokens, cache).

    Every floating parameter is taken in the compute type, as the reference
    casts it; parameters that already have it are used as they are, so a
    caller that casts once (generate) pays nothing per step."""

    def serve_step(params, batch, cache):
        params_c = cast_params(params, compute_dtype)
        logits, new_cache, _ = MDL.forward(params_c, batch, cfg, cache=cache)
        next_tokens = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return next_tokens, new_cache

    return serve_step


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, use_kernel: str = "auto",
            device=None, with_metrics: bool = False):
    """The prefill cell: a forward over the prompt with no cache. Returns
    (argmax of the last position [B], logits [B,S,V] f32), and the
    forward's metrics third when `with_metrics` (the MoE family's aux_loss,
    router_li and drop_frac; {} for the others). Parameters are used in
    their own type; `device=None` is the card."""
    dev = resolve_device(device)
    params = cast_params(params, device=dev)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    logits, _, metrics = MDL.forward(params, {"tokens": tokens}, cfg,
                                     use_kernel=use_kernel)
    out = logits[:, -1].argmax(dim=-1), logits
    return (*out, metrics) if with_metrics else out


@torch.no_grad()
def generate(cfg: ModelConfig, params, prompt_tokens, max_new: int,
             cache_len: int, device=None):
    """Greedy generation in f32: token-by-token prefill then decode, over
    the same cache code as serve_step. The parameters are cast to f32 once
    here, not once per step. Returns tokens [B, max_new] int32."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt_tokens, device=dev)
    b, s = prompt.shape
    params = cast_params(params, torch.float32, dev)
    cache = MDL.init_cache(cfg, b, cache_len, dtype=torch.float32, device=dev)
    step = make_serve_step(cfg, compute_dtype=torch.float32)
    tok = None
    for t in range(s):
        tok, cache = step(params, {"tokens": prompt[:, t:t + 1]}, cache)
    out = [tok]
    for _ in range(max_new - 1):
        tok, cache = step(params, {"tokens": out[-1][:, None]}, cache)
        out.append(tok)
    return torch.stack(out, dim=1)
