"""The language model, for the families the port runs so far: `ssm`
(Zamba2), one hybrid of Mamba2 layers and one SHARED attention block.

    x = embed(tokens)
    for each group of `hybrid_attn_period` Mamba2 layers:
        x = mamba2(x) for each layer of the group   (no residual)
        x = shared_attention_block(x)                (the same parameters
                                                      every time; one KV
                                                      cache per group)
    x = mamba2(x) for each tail layer
    logits = unembed(final_norm(x))

Parameters and caches keep the reference's pytree layout: Mamba2 weights are
stacked on a leading layer axis (`layers` [groups * period, ...],
`tail_layers` [rem, ...]), and the reference's `lax.scan` over that axis is a
Python loop over views of it. Other families raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import attention as A
from .layers import mamba2 as M
from .layers import mlp as MLP
from .layers.common import (embed, init_embedding, init_linear, init_rmsnorm,
                            linear, rmsnorm, unembed)


def _require_hybrid_ssm(cfg: ModelConfig) -> None:
    if cfg.ssm is None or not cfg.hybrid_attn_period:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only the hybrid ssm family "
            f"(zamba2) is ported so far")


def _layer(tree, idx):
    """The layer `idx` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


def _write(tree, idx, new) -> None:
    """Copy a layer's new cache into the stacked cache, in place."""
    for k, v in tree.items():
        v[idx].copy_(new[k])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Dict[str, Any]:
    """Random parameters from a torch.Generator seeded with `seed`, drawn
    on `device` (None: the card)."""
    _require_hybrid_ssm(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    hd = cfg.resolved_head_dim
    p: Dict[str, Any] = {"final_norm": init_rmsnorm(gen, cfg.d_model, dtype)}
    if cfg.embed_inputs:
        p["embed"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        p["head"] = init_linear(gen, cfg.d_model, cfg.padded_vocab, False,
                                dtype)
    period = cfg.hybrid_attn_period
    groups, rem = divmod(cfg.n_layers, period)
    p["layers"] = M.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype,
                                stack=(groups * period,))
    if rem:
        p["tail_layers"] = M.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype,
                                         stack=(rem,))
    p["shared_attn"] = {
        "norm": init_rmsnorm(gen, cfg.d_model, dtype),
        "attn": A.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                                 hd, cfg.qkv_bias, dtype),
        "mlp_norm": init_rmsnorm(gen, cfg.d_model, dtype),
        "mlp": MLP.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }
    return p


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------
def _shared_attn_block(sp, x, cfg, cache=None, kv_chunk=1024):
    hd = cfg.resolved_head_dim
    h = rmsnorm(sp["norm"], x, cfg.rmsnorm_eps)
    y, new_cache = A.attention_block(
        sp["attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=hd,
        rope_theta=cfg.rope_theta, causal=True, kv_chunk=kv_chunk, cache=cache)
    x = x + y
    h = rmsnorm(sp["mlp_norm"], x, cfg.rmsnorm_eps)
    return x + MLP.mlp(sp["mlp"], h), new_cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(params, batch, cfg: ModelConfig, cache=None, kv_chunk: int = 1024,
            use_kernel: str = "auto"):
    """Returns (logits [B,S,V] f32, new_cache, metrics).

    batch: {"tokens": [B,S]} on the parameters' device. cache: None (prefill
    from the zero state) or init_cache()'s tree for decode, which is updated
    in place and returned. use_kernel applies to the SSD chunk kernel."""
    _require_hybrid_ssm(cfg)
    x = embed(params["embed"], batch["tokens"])
    x, new_cache = _zamba_forward(params, x, cfg, cache, kv_chunk, use_kernel)
    x = rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, cfg.final_softcap)
    else:
        logits = linear(params["head"], x).float()
    return logits, new_cache, {}


def _zamba_forward(params, x, cfg, cache, kv_chunk, use_kernel):
    period = cfg.hybrid_attn_period
    groups = params["layers"]["in_proj"]["w"].shape[0] // period
    sp = params["shared_attn"]
    for g in range(groups):
        for j in range(period):
            lc = None if cache is None else _layer(cache["mamba"], (g, j))
            x, nc = M.mamba2_block(_layer(params["layers"], g * period + j),
                                   x, cfg.ssm, lc, use_kernel)
            if cache is not None:
                _write(cache["mamba"], (g, j), nc)
        ac = None
        if cache is not None:
            kv = cache["shared_attn"]
            ac = {"k": kv["k"][g], "v": kv["v"][g], "len": kv["len"][g]}
        x, nac = _shared_attn_block(sp, x, cfg, ac, kv_chunk)
        if cache is not None:
            cache["shared_attn"]["len"][g] = nac["len"]
    if "tail_layers" in params:
        for j in range(params["tail_layers"]["in_proj"]["w"].shape[0]):
            lc = None if cache is None else _layer(cache["tail"], j)
            x, nc = M.mamba2_block(_layer(params["tail_layers"], j), x,
                                   cfg.ssm, lc, use_kernel)
            if cache is not None:
                _write(cache["tail"], j, nc)
    return x, cache


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Decode cache in the reference's layout: `mamba` {conv, ssm} stacked
    [groups, period, ...], `shared_attn` {k, v [groups, B, max_len, KVH, D],
    len: one int per group}, `tail` {conv, ssm} [rem, ...] or None."""
    _require_hybrid_ssm(cfg)
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    period = cfg.hybrid_attn_period
    groups, rem = divmod(cfg.n_layers, period)
    kv_shape = (groups, batch, max_len, cfg.kv_heads, hd)
    return {
        "mamba": M.init_mamba2_cache(batch, cfg.d_model, cfg.ssm, dtype, dev,
                                     stack=(groups, period)),
        "shared_attn": {"k": torch.zeros(kv_shape, dtype=dtype, device=dev),
                        "v": torch.zeros(kv_shape, dtype=dtype, device=dev),
                        "len": [0] * groups},
        "tail": (M.init_mamba2_cache(batch, cfg.d_model, cfg.ssm, dtype, dev,
                                     stack=(rem,)) if rem else None),
    }
