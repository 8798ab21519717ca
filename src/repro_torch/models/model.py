"""The language model, for the families the port runs: dense, gemma2's
local/global pairs, MoE, and the Zamba2 hybrid (`ssm` with a shared
attention block).

    x = embed(tokens)                     (x sqrt(d_model) for gemma)
    dense:  x = layer(x) for each of L (attention + SwiGLU) layers
    gemma2: x = global(local(x)) for each of L/2 pairs (the local layer
            windowed, post-block norms, attention and final softcaps)
    moe:    x = layer(x) for each of L (attention + MoE) layers; the
            layers' aux_loss, router_li and drop_frac averaged as metrics
    zamba2: for each group of `hybrid_attn_period` Mamba2 layers:
                x = mamba2(x) for each layer of the group (no residual)
                x = shared_attention_block(x)   (the same parameters every
                                                 time; one KV cache a group)
            x = mamba2(x) for each tail layer
    logits = unembed(final_norm(x))

Parameters and caches keep the reference's pytree layout: a family's layer
weights are stacked on a leading layer axis (`layers` [L, ...]; gemma2's
`layers.{local,global}` [L/2, ...]; Zamba2's `layers` [groups * period,
...] and `tail_layers` [rem, ...]), and the reference's `lax.scan` over
that axis is a Python loop over views of it. The rwkv6, vlm and audio
families raise NotImplementedError.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import attention as A
from .layers import mamba2 as M
from .layers import mlp as MLP
from .layers import moe as MOE
from .layers.common import (embed, init_embedding, init_linear, init_rmsnorm,
                            linear, rmsnorm, unembed, wide_dtype)

PORTED = "dense, gemma2 (local/global), moe and the zamba2 hybrid"


def _family(cfg: ModelConfig) -> str:
    """The family the forward runs for `cfg`: "dense", "gemma2", "moe" or
    "hybrid"; NotImplementedError for a family the port does not run."""
    unported = None
    if cfg.rwkv is not None:
        unported = "rwkv6"
    elif cfg.cross_attn_period:
        unported = "vlm"
    elif cfg.encoder_only or not cfg.embed_inputs:
        unported = "audio"
    elif cfg.ssm is not None and not cfg.hybrid_attn_period:
        unported = "pure ssm"
    if unported:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the {unported} family is not ported "
            f"yet; the port runs {PORTED}")
    if cfg.ssm is not None:
        return "hybrid"
    if cfg.moe is not None:
        return "moe"
    return "gemma2" if cfg.local_global_period else "dense"


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
    family = _family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Dict[str, Any] = {"final_norm": init_rmsnorm(gen, cfg.d_model, dtype)}
    if cfg.embed_inputs:
        p["embed"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        p["head"] = init_linear(gen, cfg.d_model, cfg.padded_vocab, False,
                                dtype)
    if family == "moe":
        p["layers"] = _init_moe_layer(gen, cfg, dtype, (cfg.n_layers,))
        return p
    if family == "gemma2":
        pairs = (cfg.n_layers // 2,)
        p["layers"] = {"local": _init_dense_layer(gen, cfg, dtype, pairs),
                       "global": _init_dense_layer(gen, cfg, dtype, pairs)}
        return p
    if family == "dense":
        p["layers"] = _init_dense_layer(gen, cfg, dtype, (cfg.n_layers,))
        return p
    period = cfg.hybrid_attn_period
    groups, rem = divmod(cfg.n_layers, period)
    p["layers"] = M.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype,
                                stack=(groups * period,))
    if rem:
        p["tail_layers"] = M.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype,
                                         stack=(rem,))
    p["shared_attn"] = {
        "norm": init_rmsnorm(gen, cfg.d_model, dtype),
        "attn": _init_attn(gen, cfg, dtype, ()),
        "mlp_norm": init_rmsnorm(gen, cfg.d_model, dtype),
        "mlp": MLP.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }
    return p


def _init_attn(gen, cfg, dtype, stack):
    return A.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                            cfg.resolved_head_dim, cfg.qkv_bias, dtype,
                            stack=stack)


def _init_dense_layer(gen, cfg, dtype, stack):
    d = {
        "attn_norm": init_rmsnorm(gen, cfg.d_model, dtype, stack=stack),
        "attn": _init_attn(gen, cfg, dtype, stack),
        "mlp_norm": init_rmsnorm(gen, cfg.d_model, dtype, stack=stack),
        "mlp": MLP.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, stack=stack),
    }
    if cfg.post_block_norm:
        d["attn_post_norm"] = init_rmsnorm(gen, cfg.d_model, dtype,
                                           stack=stack)
        d["mlp_post_norm"] = init_rmsnorm(gen, cfg.d_model, dtype,
                                          stack=stack)
    return d


def _init_moe_layer(gen, cfg, dtype, stack):
    return {
        "attn_norm": init_rmsnorm(gen, cfg.d_model, dtype, stack=stack),
        "attn": _init_attn(gen, cfg, dtype, stack),
        "mlp_norm": init_rmsnorm(gen, cfg.d_model, dtype, stack=stack),
        "moe": MOE.init_moe(gen, cfg.d_model, cfg.moe, dtype, stack=stack),
    }


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------
def _attention(lp, h, cfg, *, window=None, softcap=None, cache=None,
               kv_chunk=1024):
    return A.attention_block(
        lp["attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=not cfg.encoder_only, window=window, softcap=softcap,
        kv_chunk=kv_chunk, cache=cache)


def _dense_layer(lp, x, cfg, *, window, cache=None, kv_chunk=1024):
    h = rmsnorm(lp["attn_norm"], x, cfg.rmsnorm_eps)
    y, new_cache = _attention(lp, h, cfg, window=window,
                              softcap=cfg.attn_softcap, cache=cache,
                              kv_chunk=kv_chunk)
    if "attn_post_norm" in lp:
        y = rmsnorm(lp["attn_post_norm"], y, cfg.rmsnorm_eps)
    x = x + y
    h = rmsnorm(lp["mlp_norm"], x, cfg.rmsnorm_eps)
    y = MLP.mlp(lp["mlp"], h)
    if "mlp_post_norm" in lp:
        y = rmsnorm(lp["mlp_post_norm"], y, cfg.rmsnorm_eps)
    return x + y, new_cache


def _moe_dense_layer(lp, x, cfg, *, cache=None, kv_chunk=1024):
    h = rmsnorm(lp["attn_norm"], x, cfg.rmsnorm_eps)
    y, new_cache = _attention(lp, h, cfg, cache=cache, kv_chunk=kv_chunk)
    x = x + y
    h = rmsnorm(lp["mlp_norm"], x, cfg.rmsnorm_eps)
    y, moe_metrics = MOE.moe_layer(lp["moe"], h, cfg.moe)
    return x + y, new_cache, moe_metrics


def _shared_attn_block(sp, x, cfg, cache=None, kv_chunk=1024):
    h = rmsnorm(sp["norm"], x, cfg.rmsnorm_eps)
    y, new_cache = _attention(sp, h, cfg, cache=cache, kv_chunk=kv_chunk)
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
    in place and returned. metrics: the MoE family's aux_loss, router_li
    and drop_frac averaged over layers, else {}. use_kernel applies to the
    SSD chunk kernel."""
    family = _family(cfg)
    x = embed(params["embed"], batch["tokens"])
    if cfg.name.startswith("gemma"):
        x = x * math.sqrt(cfg.d_model)
    metrics: Dict[str, torch.Tensor] = {}
    if family == "hybrid":
        x, cache = _zamba_forward(params, x, cfg, cache, kv_chunk,
                                  use_kernel)
    elif family == "moe":
        x, metrics = _moe_forward(params, x, cfg, cache, kv_chunk)
    elif family == "gemma2":
        x = _pair_forward(params, x, cfg, cache, kv_chunk)
    else:
        x = _dense_forward(params, x, cfg, cache, kv_chunk)
    x = rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, cfg.final_softcap)
    else:
        logits = linear(params["head"], x).to(wide_dtype(x.dtype))
    return logits, cache, metrics


def _kv_layer(kv, i):
    """Layer i of a stacked KV cache: views of its buffers and its length."""
    return {"k": kv["k"][i], "v": kv["v"][i], "len": kv["len"][i]}


def _depth(stack) -> int:
    return stack["attn_norm"]["scale"].shape[0]


def _dense_forward(params, x, cfg, cache, kv_chunk):
    for i in range(_depth(params["layers"])):
        lc = None if cache is None else _kv_layer(cache, i)
        x, nc = _dense_layer(_layer(params["layers"], i), x, cfg,
                             window=None, cache=lc, kv_chunk=kv_chunk)
        if cache is not None:
            cache["len"][i] = nc["len"]
    return x


def _pair_forward(params, x, cfg, cache, kv_chunk):
    """gemma2: each pair is a local layer (windowed) then a global one."""
    pairs = params["layers"]
    for i in range(_depth(pairs["local"])):
        for part, window in (("local", cfg.sliding_window),
                             ("global", None)):
            lc = None if cache is None else _kv_layer(cache[part], i)
            x, nc = _dense_layer(_layer(pairs[part], i), x, cfg,
                                 window=window, cache=lc, kv_chunk=kv_chunk)
            if cache is not None:
                cache[part]["len"][i] = nc["len"]
    return x


def _moe_forward(params, x, cfg, cache, kv_chunk):
    acc = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in ("aux_loss", "router_li", "drop_frac")}
    for i in range(_depth(params["layers"])):
        lc = None if cache is None else _kv_layer(cache, i)
        x, nc, mm = _moe_dense_layer(_layer(params["layers"], i), x, cfg,
                                     cache=lc, kv_chunk=kv_chunk)
        if cache is not None:
            cache["len"][i] = nc["len"]
        acc = {k: acc[k] + mm[k] for k in acc}
    return x, {k: v / cfg.n_layers for k, v in acc.items()}


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
        ac = None if cache is None else _kv_layer(cache["shared_attn"], g)
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
    """Decode cache in the reference's layout. A KV cache of n layers is
    {k, v [n, B, max_len, KVH, D], len: one int per layer}: dense and moe
    hold one of L layers, gemma2 {local, global} of L/2 each; Zamba2 holds
    `mamba` {conv, ssm} stacked [groups, period, ...], `shared_attn` (one
    KV layer per group) and `tail` {conv, ssm} [rem, ...] or None."""
    family = _family(cfg)
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim

    def kv(n):
        shape = (n, batch, max_len, cfg.kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "len": [0] * n}

    if family == "gemma2":
        return {"local": kv(cfg.n_layers // 2),
                "global": kv(cfg.n_layers // 2)}
    if family != "hybrid":
        return kv(cfg.n_layers)
    period = cfg.hybrid_attn_period
    groups, rem = divmod(cfg.n_layers, period)
    return {
        "mamba": M.init_mamba2_cache(batch, cfg.d_model, cfg.ssm, dtype, dev,
                                     stack=(groups, period)),
        "shared_attn": kv(groups),
        "tail": (M.init_mamba2_cache(batch, cfg.d_model, cfg.ssm, dtype, dev,
                                     stack=(rem,)) if rem else None),
    }
