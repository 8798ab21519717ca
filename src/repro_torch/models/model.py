"""The language model, for the reference's ten architectures: dense,
gemma2's local/global pairs, MoE, the Zamba2 hybrid (`ssm` with a shared
attention block), rwkv6, the vlm and the audio encoder.

    x = embed(tokens)                     (x sqrt(d_model) for gemma), or
        batch["embeds"] when the config takes embeddings in (audio)
    dense:  x = layer(x) for each of L (attention + SwiGLU) layers
    audio:  the dense body, bidirectional (encoder_only), frame
            embeddings in and an untied head out
    gemma2: x = global(local(x)) for each of L/2 pairs (the local layer
            windowed, post-block norms, attention and final softcaps)
    moe:    x = layer(x) for each of L (attention + MoE) layers; the
            layers' aux_loss, router_li and drop_frac averaged as metrics
    zamba2: for each group of `hybrid_attn_period` Mamba2 layers:
                x = mamba2(x) for each layer of the group (no residual)
                x = shared_attention_block(x)   (the same parameters every
                                                 time; one KV cache a group)
            x = mamba2(x) for each tail layer
    rwkv6:  x = x + time_mix(x); x = x + channel_mix(x) for each of L layers
    vlm:    for each group of `cross_attn_period` layers: period - 1 dense
            layers, then one cross layer over batch["image_embeds"] whose
            attention output is scaled by tanh(gate)
    logits = unembed(final_norm(x)), or the untied head's

Training: `forward(train=True)` runs each of the reference's remat units
inside a checkpoint (recomputed in backward), and `loss_fn` is the
cross-entropy of the next token (an encoder's labels) over the padded
vocabulary, plus MoE's weighted aux loss.

Parameters and caches keep the reference's pytree layout: a family's layer
weights are stacked on a leading layer axis (`layers` [L, ...]; gemma2's
`layers.{local,global}` [L/2, ...]; Zamba2's `layers` [groups * period,
...] and `tail_layers` [rem, ...]; the vlm's `layers` [groups * (period -
1), ...] and `cross_layers` [groups, ...]), and the reference's `lax.scan`
over that axis is a Python loop over views of it.

On a mesh (`forward(mesh=)`, a DeviceMesh with "data" and "model" axes,
"pod" too on a multi-pod mesh) the parameters are this rank's shards, laid
out by `param_layout` (the reference's sharding rules), and the batch is
this rank's rows. Train and prefill are tensor-parallel over "model", as
the reference's SPMD program is: each layer gathers its weights over the
other axes inside its remat unit and keeps its "model" block
(`_tp_keep`); the residual stream holds each rank's block of the sequence
[B, S/M, d] (the reference's `make_hint`), gathered before a layer's
attention or MLP and reduce-scattered after its row-parallel output. An
attention splits its heads where both head counts divide by M, else its
sequence (`attention.heads_split`); an MLP splits d_ff, a Mamba2 or rwkv6
layer its heads, MoE its experts (`moe.moe_layer(mesh=)` on the rank's
block of the sequence); the embedding, the logits and the
cross-entropy split the vocabulary. `forward` returns the whole logits
(gathered over "model"); `loss_fn` never gathers them. The sequence and
the padded vocabulary must divide by M (ValueError). On a "model" axis of
one rank nothing splits and the layers run their plain bodies.
Decode on a mesh (`forward(mesh=, cache=, cache_spec=)`) takes each cache
leaf as this rank's block under `launch.specs.cache_specs` and is
tensor-parallel over "model" too, in a group of its own
(`sharding.TensorParallel(whole=True)`): the one token's residual stream
is whole on every rank, each weight stays split over "model" as
`param_layout` stores it, a column-parallel projection computes the
rank's column block and a row-parallel one takes its slice of the input,
whose partial output is summed over "model" (not reduce-scattered). The
attention gathers the token's q, k and v (the rank's cache block holds
all heads of its positions or of its head_dim slice) and combines its
blocks by their log-sum-exp (`attention.decode_attention(split=)`); the
Mamba2 and rwkv6 recurrences run on the rank's heads
(`mamba2._decode_step`, `rwkv6.rwkv6_decode`); the embedding looks up in
the rank's rows of the table, and the logits of the token are gathered
over the vocabulary. MoE routes the rank's rows on every "model" rank, as
the reference's decode does, and the vlm's cross-attention (no cache)
splits its heads where they divide, else keeps its weights whole. No
collective moves more than one token's activations but the logits and,
with head_dim split, the partial q.k scores. Where a weight the decode
group splits does not divide over "model", ValueError names it.
"""
from __future__ import annotations

import functools
import math
import re
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import sharding as SH
from ..training.tree import leaves_with_paths, tree_map
from .layers import attention as A
from .layers import mamba2 as M
from .layers import mlp as MLP
from .layers import moe as MOE
from .layers import rwkv6 as R
from .layers.common import (embed, generator, init_embedding, init_linear,
                            init_rmsnorm, linear, rmsnorm,
                            softmax_cross_entropy, unembed, wide_dtype)


def _family(cfg: ModelConfig) -> str:
    """The family the forward runs for `cfg`: "rwkv6", "hybrid", "vlm",
    "moe", "gemma2", "audio" or "dense". A pure SSM config (`ssm` without
    `hybrid_attn_period`) raises NotImplementedError: the reference cannot
    run it either (its `_zamba_forward` divides by the zero period)."""
    if cfg.rwkv is not None:
        return "rwkv6"
    if cfg.ssm is not None:
        if not cfg.hybrid_attn_period:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): a pure SSM config (ssm without "
                f"hybrid_attn_period) has no forward, in the reference as "
                f"here")
        return "hybrid"
    if cfg.cross_attn_period:
        return "vlm"
    if cfg.moe is not None:
        return "moe"
    if cfg.local_global_period:
        return "gemma2"
    if cfg.encoder_only or not cfg.embed_inputs:
        return "audio"
    return "dense"


def _layer(tree, idx):
    """The layer `idx` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


_STACKED = ("layers", "cross_layers", "tail_layers")  # [L, ...] leaves


def _unstack(tree):
    """A stacked parameter tree with each leaf unbound into a tuple of its
    layers (views), which `_layer` indexes as it indexes the stack. Under
    autograd one unbind's backward stacks the layers' gradients once,
    where indexing the stack per layer adds a zero tensor the size of the
    whole leaf into its gradient at every layer."""
    if isinstance(tree, dict):
        return {k: _unstack(v) for k, v in tree.items()}
    return torch.unbind(tree)


class _LayerGather:
    """A stacked leaf's layers (the views `_unstack` gives) on a mesh:
    indexing one gathers that layer's shard, but over the axes in `keep`,
    where the layer's remat unit indexes it (recomputed in backward)."""

    def __init__(self, views, spec, mesh, keep=()):
        self.views, self.spec, self.mesh, self.keep = views, spec, mesh, keep

    def __len__(self):
        return len(self.views)

    def __getitem__(self, idx):
        return SH.gather(self.views[idx], self.spec, self.mesh,
                         keep=self.keep)


def _layer_gathers(tree, specs, mesh, keep, path):
    """`_unstack` of the stacked tree at `path` whose layers gather as they
    are indexed (keep(path) of each leaf's path stays split); an MoE subtree
    stays as its shards (`moe_layer` gathers it)."""
    if isinstance(tree, dict):
        return {k: _unstack(v) if k == "moe" else
                _layer_gathers(v, specs[k], mesh, keep, f"{path}/{k}")
                for k, v in tree.items()}
    return _LayerGather(torch.unbind(tree), specs[1:], mesh, keep(path))


def param_layout(cfg: ModelConfig, mesh,
                 weight_stationary: bool = False) -> dict:
    """The specs of cfg's parameters on `mesh`: the reference's rules,
    validated against the whole shapes (shape-only, nothing drawn).
    weight_stationary: "data" dropped from every spec, as the reference's
    dry-run lays out serving weights (model axis only, no FSDP)."""
    return _layout(cfg, tuple(SH.axis_sizes(mesh).items()), SH.MOE_FSDP,
                   weight_stationary)


@functools.lru_cache(maxsize=16)
def _layout(cfg: ModelConfig, sizes: tuple, moe_fsdp: bool,
            weight_stationary: bool) -> dict:
    # moe_fsdp keys the cache only: param_specs reads sharding.MOE_FSDP
    shapes = init_params(cfg, device="meta")
    specs = SH.param_specs(shapes)
    if weight_stationary:
        specs = tree_map(lambda sp: tuple(None if a == "data" else a
                                          for a in sp), specs)
    return SH.validate_specs(shapes, specs, dict(sizes))


def _mesh_params(params, cfg, mesh, weight_stationary=False, tp=None):
    """forward's view of this rank's parameter shards: the leaves outside
    the layer stacks gathered; the stacks' layers gathered as each layer
    indexes them; MoE subtrees as shards. Without `tp` (a "model" axis of
    one rank) every leaf is gathered whole; with it a leaf stays split
    over "model" where its layer computes with the rank's block
    (`_tp_keep`)."""
    specs = param_layout(cfg, mesh, weight_stationary)
    keep = (lambda path: ()) if tp is None else _tp_keep(cfg, tp)
    return {k: _layer_gathers(v, specs[k], mesh, keep, k) if k in _STACKED
            else SH.gather_tree(v, specs[k], mesh, keep, k)
            for k, v in params.items()}


def _tp_keep(cfg: ModelConfig, tp):
    """keep(path) of `_mesh_params` under tensor parallelism: ("model",)
    for a leaf whose layer computes with this rank's block of it (heads,
    d_ff, vocabulary, SSM or rwkv6 heads), () for one the layer reads
    whole: an attention's where its heads do not split (it splits its
    sequence), an MLP's where d_ff does not divide (it runs on the rank's
    rows), and Mamba2's packed in_proj and conv (the rank takes its heads'
    columns of them). A leaf whose spec does not name "model" is whole
    either way. In decode (`tp.whole`) every leaf stays split as stored
    but a cross-attention's whose heads do not split."""
    by_heads = A.heads_split(tp, cfg.n_heads, cfg.kv_heads)
    by_ffn = tp.divides(cfg.d_ff)

    def keep(path: str) -> tuple:
        if tp.whole:
            split = by_heads or not re.search(r"cross_attn/", path)
        elif re.search(r"attn/w[qkvo]/", path):
            split = by_heads
        elif re.search(r"mlp/w_", path):
            split = by_ffn
        else:
            split = not re.search(r"in_proj/|conv_[wb]", path)
        return (tp.axis,) if split else ()
    return keep


def _tensor_parallel(cfg: ModelConfig, mesh, dp_axes, seq_len: int,
                     weight_stationary: bool, decode: bool):
    """The tensor-parallel group of a forward on `mesh`: None off a mesh
    or where "model" holds one rank; in decode a group whose stream is
    whole. ValueError where the step cannot split: a train or prefill
    sequence, a padded vocabulary or rwkv6's d_ff that does not divide
    into the group's blocks; in decode a weight that the group reads by
    blocks and `param_layout` stores whole over "model"
    (`_unsplit`)."""
    tp = SH.tensor_parallel(mesh, dp_axes, whole=decode)
    if tp is None:
        return None
    sizes = [("the padded vocabulary", cfg.padded_vocab)]
    if not decode:
        sizes.append(("the sequence", seq_len))
    if cfg.rwkv is not None:
        sizes.append(("rwkv6's d_ff", cfg.d_ff))
    for what, n in sizes:
        if not tp.divides(n):
            raise ValueError(f"forward: {what} ({n}) does not split over "
                             f"{tp.size} {tp.axis!r} ranks")
    if decode:
        keep = _tp_keep(cfg, tp)
        for path, dims in _unsplit(cfg, tuple(SH.axis_sizes(mesh).items()),
                                   weight_stationary):
            if keep(path):
                raise ValueError(f"forward: decode splits {path} {dims} "
                                 f"over 'model', which does not divide it "
                                 f"into {tp.size} blocks")
    return tp


@functools.lru_cache(maxsize=16)
def _unsplit(cfg: ModelConfig, sizes: tuple, weight_stationary: bool):
    """(path, shape) of each parameter outside the MoE experts whose rule
    splits a dim over "model" that `param_layout` keeps whole, as it does
    a dim that does not divide."""
    shapes = init_params(cfg, device="meta")
    want = dict(leaves_with_paths(SH.param_specs(shapes)))
    got = dict(leaves_with_paths(_layout(cfg, sizes, SH.MOE_FSDP,
                                         weight_stationary)))
    return tuple((SH.path_str(p), tuple(t.shape))
                 for p, t in leaves_with_paths(shapes)
                 if "moe" not in p and
                 any("model" in SH.entry_axes(e) for e in want[p])
                 and not any("model" in SH.entry_axes(e) for e in got[p]))


def _subspec(spec, path):
    for key in path:
        spec = spec[key]
    return spec


def _kv_split(mesh, spec, *path):
    """The KVSplit of the KV cache stack at `path` of a cache laid out by
    `spec`, or None off a mesh or without a cache. Only axes of more than
    one rank split a dim: on a (1, 1) mesh every block is whole and the
    decode step does the plain step's arithmetic."""
    if mesh is None or spec is None:
        return None
    k = _subspec(spec, path)["k"]
    return A.KVSplit(mesh, SH.split_axes(k[-3], mesh),
                     SH.split_axes(k[-1], mesh))


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
    on `device` (None: the card). On the "meta" device nothing is drawn:
    the tree holds the shapes and types only."""
    family = _family(cfg)
    dev = resolve_device(device)
    gen = generator(dev, seed)
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
    if family in ("dense", "audio"):
        p["layers"] = _init_dense_layer(gen, cfg, dtype, (cfg.n_layers,))
        return p
    if family == "rwkv6":
        p["layers"] = R.init_rwkv6(gen, cfg.d_model, cfg.rwkv, cfg.d_ff,
                                   dtype, stack=(cfg.n_layers,))
        return p
    if family == "vlm":
        groups = cfg.n_layers // cfg.cross_attn_period
        p["layers"] = _init_dense_layer(
            gen, cfg, dtype, (groups * (cfg.cross_attn_period - 1),))
        p["cross_layers"] = _init_cross_layer(gen, cfg, dtype, (groups,))
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


def _init_cross_layer(gen, cfg, dtype, stack):
    """The vlm's gated cross-attention layer; its gate starts at zero, so
    at init the layer is its MLP alone."""
    return {
        "attn_norm": init_rmsnorm(gen, cfg.d_model, dtype, stack=stack),
        "cross_attn": A.init_attention(gen, cfg.d_model, cfg.n_heads,
                                       cfg.kv_heads, cfg.resolved_head_dim,
                                       False, dtype, stack=stack),
        "gate": torch.zeros(stack, dtype=dtype, device=gen.device),
        "mlp_norm": init_rmsnorm(gen, cfg.d_model, dtype, stack=stack),
        "mlp": MLP.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, stack=stack),
    }


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
               kv_chunk=1024, kv_split=None, tp=None):
    return A.attention_block(
        lp["attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=not cfg.encoder_only, window=window, softcap=softcap,
        kv_chunk=kv_chunk, cache=cache, kv_split=kv_split, tp=tp)


def _mlp(p, h, cfg, tp):
    """The MLP: tensor-parallel where d_ff splits over `tp`, else (and off
    a mesh) its whole weights on h, this rank's rows."""
    return MLP.mlp(p, h, tp=tp if tp is not None and tp.divides(cfg.d_ff)
                   else None)


def _dense_layer(lp, x, cfg, *, window, cache=None, kv_chunk=1024,
                 kv_split=None, tp=None):
    h = rmsnorm(lp["attn_norm"], x, cfg.rmsnorm_eps)
    y, new_cache = _attention(lp, h, cfg, window=window,
                              softcap=cfg.attn_softcap, cache=cache,
                              kv_chunk=kv_chunk, kv_split=kv_split, tp=tp)
    if "attn_post_norm" in lp:
        y = rmsnorm(lp["attn_post_norm"], y, cfg.rmsnorm_eps)
    x = x + y
    h = rmsnorm(lp["mlp_norm"], x, cfg.rmsnorm_eps)
    y = _mlp(lp["mlp"], h, cfg, tp)
    if "mlp_post_norm" in lp:
        y = rmsnorm(lp["mlp_post_norm"], y, cfg.rmsnorm_eps)
    return x + y, new_cache


def _moe_dense_layer(lp, x, cfg, *, cache=None, kv_chunk=1024, mesh=None,
                     dp_axes=("data",), kv_split=None,
                     weight_stationary=False, tp=None):
    h = rmsnorm(lp["attn_norm"], x, cfg.rmsnorm_eps)
    y, new_cache = _attention(lp, h, cfg, cache=cache, kv_chunk=kv_chunk,
                              kv_split=kv_split, tp=tp)
    x = x + y
    h = rmsnorm(lp["mlp_norm"], x, cfg.rmsnorm_eps)
    y, moe_metrics = MOE.moe_layer(lp["moe"], h, cfg.moe, mesh=mesh,
                                   dp_axes=dp_axes,
                                   weight_stationary=weight_stationary)
    return x + y, new_cache, moe_metrics


def _at(fn, stack, i, *args, **kw):
    """fn(layer i of `stack`, *args, **kw): the layer is indexed inside the
    remat unit, so that a layer whose weights gather on a mesh gathers
    them again when backward recomputes it."""
    return fn(_layer(stack, i), *args, **kw)


def _rwkv_layer(lp, x, cfg, cache=None, tp=None):
    """Time-mix then channel-mix, each with its residual. cache: None or
    this layer's {shift_t, shift_c, wkv} (its blocks on a mesh) for one
    decode token (`rwkv6.rwkv6_decode`); returns the new one (shift_c is
    the last position after the time-mix residual)."""
    if cache is not None:
        return R.rwkv6_decode(lp, x, cfg.rwkv, cache, tp)
    x = x + R.rwkv6_time_mix(lp, x, cfg.rwkv, tp=tp)[0]
    return x + R.rwkv6_channel_mix(lp, x, tp=tp), None


def _cross_layer(lp, x, img, cfg, tp=None):
    """The vlm's cross layer: attention from x to the image embeddings (no
    RoPE, not causal, no cache) scaled by tanh(gate), then the MLP."""
    h = rmsnorm(lp["attn_norm"], x, cfg.rmsnorm_eps)
    y, _ = A.attention_block(
        lp["cross_attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        cross_kv=img, tp=tp)
    x = x + torch.tanh(lp["gate"]) * y
    h = rmsnorm(lp["mlp_norm"], x, cfg.rmsnorm_eps)
    return x + _mlp(lp["mlp"], h, cfg, tp)


def _shared_attn_block(sp, x, cfg, cache=None, kv_chunk=1024,
                       kv_split=None, tp=None):
    h = rmsnorm(sp["norm"], x, cfg.rmsnorm_eps)
    y, new_cache = _attention(sp, h, cfg, cache=cache, kv_chunk=kv_chunk,
                              kv_split=kv_split, tp=tp)
    x = x + y
    h = rmsnorm(sp["mlp_norm"], x, cfg.rmsnorm_eps)
    return x + _mlp(sp["mlp"], h, cfg, tp), new_cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _call(train: bool, fn, *args, **kw):
    """fn(*args, **kw); under `train` inside a checkpoint, so that backward
    recomputes its activations instead of keeping them (the reference's
    jax.checkpoint around each scan body). Arguments are passed, not
    closed over: the recomputation must see this call's layer."""
    if train:
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


def forward(params, batch, cfg: ModelConfig, cache=None, kv_chunk: int = 1024,
            use_kernel: str = "auto", train: bool = False, mesh=None,
            dp_axes=("data",), cache_spec=None,
            weight_stationary: bool = False):
    """Returns (logits [B,S,V] f32, new_cache, metrics).

    batch: {"tokens": [B,S]}, or {"embeds": [B,S,d]} for a config that takes
    embeddings in (audio), plus {"image_embeds": [B,T,d]} for the vlm, on
    the parameters' device; embeddings are taken in the parameters' type.
    cache: None (prefill from the zero state) or init_cache()'s tree for
    decode, which is updated in place and returned (an encoder-only config
    has none: ValueError). metrics: the MoE family's aux_loss, router_li
    and drop_frac averaged over layers, else {}. use_kernel applies to the
    SSD chunk kernel. train: each of the reference's remat units (a layer
    of the dense, audio, MoE and rwkv6 loops, a gemma2 pair, a Zamba2 group
    with its shared attention block, each Zamba2 tail layer, a vlm group)
    runs inside a checkpoint; a cache with train raises ValueError.

    mesh: None, or a DeviceMesh over which `params` are this rank's shards
    (laid out by `param_layout`) and `batch` this rank's rows (its part of
    the batch over `dp_axes`, the same on every rank of its dp group); the
    logits are those rows', whole. The step is tensor-parallel over
    "model", with and without a cache (see the module docstring;
    ValueError where the sequence, the padded vocabulary or, in decode, a
    weight the step splits does not divide).
    A cache on a mesh holds this rank's block of each leaf under
    `cache_spec`, the tree `launch.specs.cache_specs` gave for it (torch
    tensors carry no layout; it is what the reference's jit takes as the
    cache's in_shardings): one token is decoded, no rank holds a KV cache
    or a state whole, and the blocks are updated in place and returned.
    A cache on a mesh without its cache_spec raises ValueError.
    weight_stationary: `params` are shards under `param_layout(cfg, mesh,
    weight_stationary=True)`, so no layer gathers a weight over "data"."""
    x, params, cache, metrics, tp = _hidden(
        params, batch, cfg, cache, kv_chunk, use_kernel, train, mesh,
        dp_axes, cache_spec, weight_stationary)
    logits = _logits(params, x, cfg, tp)
    if tp is not None:
        logits = SH.gather_dim(logits, 2, tp.axis, mesh)
    return logits, cache, metrics


def _logits(params, x, cfg, tp):
    """The f32 logits [B, S, V] of the final hidden states x (the tied
    embedding's or the untied head's). Under `tp` x is this rank's block
    of the sequence, and the logits [B, S, V/M] are its block of the
    vocabulary over the whole sequence."""
    if tp is not None:
        x = tp.gather_seq(x)
    if cfg.tie_embeddings and cfg.embed_inputs:
        return unembed(params["embed"], x, cfg.final_softcap)
    return linear(params["head"], x).to(wide_dtype(x.dtype))


def _hidden(params, batch, cfg, cache, kv_chunk, use_kernel, train, mesh,
            dp_axes, cache_spec, weight_stationary):
    """forward up to the final norm: (its hidden states, the parameters'
    view, the cache, the metrics, the tensor-parallel group or None)."""
    family = _family(cfg)
    if cache is not None and cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode cache")
    if cache is not None and train:
        raise ValueError("forward: train=True takes no cache (decode does "
                         "not train)")
    if mesh is not None and cache is not None and cache_spec is None:
        raise ValueError("forward: a cache on a mesh needs its cache_spec "
                         "(launch.specs.cache_specs' tree for it)")
    inputs = batch["tokens" if cfg.embed_inputs else "embeds"]
    tp = _tensor_parallel(cfg, mesh, dp_axes, inputs.shape[1],
                          weight_stationary, cache is not None)
    dtype = params["final_norm"]["scale"].dtype
    if mesh is None:
        params = {k: _unstack(v) if k in _STACKED else v
                  for k, v in params.items()}
    else:
        params = _mesh_params(params, cfg, mesh, weight_stationary, tp)
    if cfg.embed_inputs:
        x = embed(params["embed"], inputs, tp)
        if cfg.name.startswith("gemma"):
            x = x * math.sqrt(cfg.d_model)
    else:
        x = inputs.to(dtype)
        if tp is not None:
            x = tp.block(x, 1)
    metrics: Dict[str, torch.Tensor] = {}
    if family == "hybrid":
        x, cache = _zamba_forward(params, x, cfg, cache, kv_chunk,
                                  use_kernel, train, mesh, cache_spec, tp)
    elif family == "rwkv6":
        x = _rwkv_forward(params, x, cfg, cache, train, tp)
    elif family == "vlm":
        if "image_embeds" not in batch:
            raise ValueError(f"{cfg.name}: the vlm's batch needs "
                             f"image_embeds [B, T, d]")
        x = _vlm_forward(params, x, batch["image_embeds"].to(dtype), cfg,
                         cache, kv_chunk, train,
                         _kv_split(mesh, cache_spec, "self"), tp)
    elif family == "moe":
        x, metrics = _moe_forward(params, x, cfg, cache, kv_chunk, train,
                                  mesh, dp_axes,
                                  _kv_split(mesh, cache_spec),
                                  weight_stationary, tp)
    elif family == "gemma2":
        x = _pair_forward(params, x, cfg, cache, kv_chunk, train,
                          {part: _kv_split(mesh, cache_spec, part)
                           for part in ("local", "global")}, tp)
    else:
        x = _dense_forward(params, x, cfg, cache, kv_chunk, train,
                           _kv_split(mesh, cache_spec), tp)
    x = rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return x, params, cache, metrics, tp


def _kv_layer(kv, *idx):
    """The layer at `idx` of a stacked KV cache (one index, or the vlm's
    group and layer): views of its buffers and its length."""
    length = kv["len"]
    for i in idx:
        length = length[i]
    return {"k": kv["k"][idx], "v": kv["v"][idx], "len": length}


def _depth(stack) -> int:
    return len(stack["attn_norm"]["scale"])


def _dense_forward(params, x, cfg, cache, kv_chunk, train, kv_split, tp):
    for i in range(_depth(params["layers"])):
        lc = None if cache is None else _kv_layer(cache, i)
        x, nc = _call(train, _at, _dense_layer, params["layers"], i, x,
                      cfg, window=None, cache=lc, kv_chunk=kv_chunk,
                      kv_split=kv_split, tp=tp)
        if cache is not None:
            cache["len"][i] = nc["len"]
    return x


def _pair(pairs, i, x, cfg, cache, kv_chunk, kv_splits, tp):
    """gemma2's pair i: its local layer (windowed), then its global one.
    kv_splits: each part's KVSplit (None off a mesh)."""
    for part, window in (("local", cfg.sliding_window), ("global", None)):
        lc = None if cache is None else _kv_layer(cache[part], i)
        x, nc = _dense_layer(_layer(pairs[part], i), x, cfg, window=window,
                             cache=lc, kv_chunk=kv_chunk,
                             kv_split=kv_splits[part], tp=tp)
        if cache is not None:
            cache[part]["len"][i] = nc["len"]
    return x


def _pair_forward(params, x, cfg, cache, kv_chunk, train, kv_splits, tp):
    pairs = params["layers"]
    for i in range(_depth(pairs["local"])):
        x = _call(train, _pair, pairs, i, x, cfg, cache, kv_chunk,
                  kv_splits, tp)
    return x


def _moe_forward(params, x, cfg, cache, kv_chunk, train, mesh, dp_axes,
                 kv_split, weight_stationary, tp):
    acc = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in ("aux_loss", "router_li", "drop_frac")}
    for i in range(_depth(params["layers"])):
        lc = None if cache is None else _kv_layer(cache, i)
        x, nc, mm = _call(train, _at, _moe_dense_layer, params["layers"], i,
                          x, cfg, cache=lc, kv_chunk=kv_chunk, mesh=mesh,
                          dp_axes=dp_axes, kv_split=kv_split,
                          weight_stationary=weight_stationary, tp=tp)
        if cache is not None:
            cache["len"][i] = nc["len"]
        acc = {k: acc[k] + mm[k] for k in acc}
    return x, {k: v / cfg.n_layers for k, v in acc.items()}


def _rwkv_forward(params, x, cfg, cache, train, tp):
    for i in range(len(params["layers"]["wr"]["w"])):
        lc = None if cache is None else _layer(cache, i)
        x, nc = _call(train, _at, _rwkv_layer, params["layers"], i, x, cfg,
                      lc, tp)
        if cache is not None:
            _write(cache, i, nc)
    return x


def _vlm_group(params, g, x, img, cfg, kv, kv_chunk, kv_split, tp):
    """The vlm's group g: period - 1 dense layers over the group's KV
    caches, then its cross layer over `img` (recomputed every call, as the
    reference does: the cross keys and values are not cached)."""
    per = cfg.cross_attn_period - 1
    for j in range(per):
        lc = None if kv is None else _kv_layer(kv, g, j)
        x, nc = _dense_layer(_layer(params["layers"], g * per + j), x, cfg,
                             window=None, cache=lc, kv_chunk=kv_chunk,
                             kv_split=kv_split, tp=tp)
        if kv is not None:
            kv["len"][g][j] = nc["len"]
    return _cross_layer(_layer(params["cross_layers"], g), x, img, cfg, tp)


def _vlm_forward(params, x, img, cfg, cache, kv_chunk, train, kv_split, tp):
    kv = None if cache is None else cache["self"]
    for g in range(len(params["cross_layers"]["gate"])):
        x = _call(train, _vlm_group, params, g, x, img, cfg, kv, kv_chunk,
                  kv_split, tp)
    return x


def _zamba_group(params, g, x, cfg, cache, kv_chunk, use_kernel, kv_split,
                 tp):
    """Zamba2's group g: its `hybrid_attn_period` Mamba2 layers, then the
    shared attention block. kv_split: the shared attention's KVSplit (None
    off a mesh)."""
    period = cfg.hybrid_attn_period
    for j in range(period):
        lc = None if cache is None else _layer(cache["mamba"], (g, j))
        x, nc = M.mamba2_block(_layer(params["layers"], g * period + j), x,
                               cfg.ssm, lc, use_kernel, tp)
        if cache is not None:
            _write(cache["mamba"], (g, j), nc)
    ac = None if cache is None else _kv_layer(cache["shared_attn"], g)
    x, nac = _shared_attn_block(params["shared_attn"], x, cfg, ac, kv_chunk,
                                kv_split, tp)
    if cache is not None:
        cache["shared_attn"]["len"][g] = nac["len"]
    return x


def _zamba_forward(params, x, cfg, cache, kv_chunk, use_kernel, train,
                   mesh, cache_spec, tp):
    period = cfg.hybrid_attn_period
    kv_split = _kv_split(mesh, cache_spec, "shared_attn")
    for g in range(len(params["layers"]["in_proj"]["w"]) // period):
        x = _call(train, _zamba_group, params, g, x, cfg, cache, kv_chunk,
                  use_kernel, kv_split, tp)
    if "tail_layers" in params:
        for j in range(len(params["tail_layers"]["in_proj"]["w"])):
            lc = None if cache is None else _layer(cache["tail"], j)
            x, nc = _call(train, _at, M.mamba2_block, params["tail_layers"],
                          j, x, cfg.ssm, lc, use_kernel, tp)
            if cache is not None:
                _write(cache["tail"], j, nc)
    return x, cache


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Decode cache in the reference's layout, zeroed tensors of its own
    (the forward writes them in place). A KV cache of n layers is {k, v [n,
    B, max_len, KVH, D], len: one int per layer}: dense and moe hold one of
    L layers, gemma2 {local, global} of L/2 each; the vlm {"self": {k, v
    [groups, period - 1, B, max_len, KVH, D], len [groups][period - 1]}};
    rwkv6 {shift_t, shift_c [L, B, 1, d], wkv [L, B, H, D, D]}; Zamba2
    holds `mamba` {conv, ssm} stacked [groups, period, ...], `shared_attn`
    (one KV layer per group) and `tail` {conv, ssm} [rem, ...] or None. An
    encoder-only config has no cache: ValueError."""
    family = _family(cfg)
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode cache")
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim

    def kv(*stack):
        shape = (*stack, batch, max_len, cfg.kv_heads, hd)
        length = [0] * stack[-1]
        for n in reversed(stack[:-1]):
            length = [list(length) for _ in range(n)]
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "len": length}

    if family == "rwkv6":
        return R.init_rwkv6_cache(batch, cfg.d_model, cfg.rwkv, dtype, dev,
                                  stack=(cfg.n_layers,))
    if family == "vlm":
        period = cfg.cross_attn_period
        return {"self": kv(cfg.n_layers // period, period - 1)}
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


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def loss_fn(params, batch, cfg: ModelConfig, train: bool = True,
            use_kernel: str = "auto", mesh=None, dp_axes=("data",)):
    """(loss, metrics): the cross-entropy over the full padded vocabulary,
    of an encoder-only model's logits against batch["labels"], else of
    logits[:, :-1] against tokens[:, 1:]; MoE adds router_aux_weight x its
    aux_loss. metrics holds the forward's and "ce_loss", the loss (the aux
    term included, under the reference's name). On a mesh (see forward)
    the cross-entropy is that of this rank's rows, every rank of a "model"
    group holding the same, and MoE's metrics are means over the mesh; the
    logits stay split over the vocabulary (the cross-entropy is
    vocab-parallel), so no rank holds [B, S, V]."""
    x, params, _, metrics, tp = _hidden(params, batch, cfg, None, 1024,
                                        use_kernel, train, mesh, dp_axes,
                                        None, False)
    logits = _logits(params, x, cfg, tp)
    if cfg.encoder_only:
        loss = softmax_cross_entropy(logits, batch["labels"], tp)
    else:
        loss = softmax_cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                                     tp)
    if cfg.moe is not None and "aux_loss" in metrics:
        loss = loss + cfg.moe.router_aux_weight * metrics["aux_loss"]
    metrics["ce_loss"] = loss
    return loss, metrics
