"""The inputs and decode caches of a (arch x shape) cell, as shapes and
specs: the reference's `repro/launch/specs.py`, nothing allocated.

A spec is a tuple with one entry per dim, as in `distributed.sharding`
(an axis name, a tuple of axis names, or None), and `mesh` is a
DeviceMesh or axis sizes by name (`sharding.axis_sizes`), so the
production meshes (16, 16) and (2, 16, 16) are evaluated with no process
group open. `sharding.local_shape` gives a rank's block of a leaf;
`sharding.shard_tree` takes it from a whole cache.

The reference's `with_shardings` has no counterpart: torch has no
sharded abstract value to attach a spec to.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed import sharding as SH
from ..models import model as MDL


class InputSpec(NamedTuple):
    """One model input of a cell: its whole shape, dtype and spec (None
    without a mesh)."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple | None


def _entry(axes) -> str | tuple | None:
    """A spec entry naming `axes`: None for none, the name for one (as a
    PartitionSpec normalizes it), else the tuple."""
    axes = tuple(axes or ())
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _axes_size(sizes: dict, axes) -> int:
    return math.prod(sizes[a] for a in (axes or ()))


def _dp(batch: int, sizes: dict, dp_axes):
    """The batch's spec entry: the dp axes when the batch divides them and
    they hold more than one rank, else None."""
    n = _axes_size(sizes, dp_axes)
    return _entry(dp_axes) if batch % n == 0 and n > 1 else None


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                dp_axes: Tuple[str, ...]) -> dict:
    """The model inputs of this cell, {name: InputSpec}: `tokens` [B, S]
    (S = 1 for a decode cell), or `embeds` [B, S, d] bf16 and `labels`
    for a config that takes embeddings in, plus `image_embeds` [B, T, d]
    bf16 for the vlm; the batch dim over `dp_axes` where it divides them."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    dp = None if mesh is None else _dp(b, SH.axis_sizes(mesh), dp_axes)

    def spec(*rest):
        return None if mesh is None else (dp, *rest)

    out = {}
    if cfg.embed_inputs:
        out["tokens"] = InputSpec((b, s), torch.int32, spec(None))
    else:
        out["embeds"] = InputSpec((b, s, cfg.d_model), torch.bfloat16,
                                  spec(None, None))
        out["labels"] = InputSpec((b, s), torch.int32, spec(None))
    if cfg.cross_attn_period:
        out["image_embeds"] = InputSpec(
            (b, cfg.num_image_tokens, cfg.d_model), torch.bfloat16,
            spec(None, None))
    return out


def cache_shape(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16):
    """The decode cache of a cell (`seq_len` positions) on the meta
    device: shapes and types, nothing allocated."""
    return MDL.init_cache(cfg, shape.global_batch, shape.seq_len, dtype,
                          device="meta")


def cache_specs(cache_tree, cfg: ModelConfig, shape: ShapeConfig, mesh,
                dp_axes: Tuple[str, ...], kv_shard: str = "seq"):
    """The reference's path heuristic for the cache, leaf for leaf: batch
    over the dp axes (where it divides them); the KV positions over
    "model" (kv_shard="seq"; with batch 1 over ("data", "model")), or
    head_dim over "model" (kv_shard="hd", the reference's baseline; with
    batch 1 the positions over "data" too); the rwkv and Mamba2 states'
    heads and channels over "model" (where they divide); `len` whole. A
    leaf that is not a tensor (a missing Zamba2 tail) has spec None."""
    if kv_shard not in ("seq", "hd"):
        raise ValueError(f"kv_shard must be 'seq' or 'hd', got {kv_shard!r}")
    sizes = SH.axis_sizes(mesh)
    dp = _dp(shape.global_batch, sizes, dp_axes)
    seq_shard = "data" if dp is None else None
    msize = sizes["model"]

    def last_model(dim):
        return "model" if dim % msize == 0 else None

    def spec_for(name, leaf):
        if leaf is None:
            return None
        if name.endswith("len"):
            return ()
        dims = tuple(leaf.shape)
        nd = len(dims)
        if nd == 0:
            return ()
        last = name.rsplit("/", 1)[-1]
        if last in ("k", "v"):             # [..., B, S, KVH, HD]
            lead = (None,) * (nd - 4)
            sdim = dims[-3]
            if kv_shard == "hd":
                sshard = (seq_shard if seq_shard
                          and sdim % sizes["data"] == 0 else None)
                return (*lead, dp, sshard, None, last_model(dims[-1]))
            if dp is None:                 # batch 1: over data AND model
                axes = tuple(a for a in ("data", "model")
                             if sdim % sizes[a] == 0)
                if axes and sdim % _axes_size(sizes, axes) != 0:
                    axes = axes[:1]
                return (*lead, None, _entry(axes), None, None)
            return (*lead, dp, last_model(sdim), None, None)
        if "wkv" in name:                  # [L, B, H, D, D]
            return (None, dp, last_model(dims[-3]), None, None)
        if "shift" in name:                # [L, B, 1, d]
            return (None, dp, None, last_model(dims[-1]))
        if "conv" in name:                 # [..., B, W-1, C]
            return (*(None,) * (nd - 3), dp, None, last_model(dims[-1]))
        if "ssm" in name:                  # [..., B, H, N, P]
            return (*(None,) * (nd - 4), dp, last_model(dims[-3]), None,
                    None)
        return ()

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return spec_for(prefix, tree)

    return walk(cache_tree, "")
