"""Attention: chunked online softmax over KV blocks with GQA,
causal/bidirectional, sliding window, softcap and cross-attention; plus the
single-token decode path over a KV cache.

The reference writes this in jnp, not Pallas, so plain torch ops are its
port. Scores and the weighted sum of values are f32 wherever the reference
asks for an f32 product (`preferred_element_type=jnp.float32`): operands are
widened to f32 before the product, so a bf16 model does not round its scores
(a float64 model keeps float64).
Chunking over KV bounds the live score tensor to [B, H, Sq, kv_chunk].

On a mesh (`kv_split`) a rank holds a block of the KV cache, its positions
or its head_dim split over mesh axes, and decode combines the blocks'
partial softmaxes (`decode_attention(split=)`, the one-device body too);
no rank holds the cache whole. Decode on a mesh is tensor-parallel over
"model" as its weights are stored, with no need to line up with heads:
the residual stream is whole on every rank, each rank projects the
token's q, k and v onto its column block of wq, wk and wv, and the blocks
are all-gathered (one token's activations), since a rank's cache block
holds every head of its positions (or of its head_dim slice); after the
attention the rank multiplies its slice of the heads' output by its rows
of wo, and the partial outputs are summed over "model".

Tensor-parallel (`attention_block(tp=)`, train and prefill on a mesh): the
residual stream holds each rank's block of the sequence, and the layer
splits its work over the group's M ranks in one of two ways
(`heads_split`):
  * heads, where n_heads and kv_heads both divide by M: the sequence is
    gathered, the rank projects its heads (its columns of wq, wk, wv), attends
    over the whole sequence, and its rows of wo give a partial sum that is
    reduce-scattered back to the sequence blocks;
  * sequence, otherwise (qwen2-7b's 28 heads and 4 KV heads on 16 ranks):
    the weights are whole, the rank projects its S/M rows, gathers the keys
    and values of every rank's rows, and attends its queries against them
    with the causal mask offset to its rows. A cross-attention's keys and
    values come from the whole image embeddings on every rank.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from ...distributed import sharding as SH
from .common import apply_rope, init_linear, linear, softcap_fn, wide_dtype

NEG_INF = -1e30


def init_attention(gen, d_model, n_heads, kv_heads, head_dim, qkv_bias=False,
                   dtype=torch.float32, stack=()):
    kw = dict(dtype=dtype, stack=stack)
    return {
        "wq": init_linear(gen, d_model, n_heads * head_dim, qkv_bias, **kw),
        "wk": init_linear(gen, d_model, kv_heads * head_dim, qkv_bias, **kw),
        "wv": init_linear(gen, d_model, kv_heads * head_dim, qkv_bias, **kw),
        "wo": init_linear(gen, n_heads * head_dim, d_model, False, **kw),
    }


def _split_heads(x, n, d):
    return x.reshape(*x.shape[:-1], n, d)


def flash_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                    softcap: Optional[float] = None, kv_chunk: int = 1024,
                    q_offset: int = 0):
    """q [B,Sq,H,D]; k,v [B,Sk,KVH,D] -> [B,Sq,H,D].

    GQA via head grouping. q_offset: absolute position of q[0] relative to
    k[0] (prefill: 0).
    """
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    dev = q.device
    wide = wide_dtype(q.dtype)
    # [b, kvh, g, sq, d] in f32
    qg = q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4).to(wide)
    scale = 1.0 / math.sqrt(d)
    kv_chunk = min(kv_chunk, sk)
    nchunks = (sk + kv_chunk - 1) // kv_chunk
    q_pos = q_offset + torch.arange(sq, device=dev)

    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=wide, device=dev)
    l = torch.zeros((b, kvh, g, sq), dtype=wide, device=dev)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=wide, device=dev)
    for idx in range(nchunks):
        lo = idx * kv_chunk
        # [b, kvh, 1, ck, d]; the last chunk may be short (the reference
        # pads it and masks the padding: the same scores)
        kci = k[:, lo:lo + kv_chunk].permute(0, 2, 1, 3)[:, :, None]
        vci = v[:, lo:lo + kv_chunk].permute(0, 2, 1, 3)[:, :, None]
        s = (qg @ kci.to(wide).transpose(-1, -2)) * scale    # [b,kvh,g,sq,ck]
        s = softcap_fn(s, softcap)
        k_pos = lo + torch.arange(kci.shape[3], device=dev)
        mask = torch.ones((sq, kci.shape[3]), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = p.to(v.dtype).to(wide) @ vci.to(wide)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


class KVSplit(NamedTuple):
    """Where a rank's KV cache block lies on `mesh`: the positions split
    over the axes `seq`, head_dim over the axes `hd` (each the first axis
    outermost; () for a dim held whole), as the cache's spec names them."""
    mesh: Any
    seq: tuple
    hd: tuple


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window=None,
                     softcap=None, split: Optional[KVSplit] = None):
    """One-token decode: q [B,1,H,D]; caches [B,Smax,KVH,D]; cache_len is
    the valid length after the new token was inserted. Returns [B,1,H,D].

    split: None on one device, or where the caches, this rank's blocks
    [B,S_blk,KVH,D_blk], lie on a mesh: the block starts at position
    block * S_blk and at head_dim block * D_blk, and q is whole (every rank
    of the split computes the same token). With head_dim split, the
    partial q.k products are summed over `hd` before the softmax
    ([B,H,S_blk] scores). With the positions split, each rank scores its
    own positions (the same mask, window and softcap) and the partial
    softmaxes combine by their log-sum-exp: the largest score over `seq`
    (a max of [B,H]), the sum of exp(s - max) ([B,H]), then the sum of
    the normalized p v ([B,H,D_blk]). A head_dim split then gathers the
    output's slices over `hd`. Where both are () (a (1, 1) mesh) the
    arithmetic is the one-device body's."""
    b, _, h, d = q.shape
    _, s_blk, kvh, d_blk = k_cache.shape
    g = h // kvh
    wide = wide_dtype(q.dtype)
    seq, hd = (split.seq, split.hd) if split is not None else ((), ())
    lo = SH.block_start(split.mesh, hd, d_blk, d) if hd else 0
    qg = q[..., lo:lo + d_blk].reshape(b, kvh, g, d_blk).to(wide)
    kf = k_cache.permute(0, 2, 1, 3).to(wide)               # [b,kvh,S,d]
    s = qg @ kf.transpose(-1, -2)                           # [b,kvh,g,S]
    if hd:
        s = SH.all_reduce(s, hd, split.mesh)
    s = softcap_fn(s / math.sqrt(d), softcap)
    k_pos = torch.arange(s_blk, device=q.device)
    if seq:
        k_pos = SH.block_index(split.mesh, seq) * s_blk + k_pos
    mask = k_pos < cache_len
    if window is not None:
        mask = mask & (k_pos >= cache_len - window)
    s = torch.where(mask, s, NEG_INF)
    vf = v_cache.permute(0, 2, 1, 3).to(wide)
    if seq:
        m = SH.all_reduce(s.amax(dim=-1), seq, split.mesh, op="max")
        p = torch.exp(s - m[..., None])
        p = p / SH.all_reduce(p.sum(dim=-1), seq, split.mesh)[..., None]
        out = SH.all_reduce(p.to(v_cache.dtype).to(wide) @ vf, seq,
                            split.mesh)
    else:
        p = torch.softmax(s, dim=-1)
        out = p.to(v_cache.dtype).to(wide) @ vf
    out = out.reshape(b, 1, h, d_blk).to(q.dtype)
    if hd:
        out = SH.gather_dim(out, 3, hd, split.mesh)
    return out


def _check_room(base: int, s: int, whole: int) -> None:
    """RuntimeError unless positions base .. base + s - 1 lie in a KV
    cache of `whole` positions. Without it a write past the end would
    drop the new keys and values without a sound (torch broadcasts a
    [B,s,..] update onto the empty slice) and attend over a cache that
    lacks them."""
    if base + s > whole:
        raise RuntimeError(f"attention_block: positions {base}..{base + s - 1}"
                           f" are past the end of a KV cache of {whole} "
                           f"positions")


def _write_block(cache, k, v, base: int, split: KVSplit) -> None:
    """Write the new token's k, v [B,1,KVH,D] at position `base` into this
    rank's block, if its block holds that position: the head_dim slice
    the block keeps. A position past the whole cache's end raises
    RuntimeError on every rank, as on one device (`_check_room`)."""
    s_blk, d_blk = cache["k"].shape[1], cache["k"].shape[-1]
    _check_room(base, 1, s_blk * math.prod(SH.axis_sizes(split.mesh)[a]
                                           for a in split.seq))
    start = SH.block_index(split.mesh, split.seq) * s_blk
    if not start <= base < start + s_blk:
        return
    lo = SH.block_start(split.mesh, split.hd, d_blk, k.shape[-1])
    cache["k"][:, base - start] = k[:, 0, :, lo:lo + d_blk]
    cache["v"][:, base - start] = v[:, 0, :, lo:lo + d_blk]


def heads_split(tp, n_heads: int, kv_heads: int) -> bool:
    """Whether a tensor-parallel attention splits its heads over `tp`'s
    ranks (both head counts divide), rather than its sequence."""
    return tp.divides(n_heads) and tp.divides(kv_heads)


def _tp_attention(params, x, *, n_heads, kv_heads, head_dim, rope_theta,
                  causal, window, softcap, kv_chunk, cross_kv, tp):
    """attention_block on this rank's block x [B, S/M, d] of the sequence
    (see the module docstring); returns its block of the output. Under a
    decode group (whole stream) only a cross-attention comes here, which
    has no cache: it splits its heads where both counts divide, else its
    weights are whole and every rank computes the whole layer."""
    b, s, _ = x.shape
    by_heads = heads_split(tp, n_heads, kv_heads)
    if by_heads:
        h, kvh = n_heads // tp.size, kv_heads // tp.size
        x = tp.gather_seq(x)
        s, lo = x.shape[1], 0
    else:
        h, kvh = n_heads, kv_heads
        lo = 0 if tp.whole else tp.rank * s
    kv_src = x if cross_kv is None else cross_kv
    q = _split_heads(linear(params["wq"], x), h, head_dim)
    k = _split_heads(linear(params["wk"], kv_src), kvh, head_dim)
    v = _split_heads(linear(params["wv"], kv_src), kvh, head_dim)
    if cross_kv is None:
        positions = (lo + torch.arange(s, device=x.device)).expand(b, s)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        if not by_heads:
            k, v = tp.gather_seq(k), tp.gather_seq(v)
    y = flash_attention(q, k, v, causal=causal and cross_kv is None,
                        window=window, softcap=softcap, kv_chunk=kv_chunk,
                        q_offset=lo)
    y = linear(params["wo"], y.reshape(b, s, h * head_dim))
    return (tp.scatter_seq(y) if by_heads else y), None


def _project(p, x, tp):
    """linear(p, x); under a decode group (`tp`, whole stream) the rank's
    column block of it, all-gathered whole: one token's activations."""
    y = linear(p, x)
    return y if tp is None else tp.gather(y, -1)


def attention_block(params, x, *, n_heads, kv_heads, head_dim, rope_theta,
                    causal=True, window=None, softcap=None, kv_chunk=1024,
                    cache=None, cross_kv=None, kv_split=None, tp=None):
    """Full attention sub-block: proj -> rope -> (flash | decode) -> out proj.

    cache: None (prefill; returns (y, None)) or {k, v, len} for decode,
    where k and v are [B, Smax, KVH, D] buffers and len the number of valid
    positions. The reference returns updated copies of the buffers; here the
    new keys and values are written into them in place, and the returned
    cache holds the same buffers with len advanced. Positions past Smax
    raise RuntimeError (`_check_room`).
    cross_kv: [B, T, d] states the keys and values come from (the vlm's
    image embeddings): no RoPE, never causal, and no cache, also in decode
    (returns (y, None)).
    kv_split: None, or where this rank's block of the cache lies on a mesh
    (KVSplit): the cache holds the blocks, one token is decoded (S = 1;
    ValueError otherwise), the rank whose block holds position `len`
    writes its part of the new key and value, and decode_attention
    combines the blocks.
    tp: None, or the tensor-parallel group (`sharding.TensorParallel`).
    Train and prefill (no cache), and a cross-attention: x is this rank's
    block of the sequence (the whole stream in decode), the weights its
    heads' columns (rows of wo) or whole as `heads_split` says, and the
    result its block of the output. Decode (a cache; the group's stream
    is whole): q, k and v are the rank's column blocks of their
    projections, gathered whole; wo's rows are the rank's block, whose
    partial output is summed over the group.
    """
    if tp is not None and (cache is None or cross_kv is not None):
        return _tp_attention(params, x, n_heads=n_heads, kv_heads=kv_heads,
                             head_dim=head_dim, rope_theta=rope_theta,
                             causal=causal, window=window, softcap=softcap,
                             kv_chunk=kv_chunk, cross_kv=cross_kv, tp=tp)
    b, s, _ = x.shape
    kv_src = x if cross_kv is None else cross_kv
    q = _split_heads(_project(params["wq"], x, tp), n_heads, head_dim)
    k = _split_heads(_project(params["wk"], kv_src, tp), kv_heads, head_dim)
    v = _split_heads(_project(params["wv"], kv_src, tp), kv_heads, head_dim)

    if cross_kv is None:
        base = 0 if cache is None else cache["len"]
        positions = (base + torch.arange(s, device=x.device)).expand(b, s)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    if cache is not None and cross_kv is None and kv_split is not None:
        if s != 1:
            raise ValueError(f"attention_block: a KV cache on a mesh decodes "
                             f"one token, got S = {s}")
        _write_block(cache, k, v, base, kv_split)
        y = decode_attention(q, cache["k"], cache["v"], base + 1,
                             window=window, softcap=softcap, split=kv_split)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": base + 1}
    elif cache is not None and cross_kv is None:
        end = base + s
        _check_room(base, s, cache["k"].shape[1])
        cache["k"][:, base:end] = k
        cache["v"][:, base:end] = v
        y = decode_attention(q, cache["k"], cache["v"], end, window=window,
                             softcap=softcap)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": end}
    else:
        y = flash_attention(q, k, v, causal=causal and cross_kv is None,
                            window=window, softcap=softcap,
                            kv_chunk=kv_chunk)
        new_cache = None
    y = y.reshape(b, s, n_heads * head_dim)
    if tp is None:
        return linear(params["wo"], y), new_cache
    return tp.row_linear(params["wo"], tp.block(y, -1)), new_cache
