"""Shared model primitives: norms, rotary, embedding, initializers.

Parameters are plain nested dicts of tensors, in the reference's layout:
a linear layer's weight is `w [d_in, d_out]` and applies as `x @ w`, so a
reference parameter tree carries over as a plain copy. Every init_* draws
from an explicit torch.Generator, on the generator's device; `stack` puts
leading layer axes in front of each shape, as the reference's stacked
layers have them.
"""
from __future__ import annotations

import math

import torch

from ...distributed.sharding import sum_dtype


class MetaDraws:
    """Stands in for a torch.Generator on the meta device, which has none:
    the init_* functions then make tensors of the right shapes and types
    and draw nothing (a shape-only tree)."""

    device = torch.device("meta")


def generator(device: torch.device, seed: int):
    """A torch.Generator on `device` seeded with `seed`; MetaDraws on the
    meta device."""
    if device.type == "meta":
        return MetaDraws()
    return torch.Generator(device=device).manual_seed(seed)


def normal(gen, shape, dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) draws from `gen` on its device (none on the meta device)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return torch.randn(shape, dtype=dtype, device=gen.device, generator=gen)


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     dtype=torch.float32) -> torch.Tensor:
    """scale * N(0, 1) truncated to [-2, 2], as the reference initializes."""
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    if t.is_meta:
        return t
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(float(scale))


def init_linear(gen, d_in, d_out, bias=False, dtype=torch.float32,
                scale=None, stack=()):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": truncated_normal(gen, (*stack, d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=dtype, device=gen.device)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the reference's f32 computations take: float32, or
    float64 for a float64 model (whose products stay float64)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def init_rmsnorm(gen, d, dtype=torch.float32, stack=()):
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=gen.device)}


def rmsnorm(p, x, eps=1e-5, tp=None):
    """RMS norm computed in f32 (f64 for f64); returns the input's type.
    tp: x [..., d/M] is this rank's block of a last dim split over the
    tensor-parallel group (`sharding.TensorParallel`) and p["scale"] the
    block's scale; the mean of squares is over the whole dim (its sum
    all-reduced; in decode, `tp.whole`, formed and summed in
    `sharding.sum_dtype`, float64 for float32)."""
    dt = x.dtype
    x = x.to(wide_dtype(dt))
    if tp is None:
        ms = (x * x).mean(dim=-1, keepdim=True)
    else:
        xs = x.to(sum_dtype(x.dtype)) if tp.whole else x
        ms = (tp.psum((xs * xs).sum(dim=-1, keepdim=True))
              / (x.shape[-1] * tp.size)).to(x.dtype)
    x = x * torch.rsqrt(ms + eps)
    return (x * p["scale"].to(x.dtype)).to(dt)


def init_embedding(gen, vocab, d, dtype=torch.float32):
    return {"table": truncated_normal(gen, (vocab, d), 0.02, dtype)}


def embed(p, tokens, tp=None):
    """The table's rows of `tokens` [B, S]. tp: the table is this rank's
    block of the vocabulary (rows), and the result is this rank's block of
    the sequence [B, S/M, d] (in decode, `tp.whole`, the whole token):
    each rank looks up the tokens in its rows, zeros the others, and the
    blocks are summed over the group."""
    if tp is None:
        return p["table"][tokens]
    table = p["table"]
    local, inside = _vocab_block(tokens, table.shape[0], tp)
    rows = table[local] * inside[..., None].to(table.device, table.dtype)
    return tp.scatter_seq(rows)


def _vocab_block(ids, rows: int, tp):
    """(index into this rank's `rows` of the vocabulary, inside it): ids
    outside the rank's block index row 0 and are not inside."""
    local = ids.long() - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    return torch.where(inside, local, 0), inside


def unembed(p, x, softcap=None):
    """Tied unembedding. Logits in f32 (f64 for f64)."""
    wide = wide_dtype(x.dtype)
    logits = x.to(wide) @ p["table"].to(wide).T
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def softcap_fn(x, cap):
    return cap * torch.tanh(x / cap) if cap is not None else x


# ---------------------------------------------------------------------------
# Rotary position embedding (concatenated halves, not interleaved)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [D/2]
    ang = positions.float()[..., None] * freqs                # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                        # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits, labels, tp=None):
    """logits [..., V], labels [...] int -> the mean of logsumexp - gold over
    every position. Every column counts, the padded ones too: they are
    real rows of the (tied) embedding, as in the reference.

    tp: logits [..., V/M] are this rank's block of the vocabulary; the
    largest logit, the sum of exponentials and the gold logit are reduced
    over the group, so every rank returns the same loss and no rank holds
    the whole vocabulary."""
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.mean(logz - gold)
    m = tp.pmax(logits.amax(dim=-1))
    logz = torch.log(tp.psum(torch.exp(logits - m[..., None]).sum(dim=-1))) + m
    local, inside = _vocab_block(labels, logits.shape[-1], tp)
    gold = torch.gather(logits, -1, local[..., None].to(logits.device))[..., 0]
    gold = tp.psum(gold * inside.to(logits.device, logits.dtype))
    return torch.mean(logz - gold)
