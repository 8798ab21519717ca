"""RWKV6 "Finch" block: time-mix (WKV6 linear attention with data-dependent
per-channel decay) + channel-mix FFN [arXiv:2404.05892].

Prefill runs the chunked parallel form: within a chunk of T tokens the
decay products are cumulative log-decay differences (an attention-like
[T, T] matrix per head and channel), and the running state [B, H, D, D] is
carried across chunks by a Python loop, as the reference's `lax.scan`
carries it. Decode is the O(1) state update of one token, one body on one
device and on a mesh.

The reference's documented simplifications are kept: the token-shift mix
coefficients are static (full RWKV6 uses a data-dependent LoRA lerp), and
`ln_x` is one RMS norm over d_model, not a per-head group norm. The decay
LoRA and the per-head bonus u are kept, as they define WKV6.

Decode on a mesh (`rwkv6_decode(tp=)`) is tensor-parallel over "model": a
rank holds the WKV state's block of heads and the token shifts' block of
channels, and runs its heads and its block of d_ff.

Tensor-parallel (`rwkv6_time_mix(tp=)`, `rwkv6_channel_mix(tp=)`, train
and prefill on a mesh): the rank gathers the sequence, takes the token
shifts whole, and runs its block of the heads: its columns of wr, wk, wv,
wg and w_lora_b, its rows of u_bonus, its channels of w0 and ln_x (whose
sum of squares over d_model is all-reduced), and its rows of wo, whose
partial sums are reduce-scattered back to the sequence blocks. The decay
LoRA's first product (`xw @ w_lora_a`, whose weight is whole) runs on the
rank's block of the sequence and its [B, S, lora] result is gathered, as
the reference's program splits it. The channel mix is column- (wck) then
row-parallel (wcv) over d_ff.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import init_linear, init_rmsnorm, linear, normal, rmsnorm

NEG_INF = -1e30


def init_rwkv6(gen, d_model, rwkv_cfg, d_ff, dtype=torch.float32, stack=()):
    hd = rwkv_cfg.head_dim
    h = d_model // hd
    lora = rwkv_cfg.decay_lora
    dev = gen.device

    def full(value):
        return torch.full((*stack, d_model), value, dtype=dtype, device=dev)

    def draw(shape, scale):
        return normal(gen, (*stack, *shape), dtype).mul_(scale)

    def lin(d_in, d_out):
        return init_linear(gen, d_in, d_out, False, dtype, stack=stack)

    return {
        # time-mix
        "mix_r": full(0.5),
        "mix_k": full(0.5),
        "mix_v": full(0.5),
        "mix_w": full(0.5),
        "mix_g": full(0.5),
        "wr": lin(d_model, d_model),
        "wk": lin(d_model, d_model),
        "wv": lin(d_model, d_model),
        "wg": lin(d_model, d_model),
        "wo": lin(d_model, d_model),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full(-4.0),
        "w_lora_a": draw((d_model, lora), 1.0 / math.sqrt(d_model)),
        "w_lora_b": draw((lora, d_model), 1.0 / math.sqrt(lora)),
        "u_bonus": draw((h, hd), 0.1),
        "ln_x": init_rmsnorm(gen, d_model, dtype, stack=stack),
        # channel-mix
        "cmix_k": full(0.5),
        "wck": lin(d_model, d_ff),
        "wcv": lin(d_ff, d_model),
    }


def _token_shift(x, mix, last=None):
    """lerp(x_{t-1}, x_t, mix). last: [B,1,d] carry for decode (None: the
    token before the first is zero)."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = torch.cat([last.to(x.dtype), x], dim=1)[:, :-1]
    return x * mix + prev * (1 - mix)


def _wkv6_chunked(r, k, v, log_w, u, chunk, init_state=None):
    """r,k,v: [B,S,H,D]; log_w: [B,S,H,D] (log decay, < 0); u: [H,D]; S a
    multiple of `chunk`. Returns (y [B,S,H,D], state [B,H,D,D]), with
    state[k_dim, v_dim].

    Within a chunk, y_t = sum_{i<t} r_t . (k_i * prod_{i<j<t} w_j) v_i
    + (r_t . (u * k_t)) v_t + (r_t * prod_{j<t} w_j) @ state. The decay is
    formed directly as exp(cum_{t-1} - cum_i), whose exponent is <= 0 for
    i < t, so it never overflows; the exponent is masked to -1e30 before
    exp, so no 0 * inf makes a NaN."""
    b, s, h, d = r.shape
    tri_lo = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    mask = tri_lo[None, :, :, None, None]
    state = (r.new_zeros((b, h, d, d)) if init_state is None
             else init_state.to(r.dtype))
    ys = []
    for lo in range(0, s, chunk):
        r_i, k_i, v_i, lw_i = (t[:, lo:lo + chunk] for t in (r, k, v, log_w))
        cum = torch.cumsum(lw_i, dim=1)                       # [B,T,H,D]
        cum_shift = F.pad(cum, (0, 0, 0, 0, 1, 0))[:, :-1]
        expo = cum_shift[:, :, None] - cum[:, None]           # [B,T,T,H,D]
        dec = torch.exp(torch.where(mask, expo, NEG_INF))
        scores = torch.einsum("bthd,btihd->bhti", r_i, k_i[:, None] * dec)
        y_i = torch.einsum("bhti,bihd->bthd", scores, v_i)
        # the diagonal (bonus) term: (r_t . (u * k_t)) v_t
        y_i = y_i + (r_i * k_i * u[None, None]).sum(-1, keepdim=True) * v_i
        # the cross-chunk read: (r_t * exp(cum_shift_t)) @ state
        y_i = y_i + torch.einsum("bthd,bhde->bthe",
                                 r_i * torch.exp(cum_shift), state)
        # state' = diag(exp(cum_T)) state + sum_i exp(cum_T - cum_i) k_i v_i^T
        dec_end = torch.exp(cum[:, -1:] - cum)
        state = (state * torch.exp(cum[:, -1])[..., None]
                 + torch.einsum("bihd,bihe->bhde", k_i * dec_end, v_i))
        ys.append(y_i)
    return torch.cat(ys, dim=1), state


def rwkv6_time_mix(params, x, rwkv_cfg, cache=None, tp=None):
    """x [B,S,d]. cache: None (prefill from the zero state) or
    {shift_t [B,1,d], wkv [B,H,D,D]} for one decode token (S = 1; the
    reference's decode update reads position 0 only, so S > 1 with a cache
    raises ValueError). Returns (out [B,S,d], new {shift_t, wkv} or None);
    the cache passed in is not written. tp: the tensor-parallel group of a
    train or prefill step on a mesh (no cache): x and out are this rank's
    blocks of the sequence (see the module docstring)."""
    if cache is not None:
        if x.shape[1] != 1:
            raise ValueError(f"rwkv6_time_mix: a cached call takes one "
                             f"token, got S = {x.shape[1]}")
        y, state = _time_mix_step(params, x, rwkv_cfg, cache["shift_t"],
                                  cache["wkv"])
        return y, {"shift_t": x[:, -1:], "wkv": state}
    if tp is not None:
        x = tp.gather_seq(x)
    b, s, d = x.shape
    hd = rwkv_cfg.head_dim
    h = d // hd
    w0, ln_x = params["w0"], params["ln_x"]
    if tp is not None:
        if not tp.divides(h):
            raise ValueError(f"rwkv6: {h} heads do not split over "
                             f"{tp.size} {tp.axis!r} ranks")
        h, d = h // tp.size, d // tp.size
        w0, ln_x = tp.block(w0, -1), {"scale": tp.block(ln_x["scale"], -1)}
    xr, xk, xv, xw, xg = (_token_shift(x, params[f"mix_{n}"])
                          for n in "rkvwg")
    r = linear(params["wr"], xr).reshape(b, s, h, hd)
    k = linear(params["wk"], xk).reshape(b, s, h, hd)
    v = linear(params["wv"], xv).reshape(b, s, h, hd)
    g = F.silu(linear(params["wg"], xg))
    if tp is None:
        lora = torch.tanh(xw @ params["w_lora_a"])
    else:           # on the rank's block of the sequence, then gathered
        lora = tp.gather_seq(torch.tanh(tp.block(xw, 1)
                                        @ params["w_lora_a"]))
    log_w = -torch.exp(w0 + lora @ params["w_lora_b"]).reshape(b, s, h, hd)
    pad = (-s) % rwkv_cfg.chunk
    if pad:
        r, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (r, k, v, log_w))
    y, _ = _wkv6_chunked(r, k, v, log_w, params["u_bonus"], rwkv_cfg.chunk)
    y = rmsnorm(ln_x, y[:, :s].reshape(b, s, d), tp=tp) * g
    y = linear(params["wo"], y)
    return (y if tp is None else tp.scatter_seq(y)), None


def _time_mix_step(params, x, rwkv_cfg, last, wkv, tp=None):
    """The time-mix of one decode token (x [B,1,d], this rank's rows;
    last [B,1,d], the token before it; both whole) over the WKV state
    (`wkv`): one step, y = r . (u k v^T + state), state' = diag(w) state
    + k v^T. Returns (out [B,1,d], the new WKV state). tp: the decode
    group on a mesh: `wkv` is the rank's block of heads, and the rank
    projects its heads (its columns of wr, wk, wv, wg and w_lora_b, its
    rows of u_bonus, its channels of w0 and ln_x, whose sum of squares
    over d_model is all-reduced); its rows of wo give a partial output
    summed over the group."""
    b, _, d = x.shape
    hd = rwkv_cfg.head_dim
    h = d // hd
    w0, ln_x = params["w0"], params["ln_x"]
    if tp is not None:
        if not tp.divides(h):
            raise ValueError(f"rwkv6: {h} heads do not split over "
                             f"{tp.size} {tp.axis!r} ranks")
        h, d = h // tp.size, d // tp.size
        w0, ln_x = tp.block(w0, -1), {"scale": tp.block(ln_x["scale"], -1)}
    if wkv.shape[-3] != h:
        raise ValueError(f"rwkv6: a WKV state block of {wkv.shape[-3]} "
                         f"heads, not {h}")
    xr, xk, xv, xw, xg = (_token_shift(x, params[f"mix_{n}"], last)
                          for n in "rkvwg")
    r = linear(params["wr"], xr).reshape(b, h, hd)
    k = linear(params["wk"], xk).reshape(b, h, hd)
    v = linear(params["wv"], xv).reshape(b, h, hd)
    g = F.silu(linear(params["wg"], xg))
    log_w = -torch.exp(w0 + torch.tanh(xw @ params["w_lora_a"])
                       @ params["w_lora_b"]).reshape(b, h, hd)
    u = params["u_bonus"]
    state = wkv.to(r.dtype)
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    y = torch.einsum("bhd,bhde->bhe", r, u[None, :, :, None] * kv + state)
    state = state * torch.exp(log_w)[..., None] + kv
    y = rmsnorm(ln_x, y[:, None].reshape(b, 1, d), tp=tp) * g
    if tp is not None:
        return tp.row_linear(params["wo"], y), state
    return linear(params["wo"], y), state


def rwkv6_channel_mix(params, x, cache_last=None, tp=None):
    """The channel mix of x [B,S,d] (cache_last: the token before x[:, 0],
    None for zero). tp: x and the result are this rank's blocks of the
    sequence (whole in decode), wck its columns of d_ff and wcv its
    rows."""
    if tp is not None and not tp.whole:
        return tp.scatter_seq(rwkv6_channel_mix(params, tp.gather_seq(x)))
    xk = _token_shift(x, params["cmix_k"], cache_last)
    k = torch.square(F.relu(linear(params["wck"], xk)))
    if tp is not None:
        return tp.row_linear(params["wcv"], k)
    return linear(params["wcv"], k)


def rwkv6_decode(params, x, rwkv_cfg, cache, tp=None):
    """One decode token of a layer (time-mix then channel-mix, each with
    its residual; x [B,1,d], this rank's rows; S > 1 raises ValueError)
    over the cache. Returns (out, the new {shift_t, wkv, shift_c};
    shift_c is the token after the time-mix residual). tp: the decode
    group on a mesh, whose rank holds its block of the WKV state's heads
    and of the token shifts' channels (the shifts are gathered whole, one
    token's activations) and runs its heads and its block of d_ff."""
    b, s, d = x.shape
    if s != 1:
        raise ValueError(f"rwkv6: a cached call takes one token, got S = "
                         f"{s}")

    db = d if tp is None else d // tp.size
    if (cache["shift_t"].shape[-1], cache["shift_c"].shape[-1]) != (db, db):
        raise ValueError(f"rwkv6: token shift blocks of "
                         f"{cache['shift_t'].shape[-1]} channels, not {db}")

    def whole(last):
        return last if tp is None else tp.gather(last, 2)

    def mine(t):
        return t if tp is None else tp.block(t, 2)

    y, state = _time_mix_step(params, x, rwkv_cfg, whole(cache["shift_t"]),
                              cache["wkv"], tp)
    xc = x + y
    out = xc + rwkv6_channel_mix(params, xc, whole(cache["shift_c"]), tp)
    return out, {"shift_t": mine(x), "wkv": state, "shift_c": mine(xc)}


def init_rwkv6_cache(batch, d_model, rwkv_cfg, dtype=torch.float32,
                     device=None, stack=()):
    hd = rwkv_cfg.head_dim
    h = d_model // hd
    kw = dict(dtype=dtype, device=device)
    return {
        "shift_t": torch.zeros((*stack, batch, 1, d_model), **kw),
        "shift_c": torch.zeros((*stack, batch, 1, d_model), **kw),
        "wkv": torch.zeros((*stack, batch, h, hd, hd), **kw),
    }
