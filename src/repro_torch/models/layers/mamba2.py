"""Mamba2 (SSD) block — chunked state-space dual form [Dao & Gu 2024].

Prefill: the sequence is padded to a multiple of `chunk` and scanned by
`ssd_scan`, one launch of the fused K5 kernel per layer on the card (81 for
the Zamba2-7B prefill), which walks the chunks itself. Training goes
through the same forward; the SSD's gradient comes from the plain scan
(`SSDScan`). Decode: the O(1) recurrent state update, in torch ops, one
body on one device and on a mesh.

As in the reference: a single B/C group, a scalar A per head, a causal conv
of width 4. State cache = (conv_state [B, W-1, d_conv_ch], ssm_state
[B, H, N, P]). Decode on a mesh (`mamba2_block(tp=)` with a cache) is
tensor-parallel over "model": a rank holds the conv state's block of
channels and the SSM state's block of heads, and its blocks of the
weights as stored (`_decode_step`).

Tensor-parallel (`mamba2_block(tp=)`, train and prefill on a mesh): each
rank runs its block of the heads over the whole sequence, which it
gathers. in_proj packs [z | x | B | C | dt] and conv_w [x | B | C], so the
reference's contiguous "model" split of those columns does not follow the
heads: the two are gathered whole and the rank takes its heads' columns
of z, x and dt, and B and C whole (every head reads them). a_log, dt_bias,
d_skip, the gated norm's scale and out_proj's rows are split by heads as
stored; the gated norm over d_inner all-reduces its sum of squares, and
out_proj's partial sums are reduce-scattered back to the sequence blocks.
The SSD (K5 on the card) runs on the rank's heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...distributed import sharding as SH
from ...kernels.ssd_chunk.kernel import ssd_scan_plain
from ...kernels.ssd_chunk.ops import ssd_scan
from .common import init_linear, init_rmsnorm, linear, normal, rmsnorm


def init_mamba2(gen, d_model, ssm_cfg, dtype=torch.float32, stack=()):
    d_inner = ssm_cfg.expand * d_model
    n, p = ssm_cfg.d_state, ssm_cfg.head_dim
    h = d_inner // p
    conv_ch = d_inner + 2 * n  # conv over [x, B, C]
    dev = gen.device
    conv_w = normal(gen, (*stack, ssm_cfg.conv_width, conv_ch),
                    dtype).mul_(0.1)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=dtype, device=dev))
    return {
        # in_proj -> [z, x, B, C, dt]
        "in_proj": init_linear(gen, d_model, 2 * d_inner + 2 * n + h, False,
                               dtype, stack=stack),
        "conv_w": conv_w,
        "conv_b": torch.zeros((*stack, conv_ch), dtype=dtype, device=dev),
        "a_log": a_log.expand(*stack, h).clone(),
        "dt_bias": torch.zeros((*stack, h), dtype=dtype, device=dev),
        "d_skip": torch.ones((*stack, h), dtype=dtype, device=dev),
        "norm": init_rmsnorm(gen, d_inner, dtype, stack=stack),
        "out_proj": init_linear(gen, d_inner, d_model, False, dtype,
                                stack=stack),
    }


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """xbc [B,S,C]; depthwise causal conv of width W. Returns (y, state)."""
    w = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], w - 1, xbc.shape[2]))
    else:
        pad = conv_state
    xp = torch.cat([pad, xbc], dim=1)  # [B, S+W-1, C]
    s = xbc.shape[1]
    y = sum(xp[:, i:i + s] * conv_w[i] for i in range(w)) + conv_b
    return F.silu(y), xp[:, -(w - 1):]


def _discretize(xh, dt, a_log):
    """(la [B,S,H] f32 log decay, xw [B,S,H,P] discretized input in xh's
    type), as the reference prepares them for the SSD."""
    la = -torch.exp(a_log.float()) * dt.float()
    return la, xh * dt[..., None].to(xh.dtype)


def _mix(params, x, ssm_cfg):
    """in_proj, dt and the causal conv from the zero state: (z, xh
    [B,S,H,P], dt [B,S,H], b_mat, c_mat [B,S,N], the conv state)."""
    b, s, d = x.shape
    d_inner = ssm_cfg.expand * d
    n, p = ssm_cfg.d_state, ssm_cfg.head_dim
    h = d_inner // p
    zxbcdt = linear(params["in_proj"], x)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, h], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])                    # [B,S,H]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs, b_mat, c_mat = torch.split(xbc, [d_inner, n, n], dim=-1)
    return z, xs.reshape(b, s, h, p), dt, b_mat, c_mat, new_conv


class SSDScan(torch.autograd.Function):
    """ssd_scan with a gradient. The forward is ssd_scan's own: K5 on CUDA
    tensors under "auto", the plain scan on CPU tensors or under "ref".
    The backward recomputes the plain chunked scan (ssd_scan_plain) in
    torch ops under autograd and returns that graph's vector-Jacobian
    product: the reference's own gradient, autodiff of its jnp scan
    `_ssd_chunked`, since K5, like the TPU kernel it replaces, has no
    backward. Only the inputs are kept for backward."""

    @staticmethod
    def forward(ctx, la, xw, b_mat, c_mat, state0, chunk, use_kernel):
        ctx.save_for_backward(la, xw, b_mat, c_mat, state0)
        ctx.chunk = chunk
        return ssd_scan(la, xw, b_mat, c_mat, state0, chunk=chunk,
                        use_kernel=use_kernel)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            outs = ssd_scan_plain(*inputs, ctx.chunk)
            grads = iter(torch.autograd.grad(
                outs, [t for t, n in zip(inputs, needs) if n],
                (grad_y, grad_state)))
        return (*(next(grads) if n else None for n in needs), None, None)


def _ssd_chunked(xh, dt, a_log, b_mat, c_mat, chunk, init_state=None,
                 use_kernel="auto"):
    """SSD over a padded sequence. xh [B,S,H,P], dt [B,S,H], b/c [B,S,N].
    Returns (y [B,S,H,P], final_state [B,H,N,P]).

    The log decay is f32 and the discretized input is in xh's type, as the
    reference prepares them; ssd_scan then runs K5 once over all chunks
    (SSDScan, which gives it a gradient)."""
    b, s, h, p = xh.shape
    n = b_mat.shape[-1]
    la, xw = _discretize(xh, dt, a_log)
    s0 = (xh.new_zeros((b, h, n, p)) if init_state is None
          else init_state.to(xh.dtype).contiguous())
    return SSDScan.apply(la, xw, b_mat.contiguous(), c_mat.contiguous(), s0,
                         chunk, use_kernel)


def mamba2_block(params, x, ssm_cfg, cache=None, use_kernel="auto",
                 tp=None):
    """x [B,S,d]. cache None (prefill from the zero state) or {conv, ssm}
    for decode (S = 1; ValueError otherwise; `_decode_step`). Returns (y,
    new_cache_or_None). tp: the tensor-parallel group on a mesh. In train
    and prefill (no cache) x and y are this rank's blocks of the sequence
    and the rank runs its heads (see the module docstring); in decode x
    and y are whole, and the cache holds the rank's blocks of the conv
    channels and of the SSM heads.

    No residual here: the model adds none around this block."""
    if cache is not None:
        return _decode_step(params, x, ssm_cfg, cache, tp)
    if tp is not None:
        x = tp.gather_seq(x)
    b, s, d = x.shape
    d_inner = ssm_cfg.expand * d
    if tp is None:
        z, xh, dt, b_mat, c_mat, _ = _mix(params, x, ssm_cfg)
    else:
        z, xh, dt, b_mat, c_mat = _tp_mix(params, x, ssm_cfg, tp)
        d_inner //= tp.size
    pad = (-s) % ssm_cfg.chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    y, _ = _ssd_chunked(xh, dt, params["a_log"], b_mat, c_mat,
                        ssm_cfg.chunk, use_kernel=use_kernel)
    y = y[:, :s] + xh[:, :s] * params["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_inner)
    y = rmsnorm(params["norm"], y * F.silu(z), tp=tp)            # gated norm
    y = linear(params["out_proj"], y)
    return (y if tp is None else tp.scatter_seq(y)), None


def _tp_mix(params, x, ssm_cfg, tp):
    """_mix on this rank's heads (x [B,S,d] the whole sequence; in_proj,
    conv_w and conv_b whole, dt_bias the rank's heads): (z, xh [B,S,H/M,P],
    dt [B,S,H/M], b_mat, c_mat [B,S,N] whole)."""
    b, s, d = x.shape
    d_inner = ssm_cfg.expand * d
    n, p = ssm_cfg.d_state, ssm_cfg.head_dim
    h = d_inner // p
    if not tp.divides(h):
        raise ValueError(f"mamba2: {h} heads do not split over {tp.size} "
                         f"{tp.axis!r} ranks")
    hb, db = h // tp.size, d_inner // tp.size

    def span(lo, size):
        return torch.arange(lo, lo + size, device=x.device)

    mine = span(tp.rank * db, db)
    bc = span(d_inner, 2 * n)
    cols = torch.cat([mine, d_inner + mine, d_inner + bc,
                      span(2 * d_inner + 2 * n + tp.rank * hb, hb)])
    w = params["in_proj"]["w"].index_select(-1, cols)
    z, xbc, dt = torch.split(x @ w, [db, db + 2 * n, hb], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])                    # [B,S,H/M]
    ch = torch.cat([mine, bc])
    xbc, _ = _causal_conv(xbc, params["conv_w"].index_select(-1, ch),
                          params["conv_b"].index_select(-1, ch))
    xs, b_mat, c_mat = torch.split(xbc, [db, n, n], dim=-1)
    return z, xs.reshape(b, s, hb, p), dt, b_mat, c_mat


def _decode_step(params, x, ssm_cfg, cache, tp=None):
    """One decode token (x [B,1,d], this rank's rows, whole) over the
    cache: the depthwise conv and the O(1) recurrence. Returns (out
    [B,1,d], the new {conv, ssm}).

    tp: the decode group on a mesh, whose rank holds its block of the
    conv state's channels and of the SSM state's heads (cache_specs split
    both over "model"), and its blocks of every weight as stored. Its
    column block of in_proj's output is regrouped over the group
    (`sharding.regroup_last`: each rank receives its block of z, of the
    conv's input and of dt); the conv runs on its channels and its output
    ([B,1,C], whose x part the heads read and whose B and C every head
    reads) is gathered; the recurrence, the D skip and the gated norm run
    on its heads (the norm's sum of squares all-reduced), and its rows of
    out_proj give a partial output summed over the group."""
    b, s, d = x.shape
    if s != 1:
        raise ValueError(f"mamba2: a decode step takes one token, got "
                         f"S = {s}")
    d_inner = ssm_cfg.expand * d
    n, p = ssm_cfg.d_state, ssm_cfg.head_dim
    h = d_inner // p
    parts = [d_inner, d_inner + 2 * n, h]
    zxbcdt = linear(params["in_proj"], x)
    if tp is not None:
        if not all(tp.divides(k) for k in parts):
            raise ValueError(f"mamba2: d_inner {d_inner}, {d_inner + 2 * n} "
                             f"conv channels and {h} heads do not all split "
                             f"over {tp.size} {tp.axis!r} ranks")
        zxbcdt = SH.regroup_last(zxbcdt, parts, tp.axis, tp.mesh)
        parts = [k // tp.size for k in parts]
    got = (cache["conv"].shape[-1], cache["ssm"].shape[-3])
    if got != (parts[1], parts[2]):
        raise ValueError(f"mamba2: a cache block of {got[0]} conv channels "
                         f"and {got[1]} SSM heads, not {parts[1]} and "
                         f"{parts[2]}")
    z, xbc, dt = torch.split(zxbcdt, parts, dim=-1)
    dt = F.softplus(dt + params["dt_bias"])                    # [B,1,Hb]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 cache["conv"])
    if tp is not None:
        xbc = tp.gather(xbc, 2)
    xs, b_mat, c_mat = torch.split(xbc, [d_inner, n, n], dim=-1)
    hb, db = parts[2], parts[0]
    hl = 0 if tp is None else tp.rank * hb
    xh = xs.reshape(b, 1, h, p)[:, :, hl:hl + hb]
    la, xw = _discretize(xh[:, 0], dt[:, 0], params["a_log"])
    a = torch.exp(la)                                          # [B,Hb]
    state = cache["ssm"]
    state = state * a[..., None, None].to(state.dtype) + \
        torch.einsum("bn,bhp->bhnp", b_mat[:, 0], xw)
    y = torch.einsum("bn,bhnp->bhp", c_mat[:, 0], state)[:, None]
    y = y + xh * params["d_skip"][None, None, :, None]         # D skip
    y = y.reshape(b, 1, db)
    y = rmsnorm(params["norm"], y * F.silu(z), tp=tp)           # gated norm
    y = (linear(params["out_proj"], y) if tp is None
         else tp.row_linear(params["out_proj"], y))
    return y, {"conv": new_conv, "ssm": state}


def init_mamba2_cache(batch, d_model, ssm_cfg, dtype=torch.float32,
                      device=None, stack=()):
    d_inner = ssm_cfg.expand * d_model
    n, p = ssm_cfg.d_state, ssm_cfg.head_dim
    h = d_inner // p
    conv_ch = d_inner + 2 * n
    return {
        "conv": torch.zeros((*stack, batch, ssm_cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((*stack, batch, h, n, p), dtype=dtype,
                           device=device),
    }
