"""K5: one fused Mamba2 SSD chunk — the CUDA kernel's wrapper and its plain
version.

Replaces the Pallas kernel `ssd_chunk` (body `_ssd_chunk_kernel`) of
src/repro/kernels/ssd_chunk/kernel.py. The kernel and its note are in
repro_torch/csrc/ssd_chunk.cu. Forward only, as the TPU kernel: it serves
the prefill; training keeps the plain path.
"""
from __future__ import annotations

import torch

from .. import LAUNCHES, _build

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def smem_bytes(t: int, n: int, p: int) -> int:
    """Shared memory the kernel stages for a chunk of T steps (f32): cum [T],
    B and C [T][N+1], xw [T][P], the state [N][P] and the scores [T][T+1].
    The launcher takes this size as it is; the layout is ssd_chunk.cu's."""
    return 4 * (t + 2 * t * (n + 1) + t * p + n * p + t * (t + 1))


def ssd_chunk_plain(la, xw, b_mat, c_mat, state):
    """Same contract as ssd_chunk, in torch ops (port of the reference's
    ssd_chunk_ref); f32 arithmetic, outputs in xw's and state's types."""
    cum = torch.cumsum(la.float(), dim=1)                     # [B,T,H]
    t = la.shape[1]
    tri = torch.ones(t, t, dtype=torch.bool, device=la.device).tril()
    expo = cum[:, :, None, :] - cum[:, None, :, :]            # [B,T,T,H]
    dec = torch.exp(torch.where(tri[None, :, :, None], expo, -1e30))
    bf, cf = b_mat.float(), c_mat.float()
    xwf, stf = xw.float(), state.float()
    cb = torch.einsum("btn,bin->bti", cf, bf)                 # [B,T,T]
    y = torch.einsum("btih,bihp->bthp", cb[..., None] * dec, xwf)
    y = y + torch.exp(cum)[..., None] * torch.einsum("btn,bhnp->bthp",
                                                     cf, stf)
    dec_end = torch.exp(cum[:, -1:, :] - cum)                 # [B,T,H]
    sout = stf * torch.exp(cum[:, -1, :])[..., None, None] + torch.einsum(
        "btnh,bthp->bhnp", bf[..., None] * dec_end[:, :, None, :], xwf)
    return y.to(xw.dtype), sout.to(state.dtype)


def ssd_chunk(la, xw, b_mat, c_mat, state, out=None):
    """One SSD chunk for all (batch, head) pairs.

    la [B,T,H] f32 log decay; xw [B,T,H,P]; b_mat, c_mat [B,T,N];
    state [B,H,N,P] incoming state; xw, b, c and state in one compute type
    (float32 or bfloat16). Returns (y [B,T,H,P], state_out [B,H,N,P]); y is
    written into `out` when given. la, xw, b, c and out may be views with
    any batch stride (a chunk of a longer sequence); the rest is packed.

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise.
    """
    if not xw.is_cuda:
        y, sout = ssd_chunk_plain(la, xw, b_mat, c_mat, state)
        if out is None:
            return y, sout
        out.copy_(y)
        return out, sout
    bsz, t, h = la.shape
    p, n = xw.shape[-1], b_mat.shape[-1]
    want = {"xw": (bsz, t, h, p), "b_mat": (bsz, t, n),
            "c_mat": (bsz, t, n), "state": (bsz, h, n, p)}
    got = {"xw": xw, "b_mat": b_mat, "c_mat": c_mat, "state": state}
    if out is not None:
        want["out"], got["out"] = want["xw"], out
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"ssd_chunk: {key} must be {list(shape)}, got "
                             f"{list(got[key].shape)}")
    if b_mat.stride(0) != c_mat.stride(0):
        raise ValueError("ssd_chunk: b_mat and c_mat must share a batch "
                         "stride")
    smem = smem_bytes(t, n, p)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk: a chunk of T={t}, N={n}, P={p} needs "
                         f"{smem} B of shared memory, over the {SMEM_LIMIT} B "
                         f"one block may use")
    y = torch.empty(want["xw"], dtype=xw.dtype, device=xw.device) \
        if out is None else out
    _build.check("ssd_chunk", xw.dtype, xw.device,
                 batch_strided=("la_f32", "xw", "b", "c", "y"), la_f32=la,
                 xw=xw, b=b_mat, c=c_mat, state=state, y=y)
    sout = torch.empty_like(state)
    _build.launch("ssd_chunk", xw.dtype,
                  (la, xw, b_mat, c_mat, state, y, sout),
                  (bsz, t, h, n, p, la.stride(0), xw.stride(0),
                   b_mat.stride(0), y.stride(0), smem))
    LAUNCHES["ssd_chunk"] += 1
    return y, sout
