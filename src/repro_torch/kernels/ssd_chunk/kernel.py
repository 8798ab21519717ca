"""K5: the Mamba2 SSD over a sequence, one launch per layer — the CUDA
kernel's wrapper and its plain version.

Replaces the Pallas kernel `ssd_chunk` (body `_ssd_chunk_kernel`) of
src/repro/kernels/ssd_chunk/kernel.py, and the reference's scan of it over
the chunks of a sequence. The kernel and its note are in
repro_torch/csrc/ssd_chunk.cu: at N = P = 64 `ssd_scan_tc_kernel` (bf16)
and `ssd_scan_tf32_kernel` (f32, three TF32 products per product) on the
tensor cores, `ssd_scan_simt_kernel` on the CUDA cores for the other
shapes. Forward only, as the TPU kernel: it serves the
prefill and the forward of a train step, whose gradient comes from the
plain scan (models/layers/mamba2.py `SSDScan`).
"""
from __future__ import annotations

import torch

from .. import LAUNCHES, _build

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def tensor_core_shape(t: int, n: int, p: int, dtype) -> bool:
    """True when the shape takes a tensor-core body (N = P = 64, T a multiple
    of 16 up to 128; bf16 products in bf16, f32 ones in three TF32
    products); the kernel also needs 16-byte aligned operands and otherwise
    takes the CUDA-core body."""
    return (dtype in (torch.float32, torch.bfloat16) and n == 64 and p == 64
            and t % 16 == 0 and 16 <= t <= 128)


def smem_bytes(t: int, n: int, p: int, dtype=torch.float32) -> int:
    """Shared memory of the body a chunk of T steps takes; the layouts are
    ssd_chunk.cu's. bf16 tensor-core body: C, B and xw twice (the current
    and the next chunk) as bf16 rows of 64, the state [N][64], the cumsum
    twice and the state update's decays. f32 tensor-core body: C, B and xw
    once as f32 rows of 64, the state, the cumsum and the decays. CUDA-core
    body, f32: cum [T], B and C [T][N+1], xw [T][P], the state [N][P] and
    the scores [T][T+1]."""
    if tensor_core_shape(t, n, p, dtype):
        if dtype == torch.bfloat16:
            return 2 * (3 * 2 * t * 64 + 64 * 64) + 4 * 3 * t
        return 4 * (3 * t * 64 + 64 * 64) + 4 * 2 * t
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


def ssd_scan_plain(la, xw, b_mat, c_mat, state0, chunk: int):
    """The plain version of the sequence kernel: ssd_chunk_plain chunk by
    chunk, the state carried (and rounded to its type) between chunks, as
    the reference's scan carries it."""
    s = la.shape[1]
    y = torch.empty(xw.shape, dtype=xw.dtype, device=xw.device)
    state = state0
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        y[:, sl], state = ssd_chunk_plain(la[:, sl], xw[:, sl], b_mat[:, sl],
                                          c_mat[:, sl], state)
    return y, state


def check_sequence(la, xw, b_mat, c_mat, state, chunk: int, out=None):
    """Raise unless the operands fit the sequence kernel: the shapes below,
    S a multiple of `chunk`, one compute type (float32 or bfloat16) with
    la in float32, every tensor on one device, packed past the batch dim
    (la, xw, b, c and out) or packed (state), and a chunk whose shared
    memory fits one block."""
    if la.dim() != 3:
        raise ValueError(f"ssd_scan: la must be [B, S, H], got "
                         f"{list(la.shape)}")
    bsz, s, h = la.shape
    if xw.dim() != 4 or b_mat.dim() != 3:
        raise ValueError(f"ssd_scan: xw must be [B, S, H, P] and b_mat "
                         f"[B, S, N], got {list(xw.shape)} and "
                         f"{list(b_mat.shape)}")
    p, n = xw.shape[-1], b_mat.shape[-1]
    want = {"xw": (bsz, s, h, p), "b_mat": (bsz, s, n),
            "c_mat": (bsz, s, n), "state": (bsz, h, n, p)}
    got = {"xw": xw, "b_mat": b_mat, "c_mat": c_mat, "state": state}
    if out is not None:
        want["out"], got["out"] = want["xw"], out
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"ssd_scan: {key} must be {list(shape)}, got "
                             f"{list(got[key].shape)}")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"ssd_scan: sequence {s} does not divide by chunk "
                         f"{chunk}")
    if b_mat.stride(0) != c_mat.stride(0):
        raise ValueError("ssd_scan: b_mat and c_mat must share a batch "
                         "stride")
    smem = smem_bytes(chunk, n, p, xw.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: a chunk of T={chunk}, N={n}, P={p} "
                         f"needs {smem} B of shared memory, over the "
                         f"{SMEM_LIMIT} B one block may use")
    extra = {} if out is None else {"y": out}
    _build.check("ssd_scan", xw.dtype, xw.device,
                 batch_strided=("la_f32", "xw", "b", "c", "y"), la_f32=la,
                 xw=xw, b=b_mat, c=c_mat, state=state, **extra)


def ssd_sequence(la, xw, b_mat, c_mat, state, chunk: int, out=None):
    """The SSD over a whole sequence in chunks of `chunk` steps, one launch.

    la [B,S,H] f32 log decay; xw [B,S,H,P]; b_mat, c_mat [B,S,N]; state
    [B,H,N,P] incoming state; xw, b, c and state in one compute type
    (float32 or bfloat16); S a multiple of `chunk`. Returns (y [B,S,H,P],
    final state [B,H,N,P]); y is written into `out` when given. The state is
    rounded to its type at every chunk boundary, as ssd_scan_plain rounds
    it.

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise. Shapes are checked before either.
    """
    if not xw.is_cuda:
        check_sequence(la, xw, b_mat, c_mat, state, chunk)
        y, sout = ssd_scan_plain(la, xw, b_mat, c_mat, state, chunk)
        if out is None:
            return y, sout
        out.copy_(y)
        return out, sout
    y = torch.empty(xw.shape, dtype=xw.dtype, device=xw.device) \
        if out is None else out
    check_sequence(la, xw, b_mat, c_mat, state, chunk, out=y)
    bsz, s, h = la.shape
    p, n = xw.shape[-1], b_mat.shape[-1]
    sout = torch.empty_like(state)
    _build.launch("ssd_scan", xw.dtype,
                  (la, xw, b_mat, c_mat, state, y, sout),
                  (bsz, s, chunk, h, n, p, la.stride(0), xw.stride(0),
                   b_mat.stride(0), y.stride(0)))
    LAUNCHES["ssd_chunk"] += 1
    return y, sout


def ssd_chunk(la, xw, b_mat, c_mat, state, out=None):
    """One SSD chunk for all (batch, head) pairs: the sequence kernel with
    S = T.

    la [B,T,H] f32 log decay; xw [B,T,H,P]; b_mat, c_mat [B,T,N];
    state [B,H,N,P] incoming state; xw, b, c and state in one compute type
    (float32 or bfloat16). Returns (y [B,T,H,P], state_out [B,H,N,P]); y is
    written into `out` when given. la, xw, b, c and out may be views with
    any batch stride (a chunk of a longer sequence); the rest is packed.

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise.
    """
    return ssd_sequence(la, xw, b_mat, c_mat, state, la.shape[1], out=out)
