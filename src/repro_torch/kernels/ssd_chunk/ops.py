"""Full-sequence SSD over chunks, one K5 launch per chunk (forward only:
serving and prefill). The counterpart of the reference's `lax.scan` over
`ssd_chunk` in kernels/ssd_chunk/ops.py."""
from __future__ import annotations

import torch

from ...device import check_use_kernel, wants_plain
from .kernel import ssd_chunk, ssd_chunk_plain


def ssd_scan(la, xw, b_mat, c_mat, state0, chunk: int = 128,
             use_kernel: str = "auto"):
    """la [B,S,H] f32; xw [B,S,H,P]; b/c [B,S,N]; state0 [B,H,N,P].
    Returns (y [B,S,H,P], final state). S must divide by `chunk`.

    use_kernel "auto" launches K5 on CUDA tensors and runs the plain version
    on CPU tensors; "ref" runs the plain version anywhere; "cuda" insists on
    the kernel."""
    check_use_kernel(use_kernel)
    bsz, s, h = la.shape
    if s % chunk:
        raise ValueError(f"ssd_scan: sequence {s} does not divide by chunk "
                         f"{chunk}")
    plain = wants_plain(use_kernel, xw)
    y = torch.empty(xw.shape, dtype=xw.dtype, device=xw.device)
    state = state0
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (la[:, sl], xw[:, sl], b_mat[:, sl], c_mat[:, sl], state)
        if plain:
            y[:, sl], state = ssd_chunk_plain(*args)
        else:
            _, state = ssd_chunk(*args, out=y[:, sl])
    return y, state
