"""Full-sequence SSD over chunks, one K5 launch per call (forward only:
the prefill and a train step's forward; `mamba2.SSDScan` gives it a
gradient). The counterpart of the reference's `lax.scan` over
`ssd_chunk` in kernels/ssd_chunk/ops.py."""
from __future__ import annotations

from ...device import check_use_kernel, wants_plain
from .kernel import ssd_scan_plain, ssd_sequence


def ssd_scan(la, xw, b_mat, c_mat, state0, chunk: int = 128,
             use_kernel: str = "auto"):
    """la [B,S,H] f32; xw [B,S,H,P]; b/c [B,S,N]; state0 [B,H,N,P].
    Returns (y [B,S,H,P], final state). S must divide by `chunk`.

    use_kernel "auto" launches K5 once over the whole sequence on CUDA
    tensors and runs the plain version on CPU tensors; "ref" runs the plain
    version (ssd_chunk_plain chunk by chunk) anywhere; "cuda" insists on the
    kernel."""
    check_use_kernel(use_kernel)
    s = la.shape[1]
    if s % chunk:
        raise ValueError(f"ssd_scan: sequence {s} does not divide by chunk "
                         f"{chunk}")
    if wants_plain(use_kernel, xw):
        return ssd_scan_plain(la, xw, b_mat, c_mat, state0, chunk)
    return ssd_sequence(la, xw, b_mat, c_mat, state0, chunk)
