"""K2: k-tiled SELL-C-σ SpMM — the CUDA kernel's wrapper and its plain version.

Replaces the Pallas kernel `sell_spmm_ktiled` (body `_sell_spmm_kernel`) of
src/repro/kernels/sell_spmm/kernel.py. The kernel and its note are in
repro_torch/csrc/spmv_kernels.cu (`sell_spmm_kernel`). The plain version is
K1's: the SpMV oracle already carries a trailing vector axis.
"""
from __future__ import annotations

import torch

from ...core.spmv.ref import spmv_sell as sell_spmm_plain  # noqa: F401
from .. import LAUNCHES, _build


def pick_k_tile(k: int) -> int:
    """Columns per thread block: a power of two in [8, 32] covering k.

    8 is a quarter warp, so even k=8 fills warps with whole rows; 32 keeps
    a warp's x loads on one row and 8 rows per 256-thread block. (The TPU's
    128-lane cap does not apply on this card.)
    """
    kt = 8
    while kt < min(max(int(k), 1), 32):
        kt *= 2
    return kt


def sell_spmm(chunk_vals: torch.Tensor, chunk_cols: torch.Tensor,
              chunk_slice: torch.Tensor, slice_ptr: torch.Tensor,
              x: torch.Tensor, num_slices: int, kt: int) -> torch.Tensor:
    """y[S, C, k] = SELL(chunk_vals, chunk_cols) @ x[n, k], slice order,
    k-tiled by kt columns per thread block. No k padding: the kernel masks
    the ragged tile. CPU tensors take the plain version."""
    if not x.is_cuda:
        return sell_spmm_plain(chunk_vals, chunk_cols, chunk_slice, x,
                               num_slices)
    t, c, w = chunk_vals.shape
    if x.dim() != 2 or slice_ptr.numel() != num_slices + 1:
        raise ValueError(f"sell_spmm: x must be [n, k] and slice_ptr "
                         f"[{num_slices + 1}], got {tuple(x.shape)} and "
                         f"{tuple(slice_ptr.shape)}")
    if kt not in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        raise ValueError(f"sell_spmm: kt must be a power of two <= 256, "
                         f"got {kt}")
    _build.check("sell_spmm", x.dtype, x.device, vals=chunk_vals,
                 cols_i32=chunk_cols, ptr_i64=slice_ptr, x=x)
    k = x.shape[1]
    y = torch.empty((num_slices, c, k), dtype=x.dtype, device=x.device)
    _build.launch("sell_spmm", x.dtype,
                  (chunk_vals, chunk_cols, slice_ptr, x, y),
                  (num_slices, c, w, k, kt))
    LAUNCHES["sell_spmm"] += 1
    return y
