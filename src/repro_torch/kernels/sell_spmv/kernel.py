"""K1: SELL-C-σ SpMV — the CUDA kernel's wrapper and its plain torch version.

Replaces the Pallas kernel `sell_spmm` (body `_sell_kernel`) of
src/repro/kernels/sell_spmv/kernel.py. The kernel itself, and the note on
what bounds it and what its design does about that, are in
repro_torch/csrc/spmv_kernels.cu (`sell_spmv_kernel`, one warp per slice
with 16-byte loads, or `sell_spmv_rows_kernel` for the shapes it does not
take; launched by `sell_spmv_f32` / `_f64` / `_bf16`).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.spmv.ref import spmv_sell as sell_spmv_plain  # noqa: F401
from .. import LAUNCHES, _build


def slice_chunk_ptr(chunk_slice: np.ndarray, num_slices: int) -> np.ndarray:
    """int64[S + 1]: the chunks of slice s are ptr[s] .. ptr[s + 1] (host
    side, once per operator: chunk_slice is nondecreasing)."""
    return np.searchsorted(np.asarray(chunk_slice),
                           np.arange(num_slices + 1)).astype(np.int64)


def sell_spmv(chunk_vals: torch.Tensor, chunk_cols: torch.Tensor,
              chunk_slice: torch.Tensor, slice_ptr: torch.Tensor,
              x: torch.Tensor, num_slices: int) -> torch.Tensor:
    """y[S, C, nv] = SELL(chunk_vals, chunk_cols) @ x[n, nv], slice order.

    CPU tensors take the plain version (chunk_slice + index_add_); CUDA
    tensors launch the kernel (slice_ptr), or raise.
    """
    if not x.is_cuda:
        return sell_spmv_plain(chunk_vals, chunk_cols, chunk_slice, x,
                               num_slices)
    t, c, w = chunk_vals.shape
    if x.dim() != 2 or slice_ptr.numel() != num_slices + 1:
        raise ValueError(f"sell_spmv: x must be [n, nv] and slice_ptr "
                         f"[{num_slices + 1}], got {tuple(x.shape)} and "
                         f"{tuple(slice_ptr.shape)}")
    _build.check("sell_spmv", x.dtype, x.device, vals=chunk_vals,
                 cols_i32=chunk_cols, ptr_i64=slice_ptr, x=x)
    nv = x.shape[1]
    y = torch.empty((num_slices, c, nv), dtype=x.dtype, device=x.device)
    _build.launch("sell_spmv", x.dtype,
                  (chunk_vals, chunk_cols, slice_ptr, x, y),
                  (num_slices, c, w, nv))
    LAUNCHES["sell_spmv"] += 1
    return y
