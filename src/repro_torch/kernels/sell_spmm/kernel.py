"""K2: k-tiled SELL-C-σ SpMM — the CUDA kernel's wrapper and its plain version.

Replaces the Pallas kernel `sell_spmm_ktiled` (body `_sell_spmm_kernel`) of
src/repro/kernels/sell_spmm/kernel.py. The kernel and its note are in
repro_torch/csrc/spmv_kernels.cu (`sell_spmm_kernel`, one warp per slice and
k-tile, the chunk staged in shared memory by 16-byte cp.async loads and each
slot's x tile gathered as 16-byte vectors, or
`sell_spmm_rows_kernel` for the shapes it does not take; launched by
`sell_spmm_f32` / `sell_spmm_f64`). The plain version is K1's: the SpMV
oracle already carries a trailing vector axis.
"""
from __future__ import annotations

import torch

from ...core.spmv.ref import spmv_sell as sell_spmm_plain  # noqa: F401
from .. import LAUNCHES, _build


K_TILES = (8, 16, 32)


def pick_k_tile(k: int) -> int:
    """Columns per k-tile (KT): the smallest of 8, 16 and 32 covering k.

    The kernel's vector body gives each slot KT / kN lanes, one 16-byte x
    vector each (kN = 4 in f32, 2 in f64), so a warp load gathers 32 * kN /
    KT slots; each lane keeps at most KT accumulators. The matrix is staged
    once per k-tile, ceil(k / KT) times: once for k <= 32, twice at k = 64.
    A wider tile would cut the slots per warp load below 4 and take more
    registers. The kernel is compiled for these three widths; at k = 4 the
    second half of an 8-wide tile loads and adds nothing. (The TPU's
    128-lane cap does not apply.)
    """
    kt = K_TILES[0]
    while kt < min(max(int(k), 1), K_TILES[-1]):
        kt *= 2
    return kt


def sell_spmm(chunk_vals: torch.Tensor, chunk_cols: torch.Tensor,
              chunk_slice: torch.Tensor, slice_ptr: torch.Tensor,
              x: torch.Tensor, num_slices: int, kt: int) -> torch.Tensor:
    """y[S, C, k] = SELL(chunk_vals, chunk_cols) @ x[n, k], slice order,
    kt (one of K_TILES) columns per k-tile. No k padding: the kernel masks
    the ragged tile. CPU tensors take the plain version; the shapes and kt
    are checked first on either device."""
    if x.dim() != 2 or slice_ptr.numel() != num_slices + 1:
        raise ValueError(f"sell_spmm: x must be [n, k] and slice_ptr "
                         f"[{num_slices + 1}], got {tuple(x.shape)} and "
                         f"{tuple(slice_ptr.shape)}")
    if kt not in K_TILES:
        raise ValueError(f"sell_spmm: kt must be one of {K_TILES}, got {kt}")
    if not x.is_cuda:
        return sell_spmm_plain(chunk_vals, chunk_cols, chunk_slice, x,
                               num_slices)
    c, w = chunk_vals.shape[1:]
    _build.check("sell_spmm", x.dtype, x.device, vals=chunk_vals,
                 cols_i32=chunk_cols, ptr_i64=slice_ptr, x=x)
    k = x.shape[1]
    y = torch.empty((num_slices, c, k), dtype=x.dtype, device=x.device)
    _build.launch("sell_spmm", x.dtype,
                  (chunk_vals, chunk_cols, slice_ptr, x, y),
                  (num_slices, c, w, k, kt))
    LAUNCHES["sell_spmm"] += 1
    return y
