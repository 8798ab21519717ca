"""sell_matmul: what SellOperator.matmul dispatches to for a 2-D x.

Handles the σ-sort un-permute and the kernel choice. No n or k padding:
the kernel masks the ragged k-tile itself.
"""
from __future__ import annotations

import torch

from ... import obs
from ...device import wants_plain
from .kernel import pick_k_tile, sell_spmm, sell_spmm_plain


def sell_matmul(op, x: torch.Tensor) -> torch.Tensor:
    """y[m, k] = A @ x[n, k] for a SellOperator `op` (kernels/sell_spmv)."""
    k = x.shape[1]
    with obs.span("kernel.spmm", engine="sell", k=int(k), backend="torch",
                  use_kernel=op.use_kernel) as sp:
        x = x.contiguous()
        if wants_plain(op.use_kernel, x):
            y = sell_spmm_plain(op.chunk_vals, op.chunk_cols, op.chunk_slice,
                                x, op.num_slices)
        else:
            kt = pick_k_tile(k)
            sp.set(k_tile=int(kt))
            y = sell_spmm(op.chunk_vals, op.chunk_cols, op.chunk_slice,
                          op.slice_ptr, x, op.num_slices, kt)
        # y is in slice order; inv_perm[r] = slice position of row r
        return y.reshape(-1, k).index_select(0, op.inv_perm)
