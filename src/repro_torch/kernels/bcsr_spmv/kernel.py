"""K3: BCSR SpMV/SpMM — the CUDA kernel's wrapper and its plain torch version.

Replaces the Pallas kernel `bcsr_spmm` (body `_bcsr_kernel`) of
src/repro/kernels/bcsr_spmv/kernel.py. The kernel and its note are in
repro_torch/csrc/spmv_kernels.cu: `bcsr_spmv_kernel`, one warp per block
row with 16-byte loads (the body K4 uses, over the row pointer's blocks),
or `bcsr_spmv_rows_kernel` for nv > 1 and the other shapes it does not
take.
"""
from __future__ import annotations

import torch

from ...core.spmv.ref import spmv_bcsr as bcsr_spmv_plain  # noqa: F401
from .. import LAUNCHES, _build


def bcsr_spmv(blocks: torch.Tensor, block_rows: torch.Tensor,
              block_cols: torch.Tensor, block_rowptr: torch.Tensor,
              x2d: torch.Tensor, num_block_rows: int) -> torch.Tensor:
    """y[nbr, bm, nv] = BCSR @ x2d[ncb, bn, nv].

    CPU tensors take the plain version (block_rows + index_add_); CUDA
    tensors launch the kernel (block_rowptr), or raise.
    """
    if not x2d.is_cuda:
        return bcsr_spmv_plain(blocks, block_rows, block_cols, x2d,
                               num_block_rows)
    t, bm, bn = blocks.shape
    if x2d.dim() != 3 or x2d.shape[1] != bn \
            or block_rowptr.numel() != num_block_rows + 1:
        raise ValueError(f"bcsr_spmv: x2d must be [ncb, {bn}, nv] and "
                         f"block_rowptr [{num_block_rows + 1}], got "
                         f"{tuple(x2d.shape)} and {tuple(block_rowptr.shape)}")
    _build.check("bcsr_spmv", x2d.dtype, x2d.device, blocks=blocks,
                 cols_i32=block_cols, rowptr_i64=block_rowptr, x=x2d)
    nv = x2d.shape[2]
    y = torch.empty((num_block_rows, bm, nv), dtype=x2d.dtype,
                    device=x2d.device)
    _build.launch("bcsr_spmv", x2d.dtype,
                  (blocks, block_cols, block_rowptr, x2d, y),
                  (num_block_rows, bm, bn, nv))
    LAUNCHES["bcsr_spmv"] += 1
    return y
