"""K4: Block-ELL SpMV/SpMM — the CUDA kernel's wrapper and its plain version.

Replaces the Pallas kernel `bell_spmm` (body `_bell_kernel`) of
src/repro/kernels/bell_spmv/kernel.py. The kernel and its note are in
repro_torch/csrc/spmv_kernels.cu (`bell_spmv_kernel`).
"""
from __future__ import annotations

import torch

from ...core.spmv.ref import spmv_bell as bell_spmv_plain  # noqa: F401
from .. import LAUNCHES, _build


def bell_spmv(blocks: torch.Tensor, block_cols: torch.Tensor,
              x2d: torch.Tensor) -> torch.Tensor:
    """y[nbr, bm, nv] = BlockELL(blocks, block_cols) @ x2d[ncb, bn, nv].

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise.
    """
    if not x2d.is_cuda:
        return bell_spmv_plain(blocks, block_cols, x2d)
    nbr, kk, bm, bn = blocks.shape
    if x2d.dim() != 3 or x2d.shape[1] != bn \
            or tuple(block_cols.shape) != (nbr, kk):
        raise ValueError(f"bell_spmv: x2d must be [ncb, {bn}, nv] and "
                         f"block_cols [{nbr}, {kk}], got {tuple(x2d.shape)} "
                         f"and {tuple(block_cols.shape)}")
    _build.check("bell_spmv", x2d.dtype, x2d.device, blocks=blocks,
                 cols_i32=block_cols, x=x2d)
    nv = x2d.shape[2]
    y = torch.empty((nbr, bm, nv), dtype=x2d.dtype, device=x2d.device)
    _build.launch("bell_spmv", x2d.dtype, (blocks, block_cols, x2d, y),
                  (nbr, kk, bm, bn, nv))
    LAUNCHES["bell_spmv"] += 1
    return y
