"""BcsrOperator: host BCSR format in, device operator out."""
from __future__ import annotations

import numpy as np
import torch

from ... import obs
from ...core.sparse.bell import BCSR
from ...device import (check_use_kernel, host_array, resolve_device,
                       to_device, torch_dtype, wants_plain)
from .kernel import bcsr_spmv, bcsr_spmv_plain


def pad_empty_rows(host: BCSR) -> BCSR:
    """Ensure every block row has >= 1 block: insert an explicit zero block
    (col 0) for each empty block row. A copy of the JAX package's helper,
    so both packages hold the same block list."""
    counts = np.diff(host.block_rowptr.astype(np.int64))
    empty = np.flatnonzero(counts == 0)
    if empty.size == 0:
        return host
    bm, bn = host.block_shape
    add_blocks = np.zeros((empty.size, bm, bn), dtype=host.blocks.dtype)
    rows = np.concatenate([host.block_rows, empty.astype(np.int32)])
    cols = np.concatenate([host.block_cols, np.zeros(empty.size, np.int32)])
    blocks = np.concatenate([host.blocks, add_blocks], axis=0)
    order = np.argsort(rows, kind="stable")
    rowptr = np.zeros(host.num_block_rows + 1, dtype=np.int64)
    np.add.at(rowptr, rows.astype(np.int64) + 1, 1)
    return BCSR(blocks=blocks[order], block_rows=rows[order],
                block_cols=cols[order],
                block_rowptr=np.cumsum(rowptr).astype(np.int32),
                shape=host.shape, block_shape=host.block_shape)


def pad_x2d(x: torch.Tensor, ncb: int, bn: int) -> torch.Tensor:
    """x [n, nv] zero-padded to ncb * bn rows and viewed as [ncb, bn, nv]."""
    n, nv = x.shape
    if n == ncb * bn:
        return x.contiguous().reshape(ncb, bn, nv)
    xp = x.new_zeros((ncb * bn, nv))
    xp[:n] = x
    return xp.reshape(ncb, bn, nv)


class BcsrOperator:
    """Device-resident BCSR operator: y = A @ x."""

    def __init__(self, host: BCSR, dtype=torch.float32,
                 use_kernel: str = "auto", device=None):
        dev = resolve_device(device)
        host = pad_empty_rows(host)
        self.block_shape = host.block_shape
        self.shape = host.shape
        self.nbr = host.num_block_rows
        bm, bn = host.block_shape
        self.ncb = (host.shape[1] + bn - 1) // bn
        self.blocks = to_device(host.blocks, torch_dtype(dtype), dev)
        self.block_rows = to_device(host.block_rows, torch.int32, dev)
        self.block_cols = to_device(host.block_cols, torch.int32, dev)
        self._finish(dev, use_kernel)

    def _finish(self, dev, use_kernel: str) -> None:
        self.device = dev
        # block_rows is sorted and covers every block row (pad_empty_rows)
        rows = host_array(self.block_rows)
        self.block_rowptr = to_device(
            np.searchsorted(rows, np.arange(self.nbr + 1)), torch.int64, dev)
        self.use_kernel = check_use_kernel(use_kernel)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with obs.span("kernel.spmv", engine="bcsr", backend="torch",
                      use_kernel=self.use_kernel):
            squeeze = x.dim() == 1
            x2 = x[:, None] if squeeze else x
            bm, bn = self.block_shape
            x2d = pad_x2d(x2, self.ncb, bn)
            if wants_plain(self.use_kernel, x2d):
                y = bcsr_spmv_plain(self.blocks, self.block_rows,
                                    self.block_cols, x2d, self.nbr)
            else:
                y = bcsr_spmv(self.blocks, self.block_rows, self.block_cols,
                              self.block_rowptr, x2d, self.nbr)
            y = y.reshape(-1, x2.shape[1])[: self.shape[0]]
            return y[:, 0] if squeeze else y

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x: [n, k] -> y: [m, k] (one stream of the block list serves all
        k vectors)."""
        return self(x)

    def flops(self) -> int:
        t, bm, bn = self.blocks.shape
        return 2 * t * bm * bn

    # -- state protocol (array and meta names as in the JAX package) -------
    def state(self):
        meta = {"shape": list(self.shape),
                "block_shape": list(self.block_shape),
                "nbr": self.nbr, "ncb": self.ncb,
                "use_kernel": self.use_kernel}
        return meta, {"blocks": host_array(self.blocks),
                      "block_rows": host_array(self.block_rows),
                      "block_cols": host_array(self.block_cols)}

    @classmethod
    def from_state(cls, meta, arrays, dtype=None, device=None):
        dev = resolve_device(device)
        op = object.__new__(cls)
        op.shape = tuple(meta["shape"])
        op.block_shape = tuple(meta["block_shape"])
        op.nbr, op.ncb = meta["nbr"], meta["ncb"]
        blocks = np.asarray(arrays["blocks"])
        op.blocks = to_device(blocks, torch_dtype(dtype or blocks.dtype), dev)
        op.block_rows = to_device(arrays["block_rows"], torch.int32, dev)
        op.block_cols = to_device(arrays["block_cols"], torch.int32, dev)
        op._finish(dev, meta.get("use_kernel", "auto"))
        return op
