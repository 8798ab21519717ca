"""BellOperator: host Block-ELL format in, device operator out."""
from __future__ import annotations

import numpy as np
import torch

from ... import obs
from ...core.sparse.bell import BlockELL
from ...device import (check_use_kernel, host_array, resolve_device,
                       to_device, torch_dtype, wants_plain)
from ..bcsr_spmv.ops import pad_x2d
from .kernel import bell_spmv, bell_spmv_plain


class BellOperator:
    """Device-resident Block-ELL operator: y = A @ x."""

    def __init__(self, host: BlockELL, dtype=torch.float32,
                 use_kernel: str = "auto", device=None):
        dev = resolve_device(device)
        self.block_shape = host.block_shape
        self.shape = host.shape
        bm, bn = host.block_shape
        self.ncb = (host.shape[1] + bn - 1) // bn
        self.blocks = to_device(host.blocks, torch_dtype(dtype), dev)
        self.block_cols = to_device(host.block_cols, torch.int32, dev)
        self.device = dev
        self.use_kernel = check_use_kernel(use_kernel)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: [n] or [n, nv] -> y: [m] or [m, nv]."""
        with obs.span("kernel.spmv", engine="bell", backend="torch",
                      use_kernel=self.use_kernel):
            squeeze = x.dim() == 1
            x2 = x[:, None] if squeeze else x
            bm, bn = self.block_shape
            x2d = pad_x2d(x2, self.ncb, bn)
            if wants_plain(self.use_kernel, x2d):
                y = bell_spmv_plain(self.blocks, self.block_cols, x2d)
            else:
                y = bell_spmv(self.blocks, self.block_cols, x2d)
            y = y.reshape(-1, x2.shape[1])[: self.shape[0]]
            return y[:, 0] if squeeze else y

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x: [n, k] -> y: [m, k] — each dense block is streamed once for
        all k vectors."""
        return self(x)

    def flops(self) -> int:
        """Flops per SpMV (2 * padded block volume)."""
        nbr, k, bm, bn = self.blocks.shape
        return 2 * nbr * k * bm * bn

    # -- state protocol (array and meta names as in the JAX package) -------
    def state(self):
        meta = {"shape": list(self.shape),
                "block_shape": list(self.block_shape),
                "ncb": self.ncb, "use_kernel": self.use_kernel}
        return meta, {"blocks": host_array(self.blocks),
                      "block_cols": host_array(self.block_cols)}

    @classmethod
    def from_state(cls, meta, arrays, dtype=None, device=None):
        dev = resolve_device(device)
        op = object.__new__(cls)
        op.shape = tuple(meta["shape"])
        op.block_shape = tuple(meta["block_shape"])
        op.ncb = meta["ncb"]
        blocks = np.asarray(arrays["blocks"])
        op.blocks = to_device(blocks, torch_dtype(dtype or blocks.dtype), dev)
        op.block_cols = to_device(arrays["block_cols"], torch.int32, dev)
        op.device = dev
        op.use_kernel = check_use_kernel(meta.get("use_kernel", "auto"))
        return op
