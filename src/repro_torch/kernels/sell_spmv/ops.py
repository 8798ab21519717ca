"""SellOperator: host SELL-C-σ format in, device operator out.

Handles the σ-sort un-permute (inv_perm gather) and the kernel choice
(kernel on CUDA tensors, plain version on CPU tensors or for "ref"). Unlike
the TPU path, x needs no padding: every column index is < n.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import obs
from ...core.sparse.sell import SellCS
from ...device import (check_use_kernel, host_array, resolve_device,
                       to_device, torch_dtype, wants_plain)
from .kernel import sell_spmv, sell_spmv_plain, slice_chunk_ptr


class SellOperator:
    """Device-resident SELL-C-σ operator: y = A @ x."""

    def __init__(self, host: SellCS, dtype=torch.float32,
                 use_kernel: str = "auto", device=None):
        dev = resolve_device(device)
        self.shape = host.shape
        self.c = host.c
        self.sigma = host.sigma
        self.w = host.w
        self.num_slices = host.num_slices
        # the reference pads x to a lane multiple; kept for state() parity
        self.n_pad = ((host.shape[1] + 127) // 128) * 128
        self.chunk_vals = to_device(host.chunk_vals, torch_dtype(dtype), dev)
        self.chunk_cols = to_device(host.chunk_cols, torch.int32, dev)
        self.chunk_slice = to_device(host.chunk_slice, torch.int32, dev)
        self.inv_perm = to_device(host.inv_perm, torch.int32, dev)
        self._finish(dev, use_kernel)

    def _finish(self, dev, use_kernel: str) -> None:
        self.device = dev
        self.slice_ptr = to_device(
            slice_chunk_ptr(host_array(self.chunk_slice), self.num_slices),
            torch.int64, dev)
        self.use_kernel = check_use_kernel(use_kernel)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: [n] or [n, nv] -> y: [m] or [m, nv]."""
        with obs.span("kernel.spmv", engine="sell", backend="torch",
                      use_kernel=self.use_kernel):
            squeeze = x.dim() == 1
            x2 = (x[:, None] if squeeze else x).contiguous()
            if wants_plain(self.use_kernel, x2):
                y = sell_spmv_plain(self.chunk_vals, self.chunk_cols,
                                    self.chunk_slice, x2, self.num_slices)
            else:
                y = sell_spmv(self.chunk_vals, self.chunk_cols,
                              self.chunk_slice, self.slice_ptr, x2,
                              self.num_slices)
            # y is in slice order; inv_perm[r] = slice position of row r
            y = y.reshape(-1, x2.shape[1]).index_select(0, self.inv_perm)
            return y[:, 0] if squeeze else y

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x: [n, k] -> y: [m, k] through the k-tiled SpMM kernel (K2)."""
        if x.dim() == 1:
            return self(x)
        from ..sell_spmm.ops import sell_matmul

        return sell_matmul(self, x)

    # -- state protocol (array and meta names as in the JAX package) -------
    def state(self):
        meta = {"shape": list(self.shape), "c": self.c, "sigma": self.sigma,
                "w": self.w, "num_slices": self.num_slices,
                "n_pad": self.n_pad, "use_kernel": self.use_kernel}
        arrays = {"chunk_vals": host_array(self.chunk_vals),
                  "chunk_cols": host_array(self.chunk_cols),
                  "chunk_slice": host_array(self.chunk_slice),
                  "inv_perm": host_array(self.inv_perm)}
        return meta, arrays

    @classmethod
    def from_state(cls, meta, arrays, dtype=None, device=None):
        dev = resolve_device(device)
        op = object.__new__(cls)
        op.shape = tuple(meta["shape"])
        op.c, op.sigma, op.w = meta["c"], meta["sigma"], meta["w"]
        op.num_slices, op.n_pad = meta["num_slices"], meta["n_pad"]
        vals = np.asarray(arrays["chunk_vals"])
        op.chunk_vals = to_device(vals, torch_dtype(dtype or vals.dtype), dev)
        op.chunk_cols = to_device(arrays["chunk_cols"], torch.int32, dev)
        op.chunk_slice = to_device(arrays["chunk_slice"], torch.int32, dev)
        op.inv_perm = to_device(arrays["inv_perm"], torch.int32, dev)
        op._finish(dev, meta.get("use_kernel", "auto"))
        return op

    @property
    def padded_nnz(self) -> int:
        """Stored element count — the format's work/footprint measure."""
        return int(self.chunk_vals.numel())

    def flops(self) -> int:
        """Flops per SpMV (2 * stored elements, padding included)."""
        return 2 * self.padded_nnz
