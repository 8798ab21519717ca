"""SpMV engines and the registry-dispatched factory `make_engine`.

Engines (each a build function in the plugin registry, core/registry.py), in the
JAX package's registration order, which is the tuner's candidate order:
  csr    — gather + segment-sum (index_add_), torch ops
  ell    — padded row-major ELLPACK, torch ops
  bell   — Block-ELL, CUDA kernel K4 (plain torch version on the CPU)
  bcsr   — BCSR, CUDA kernel K3
  sell   — SELL-C-σ, CUDA kernels K1 (SpMV) and K2 (k-tiled SpMM)
  dense  — dense matmul (tiny matrices / sanity only)

Every operator takes x: [n] -> [m] and `matmul(X[n, k]) -> [m, k]`, lives
on the device its build function was given (`device=None` = the card; raises
without one), and speaks the JAX package's state()/from_state() protocol
with the same array and meta names.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from ... import obs
from ...device import host_array, resolve_device, to_device, torch_dtype
from ..registry import get_engine, register_engine
from ..sparse.bell import to_bcsr, to_block_ell
from ..sparse.csr import CSRMatrix
from ..sparse.sell import to_sell
from . import ref, tune

Engine = Literal["csr", "ell", "sell", "bell", "bcsr", "dense", "auto"]


class DeviceCSR:
    """Device-resident CSR (COO-expanded) operator."""

    def __init__(self, mat: CSRMatrix, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        self.m, self.n = mat.shape
        self.nnz = mat.nnz
        row_ids = np.repeat(np.arange(mat.m, dtype=np.int32), mat.row_nnz())
        self.row_ids = to_device(row_ids, torch.int32, dev)
        self.cols = to_device(mat.cols, torch.int32, dev)
        self.vals = to_device(mat.vals, torch_dtype(dtype), dev)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with obs.span("kernel.spmv", engine="csr", backend="torch"):
            return ref.spmv_csr(self.row_ids, self.cols, self.vals, x, self.m)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x: [n, k] -> y: [m, k]: one gather/segment-sum pass for all k."""
        if x.dim() == 1:
            return self(x)
        with obs.span("kernel.spmm", engine="csr", k=int(x.shape[1]),
                      backend="torch"):
            return ref.spmm_csr(self.row_ids, self.cols, self.vals, x, self.m)

    def state(self):
        meta = {"m": self.m, "n": self.n, "nnz": self.nnz}
        arrays = {"row_ids": host_array(self.row_ids),
                  "cols": host_array(self.cols),
                  "vals": host_array(self.vals)}
        return meta, arrays

    @classmethod
    def from_state(cls, meta, arrays, dtype=None, device=None):
        dev = resolve_device(device)
        op = object.__new__(cls)
        op.m, op.n, op.nnz = meta["m"], meta["n"], meta["nnz"]
        vals = np.asarray(arrays["vals"])
        op.row_ids = to_device(arrays["row_ids"], torch.int32, dev)
        op.cols = to_device(arrays["cols"], torch.int32, dev)
        op.vals = to_device(vals, torch_dtype(dtype or vals.dtype), dev)
        return op


class DeviceELL:
    def __init__(self, mat: CSRMatrix, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        self.m, self.n = mat.shape
        counts = mat.row_nnz()
        k = max(int(counts.max()), 1)
        cols = np.zeros((mat.m, k), dtype=np.int32)
        vals = np.zeros((mat.m, k), dtype=np.float64)
        rp = mat.rowptr.astype(np.int64)
        # vectorized scatter: element e of row r lands at (r, e - rowptr[r])
        r = np.repeat(np.arange(mat.m), counts)
        j = np.arange(mat.nnz) - np.repeat(rp[:-1], counts)
        cols[r, j] = mat.cols
        vals[r, j] = mat.vals
        self.ell_cols = to_device(cols, torch.int32, dev)
        self.ell_vals = to_device(vals, torch_dtype(dtype), dev)
        self.padded_nnz = mat.m * k

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with obs.span("kernel.spmv", engine="ell", backend="torch"):
            return ref.spmv_ell(self.ell_cols, self.ell_vals, x)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x: [n, k] -> y: [m, k] (batched padded-ELL contraction)."""
        if x.dim() == 1:
            return self(x)
        with obs.span("kernel.spmm", engine="ell", k=int(x.shape[1]),
                      backend="torch"):
            return ref.spmm_ell(self.ell_cols, self.ell_vals, x)

    def state(self):
        meta = {"m": self.m, "n": self.n, "padded_nnz": self.padded_nnz}
        return meta, {"ell_cols": host_array(self.ell_cols),
                      "ell_vals": host_array(self.ell_vals)}

    @classmethod
    def from_state(cls, meta, arrays, dtype=None, device=None):
        dev = resolve_device(device)
        op = object.__new__(cls)
        op.m, op.n = meta["m"], meta["n"]
        op.padded_nnz = meta["padded_nnz"]
        vals = np.asarray(arrays["ell_vals"])
        op.ell_cols = to_device(arrays["ell_cols"], torch.int32, dev)
        op.ell_vals = to_device(vals, torch_dtype(dtype or vals.dtype), dev)
        return op


class DeviceDense:
    def __init__(self, mat: CSRMatrix, dtype=torch.float32, device=None):
        self.a = to_device(mat.to_dense(), torch_dtype(dtype),
                           resolve_device(device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with obs.span("kernel.spmv", engine="dense", backend="torch"):
            return self.a @ x

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        with obs.span("kernel.spmm", engine="dense", backend="torch"):
            return self.a @ x

    def state(self):
        return {}, {"a": host_array(self.a)}

    @classmethod
    def from_state(cls, meta, arrays, dtype=None, device=None):
        op = object.__new__(cls)
        a = np.asarray(arrays["a"])
        op.a = to_device(a, torch_dtype(dtype or a.dtype),
                         resolve_device(device))
        return op


def _in_dtype(mat: CSRMatrix, dtype) -> CSRMatrix:
    """`mat` with its values in float32 when the operator is float32: a
    padded format built from it holds its blocks or chunks in float32 on
    the host, half the bytes of float64, and the device gets the same
    values (each rounded once from float64 either way)."""
    if torch_dtype(dtype) == torch.float32 and mat.vals.dtype != np.float32:
        return dataclasses.replace(mat, vals=mat.vals.astype(np.float32))
    return mat


# -- engine registry entries (registration order = tuner candidate order) --

@register_engine("csr", cost_fn=tune.cost_csr,
                 candidates_fn=tune.cands_default,
                 description="COO-expanded gather + segment-sum")
def _build_csr(mat: CSRMatrix, dtype=torch.float32, block_shape=(8, 128),
               sell_sigma=None, use_kernel: str = "auto", device=None):
    return DeviceCSR(mat, dtype, device=device)


@register_engine("ell", cost_fn=tune.cost_ell,
                 candidates_fn=tune.cands_default,
                 description="padded row-major ELLPACK")
def _build_ell(mat: CSRMatrix, dtype=torch.float32, block_shape=(8, 128),
               sell_sigma=None, use_kernel: str = "auto", device=None):
    return DeviceELL(mat, dtype, device=device)


@register_engine("bell", cost_fn=tune.cost_bell,
                 candidates_fn=tune.cands_default,
                 description="Block-ELL CUDA kernel (plain torch on CPU)")
def _build_bell(mat: CSRMatrix, dtype=torch.float32, block_shape=(8, 128),
                sell_sigma=None, use_kernel: str = "auto", device=None):
    from ...kernels.bell_spmv.ops import BellOperator

    return BellOperator(to_block_ell(_in_dtype(mat, dtype), *block_shape),
                        dtype, use_kernel, device=device)


@register_engine("bcsr", cost_fn=tune.cost_bcsr,
                 candidates_fn=tune.cands_default,
                 description="BCSR CUDA kernel (plain torch on CPU)")
def _build_bcsr(mat: CSRMatrix, dtype=torch.float32, block_shape=(8, 128),
                sell_sigma=None, use_kernel: str = "auto", device=None):
    from ...kernels.bcsr_spmv.ops import BcsrOperator

    return BcsrOperator(to_bcsr(_in_dtype(mat, dtype), *block_shape), dtype,
                        use_kernel, device=device)


@register_engine("sell", cost_fn=tune.cost_sell,
                 candidates_fn=tune.cands_sell,
                 description="SELL-C-σ CUDA kernels, k-tiled SpMM")
def _build_sell(mat: CSRMatrix, dtype=torch.float32, block_shape=(8, 128),
                sell_sigma=None, use_kernel: str = "auto", device=None):
    from ...kernels.sell_spmv.ops import SellOperator

    c, w = block_shape
    sigma = 8 * c if sell_sigma is None else sell_sigma
    return SellOperator(to_sell(_in_dtype(mat, dtype), c=c, sigma=sigma,
                                w=w), dtype, use_kernel, device=device)


@register_engine("dense", cost_fn=tune.cost_dense,
                 candidates_fn=tune.cands_dense,
                 description="dense matmul (tiny matrices / sanity only)")
def _build_dense(mat: CSRMatrix, dtype=torch.float32, block_shape=(8, 128),
                 sell_sigma=None, use_kernel: str = "auto", device=None):
    return DeviceDense(mat, dtype, device=device)


def make_engine(mat: CSRMatrix, engine: Engine = "csr", dtype=torch.float32,
                block_shape=(8, 128), use_kernel: str = "auto",
                sell_sigma: int | None = None, probe=False, k: int = 1,
                device=None):
    """Factory: host CSRMatrix -> operator y = A @ x on `device`
    (None = the card; raises without one), dispatched through the engine
    registry.

    engine="auto" runs the tuner (core/spmv/tune.py) and attaches its
    TunePlan as `.plan`. k is the expected number of right-hand sides; it
    steers tuning only. For engine="sell", block_shape is (C, W) and
    sell_sigma the σ window (default 8 * C). Operators live in the given
    matrix's index space; the permutation-carrying wrapper is
    plan(...).build().
    """
    dev = resolve_device(device)
    if engine == "auto":
        return tune.build_tuned(mat, dtype=dtype, probe=probe,
                                use_kernel=use_kernel, k=k, device=dev)
    spec = get_engine(engine)
    return spec.build(mat, dtype=torch_dtype(dtype), block_shape=block_shape,
                      sell_sigma=sell_sigma, use_kernel=use_kernel,
                      device=dev)
