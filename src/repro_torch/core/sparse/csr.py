"""Host-side CSR sparse-matrix container.

This mirrors the C struct used throughout the paper (rowPtr / cols / values)
and is the plan-time representation every other component consumes:
reorderers permute it, partitioners split it, and the device formats
(Block-ELL / BCSR, see bell.py / bcsr.py) are built from it.

All arrays are numpy (host). Device/JAX formats are separate classes so that
nothing here ever touches jax device state (important: the dry-run must be
able to set XLA_FLAGS before any jax import).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed Sparse Row matrix (square or rectangular).

    rowptr: int32[m + 1]
    cols:   int32[nnz]   column index of each stored element, row-major
    vals:   float{32,64}[nnz]
    shape:  (m, n)
    """

    rowptr: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: Tuple[int, int]

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_coo(rows, cols, vals, shape) -> "CSRMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        m, n = shape
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        # deduplicate (sum duplicates, scipy semantics)
        if rows.size:
            key = rows * n + cols
            uniq, inv = np.unique(key, return_inverse=True)
            if uniq.size != rows.size:
                summed = np.zeros(uniq.size, dtype=vals.dtype)
                np.add.at(summed, inv, vals)
                rows = (uniq // n).astype(np.int64)
                cols = (uniq % n).astype(np.int64)
                vals = summed
        rowptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(rowptr, rows + 1, 1)
        rowptr = np.cumsum(rowptr)
        return CSRMatrix(
            rowptr=rowptr.astype(np.int32),
            cols=cols.astype(np.int32),
            vals=vals,
            shape=(int(m), int(n)),
        )

    @staticmethod
    def from_dense(dense: np.ndarray) -> "CSRMatrix":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return CSRMatrix.from_coo(rows, cols, dense[rows, cols], dense.shape)

    # -- basic properties --------------------------------------------------
    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    def row_nnz(self) -> np.ndarray:
        """int64[m] — nonzeros per row (the paper's per-row workload)."""
        return np.diff(self.rowptr.astype(np.int64))

    # -- conversions -------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        r = np.repeat(np.arange(self.m), self.row_nnz())
        out[r, self.cols] = self.vals
        return out

    # -- operations --------------------------------------------------------
    def permute(self, row_perm: np.ndarray, col_perm: np.ndarray | None = None) -> "CSRMatrix":
        """Symmetric (or general) permutation: B = P A Q^T.

        row_perm[i] = original row placed at new position i (gather
        semantics). When col_perm is None the same permutation is applied to
        columns — the paper's symmetric row/column reordering, which keeps a
        symmetric matrix symmetric and is what every scheme in §2.1 emits.
        """
        row_perm = np.asarray(row_perm, dtype=np.int64)
        if col_perm is None:
            col_perm = row_perm
        m, n = self.shape
        assert row_perm.shape == (m,) and col_perm.shape == (n,)
        # inverse permutation for the column relabel:
        inv_col = np.empty(n, dtype=np.int64)
        inv_col[col_perm] = np.arange(n)

        counts = self.row_nnz()[row_perm]
        new_rowptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(counts, out=new_rowptr[1:])
        rp = self.rowptr.astype(np.int64)
        # Vectorized ragged gather: element j of new row i comes from
        # rp[row_perm[i]] + j. Then one lexsort restores per-row column order.
        offs = np.arange(self.nnz, dtype=np.int64) - np.repeat(new_rowptr[:-1], counts)
        src = np.repeat(rp[row_perm], counts) + offs
        new_rows = np.repeat(np.arange(m, dtype=np.int64), counts)
        new_cols = inv_col[self.cols[src]].astype(np.int32)
        new_vals = self.vals[src]
        order = np.lexsort((new_cols, new_rows))
        new_cols = new_cols[order]
        new_vals = new_vals[order]
        return CSRMatrix(
            rowptr=new_rowptr.astype(np.int32),
            cols=new_cols,
            vals=new_vals,
            shape=self.shape,
        )

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Numpy oracle: y = A @ x (paper Listing 4, sequential)."""
        y = np.zeros(self.m, dtype=np.result_type(self.vals, x))
        rp = self.rowptr.astype(np.int64)
        # vectorized segment-sum
        prod = self.vals * x[self.cols]
        np.add.at(y, np.repeat(np.arange(self.m), self.row_nnz()), prod)
        return y

    def astype(self, dtype) -> "CSRMatrix":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))
