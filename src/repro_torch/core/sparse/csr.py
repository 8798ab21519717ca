"""Host-side CSR sparse-matrix container.

This mirrors the C struct used throughout the paper (rowPtr / cols / values)
and is the plan-time representation every other component consumes:
reorderers permute it, partitioners split it, and the device formats
(Block-ELL / BCSR, see bell.py / bcsr.py) are built from it.

All arrays are numpy (host). Device formats are separate classes.

The arrays are the JAX package's, bit for bit; the sorts are not its
calls. numpy 2.3 takes `np.unique` without an inverse through a hash
table, and `np.lexsort` of two keys costs ~20 s on the 32.5 M entries of
a Fig. 1 matrix against ~1 s for one stable argsort of the combined key
row * n + col, which orders entries of valid coordinates the same way.
`from_coo` raises ValueError for coordinates outside the shape, where the
JAX package builds a corrupt matrix or raises IndexError.
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
        if rows.size and (rows.min() < 0 or rows.max() >= m
                          or cols.min() < 0 or cols.max() >= n):
            raise ValueError(f"COO coordinates out of range for shape "
                             f"{(m, n)}")
        order = _row_major_order(rows, cols, n)
        rows, cols, vals = rows[order], cols[order], vals[order]
        # deduplicate (sum duplicates, scipy semantics); the key is sorted,
        # so a new entry starts where it changes
        if rows.size:
            key = rows * n + cols
            new = np.empty(key.size, dtype=bool)
            new[0] = True
            np.not_equal(key[1:], key[:-1], out=new[1:])
            if not new.all():
                summed = np.zeros(int(new.sum()), dtype=vals.dtype)
                np.add.at(summed, np.cumsum(new) - 1, vals)
                uniq = key[new]
                rows = uniq // n
                cols = uniq % n
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
        order = _row_major_order(new_rows, new_cols, n)
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


def _row_major_order(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """np.lexsort((cols, rows)) for rows >= 0 and 0 <= cols < n: a stable
    argsort of row * n + col (the same permutation, ties in input order)."""
    return np.argsort(rows.astype(np.int64) * n + cols, kind="stable")
