"""Graph view of a matrix for the reorderers (vectorized numpy).

A CSRMatrix is viewed as an undirected weighted graph: vertices = rows,
edges = off-diagonal nonzeros, weight = |a_ij| (symmetric input guaranteed
by the corpus, mirroring the paper's symmetric-only filter). Only the part
RCM needs; the coarsening machinery of the partitioners is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse.csr import CSRMatrix


@dataclasses.dataclass
class Graph:
    """Adjacency in CSR layout, self-loops removed."""

    indptr: np.ndarray   # int64[m+1]
    indices: np.ndarray  # int32[nnz]
    weights: np.ndarray  # float64[nnz]
    vwgt: np.ndarray     # float64[m] vertex weights

    @property
    def m(self) -> int:
        return len(self.indptr) - 1

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def from_matrix(mat: CSRMatrix, degree_weighted: bool = False) -> Graph:
    """degree_weighted: vertex weight = row nnz instead of 1."""
    r = np.repeat(np.arange(mat.m), mat.row_nnz()).astype(np.int64)
    keep = r != mat.cols
    r = r[keep]
    c = mat.cols[keep].astype(np.int64)
    w = np.abs(mat.vals[keep]).astype(np.float64)
    indptr = np.zeros(mat.m + 1, dtype=np.int64)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr)
    vwgt = (mat.row_nnz().astype(np.float64) if degree_weighted
            else np.ones(mat.m))
    return Graph(indptr=indptr, indices=c.astype(np.int32), weights=w,
                 vwgt=vwgt)
