"""Structural diagnostics from the paper (§2, §6) — plan-time numpy.

The part the tuner's feature vector needs: bandwidth and profile (RCM's
objective) and the mean row bandwidth (the locality proxy the cost model's
gather penalty reads). Load-imbalance and partition metrics are not ported
yet.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRMatrix


def bandwidth(mat: CSRMatrix) -> int:
    """max_i max_{j: a_ij != 0} |i - j|."""
    if mat.nnz == 0:
        return 0
    r = np.repeat(np.arange(mat.m), mat.row_nnz())
    return int(np.abs(r - mat.cols.astype(np.int64)).max())


def profile(mat: CSRMatrix) -> int:
    """sum_i (i - min_col(i)) over the lower triangle — the 'envelope'.

    Per-row minima via ufunc.reduceat: the segment from a nonempty row's
    rowptr to the NEXT nonempty row's rowptr is exactly that row's elements
    (empty rows in between contribute none).
    """
    rp = mat.rowptr.astype(np.int64)
    nnz_rows = np.flatnonzero(np.diff(rp) > 0)
    if nnz_rows.size == 0:
        return 0
    cmin = np.minimum.reduceat(mat.cols, rp[nnz_rows]).astype(np.int64)
    d = nnz_rows - cmin
    return int(d[d > 0].sum())


def avg_row_bandwidth(mat: CSRMatrix) -> float:
    """Mean |i - j| over nonzeros — a smoother locality proxy than max."""
    if mat.nnz == 0:
        return 0.0
    r = np.repeat(np.arange(mat.m), mat.row_nnz())
    return float(np.abs(r - mat.cols.astype(np.int64)).mean())
