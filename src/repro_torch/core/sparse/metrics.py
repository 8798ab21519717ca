"""Structural diagnostics from the paper (§2, §6) — plan-time numpy.

These are the quantities the paper uses to *explain* SpMV performance:
  * nnz load imbalance (paper §6.1)             -> load_imbalance()
  * matrix bandwidth / profile (RCM's target)   -> bandwidth(), profile()
  * block locality proxies                      -> distinct_col_blocks(),
                                                   block_fill_ratio()
  * partition communication volume (cut)        -> cut_volume(), halo_width()

The port's own copy of the JAX package's numpy code: every function gives
the reference's value on the same matrix (tests pin that).
"""
from __future__ import annotations

import numpy as np

from .csr import CSRMatrix


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """np.unique(a) (the sorted distinct values) by one sort and a
    neighbour compare: the same array. numpy 2.3 takes np.unique through a
    hash table, which on tens of millions of mostly distinct keys (the
    block keys of the shuffled Fig. 1 matrix) is many times slower than
    one sort."""
    s = np.sort(a, axis=None)
    if s.size == 0:
        return s
    keep = np.empty(s.size, dtype=bool)
    keep[0] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


# --------------------------------------------------------------------------
# Load imbalance (paper §6.1)
# --------------------------------------------------------------------------
def panel_loads(mat: CSRMatrix, panel_starts: np.ndarray) -> np.ndarray:
    """nnz assigned to each row panel. panel_starts: int[P+1] row offsets."""
    rp = mat.rowptr.astype(np.int64)
    return rp[panel_starts[1:]] - rp[panel_starts[:-1]]


def load_imbalance(mat: CSRMatrix, panel_starts: np.ndarray) -> float:
    """LI = max_load / fair_load, fair_load = total_nnz / P (paper §6.1)."""
    loads = panel_loads(mat, panel_starts)
    p = len(panel_starts) - 1
    fair = mat.nnz / max(p, 1)
    if fair == 0:
        return 1.0
    return float(loads.max() / fair)


def static_block_panels(m: int, p: int) -> np.ndarray:
    """Default OpenMP static schedule: one maximal contiguous chunk per
    processor (paper §3.2). Returns int[P+1] row offsets."""
    base, rem = divmod(m, p)
    sizes = np.full(p, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


# --------------------------------------------------------------------------
# Bandwidth / profile (RCM's objective)
# --------------------------------------------------------------------------
def bandwidth(mat: CSRMatrix) -> int:
    """max_i max_{j: a_ij != 0} |i - j|."""
    if mat.nnz == 0:
        return 0
    r = np.repeat(np.arange(mat.m), mat.row_nnz())
    return int(np.abs(r - mat.cols.astype(np.int64)).max())


def profile(mat: CSRMatrix) -> int:
    """sum_i (i - min_col(i)) over the lower triangle — the 'envelope'.

    Vectorized per-row minima via ufunc.reduceat: the segment from a
    nonempty row's rowptr to the NEXT nonempty row's rowptr is exactly that
    row's elements (empty rows in between contribute none), so reduceat
    over the nonempty starts gives every row min in one pass.
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


# --------------------------------------------------------------------------
# Block locality
# --------------------------------------------------------------------------
def distinct_col_blocks(mat: CSRMatrix, panel_starts: np.ndarray, block_n: int) -> np.ndarray:
    """Per panel: number of distinct column blocks of width block_n touched.

    The block analogue of 'distinct cache lines of x touched per core':
    each distinct block is one x segment a panel gathers. Lower = better
    data movement (what RCM improves).
    """
    rp = mat.rowptr.astype(np.int64)
    p = len(panel_starts) - 1
    if mat.nnz == 0 or p == 0:
        return np.zeros(p, dtype=np.int64)
    blocks = mat.cols.astype(np.int64) // block_n
    bounds = rp[np.asarray(panel_starts, dtype=np.int64)]   # [P+1] nnz offsets
    # panel of each in-panel nonzero (linear repeat over segment lengths,
    # same construction as partition_to_owner), then count distinct
    # (panel, block) pairs in one vectorized unique over composite keys
    pid = np.repeat(np.arange(p, dtype=np.int64), np.diff(bounds))
    nbt = (mat.n + block_n - 1) // block_n
    uniq = sorted_unique(pid * nbt + blocks[bounds[0]:bounds[-1]])
    return np.bincount(uniq // nbt, minlength=p).astype(np.int64)


def block_fill_ratio(mat: CSRMatrix, block_m: int, block_n: int) -> float:
    """nnz / (num_nonempty_blocks * block_m * block_n).

    Fraction of useful work when the matrix is tiled into dense
    block_m x block_n blocks (the Block-ELL/BCSR engines' tiles). 1.0 =
    perfectly dense blocks.
    """
    if mat.nnz == 0:
        return 1.0
    r = np.repeat(np.arange(mat.m), mat.row_nnz()).astype(np.int64)
    c = mat.cols.astype(np.int64)
    keys = (r // block_m) * ((mat.n + block_n - 1) // block_n) + (c // block_n)
    nblocks = sorted_unique(keys).size
    return float(mat.nnz / (nblocks * block_m * block_n))


def num_nonempty_blocks(mat: CSRMatrix, block_m: int, block_n: int) -> int:
    if mat.nnz == 0:
        return 0
    r = np.repeat(np.arange(mat.m), mat.row_nnz()).astype(np.int64)
    c = mat.cols.astype(np.int64)
    keys = (r // block_m) * ((mat.n + block_n - 1) // block_n) + (c // block_n)
    return int(sorted_unique(keys).size)


# --------------------------------------------------------------------------
# Partition quality (distributed setting; PaToH/METIS objective)
# --------------------------------------------------------------------------
def cut_volume(mat: CSRMatrix, panel_starts: np.ndarray) -> int:
    """Communication volume of a 1-D row partition with x partitioned
    conformally: nnz whose column lives in a different panel than the row.

    This is what hypergraph partitioning minimizes and what turns into
    collective bytes in the distributed SpMV.
    """
    # tolerant owner map (old-loop semantics: rows outside the partition
    # belong to panel 0) — partition_to_owner is the strict covering-
    # partition variant, and this metric, like halo_width, must keep
    # accepting prefix/partial partitions
    starts = np.asarray(panel_starts, dtype=np.int64)
    owner = np.zeros(mat.m, dtype=np.int32)
    owner[starts[0]:starts[-1]] = np.repeat(
        np.arange(starts.size - 1, dtype=np.int32), np.diff(starts))
    r = np.repeat(np.arange(mat.m), mat.row_nnz()).astype(np.int64)
    c = mat.cols.astype(np.int64)
    return int(np.count_nonzero(owner[r] != owner[c]))


def halo_width(mat: CSRMatrix, panel_starts: np.ndarray) -> int:
    """Max distance a panel must reach outside its own x range.

    For a bandwidth-reduced (RCM) matrix this equals the bandwidth, and it
    bounds the halo-exchange size of the distributed SpMV.
    """
    rp = mat.rowptr.astype(np.int64)
    starts = np.asarray(panel_starts, dtype=np.int64)
    bounds = rp[starts]                              # [P+1] nnz offsets
    ne = np.flatnonzero(np.diff(bounds) > 0)         # nonempty panels
    if ne.size == 0:
        return 0
    # reduceat over nonempty panel starts: each segment is exactly that
    # panel's elements (empty panels in between contribute none); slicing
    # at bounds[-1] keeps the LAST segment inside the final panel even for
    # a partition that does not reach row m
    cols = mat.cols[:bounds[-1]].astype(np.int64)
    cmin = np.minimum.reduceat(cols, bounds[ne])
    cmax = np.maximum.reduceat(cols, bounds[ne])
    reach = np.maximum(starts[ne] - cmin, cmax - (starts[ne + 1] - 1))
    return int(max(np.max(reach), 0))


def summary(mat: CSRMatrix, p: int = 8, block: int = 128) -> dict:
    panels = static_block_panels(mat.m, p)
    return {
        "m": mat.m,
        "nnz": mat.nnz,
        "bandwidth": bandwidth(mat),
        "avg_row_bandwidth": avg_row_bandwidth(mat),
        "load_imbalance": load_imbalance(mat, panels),
        "block_fill_ratio": block_fill_ratio(mat, 8, block),
        "cut_volume": cut_volume(mat, panels),
    }
