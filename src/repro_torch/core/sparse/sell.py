"""SELL-C-σ host-side conversion (Kreutzer et al.).

SELL-C-σ = sliced ELLPACK: rows are grouped into slices of C rows and each
slice is padded only to *its own* widest row, after a σ-window sort that
places rows of similar nnz into the same slice. Padding therefore scales
with the per-slice max instead of the global max — on power-law matrices
(the regime where reordering matters most, and where plain ELL storage
explodes) this is the difference between O(nnz) and O(m * max_deg).

The slice data is stored as [C, W] chunks, so a slice of width K_s becomes
ceil(K_s / W) chunks. All chunks across all slices are flattened into one
array with a `chunk_slice` map saying which slice each chunk accumulates
into. Empty slices still get one zero chunk so every output row is written.
The arrays are bit-identical to the JAX package's conversion, so both packages
can be handed the same format.

The σ-sort is a pure *storage* permutation: `row_perm` maps slice position
-> original row, and `inv_perm` undoes it after the multiply. It composes
with (and is independent of) the paper's reordering schemes, which permute
the matrix itself.

The conversion is numpy-only and fully vectorized; arrays go to the device in the
ops layer (kernels/sell_spmv/ops.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import CSRMatrix


@dataclasses.dataclass(frozen=True)
class SellCS:
    chunk_cols: np.ndarray    # [T, C, W] int32 column ids (padding -> 0)
    chunk_vals: np.ndarray    # [T, C, W] float  (padding -> 0)
    chunk_slice: np.ndarray   # [T] int32, nondecreasing slice id per chunk
    slice_width: np.ndarray   # [S] int32 true (pre-chunk) width of each slice
    row_perm: np.ndarray      # [S*C] int64: original row at slice position i
                              #   (positions >= m are phantom padding rows)
    inv_perm: np.ndarray      # [m] int64: slice position of original row r
    shape: tuple              # (m, n)
    c: int                    # slice height (TPU sublane count)
    sigma: int                # sort-window size (1 = no sorting)
    w: int                    # chunk width (TPU lane alignment)

    @property
    def num_slices(self) -> int:
        return int(self.slice_width.shape[0])

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_slice.shape[0])

    @property
    def padded_nnz(self) -> int:
        """Stored element count (the format's memory/work footprint)."""
        return int(self.chunk_vals.size)

    def density_stats(self) -> dict:
        nnz = int(np.count_nonzero(self.chunk_vals))
        return {
            "num_slices": self.num_slices,
            "num_chunks": self.num_chunks,
            "padded_nnz": self.padded_nnz,
            "fill_ratio": nnz / max(self.padded_nnz, 1),
        }


def sell_padded_nnz(mat: CSRMatrix, c: int = 8, sigma: int = 64,
                    w: int = 1) -> int:
    """Predict SELL-C-σ stored elements WITHOUT building the format.

    Cheap enough for the autotuner's cost model: one sort of row counts per
    σ-window, then per-slice maxima. w quantizes slice widths up to the
    chunk width (w=1 -> un-chunked ideal SELL padding).
    """
    counts = _sorted_counts(mat.row_nnz(), c, sigma)
    s = counts.shape[0] // c
    widths = counts.reshape(s, c).max(axis=1)
    widths = np.maximum(((widths + w - 1) // w) * w, w)
    return int(widths.sum() * c)


def pick_chunk_width(mat: CSRMatrix, lo: int = 8, hi: int = 128) -> int:
    """Adaptive chunk width: smallest power of two covering the 75th
    percentile row, clipped to [lo, hi]. Small-degree corpora want narrow
    chunks (padding scales with W); the tuner also keeps a W=128 candidate
    in the race (the reference's candidate grid, kept so both packages
    plan alike)."""
    counts = mat.row_nnz()
    p75 = float(np.percentile(counts, 75)) if counts.size else 1.0
    w = lo
    while w < hi and w < p75:
        w *= 2
    return w


def _sorted_counts(counts: np.ndarray, c: int, sigma: int) -> np.ndarray:
    """Row-nnz counts, padded to a multiple of c, after the σ-window sort."""
    m = counts.shape[0]
    m_pad = ((m + c - 1) // c) * c
    padded = np.zeros(m_pad, dtype=np.int64)
    padded[:m] = counts
    return padded[_sigma_sort_perm(counts, c, sigma)]


def _sigma_sort_perm(counts: np.ndarray, c: int, sigma: int) -> np.ndarray:
    """row_perm[i] = original row at slice position i (descending nnz within
    each σ-window; stable, so the reordering scheme's row order is preserved
    among equal-degree rows). Positions beyond m map to phantom rows >= m.

    Vectorized: all windows sort as rows of one 2-D argsort. Buffer slots
    beyond m_pad carry key -1 and larger indices than any real slot, so the
    stable sort puts them last in their window; dropping indices >= m_pad
    afterwards is exact.
    """
    m = counts.shape[0]
    sigma = max(int(sigma), 1)
    m_pad = ((m + c - 1) // c) * c
    nwin = max((m_pad + sigma - 1) // sigma, 1)
    buf = np.full(nwin * sigma, -1, dtype=np.int64)
    buf[:m] = counts
    order = np.argsort(-buf.reshape(nwin, sigma), axis=1, kind="stable")
    perm = (order + sigma * np.arange(nwin, dtype=np.int64)[:, None]).ravel()
    return perm[perm < m_pad]


def to_sell(mat: CSRMatrix, c: int = 8, sigma: int = 64, w: int = 128) -> SellCS:
    """Build SELL-C-σ with chunked slices.

    c:     slice height (rows per slice)
    sigma: sort window; multiple of c, sigma=1 disables sorting (pure SELL-C)
    w:     chunk width in elements
    """
    m, n = mat.shape
    counts = mat.row_nnz()
    perm = _sigma_sort_perm(counts, c, sigma)
    m_pad = perm.shape[0]
    s = m_pad // c

    counts_pad = np.zeros(m_pad, dtype=np.int64)
    counts_pad[:m] = counts
    counts_p = counts_pad[perm]                       # counts in slice order
    slice_width = counts_p.reshape(s, c).max(axis=1).astype(np.int32)

    # chunks per slice (>= 1 so each y tile is written at least once)
    chunks_per_slice = np.maximum((slice_width + w - 1) // w, 1).astype(np.int64)
    chunk_start = np.concatenate([[0], np.cumsum(chunks_per_slice)])
    t = int(chunk_start[-1])

    chunk_cols = np.zeros((t, c, w), dtype=np.int32)
    chunk_vals = np.zeros((t, c, w), dtype=mat.vals.dtype)
    chunk_slice = np.repeat(np.arange(s, dtype=np.int32), chunks_per_slice)

    # Vectorized fill. For slice position i = slice*c + lane holding original
    # row perm[i], its element j (j-th nonzero of the row) lands in chunk
    # chunk_start[slice] + j // w at [lane, j % w].
    nnz = mat.nnz
    if nnz:
        rp = mat.rowptr.astype(np.int64)
        real = perm < m                                # mask phantom rows
        rows_p = perm[real]
        cnt_p = counts_pad[perm][real]
        pos_p = np.flatnonzero(real)                   # slice position of each
        # ragged per-element indices, in slice-position order:
        ends = np.cumsum(cnt_p)
        j = np.arange(nnz, dtype=np.int64) - np.repeat(ends - cnt_p, cnt_p)
        src = np.repeat(rp[rows_p], cnt_p) + j         # CSR source index
        pos = np.repeat(pos_p, cnt_p)                  # slice position
        sl, lane = pos // c, pos % c
        chunk = chunk_start[sl] + j // w
        flat = (chunk * c + lane) * w + (j % w)
        chunk_cols.reshape(-1)[flat] = mat.cols[src]
        chunk_vals.reshape(-1)[flat] = mat.vals[src]

    inv_perm = np.empty(m_pad, dtype=np.int64)
    inv_perm[perm] = np.arange(m_pad)
    return SellCS(chunk_cols=chunk_cols, chunk_vals=chunk_vals,
                  chunk_slice=chunk_slice, slice_width=slice_width,
                  row_perm=perm, inv_perm=inv_perm[:m][...],
                  shape=(m, n), c=c, sigma=sigma, w=w)


def sell_to_dense(s: SellCS) -> np.ndarray:
    """Debug/test helper: densify (inverse of to_sell up to explicit zeros)."""
    m, n = s.shape
    out = np.zeros((m, n), dtype=s.chunk_vals.dtype)
    t, c, w = s.chunk_vals.shape
    ch, lane, ww = np.nonzero(s.chunk_vals)
    pos = s.chunk_slice[ch].astype(np.int64) * c + lane
    rows = s.row_perm[pos]
    cols = s.chunk_cols[ch, lane, ww]
    out[rows, cols] = s.chunk_vals[ch, lane, ww]
    return out
