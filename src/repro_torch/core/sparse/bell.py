"""Device-facing block formats: Block-ELL and BCSR (host-side conversion).

The device format stores *dense* (bm x bn) blocks at the nonempty block
positions of the (reordered) matrix. Reordering quality shows up as block
fill ratio (fewer, denser blocks) and block-column locality (fewer distinct
x tiles per block row).

* BlockELL — per block-row, blocks padded to the max count K. Uniform shape.
  Padding blocks point at column-block 0 with zero values (result-neutral).
* BCSR — true variable-count block rows with (block_row, block_col) ids and
  a block_rowptr. No padding waste; used when the block-count distribution
  is skewed (power-law graphs).

Conversions are numpy-only and bit-identical to the JAX package's; the arrays
are handed to the device by the ops layer.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import CSRMatrix


@dataclasses.dataclass(frozen=True)
class BlockELL:
    blocks: np.ndarray      # [nbr, K, bm, bn] float
    block_cols: np.ndarray  # [nbr, K] int32 (padding -> 0, with zero block)
    nblocks: np.ndarray     # [nbr] int32 true block count per block row
    shape: tuple            # (m, n) original logical shape
    block_shape: tuple      # (bm, bn)

    @property
    def num_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def k(self) -> int:
        return self.blocks.shape[1]


@dataclasses.dataclass(frozen=True)
class BCSR:
    blocks: np.ndarray      # [total_blocks, bm, bn]
    block_rows: np.ndarray  # [total_blocks] int32, nondecreasing
    block_cols: np.ndarray  # [total_blocks] int32
    block_rowptr: np.ndarray  # [nbr+1] int32
    shape: tuple
    block_shape: tuple

    @property
    def num_block_rows(self) -> int:
        return len(self.block_rowptr) - 1

    @property
    def total_blocks(self) -> int:
        return self.blocks.shape[0]


def _block_coo(mat: CSRMatrix, bm: int, bn: int):
    """(block_row, block_col, dense_block) triples for nonempty blocks."""
    m, n = mat.shape
    r = np.repeat(np.arange(m), mat.row_nnz()).astype(np.int64)
    c = mat.cols.astype(np.int64)
    br, bc = r // bm, c // bn
    nbc = (n + bn - 1) // bn
    key = br * nbc + bc
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((uniq.size, bm, bn), dtype=mat.vals.dtype)
    # vectorized scatter: CSR guarantees unique (r, c), so no collisions
    blocks[inv, r % bm, c % bn] = mat.vals
    return (uniq // nbc).astype(np.int32), (uniq % nbc).astype(np.int32), blocks


def to_block_ell(mat: CSRMatrix, bm: int = 8, bn: int = 128, k: int | None = None) -> BlockELL:
    """Build Block-ELL. k: pad/cap width (default = max block count)."""
    m, n = mat.shape
    nbr = (m + bm - 1) // bm
    br, bc, dense = _block_coo(mat, bm, bn)
    counts = np.zeros(nbr, dtype=np.int32)
    np.add.at(counts, br, 1)
    kk = int(counts.max()) if k is None else int(k)
    kk = max(kk, 1)
    if k is not None and counts.max() > k:
        raise ValueError(f"k={k} < max block count {counts.max()}")
    blocks = np.zeros((nbr, kk, bm, bn), dtype=mat.vals.dtype)
    cols = np.zeros((nbr, kk), dtype=np.int32)
    # br is sorted (block-COO keys are row-major), so the slot of block i
    # within its block row is i - first_index_of(br[i]).
    csum = np.concatenate([[0], np.cumsum(np.bincount(br, minlength=nbr))])
    slot = np.arange(br.size) - csum[br]
    blocks[br, slot] = dense
    cols[br, slot] = bc
    return BlockELL(blocks=blocks, block_cols=cols, nblocks=counts,
                    shape=(m, n), block_shape=(bm, bn))


def bell_to_dense(b: BlockELL) -> np.ndarray:
    """Debug/test helper: densify a Block-ELL matrix."""
    bm, bn = b.block_shape
    m, n = b.shape
    nbc = (n + bn - 1) // bn
    out = np.zeros((b.num_block_rows * bm, nbc * bn), dtype=b.blocks.dtype)
    for i in range(b.num_block_rows):
        for kk in range(int(b.nblocks[i])):
            c = b.block_cols[i, kk]
            out[i * bm:(i + 1) * bm, c * bn:(c + 1) * bn] += b.blocks[i, kk]
    return out[:m, :n]


def to_bcsr(mat: CSRMatrix, bm: int = 8, bn: int = 128) -> BCSR:
    m, n = mat.shape
    nbr = (m + bm - 1) // bm
    br, bc, dense = _block_coo(mat, bm, bn)
    rowptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(rowptr, br.astype(np.int64) + 1, 1)
    rowptr = np.cumsum(rowptr)
    return BCSR(blocks=dense, block_rows=br, block_cols=bc,
                block_rowptr=rowptr.astype(np.int32), shape=(m, n),
                block_shape=(bm, bn))
