"""Plain torch SpMV oracles — the correctness references for every engine.

Straight-line torch (no hand-written kernel): each engine and each CUDA
kernel is tested against these, which are tested against the numpy
CSRMatrix.spmv and against the JAX package's jnp oracles. Segment sums are
`index_add_`. Every oracle accumulates at >= float32 (the promoted type of
the operands and float32) and returns the operand dtype, so an f64
operator keeps f64 accuracy, with one exception: the CSR oracle in bf16
multiplies and sums in bf16, as the reference's `spmv_csr` does (on the
CPU the two agree bit for bit; on the card `index_add_` adds atomically,
in no fixed order).
"""
from __future__ import annotations

import torch

from ...device import acc_dtype


def spmv_dense(a_dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return a_dense @ x


def spmv_csr(row_ids: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, m: int) -> torch.Tensor:
    """CSR-as-COO gather + segment-sum (paper Listing 4 semantics).

    row_ids: int[nnz] (row of each stored element, nondecreasing);
    x: [n] or [n, k] (the k axis rides along every gathered element).
    In bf16 the products and the segment sum stay in bf16, as in the
    reference; every other type accumulates at >= float32.
    """
    dt = torch.promote_types(vals.dtype, x.dtype)
    acc = dt if dt == torch.bfloat16 else acc_dtype(dt)
    prod = x[cols.long()].to(acc)
    prod *= vals.to(acc).reshape((-1,) + (1,) * (x.dim() - 1))
    rows = row_ids.long()
    if acc == torch.bfloat16 and x.dim() > 1:
        # torch sums a 2-D bf16 index_add_ in f32 on the CPU; one 1-D sum
        # per column adds in bf16 in row order, as the reference does
        cols_y = [torch.zeros(m, dtype=acc, device=x.device).index_add_(
            0, rows, prod[:, j].contiguous()) for j in range(x.shape[1])]
        return torch.stack(cols_y, dim=1)
    y = torch.zeros((m,) + tuple(x.shape[1:]), dtype=acc, device=x.device)
    y.index_add_(0, rows, prod)
    return y.to(x.dtype)


spmm_csr = spmv_csr


def spmv_ell(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """ELLPACK: ell_cols/vals [m, K], padding has val 0 (col arbitrary);
    x: [n] or [n, k]."""
    acc = acc_dtype(torch.promote_types(ell_vals.dtype, x.dtype))
    gathered = x[ell_cols.long()].to(acc)                # [m, K(, k)]
    if x.dim() == 1:
        return (ell_vals.to(acc) * gathered).sum(1).to(x.dtype)
    return torch.einsum("mj,mjv->mv", ell_vals.to(acc),
                        gathered).to(x.dtype)


spmm_ell = spmv_ell


def spmv_bell(blocks: torch.Tensor, block_cols: torch.Tensor,
              x2d: torch.Tensor) -> torch.Tensor:
    """Block-ELL: blocks [nbr, K, bm, bn]; block_cols [nbr, K];
    x2d [ncb, bn, nv]. Returns y [nbr, bm, nv]. Padding blocks are all-zero
    so their contribution vanishes whatever block column they name."""
    acc = acc_dtype(x2d.dtype)
    gathered = x2d[block_cols.long()].to(acc)            # [nbr, K, bn, nv]
    return torch.einsum("rkij,rkjv->riv", blocks.to(acc),
                        gathered).to(x2d.dtype)


def spmv_sell(chunk_vals: torch.Tensor, chunk_cols: torch.Tensor,
              chunk_slice: torch.Tensor, x: torch.Tensor,
              num_slices: int) -> torch.Tensor:
    """SELL-C-σ: chunk_vals/cols [T, C, W]; chunk_slice int[T]
    nondecreasing; x [n, nv]. Returns y [S, C, nv] in slice order (caller
    un-permutes via inv_perm). Padding slots have val 0, so they add 0."""
    acc = acc_dtype(x.dtype)
    _, c, _ = chunk_vals.shape
    gathered = x[chunk_cols.long()].to(acc)              # [T, C, W, nv]
    part = torch.einsum("tcw,tcwv->tcv", chunk_vals.to(acc), gathered)
    y = torch.zeros((num_slices, c, x.shape[1]), dtype=acc, device=x.device)
    y.index_add_(0, chunk_slice.long(), part)
    return y.to(x.dtype)


def spmv_bcsr(blocks: torch.Tensor, block_rows: torch.Tensor,
              block_cols: torch.Tensor, x2d: torch.Tensor,
              num_block_rows: int) -> torch.Tensor:
    """BCSR: blocks [T, bm, bn], block_rows/cols [T]. Returns [nbr, bm, nv]."""
    acc = acc_dtype(x2d.dtype)
    _, bm, _ = blocks.shape
    gathered = x2d[block_cols.long()].to(acc)            # [T, bn, nv]
    part = torch.einsum("tij,tjv->tiv", blocks.to(acc), gathered)
    y = torch.zeros((num_block_rows, bm, x2d.shape[2]), dtype=acc,
                    device=x2d.device)
    y.index_add_(0, block_rows.long(), part)
    return y.to(x2d.dtype)
