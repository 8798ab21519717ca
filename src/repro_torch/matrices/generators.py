"""Synthetic sparse-matrix corpus (SuiteSparse substitute — DESIGN.md §6).

Every generator returns a *symmetric* CSRMatrix (the paper filters to
symmetric matrices because METIS requires them). Seeded and deterministic.

Families span the structural regimes of the paper's 559-matrix corpus:
  banded          — paper Fig. 1 left (bandwidth-limited, FEM 1-D)
  stencil_2d/3d   — 5/7-point Laplacians (regular FEM / CFD meshes)
  rmat            — power-law graphs (web/social; worst-case skew)
  sbm             — stochastic block model (community structure;
                    the regime Louvain/METIS target)
  small_world     — Watts-Strogatz ring + random rewires
  kron            — Kronecker product structure (recursive self-similarity)
  random_uniform  — Erdos-Renyi (paper Fig. 1 right after shuffle)
plus `shuffle()` which applies the paper's random symmetric permutation.
"""
from __future__ import annotations

import numpy as np

from ..core.sparse.csr import CSRMatrix


def _symmetrize_coo(rows, cols, m, rng, weights=None):
    """Build symmetric CSR from an edge list: A = B + B^T with unit/random
    weights and a diagonal added (keeps CG-compatible SPD-ish structure)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    r = np.concatenate([rows, cols, np.arange(m)])
    c = np.concatenate([cols, rows, np.arange(m)])
    if weights is None:
        v = rng.uniform(0.1, 1.0, size=rows.size)
    else:
        v = weights[keep]
    # duplicate edges collapse via from_coo's dedup (sums); that retains
    # symmetry since both directions receive identical sums.
    vals = np.concatenate([v, v, np.full(m, float(m))])
    return CSRMatrix.from_coo(r, c, vals, (m, m))


def banded(m: int, half_bw: int, seed: int = 0) -> CSRMatrix:
    """Symmetric banded matrix, half-bandwidth `half_bw` (Fig. 1 left)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for d in range(1, half_bw + 1):
        i = np.arange(m - d)
        rows.append(i)
        cols.append(i + d)
    rows = np.concatenate(rows) if rows else np.empty(0, dtype=np.int64)
    cols = np.concatenate(cols) if cols else np.empty(0, dtype=np.int64)
    return _symmetrize_coo(rows, cols, m, rng)


def stencil_2d(nx: int, ny: int | None = None, seed: int = 0) -> CSRMatrix:
    """5-point Laplacian on an nx x ny grid (natural row-major ordering)."""
    ny = ny or nx
    rng = np.random.default_rng(seed)
    idx = np.arange(nx * ny).reshape(nx, ny)
    rows, cols = [], []
    rows.append(idx[:, :-1].ravel()); cols.append(idx[:, 1:].ravel())
    rows.append(idx[:-1, :].ravel()); cols.append(idx[1:, :].ravel())
    return _symmetrize_coo(np.concatenate(rows), np.concatenate(cols), nx * ny, rng)


def stencil_3d(nx: int, ny: int | None = None, nz: int | None = None, seed: int = 0) -> CSRMatrix:
    ny = ny or nx
    nz = nz or nx
    rng = np.random.default_rng(seed)
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    rows, cols = [], []
    rows.append(idx[:, :, :-1].ravel()); cols.append(idx[:, :, 1:].ravel())
    rows.append(idx[:, :-1, :].ravel()); cols.append(idx[:, 1:, :].ravel())
    rows.append(idx[:-1, :, :].ravel()); cols.append(idx[1:, :, :].ravel())
    return _symmetrize_coo(np.concatenate(rows), np.concatenate(cols), nx * ny * nz, rng)


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSRMatrix:
    """R-MAT power-law graph, 2^scale vertices (Graph500-style)."""
    rng = np.random.default_rng(seed)
    m = 1 << scale
    ne = m * edge_factor
    rows = np.zeros(ne, dtype=np.int64)
    cols = np.zeros(ne, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(ne)
        # quadrant probabilities (a, b, c, d)
        row_bit = (r >= a + b).astype(np.int64) * ((r < a + b + c).astype(np.int64) * 0 + 1)
        row_bit = (r >= a + b).astype(np.int64)
        col_bit = ((r >= a) & (r < a + b)).astype(np.int64) | (r >= a + b + c).astype(np.int64)
        rows |= row_bit << bit
        cols |= col_bit << bit
    return _symmetrize_coo(rows, cols, m, rng)


def sbm(m: int, communities: int, p_in: float, p_out: float, seed: int = 0) -> CSRMatrix:
    """Stochastic block model with a hidden (shuffled) community layout."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, communities, size=m)
    # expected degrees: d_in = (m/communities)*p_in, d_out = m*p_out
    n_in = int(m * (m / communities) * p_in / 2)
    n_out = int(m * m * p_out / 2)
    ri = rng.integers(0, m, size=2 * n_in)
    # sample within-community edges by matching labels via sort trick
    order = np.argsort(labels[ri], kind="stable")
    ri = ri[order]
    rows_in = ri[0::2][: n_in]
    cols_in = ri[1::2][: n_in]
    same = labels[rows_in] == labels[cols_in]
    rows_in, cols_in = rows_in[same], cols_in[same]
    rows_out = rng.integers(0, m, size=n_out)
    cols_out = rng.integers(0, m, size=n_out)
    rows = np.concatenate([rows_in, rows_out])
    cols = np.concatenate([cols_in, cols_out])
    return _symmetrize_coo(rows, cols, m, rng)


def small_world(m: int, k: int = 6, beta: float = 0.1, seed: int = 0) -> CSRMatrix:
    """Watts-Strogatz: ring lattice with k/2 neighbours each side, random
    rewiring with probability beta."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for d in range(1, k // 2 + 1):
        i = np.arange(m)
        j = (i + d) % m
        rewire = rng.random(m) < beta
        j = np.where(rewire, rng.integers(0, m, size=m), j)
        rows.append(i)
        cols.append(j)
    return _symmetrize_coo(np.concatenate(rows), np.concatenate(cols), m, rng)


def kron_graph(base_m: int, power: int, density: float = 0.3, seed: int = 0) -> CSRMatrix:
    """Kronecker power of a random base adjacency (recursive structure)."""
    rng = np.random.default_rng(seed)
    base = (rng.random((base_m, base_m)) < density).astype(np.float64)
    base = np.maximum(base, base.T)
    g = base
    for _ in range(power - 1):
        g = np.kron(g, base)
    np.fill_diagonal(g, 0)
    r, c = np.nonzero(g)
    return _symmetrize_coo(r, c, g.shape[0], rng)


def power_law(m: int, alpha: float = 2.1, max_deg: int | None = None,
              seed: int = 0) -> CSRMatrix:
    """Configuration-model graph with zipf(alpha) row degrees.

    The explicit row-skew stressor for the SELL-vs-ELL comparison: a few
    hub rows carry O(max_deg) nonzeros while the bulk stay at 1-3, so
    padded-ELL storage explodes (m * max_deg) while SELL-C-σ stays O(nnz).
    Lower alpha = heavier tail. Degrees are capped at max_deg
    (default m // 4) to keep the matrix buildable.
    """
    rng = np.random.default_rng(seed)
    cap = m // 4 if max_deg is None else max_deg
    deg = np.minimum(rng.zipf(alpha, size=m).astype(np.int64), max(cap, 1))
    # configuration model: pair stubs uniformly (hubs attract edges in
    # proportion to their degree, preserving the skew after symmetrization)
    stubs = np.repeat(np.arange(m, dtype=np.int64), deg)
    return _symmetrize_coo(stubs, rng.permutation(stubs), m, rng)


def random_uniform(m: int, avg_deg: int, seed: int = 0) -> CSRMatrix:
    """Erdos-Renyi-ish uniform random (Fig. 1 right regime)."""
    rng = np.random.default_rng(seed)
    ne = m * avg_deg // 2
    return _symmetrize_coo(rng.integers(0, m, ne), rng.integers(0, m, ne), m, rng)


def shuffle(mat: CSRMatrix, seed: int = 0) -> CSRMatrix:
    """The paper's Fig. 1 experiment: random symmetric row/col permutation."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(mat.m)
    return mat.permute(perm)
