"""PaToH-style multilevel *hypergraph* partitioning / reordering (§2.1).

Column-net model [Catalyurek & Aykanat 1999]: vertices = rows of A, net j =
column j connecting every row with a nonzero in column j (for symmetric A,
net i = {i} ∪ neighbours(i)). Objective = connectivity-1 cut
(sum over nets of (#parts spanned - 1)) — the communication volume of
row-parallel SpMV, which is exactly what the distributed runtime pays.

Multilevel scheme mirrors metis.py but the refinement gain is net-based:
moving v across helps when v is a net's sole pin on its side (net becomes
uncut) and hurts when it breaks a pure net. Simplified vs real PaToH:
synchronous gain passes instead of sequential FM with a bucket queue;
exact connectivity recomputed per pass, best kept. The port's own copy of
the JAX package's numpy code: the same permutations and labels.
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSRMatrix
from . import graphutil
from .graphutil import Graph


def _net_side_counts(mat_rowptr, mat_cols, side):
    """For each net (= row i of symmetric A): pins = {i} ∪ cols(i).
    Returns (pins_on_1, pin_count) arrays over nets."""
    m = len(mat_rowptr) - 1
    counts = np.diff(mat_rowptr.astype(np.int64))
    on1 = np.zeros(m, dtype=np.int64)
    src = np.repeat(np.arange(m), counts)
    np.add.at(on1, src, side[mat_cols].astype(np.int64))
    on1 += side.astype(np.int64)  # the row vertex itself is a pin
    return on1, counts + 1


def connectivity_cut(mat: CSRMatrix, side: np.ndarray) -> int:
    on1, tot = _net_side_counts(mat.rowptr, mat.cols, side)
    return int(np.count_nonzero((on1 > 0) & (on1 < tot)))


def _refine_hg(mat: CSRMatrix, side: np.ndarray, passes: int = 4,
               tol: float = 0.08) -> np.ndarray:
    """Synchronous net-gain refinement on the fine hypergraph."""
    m = mat.m
    side = side.copy().astype(np.int8)
    best_side = side.copy()
    best_cut = connectivity_cut(mat, side)
    rowptr = mat.rowptr.astype(np.int64)
    src = np.repeat(np.arange(m), np.diff(rowptr))
    for _ in range(passes):
        on1, tot = _net_side_counts(mat.rowptr, mat.cols, side)
        on0 = tot - on1
        # per-vertex gain: a vertex v participates in net n (as row-pin of
        # its own net and as col-pin of nets of its neighbours). Moving v to
        # the other side: gain += 1 if v was the only pin on its side of n
        # (n becomes uncut); gain -= 1 if n was pure and v breaks it.
        own_count = np.where(side == 1, on1, on0)
        gain = np.zeros(m, dtype=np.int64)
        # contribution of v's own net:
        gain += (own_count == 1).astype(np.int64) - (own_count == tot).astype(np.int64)
        # contribution as a pin of each neighbour's net:
        n_own = np.where(side[src] == 1, on1[mat.cols], on0[mat.cols])
        # careful: for net of neighbour u (net id = column value), v=src pin side = side[src]
        n_own = np.where(side[src] == 1, on1[mat.cols], on0[mat.cols])
        n_tot = tot[mat.cols]
        contrib = (n_own == 1).astype(np.int64) - (n_own == n_tot).astype(np.int64)
        np.add.at(gain, src, contrib)
        cand = np.flatnonzero(gain > 0)
        if cand.size == 0:
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")]
        # keep balance
        total = m
        w1 = int(side.sum())
        delta = np.where(side[cand] == 1, -1, 1)
        run = w1 + np.cumsum(delta)
        ok = (run >= total * (0.5 - tol)) & (run <= total * (0.5 + tol))
        limit = max(1, cand.size // 2)
        sel = cand[:limit][ok[:limit]]
        if sel.size == 0:
            break
        side[sel] ^= 1
        cut = connectivity_cut(mat, side)
        if cut < best_cut:
            best_cut, best_side = cut, side.copy()
    return best_side


def _bisect_hg(mat: CSRMatrix, vertices: np.ndarray, g: Graph,
               rng: np.random.Generator) -> np.ndarray:
    """Bisection of the induced sub(hyper)graph: seed with the graph
    bisection (heavy-edge multilevel — a good hypergraph start since the
    clique-net expansion of the column-net model is the graph itself), then
    refine with the true connectivity-1 objective."""
    from .metis import bisect

    sub_g = graphutil.subgraph(g, vertices)
    side = bisect(sub_g, rng)
    # build the induced CSR submatrix for net-based refinement
    sub = _induced_csr(mat, vertices)
    side = _refine_hg(sub, side)
    return side


def _induced_csr(mat: CSRMatrix, vertices: np.ndarray) -> CSRMatrix:
    m = mat.m
    local = np.full(m, -1, dtype=np.int64)
    local[vertices] = np.arange(vertices.size)
    rowptr = mat.rowptr.astype(np.int64)
    src = np.repeat(np.arange(m), np.diff(rowptr))
    keep = (local[src] >= 0) & (local[mat.cols] >= 0)
    return CSRMatrix.from_coo(local[src[keep]], local[mat.cols[keep]],
                              mat.vals[keep], (vertices.size, vertices.size))


def patoh_order(mat: CSRMatrix, seed: int = 0, leaf: int | None = None) -> np.ndarray:
    g = graphutil.from_matrix(mat)
    rng = np.random.default_rng(seed)
    # cap recursion depth on big matrices: locality plateaus past
    # ~32 partitions while cost keeps growing linearly
    leaf = leaf or max(64, mat.m // 32)
    out: list = []

    def rec(vertices):
        if vertices.size <= leaf:
            out.append(vertices)
            return
        side = _bisect_hg(mat, vertices, g, rng)
        left, right = vertices[side == 0], vertices[side == 1]
        if left.size == 0 or right.size == 0:
            out.append(vertices)
            return
        rec(left)
        rec(right)

    rec(np.arange(mat.m, dtype=np.int64))
    return np.concatenate(out)


def patoh_partition(mat: CSRMatrix, k: int, seed: int = 0) -> np.ndarray:
    g = graphutil.from_matrix(mat)
    rng = np.random.default_rng(seed)
    labels = np.zeros(mat.m, dtype=np.int64)
    parts = [np.arange(mat.m, dtype=np.int64)]
    for _ in range(int(np.ceil(np.log2(max(k, 1))))):
        nxt = []
        for p in parts:
            if p.size <= 1:
                nxt.append(p)
                continue
            side = _bisect_hg(mat, p, g, rng)
            nxt.append(p[side == 0])
            nxt.append(p[side == 1])
        parts = nxt
    for i, p in enumerate(parts):
        labels[p] = i
    return labels
