"""Reverse Cuthill-McKee ordering (paper §2.1, the sequential-case winner).

Own implementation (validated in tests against
scipy.sparse.csgraph.reverse_cuthill_mckee):
  * pseudo-peripheral start vertex per connected component (George & Liu
    double-BFS heuristic),
  * BFS visiting neighbours in order of increasing degree,
  * final ordering reversed.

Vectorized level-by-level BFS: each frontier expansion is one numpy gather +
lexsort, so cost is O(levels) python overhead, O(nnz) work.
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSRMatrix
from . import graphutil


def _bfs_levels(g: graphutil.Graph, start: int, component_mask: np.ndarray):
    """Level sets of BFS from start (within component). Returns (levels list,
    level id array)."""
    m = g.m
    level = np.full(m, -1, dtype=np.int64)
    level[start] = 0
    frontier = np.array([start], dtype=np.int64)
    levels = [frontier]
    lv = 0
    while True:
        # gather all neighbours of frontier (vectorized range concat)
        counts = g.indptr[frontier + 1] - g.indptr[frontier]
        if counts.sum() == 0:
            break
        nbrs = g.indices[_ranges(g.indptr, frontier, counts)]
        nbrs = np.unique(nbrs)
        nbrs = nbrs[(level[nbrs] < 0) & component_mask[nbrs]]
        if nbrs.size == 0:
            break
        lv += 1
        level[nbrs] = lv
        frontier = nbrs
        levels.append(frontier)
    return levels, level


def _cm_component_exact(g, deg, visited, comp_seed, order, pos):
    """Classic per-vertex Cuthill-McKee queue (exact; O(m) python loop)."""
    queue = [comp_seed]
    visited[comp_seed] = True
    head = 0
    while head < len(queue):
        v = queue[head]
        head += 1
        order[pos] = v
        pos += 1
        nb = g.indices[g.indptr[v]:g.indptr[v + 1]]
        nb = nb[~visited[nb]]
        if nb.size:
            nb = np.unique(nb)  # dedup parallel edges
            nb = nb[~visited[nb]]
            nb = nb[np.argsort(deg[nb], kind="stable")]
            visited[nb] = True
            queue.extend(nb.tolist())
    return pos


def _cm_component_leveled(g, deg, visited, comp_seed, order, pos):
    """Level-vectorized Cuthill-McKee: each BFS level is ordered by
    (position of first parent, degree) via one lexsort — the standard
    parallel-CM relaxation (identical level sets, near-identical in-level
    order). O(levels) python overhead instead of O(m)."""
    m = g.m
    rank = np.full(m, np.iinfo(np.int64).max, dtype=np.int64)
    visited[comp_seed] = True
    frontier = np.array([comp_seed], dtype=np.int64)
    rank[comp_seed] = 0
    while frontier.size:
        order[pos:pos + frontier.size] = frontier
        pos += frontier.size
        counts = g.indptr[frontier + 1] - g.indptr[frontier]
        if counts.sum() == 0:
            break
        idx = np.concatenate([np.arange(g.indptr[v], g.indptr[v + 1]) for v in frontier]) \
            if frontier.size < 128 else _ranges(g.indptr, frontier, counts)
        nbrs = g.indices[idx]
        parent_rank = np.repeat(rank[frontier], counts)
        fresh = ~visited[nbrs]
        nbrs, parent_rank = nbrs[fresh], parent_rank[fresh]
        if nbrs.size == 0:
            break
        # min parent rank per child
        orderv = np.lexsort((parent_rank, nbrs))
        nb_s = nbrs[orderv]
        first = np.ones(nb_s.size, dtype=bool)
        first[1:] = nb_s[1:] != nb_s[:-1]
        kids = nb_s[first]
        kid_parent = parent_rank[orderv][first]
        sortk = np.lexsort((deg[kids], kid_parent))
        kids = kids[sortk]
        visited[kids] = True
        rank[kids] = np.arange(kids.size)
        frontier = kids
    return pos


def _ranges(indptr, verts, counts):
    """Concatenated index ranges [indptr[v], indptr[v+1]) — vectorized."""
    total = int(counts.sum())
    out = np.ones(total, dtype=np.int64)
    starts = np.zeros(len(verts) + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    out[starts[:-1]] = indptr[verts]
    out[starts[1:-1]] -= indptr[verts[:-1]] + counts[:-1] - 1
    return np.cumsum(out)


def rcm_order(mat: CSRMatrix, seed: int = 0) -> np.ndarray:
    """Returns perm with perm[i] = original row at new position i.

    Exact queue-CM for small matrices; level-vectorized CM above 100k rows
    (same algorithmic definition, lexsort tie-break per level)."""
    g = graphutil.from_matrix(mat)
    m = g.m
    deg = g.degrees()
    visited = np.zeros(m, dtype=bool)
    order = np.empty(m, dtype=np.int64)
    component = _cm_component_exact if m <= 100_000 else _cm_component_leveled
    pos = 0
    # iterate components in order of their min-degree vertex (deterministic)
    while pos < m:
        remaining = np.flatnonzero(~visited)
        comp_seed = _pseudo_peripheral_masked(g, remaining, deg, visited)
        pos = component(g, deg, visited, comp_seed, order, pos)
    return order[::-1].copy()  # the Reverse in RCM


def _pseudo_peripheral_masked(g, remaining, deg, visited):
    mask = ~visited
    start = remaining[np.argmin(deg[remaining])]
    best_ecc = -1
    for _ in range(4):
        levels, _ = _bfs_levels(g, int(start), mask)
        ecc = len(levels) - 1
        if ecc <= best_ecc:
            break
        best_ecc = ecc
        last = levels[-1]
        start = last[np.argmin(deg[last])]
    return int(start)
