"""Graph machinery for the reorderers (vectorized numpy): the graph view
of a matrix, and the coarsening of the multilevel partitioners (heavy-edge
matching, contraction, induced subgraphs, cut weights).

A CSRMatrix is viewed as an undirected weighted graph: vertices = rows,
edges = off-diagonal nonzeros, weight = |a_ij| (symmetric input guaranteed
by the corpus, mirroring the paper's symmetric-only filter). The port's own
copy of the JAX package's numpy code: the same arrays, bit for bit.
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
    vwgt: np.ndarray     # float64[m] vertex weights (coarsening mass)

    @property
    def m(self) -> int:
        return len(self.indptr) - 1

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def edge_sources(self) -> np.ndarray:
        return np.repeat(np.arange(self.m), self.degrees()).astype(np.int64)


def from_matrix(mat: CSRMatrix, degree_weighted: bool = False) -> Graph:
    """degree_weighted: vertex weight = row nnz instead of 1, so balanced
    bisections balance nnz (the paper's load-balance object) instead of the
    vertex count."""
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


def heavy_edge_matching(g: Graph, rng: np.random.Generator, rounds: int = 3) -> np.ndarray:
    """Parallel heavy-edge matching: each vertex proposes to its heaviest
    unmatched neighbour; mutual proposals match. Returns match[v] = partner
    (or v itself if unmatched). Fully vectorized."""
    m = g.m
    match = np.arange(m, dtype=np.int64)
    matched = np.zeros(m, dtype=bool)
    src = g.edge_sources()
    for _ in range(rounds):
        free = ~matched
        # mask edges between free vertices
        ok = free[src] & free[g.indices]
        if not ok.any():
            break
        w = np.where(ok, g.weights, -np.inf)
        # per-source argmax via segmented reduction
        # trick: sort by (src, w) and take last per segment
        order = np.lexsort((w, src))
        s_sorted = src[order]
        last = np.zeros(m, dtype=np.int64) - 1
        # positions where segment ends
        seg_end = np.flatnonzero(np.diff(np.append(s_sorted, m)) != 0)
        cand = np.full(m, -1, dtype=np.int64)
        valid_end = seg_end[w[order][seg_end] > -np.inf]
        cand[s_sorted[valid_end]] = g.indices[order][valid_end]
        # mutual match
        has = cand >= 0
        mutual = has & (cand[np.clip(cand, 0, m - 1)] == np.arange(m)) & (cand != np.arange(m))
        a = np.flatnonzero(mutual)
        b = cand[a]
        pick = a < b  # each pair once
        a, b = a[pick], b[pick]
        match[a] = b
        match[b] = a
        matched[a] = True
        matched[b] = True
    return match


def coarsen(g: Graph, match: np.ndarray):
    """Contract matched pairs. Returns (coarse_graph, cmap) where
    cmap[v] = coarse vertex id of v."""
    m = g.m
    rep = np.minimum(np.arange(m), match)  # pair representative
    uniq, cmap = np.unique(rep, return_inverse=True)
    cm = uniq.size
    src = g.edge_sources()
    cs, cd = cmap[src], cmap[g.indices]
    keep = cs != cd
    key = cs[keep] * cm + cd[keep]
    uk, inv = np.unique(key, return_inverse=True)
    w = np.zeros(uk.size)
    np.add.at(w, inv, g.weights[keep])
    new_src = (uk // cm).astype(np.int64)
    new_dst = (uk % cm).astype(np.int32)
    indptr = np.zeros(cm + 1, dtype=np.int64)
    np.add.at(indptr, new_src + 1, 1)
    indptr = np.cumsum(indptr)
    vwgt = np.zeros(cm)
    np.add.at(vwgt, cmap, g.vwgt)
    return Graph(indptr=indptr, indices=new_dst, weights=w, vwgt=vwgt), cmap


def subgraph(g: Graph, vertices: np.ndarray):
    """Induced subgraph. Returns (sub, local_ids_of_vertices_order)."""
    m = g.m
    sel = np.zeros(m, dtype=bool)
    sel[vertices] = True
    local = np.full(m, -1, dtype=np.int64)
    local[vertices] = np.arange(vertices.size)
    src = g.edge_sources()
    keep = sel[src] & sel[g.indices]
    s = local[src[keep]]
    d = local[g.indices[keep]]
    w = g.weights[keep]
    indptr = np.zeros(vertices.size + 1, dtype=np.int64)
    np.add.at(indptr, s + 1, 1)
    indptr = np.cumsum(indptr)
    order = np.argsort(s, kind="stable")
    return Graph(indptr=indptr, indices=d[order].astype(np.int32),
                 weights=w[order], vwgt=g.vwgt[vertices])


def neighbor_side_weights(g: Graph, side: np.ndarray):
    """For each vertex: (weight to side 0, weight to side 1)."""
    src = g.edge_sources()
    to1 = np.zeros(g.m)
    np.add.at(to1, src, g.weights * side[g.indices])
    tot = np.zeros(g.m)
    np.add.at(tot, src, g.weights)
    return tot - to1, to1


def edge_cut(g: Graph, side: np.ndarray) -> float:
    src = g.edge_sources()
    return float(np.sum(g.weights[side[src] != side[g.indices]]) / 2.0)
