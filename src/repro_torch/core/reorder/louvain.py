"""Louvain community detection as a reordering (paper §2.1).

Vectorized synchronous variant of Blondel et al. 2008: local-move sweeps
computed for all vertices at once (each vertex picks the neighbouring
community with max modularity gain; a fraction of movers is applied per
sweep to damp oscillation), then community aggregation, repeated until
modularity stalls. Ordering = communities concatenated (hierarchically:
the aggregated graph's ordering recursively orders the communities),
vertices within a community kept in original relative order. The port's
own copy of the JAX package's numpy code: the same rng draws and order.
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSRMatrix
from . import graphutil
from .graphutil import Graph


def _local_moves(g: Graph, comm: np.ndarray, rng: np.random.Generator,
                 sweeps: int = 8) -> np.ndarray:
    """Synchronous local-move phase. Returns updated community labels."""
    m = g.m
    src = g.edge_sources()
    two_m = g.weights.sum()  # = 2|E| for symmetric input
    if two_m == 0:
        return comm
    k = np.zeros(m)  # weighted degree
    np.add.at(k, src, g.weights)
    comm = comm.copy()
    for s in range(sweeps):
        sigma_tot = np.zeros(m)
        np.add.at(sigma_tot, comm, k)
        # weight from each vertex to each neighbouring community:
        key = src * np.int64(m) + comm[g.indices]
        uk, inv = np.unique(key, return_inverse=True)
        w_vc = np.zeros(uk.size)
        np.add.at(w_vc, inv, g.weights)
        v_of = (uk // m).astype(np.int64)
        c_of = (uk % m).astype(np.int64)
        # modularity gain of moving v into community c (after removal from own):
        # dQ ∝ w_vc - k_v * sigma_tot(c \ v) / two_m
        sig_adj = sigma_tot[c_of] - np.where(comm[v_of] == c_of, k[v_of], 0.0)
        gain = w_vc - k[v_of] * sig_adj / two_m
        # current community score for each vertex (gain of staying = its own entry)
        # pick per-vertex argmax via lexsort trick
        order = np.lexsort((gain, v_of))
        vo = v_of[order]
        seg_end = np.flatnonzero(np.diff(np.append(vo, m)) != 0)
        best_c = np.full(m, -1, dtype=np.int64)
        best_g = np.full(m, -np.inf)
        best_c[vo[seg_end]] = c_of[order][seg_end]
        best_g[vo[seg_end]] = gain[order][seg_end]
        # gain of keeping current community
        cur_key_gain = np.full(m, 0.0)
        own = comm[v_of] == c_of
        cur_key_gain[v_of[own]] = gain[own]
        movers = np.flatnonzero((best_c >= 0) & (best_c != comm) &
                                (best_g > cur_key_gain + 1e-12))
        if movers.size == 0:
            break
        # damp: move a random half on even sweeps (synchronous Louvain trick)
        if movers.size > 1:
            movers = movers[rng.random(movers.size) < 0.7]
        comm[movers] = best_c[movers]
    # compact labels
    _, comm = np.unique(comm, return_inverse=True)
    return comm


def louvain_communities(mat: CSRMatrix, seed: int = 0, max_levels: int = 6):
    """Returns (labels per level list, final labels on original vertices)."""
    g = graphutil.from_matrix(mat)
    rng = np.random.default_rng(seed)
    mapping = np.arange(g.m, dtype=np.int64)  # original -> current coarse id
    levels = []
    for _ in range(max_levels):
        comm = _local_moves(g, np.arange(g.m, dtype=np.int64), rng)
        ncomm = int(comm.max()) + 1 if comm.size else 0
        levels.append(comm)
        if ncomm >= g.m or ncomm <= 1:
            break
        # aggregate
        g, _ = _aggregate(g, comm)
        mapping = comm[mapping]
    return levels, mapping


def _aggregate(g: Graph, comm: np.ndarray):
    src = g.edge_sources()
    cm = int(comm.max()) + 1
    cs, cd = comm[src], comm[g.indices]
    keep = cs != cd
    key = cs[keep] * np.int64(cm) + cd[keep]
    uk, inv = np.unique(key, return_inverse=True)
    w = np.zeros(uk.size)
    np.add.at(w, inv, g.weights[keep])
    indptr = np.zeros(cm + 1, dtype=np.int64)
    np.add.at(indptr, (uk // cm).astype(np.int64) + 1, 1)
    indptr = np.cumsum(indptr)
    vwgt = np.zeros(cm)
    np.add.at(vwgt, comm, g.vwgt)
    return Graph(indptr=indptr, indices=(uk % cm).astype(np.int32),
                 weights=w, vwgt=vwgt), None


def louvain_order(mat: CSRMatrix, seed: int = 0) -> np.ndarray:
    """Order = sort by final community id (stable -> original order within),
    communities themselves ordered by the hierarchy's discovery order."""
    _, labels = louvain_communities(mat, seed)
    return np.argsort(labels, kind="stable").astype(np.int64)
