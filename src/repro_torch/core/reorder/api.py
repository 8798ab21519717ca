"""Reordering API + disk cache.

reorder(mat, scheme, seed) -> permutation (perm[i] = old row at position i)

Schemes: baseline (identity), random (the paper's Fig. 1 shuffle), rcm
(paper §2.1) and the beyond-paper rcm_blocked (block-fill-aware
tie-break). METIS, PaToH and Louvain are not ported yet.

Reordering is plan-time preprocessing (the paper never times it). With
cache=True a permutation is content-addressed on disk, written
write-then-rename so a concurrent run never reads a torn .npy. The cache
directory is the port's own (REPRO_TORCH_REORDER_CACHE, default
`repro_torch_reorder` under the system temp directory).
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import threading

import numpy as np

from ... import obs
from ..registry import get_scheme, register_scheme
from ..sparse.csr import CSRMatrix
from .rcm import rcm_order


def _cache_dir() -> str:
    # read per call (not at import) so tests can repoint it via monkeypatch
    return os.environ.get(
        "REPRO_TORCH_REORDER_CACHE",
        os.path.join(tempfile.gettempdir(), "repro_torch_reorder"))


@register_scheme("baseline", auto_candidate=True,
                 description="identity (no reordering)")
def _identity(mat: CSRMatrix, seed: int = 0) -> np.ndarray:
    return np.arange(mat.m, dtype=np.int64)


@register_scheme("random", description="random shuffle (paper Fig. 1)")
def _random(mat: CSRMatrix, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).permutation(mat.m).astype(np.int64)


register_scheme("rcm", paper=True, auto_candidate=True,
                description="reverse Cuthill-McKee")(rcm_order)


@register_scheme("rcm_blocked", auto_candidate=True,
                 description="RCM + block-fill-aware within-window packing")
def _rcm_blocked(mat: CSRMatrix, seed: int = 0, block: int = 8) -> np.ndarray:
    """RCM followed by a within-window pass that packs rows with similar
    column-block signatures into the same block row (denser blocks)."""
    base = rcm_order(mat, seed)
    rmat = mat.permute(base)
    m = rmat.m
    win = block * 8
    perm_local = np.arange(m, dtype=np.int64)
    rp = rmat.rowptr.astype(np.int64)
    cols = rmat.cols.astype(np.int64)
    # signature = min col-block touched (cheap proxy for tile overlap);
    # rowptr-gather over all rows at once, empty rows keep the sentinel
    sig = np.full(m, np.iinfo(np.int64).max)
    nonempty = rp[1:] > rp[:-1]
    sig[nonempty] = cols[rp[:-1][nonempty]] // 128
    for w0 in range(0, m, win):
        w1 = min(w0 + win, m)
        rows = np.arange(w0, w1)
        order = np.argsort(sig[w0:w1], kind="stable")
        perm_local[w0:w1] = rows[order]
    return base[perm_local]


def _content_key(mat: CSRMatrix, scheme: str, seed: int) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mat.rowptr).tobytes())
    h.update(np.ascontiguousarray(mat.cols).tobytes())
    h.update(f"{scheme}:{seed}".encode())
    return h.hexdigest()[:20]


def reorder(mat: CSRMatrix, scheme: str, seed: int = 0,
            cache: bool = True) -> np.ndarray:
    fn = get_scheme(scheme).fn
    with obs.span("plan.reorder", scheme=scheme, seed=int(seed),
                  shape=str(tuple(mat.shape)), backend="torch") as sp:
        if not cache:
            return fn(mat, seed)
        cache_dir = _cache_dir()
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir,
                            _content_key(mat, scheme, seed) + ".npy")
        if os.path.exists(path):
            obs.counter("reorder_cache.hits").inc()
            sp.set(cache_hit=True)
            return np.load(path)
        obs.counter("reorder_cache.misses").inc()
        sp.set(cache_hit=False)
        perm = fn(mat, seed)
        # write-then-rename (tmp name carries pid AND thread id) so a
        # concurrent run never reads a torn .npy
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, perm)
        os.replace(tmp, path)
        return perm
