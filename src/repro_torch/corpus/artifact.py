"""Device-ready `.csrz` artifact cache — a real matrix is parsed once, ever.

A `.csrz` artifact is the compact binary form of an ingested matrix:

    <key>.csrz       — compressed npz: indptr / indices / values / shape
                       (the exact CSRMatrix arrays, bit-identical on load)
    <key>.csrz.json  — structural-metrics sidecar: dims, density, the
                       tuner feature vector, locality summary, provenance
                       (source path + sha256 + parse accounting)

`key` is the streamed sha256 of the *source file bytes*, so re-ingesting
the same MatrixMarket file — any path, any process — resolves to the
cached artifact without touching the parser (`corpus.artifact_hits` vs
`corpus.parses` counters make this auditable). Writes follow the port's
cache convention (plan.py / opcache.py): tmp + atomic rename, npz first,
sidecar json LAST so a reader never sees a torn artifact; loads are
tolerant (any corruption → None → re-parse).

Cache root: $REPRO_TORCH_CORPUS_CACHE (default `repro_torch_corpus` under
the system temp directory; "off"/"0"/"none" disables, as the port's other
caches). The format is the JAX package's: either package loads the
other's artifacts.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from .. import obs
from ..core.sparse import metrics
from ..core.sparse.csr import CSRMatrix
from . import mtxstream

CSRZ_SCHEMA = 1

_OFF = ("off", "0", "none", "")


def cache_dir() -> str:
    return os.environ.get(
        "REPRO_TORCH_CORPUS_CACHE",
        os.path.join(tempfile.gettempdir(), "repro_torch_corpus"))


def cache_enabled() -> bool:
    return cache_dir().strip().lower() not in _OFF


def file_sha256(path: str, block_bytes: int = 1 << 20) -> str:
    """Streamed content hash of the source file — the artifact key."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(block_bytes)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def artifact_paths(key: str, root: Optional[str] = None) -> Tuple[str, str]:
    base = os.path.join(root or cache_dir(), key)
    return base + ".csrz", base + ".csrz.json"


def structural_meta(mat: CSRMatrix) -> dict:
    """The sidecar: everything the advisor/reporting layers read without
    ever loading the arrays."""
    from ..core.spmv.tune import matrix_features

    feat = matrix_features(mat)
    m, n = mat.shape
    return {
        "m": int(m),
        "n": int(n),
        "nnz": int(mat.nnz),
        "dtype": str(mat.vals.dtype),
        "density": float(mat.nnz) / max(float(m) * float(n), 1.0),
        "features": feat,
        "locality": metrics.summary(mat),
    }


def save_csrz(path: str, mat: CSRMatrix, meta: Optional[dict] = None) -> str:
    """Atomically write `<base>.csrz` + `<base>.csrz.json`; returns the
    npz path. `path` may be given with or without the .csrz suffix."""
    base = path[:-5] if path.endswith(".csrz") else path
    zpath, jpath = base + ".csrz", base + ".csrz.json"
    d = os.path.dirname(zpath)
    if d:
        os.makedirs(d, exist_ok=True)
    if meta is None:
        meta = structural_meta(mat)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    ztmp, jtmp = f"{zpath}.{tag}.tmp", f"{jpath}.{tag}.tmp"
    try:
        with open(ztmp, "wb") as f:
            np.savez_compressed(f, indptr=mat.rowptr, indices=mat.cols,
                                values=mat.vals,
                                shape=np.asarray(mat.shape, dtype=np.int64))
        os.replace(ztmp, zpath)
        with open(jtmp, "w") as f:
            json.dump({"schema": CSRZ_SCHEMA, "meta": meta}, f)
        os.replace(jtmp, jpath)  # json lands LAST: it gates reads
    except OSError:
        for t in (ztmp, jtmp):
            try:
                os.remove(t)
            except OSError:
                pass
        raise
    obs.counter("corpus.artifact_writes").inc()
    return zpath


def load_csrz(path: str) -> Optional[Tuple[CSRMatrix, dict]]:
    """Tolerant artifact load: (matrix, meta) or None on any miss or
    corruption (caller re-parses)."""
    base = path[:-5] if path.endswith(".csrz") else path
    zpath, jpath = base + ".csrz", base + ".csrz.json"
    try:
        with open(jpath) as f:
            rec = json.load(f)
        if rec.get("schema") != CSRZ_SCHEMA:
            return None
        with np.load(zpath) as z:
            mat = CSRMatrix(rowptr=np.ascontiguousarray(z["indptr"]),
                            cols=np.ascontiguousarray(z["indices"]),
                            vals=np.ascontiguousarray(z["values"]),
                            shape=tuple(int(s) for s in z["shape"]))
        if mat.rowptr.shape[0] != mat.shape[0] + 1:
            return None
        return mat, rec.get("meta", {})
    except Exception:
        return None


@dataclasses.dataclass
class IngestResult:
    mat: CSRMatrix
    meta: dict
    key: str             # content hash (or stand-in key) of the source
    artifact: str        # npz path ("" when caching is disabled)
    cache_hit: bool
    parse_stats: Optional[dict]  # None on a cache hit — nothing was parsed


def ingest_path(path: str, chunk_nnz: Optional[int] = None,
                cache: bool = True) -> IngestResult:
    """Ingest a MatrixMarket file through the artifact cache.

    Hit: zero parse work (the `corpus.parses` counter does not move).
    Miss: chunked parse (`corpus.parse`/`corpus.build` spans) + artifact
    write, keyed by the source file's sha256.
    """
    key = file_sha256(path)
    use_cache = cache and cache_enabled()
    zpath = artifact_paths(key)[0] if use_cache else ""
    if use_cache:
        hit = load_csrz(zpath)
        if hit is not None:
            obs.counter("corpus.artifact_hits").inc()
            mat, meta = hit
            return IngestResult(mat=mat, meta=meta, key=key, artifact=zpath,
                                cache_hit=True, parse_stats=None)
        obs.counter("corpus.artifact_misses").inc()
    mat, stats = mtxstream.parse_mtx(path, chunk_nnz=chunk_nnz)
    meta = structural_meta(mat)
    meta["source"] = {
        "path": os.path.abspath(path),
        "sha256": key,
        "field": stats["field"],
        "symmetry": stats["symmetry"],
        "parse": {k: stats[k] for k in
                  ("chunks", "chunk_nnz", "max_chunk_elems", "passes",
                   "duplicates_merged")},
    }
    if use_cache:
        save_csrz(zpath, mat, meta)
    return IngestResult(mat=mat, meta=meta, key=key, artifact=zpath,
                        cache_hit=False, parse_stats=stats)
