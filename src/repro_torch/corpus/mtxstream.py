"""Streaming MatrixMarket ingestion: chunked parsing with bounded memory.

A whole-file reader holds the text, the token list and the full COO
triplet at once, several times the matrix's own footprint at peak.
SuiteSparse-scale files (10^7-10^8 coordinate lines) are parsed in
fixed-size coordinate blocks that assemble CSR directly, so the parser's
working set is bounded by the chunk size while the only O(nnz)
allocations are the output arrays themselves.

Two streaming passes over the data section:

  pass 1 — row occupancy: each chunk contributes per-row counts
           (symmetric files also count the mirrored off-diagonal
           entries); the exclusive scan of the counts is the final
           rowptr. Peak: one chunk's buffers + int64[m+1].
  pass 2 — placement: each chunk's entries land at per-row fill cursors
           (stable within-chunk ordering via one argsort per chunk), so
           cols/vals are written once, in place — no global COO sort of
           3x nnz temporary arrays.

A final per-row column ordering (one lexsort over the output arrays) and
a duplicate merge (the format forbids duplicates but assembled files ship
them; scipy semantics: sum) finish the build.

Supported: ``coordinate`` x ``real``/``integer``/``pattern`` x
``general``/``symmetric``. ``complex``/``hermitian``/``skew-symmetric``
fields and the dense ``array`` format are rejected with a clear error.

The port's own copy of the JAX package's parser: the same CSR arrays.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import obs
from ..core.sparse.csr import CSRMatrix

# Coordinate lines parsed per block. 2^18 lines is ~8 MB of text and
# ~6 MB of parsed buffers — invisible next to any matrix worth streaming,
# large enough that per-chunk overhead (seek bookkeeping, argsort setup)
# amortizes away.
DEFAULT_CHUNK_NNZ = 1 << 18

_FIELDS = ("real", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric")


@dataclasses.dataclass(frozen=True)
class MtxHeader:
    """Validated MatrixMarket banner + size line."""

    field: str      # real | integer | pattern
    symmetry: str   # general | symmetric
    m: int
    n: int
    nnz: int        # declared entry count (stored entries, pre-mirror)
    data_offset: int  # stream position of the first data line

    @property
    def ncols(self) -> int:
        return 2 if self.field == "pattern" else 3

    @property
    def symmetric(self) -> bool:
        return self.symmetry == "symmetric"


def read_header(path: str) -> MtxHeader:
    with open(path, "r") as f:
        return _parse_header(f, path)


def _parse_header(f, path: str) -> MtxHeader:
    banner = f.readline()
    if not banner.startswith("%%MatrixMarket"):
        raise ValueError(
            f"{path}: not a MatrixMarket file (banner starts {banner[:40]!r})")
    toks = banner.split()
    if len(toks) < 5:
        raise ValueError(
            f"{path}: malformed MatrixMarket banner {banner.strip()!r} "
            "(need '%%MatrixMarket object format field symmetry')")
    obj, fmt, field, sym = (t.lower() for t in toks[1:5])
    if obj != "matrix":
        raise ValueError(f"{path}: MatrixMarket object {obj!r} is not supported "
                         "(only 'matrix')")
    if fmt != "coordinate":
        raise ValueError(
            f"{path}: MatrixMarket format {fmt!r} is not supported — only "
            "sparse 'coordinate' files can be ingested (dense 'array' files "
            "have no sparse structure)")
    if field == "complex":
        raise ValueError(
            f"{path}: complex-valued MatrixMarket files are not supported — "
            "the SpMV pipeline is real-valued; extract the real part (or the "
            "magnitude) upstream and re-export as field 'real'")
    if field not in _FIELDS:
        raise ValueError(f"{path}: MatrixMarket field {field!r} is not supported "
                         f"(one of {_FIELDS})")
    if sym in ("hermitian", "skew-symmetric"):
        raise ValueError(
            f"{path}: MatrixMarket symmetry {sym!r} is not supported — only "
            f"{_SYMMETRIES}; re-export with the full (or lower-triangle "
            "symmetric) pattern")
    if sym not in _SYMMETRIES:
        raise ValueError(f"{path}: MatrixMarket symmetry {sym!r} is not supported "
                         f"(one of {_SYMMETRIES})")
    line = f.readline()
    while line and (line.startswith("%") or not line.strip()):
        line = f.readline()
    parts = line.split()
    if len(parts) != 3:
        raise ValueError(f"{path}: malformed MatrixMarket size line "
                         f"{line.strip()!r} (need 'm n nnz')")
    try:
        m, n, nnz = (int(p) for p in parts)
    except ValueError:
        raise ValueError(f"{path}: malformed MatrixMarket size line "
                         f"{line.strip()!r} (need three integers)") from None
    if m < 0 or n < 0 or nnz < 0:
        raise ValueError(f"{path}: negative dimension in size line {line.strip()!r}")
    if sym == "symmetric" and m != n:
        raise ValueError(f"{path}: symmetric MatrixMarket file must be square, "
                         f"got {m}x{n}")
    return MtxHeader(field=field, symmetry=sym, m=m, n=n, nnz=nnz,
                     data_offset=f.tell())


def _parse_chunk(lines, hdr: MtxHeader, lineno: int, path: str):
    """Parse one block of coordinate lines → (rows0, cols0, vals) 0-based."""
    nc = hdr.ncols
    toks = "".join(lines).split()
    if len(toks) != nc * len(lines):
        raise ValueError(
            f"{path}: malformed MatrixMarket data near line {lineno}: expected "
            f"{nc} whitespace-separated columns per entry for field "
            f"{hdr.field!r}")
    try:
        arr = np.asarray(toks, dtype=np.float64)
    except ValueError:
        raise ValueError(
            f"{path}: malformed MatrixMarket data near line {lineno}: "
            "non-numeric token") from None
    arr = arr.reshape(-1, nc)
    rc = arr[:, :2]
    if not np.all(rc == np.floor(rc)):
        raise ValueError(
            f"{path}: non-integer row/column index near line {lineno}")
    r = rc[:, 0].astype(np.int64) - 1
    c = rc[:, 1].astype(np.int64) - 1
    if r.size:
        if (int(r.min()) < 0 or int(c.min()) < 0
                or int(r.max()) >= hdr.m or int(c.max()) >= hdr.n):
            raise ValueError(
                f"{path}: coordinate out of range near line {lineno}: indices "
                f"are 1-based in [1, {hdr.m}] x [1, {hdr.n}]")
    if nc == 2:
        v = np.ones(r.size, dtype=np.float64)
    else:
        v = np.ascontiguousarray(arr[:, 2])
    return r, c, v


def _iter_chunks(path: str, hdr: MtxHeader, chunk_nnz: int,
                 stats: dict) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield parsed coordinate blocks of at most `chunk_nnz` entries.

    Enforces the declared entry count: raises on truncated files (fewer
    data lines than `nnz`) and on trailing non-blank garbage.
    """
    with open(path, "r") as f:
        f.seek(hdr.data_offset)
        consumed = 0
        while consumed < hdr.nnz:
            want = min(chunk_nnz, hdr.nnz - consumed)
            lines = []
            while len(lines) < want:
                line = f.readline()
                if not line:
                    raise ValueError(
                        f"{path}: truncated MatrixMarket file: header declares "
                        f"{hdr.nnz} entries, found {consumed + len(lines)}")
                if not line.strip():
                    continue
                lines.append(line)
            lineno = consumed + 1  # 1-based data line of the chunk start
            chunk = _parse_chunk(lines, hdr, lineno, path)
            consumed += len(lines)
            stats["chunks"] += 1
            stats["max_chunk_elems"] = max(stats["max_chunk_elems"], len(lines))
            yield chunk
        for line in f:
            if line.strip():
                raise ValueError(
                    f"{path}: MatrixMarket file has data beyond the declared "
                    f"{hdr.nnz} entries")


def _place(cursors: np.ndarray, r: np.ndarray, c: np.ndarray, v: np.ndarray,
           cols: np.ndarray, vals: np.ndarray) -> None:
    """Scatter one chunk into the output arrays at per-row fill cursors."""
    if r.size == 0:
        return
    order = np.argsort(r, kind="stable")
    rs = r[order]
    first = np.flatnonzero(np.r_[True, rs[1:] != rs[:-1]])
    runlen = np.diff(np.r_[first, rs.size])
    within = np.arange(rs.size, dtype=np.int64) - np.repeat(first, runlen)
    pos = cursors[rs] + within
    cols[pos] = c[order]
    vals[pos] = v[order]
    cursors[rs[first]] += runlen


def _mirror(r, c, v):
    """Append the transposed off-diagonal entries (symmetric expansion)."""
    off = r != c
    return (np.concatenate([r, c[off]]),
            np.concatenate([c, r[off]]),
            np.concatenate([v, v[off]]))


def parse_mtx(path: str, chunk_nnz: Optional[int] = None) -> Tuple[CSRMatrix, dict]:
    """Stream-parse a MatrixMarket file into CSR with bounded peak memory.

    Returns (matrix, stats). `stats["chunks"]` counts chunk parses across
    both passes (per-pass count = chunks // 2) and `stats["max_chunk_elems"]`
    never exceeds `chunk_nnz` — the chunk-count accounting that pins peak
    parser memory to the chunk size rather than the file size.
    """
    chunk_nnz = int(chunk_nnz if chunk_nnz is not None else DEFAULT_CHUNK_NNZ)
    if chunk_nnz < 1:
        raise ValueError(f"chunk_nnz must be >= 1, got {chunk_nnz}")
    hdr = read_header(path)
    stats = {"chunks": 0, "max_chunk_elems": 0, "passes": 2,
             "chunk_nnz": chunk_nnz, "declared_nnz": hdr.nnz,
             "field": hdr.field, "symmetry": hdr.symmetry,
             "duplicates_merged": 0}
    with obs.span("corpus.parse", path=os.path.basename(path), m=hdr.m,
                  n=hdr.n, declared_nnz=hdr.nnz, chunk_nnz=chunk_nnz,
                  field=hdr.field, symmetry=hdr.symmetry,
                  backend="torch") as sp:
        # pass 1: row occupancy
        counts = np.zeros(hdr.m, dtype=np.int64)
        for r, c, _ in _iter_chunks(path, hdr, chunk_nnz, stats):
            counts += np.bincount(r, minlength=hdr.m)
            if hdr.symmetric:
                off = r != c
                counts += np.bincount(c[off], minlength=hdr.m)
        rowptr = np.zeros(hdr.m + 1, dtype=np.int64)
        np.cumsum(counts, out=rowptr[1:])
        total = int(rowptr[-1])
        cols = np.empty(total, dtype=np.int64)
        vals = np.empty(total, dtype=np.float64)
        # pass 2: placement at per-row cursors
        cursors = rowptr[:-1].copy()
        for r, c, v in _iter_chunks(path, hdr, chunk_nnz, stats):
            if hdr.symmetric:
                r, c, v = _mirror(r, c, v)
            _place(cursors, r, c, v, cols, vals)
        sp.set(chunks=stats["chunks"], max_chunk_elems=stats["max_chunk_elems"])

    with obs.span("corpus.build", m=hdr.m, n=hdr.n, nnz=total,
                  backend="torch") as sp:
        # rows are already contiguous by construction; one stable lexsort
        # orders columns within each row.
        row_ids = np.repeat(np.arange(hdr.m, dtype=np.int64), np.diff(rowptr))
        order = np.lexsort((cols, row_ids))
        cols = cols[order]
        vals = vals[order]
        if total:
            key = row_ids * np.int64(max(hdr.n, 1)) + cols
            starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
            if starts.size != total:
                # duplicate coordinates: sum, matching CSRMatrix.from_coo
                # (and scipy's mmread).
                vals = np.add.reduceat(vals, starts)
                cols = cols[starts]
                row_ids = row_ids[starts]
                stats["duplicates_merged"] = total - int(starts.size)
                counts = np.bincount(row_ids, minlength=hdr.m)
                rowptr = np.zeros(hdr.m + 1, dtype=np.int64)
                np.cumsum(counts, out=rowptr[1:])
                total = int(starts.size)
        mat = CSRMatrix(rowptr=rowptr.astype(np.int32),
                        cols=cols.astype(np.int32),
                        vals=np.ascontiguousarray(vals),
                        shape=(hdr.m, hdr.n))
        sp.set(nnz=mat.nnz, duplicates_merged=stats["duplicates_merged"])
    obs.counter("corpus.parses").inc()
    stats.update(m=hdr.m, n=hdr.n, nnz=mat.nnz)
    return mat, stats


def read_mtx(path: str, chunk_nnz: Optional[int] = None) -> CSRMatrix:
    """Parse a MatrixMarket file into CSR (chunked)."""
    return parse_mtx(path, chunk_nnz=chunk_nnz)[0]
