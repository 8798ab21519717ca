"""Corpus manifest: declarative registry of real matrices, resolved offline.

`manifest.json` pins ~10 well-known SuiteSparse matrices (expected dims,
the archive URL the JAX package downloads from) plus the bundled tiny
fixtures under `fixtures/`. Every entry resolves through one funnel:

    corpus://<name>  →  ensure(name)  →  IngestResult (.csrz artifact)

The first rung that works wins:
  1. bundled fixture        — checked-in .mtx, content-hash ingest
  2. a local .mtx           — `<cache>/mtx/<name>.mtx` placed there by the
                              user, content-hash ingest
  3. offline stand-in       — deterministic synthetic matrix at the
                              entry's scale (exact m, approximate nnz),
                              cached as a first-class .csrz artifact

The port downloads nothing: the manifest's URLs stay unused, and an entry
with no local file resolves to its stand-in. A stand-in's sidecar carries
`"standin": true` so reports can never pass synthetic numbers off as the
real matrix. The stand-ins are the JAX package's, bit for bit (the same
seeds, generators and `_STANDIN_VERSION`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zlib
from typing import Dict, Optional

from .. import obs
from ..core.sparse.csr import CSRMatrix
from . import artifact as artifact_mod

CORPUS_PREFIX = "corpus://"
MANIFEST_PATH = os.path.join(os.path.dirname(__file__), "manifest.json")
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")

_STANDIN_VERSION = 1  # bump to invalidate cached stand-in artifacts

_KINDS = ("mesh", "graph", "web", "fixture")


@dataclasses.dataclass(frozen=True)
class CorpusEntry:
    """One manifest row. `url` and `sha256` describe the real matrix's
    archive; the port reads neither."""

    name: str
    group: str
    m: int
    n: int
    nnz: int                 # expected nnz of the ASSEMBLED CSR (post-mirror)
    symmetric: bool
    kind: str                # mesh | graph | web | fixture (stand-in family)
    url: Optional[str] = None
    sha256: Optional[str] = None
    fixture: Optional[str] = None
    tags: tuple = ()

    @property
    def qualified(self) -> str:
        return CORPUS_PREFIX + self.name


def load_manifest(path: Optional[str] = None) -> Dict[str, CorpusEntry]:
    path = path or MANIFEST_PATH
    with open(path) as f:
        raw = json.load(f)
    entries: Dict[str, CorpusEntry] = {}
    for rec in raw["matrices"]:
        e = CorpusEntry(name=rec["name"], group=rec.get("group", ""),
                        m=int(rec["m"]), n=int(rec["n"]), nnz=int(rec["nnz"]),
                        symmetric=bool(rec["symmetric"]), kind=rec["kind"],
                        url=rec.get("url"), sha256=rec.get("sha256"),
                        fixture=rec.get("fixture"),
                        tags=tuple(rec.get("tags", ())))
        if e.name in entries:
            raise ValueError(f"{path}: duplicate corpus entry {e.name!r}")
        if e.kind not in _KINDS:
            raise ValueError(f"{path}: entry {e.name!r} has unknown kind "
                             f"{e.kind!r} (one of {_KINDS})")
        if e.url is None and e.fixture is None:
            raise ValueError(f"{path}: entry {e.name!r} has neither url nor "
                             "fixture — unresolvable")
        if e.m <= 0 or e.n <= 0 or e.nnz <= 0:
            raise ValueError(f"{path}: entry {e.name!r} has non-positive dims")
        entries[e.name] = e
    return entries


def get_entry(name: str) -> CorpusEntry:
    if name.startswith(CORPUS_PREFIX):
        name = name[len(CORPUS_PREFIX):]
    entries = load_manifest()
    try:
        return entries[name]
    except KeyError:
        known = ", ".join(sorted(entries))
        raise KeyError(f"unknown corpus matrix {name!r}; manifest has: "
                       f"{known}") from None


def corpus_names() -> list:
    """Qualified corpus:// names, the form the suite registry exposes."""
    return [CORPUS_PREFIX + n for n in sorted(load_manifest())]


def local_mtx_path(entry: CorpusEntry) -> str:
    """Where the entry's .mtx is read from: the bundled fixture, or
    `<cache>/mtx/<name>.mtx`."""
    if entry.fixture:
        return os.path.join(FIXTURE_DIR, entry.fixture)
    return os.path.join(artifact_mod.cache_dir(), "mtx", f"{entry.name}.mtx")


# -- offline stand-ins -----------------------------------------------------

def _standin_key(entry: CorpusEntry) -> str:
    sig = f"standin:v{_STANDIN_VERSION}:{entry.name}:{entry.m}:{entry.n}:" \
          f"{entry.nnz}:{entry.kind}"
    return hashlib.sha256(sig.encode()).hexdigest()


def standin(entry: CorpusEntry) -> CSRMatrix:
    """Deterministic synthetic matrix at the entry's scale: exact m (the
    quantity the scale stamp keys on), nnz matched to the entry's average
    degree, structural family matched to `kind`."""
    from ..matrices import generators

    seed = zlib.crc32(entry.name.encode()) & 0x7FFFFFFF
    deg = max(1, round(entry.nnz / max(entry.m, 1)))
    if entry.kind in ("mesh", "fixture"):
        half_bw = max(1, (deg - 1) // 2)
        return generators.banded(entry.m, half_bw, seed=seed)
    if entry.kind == "graph":
        return generators.random_uniform(entry.m, deg, seed=seed)
    # web: the row-skew regime
    return generators.power_law(entry.m, alpha=2.1, seed=seed)


def _ensure_standin(entry: CorpusEntry) -> artifact_mod.IngestResult:
    key = _standin_key(entry)
    use_cache = artifact_mod.cache_enabled()
    zpath = artifact_mod.artifact_paths(key)[0] if use_cache else ""
    if use_cache:
        hit = artifact_mod.load_csrz(zpath)
        if hit is not None:
            obs.counter("corpus.artifact_hits").inc()
            mat, meta = hit
            return artifact_mod.IngestResult(mat=mat, meta=meta, key=key,
                                             artifact=zpath, cache_hit=True,
                                             parse_stats=None)
        obs.counter("corpus.artifact_misses").inc()
    with obs.span("corpus.standin", matrix=entry.name, m=entry.m,
                  kind=entry.kind, backend="torch"):
        mat = standin(entry)
        meta = artifact_mod.structural_meta(mat)
        meta["standin"] = True
        meta["source"] = {"name": entry.name, "kind": entry.kind,
                          "target_nnz": entry.nnz,
                          "version": _STANDIN_VERSION}
        if use_cache:
            artifact_mod.save_csrz(zpath, mat, meta)
    obs.counter("corpus.standins").inc()
    return artifact_mod.IngestResult(mat=mat, meta=meta, key=key,
                                     artifact=zpath, cache_hit=False,
                                     parse_stats=None)


# -- the resolution funnel -------------------------------------------------

def _check_dims(entry: CorpusEntry, res: artifact_mod.IngestResult) -> None:
    got = (res.mat.m, res.mat.n, res.mat.nnz)
    want = (entry.m, entry.n, entry.nnz)
    if got != want:
        raise ValueError(
            f"corpus entry {entry.name!r}: manifest expects m/n/nnz {want}, "
            f"ingested file has {got} — stale manifest or wrong file")


def ensure(name: str,
           chunk_nnz: Optional[int] = None) -> artifact_mod.IngestResult:
    """Resolve a corpus name to an ingested artifact (the funnel above)."""
    entry = get_entry(name)
    mtx = local_mtx_path(entry)
    if os.path.exists(mtx):
        res = artifact_mod.ingest_path(mtx, chunk_nnz=chunk_nnz)
        _check_dims(entry, res)
        return res
    if entry.fixture:
        raise FileNotFoundError(
            f"corpus entry {entry.name!r}: bundled fixture {mtx} is missing")
    return _ensure_standin(entry)


def resolve(name: str, chunk_nnz: Optional[int] = None) -> CSRMatrix:
    """corpus://<name> → CSRMatrix (what `matrices.suite.get` delegates to)."""
    return ensure(name, chunk_nnz=chunk_nnz).mat


def verify_entry(name: str) -> dict:
    """Consistency report for one entry: artifact present? sidecar matches
    a recomputed structural summary? dims match the manifest?"""
    entry = get_entry(name)
    report = {"name": entry.name, "ok": True, "problems": [], "artifact": None,
              "standin": None}
    res = ensure(name)
    report["artifact"] = res.artifact
    report["standin"] = bool(res.meta.get("standin"))
    fresh = artifact_mod.structural_meta(res.mat)
    for fld in ("m", "n", "nnz"):
        if fresh[fld] != res.meta.get(fld):
            report["problems"].append(
                f"sidecar {fld}={res.meta.get(fld)} != recomputed {fresh[fld]}")
    if not report["standin"]:
        want = (entry.m, entry.n, entry.nnz)
        got = (fresh["m"], fresh["n"], fresh["nnz"])
        if want != got:
            report["problems"].append(f"manifest dims {want} != artifact {got}")
    elif fresh["m"] != entry.m or fresh["n"] != entry.n:
        report["problems"].append(
            f"stand-in shape {(fresh['m'], fresh['n'])} != manifest "
            f"{(entry.m, entry.n)}")
    report["ok"] = not report["problems"]
    return report
