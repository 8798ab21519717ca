"""repro_torch.corpus — the offline real-matrix corpus: streaming
MatrixMarket ingestion, the `.csrz` artifact cache, the declarative
manifest with its deterministic stand-ins, and the learned tuner.

    from repro_torch import corpus

    mat = corpus.resolve("corpus://bcsstk17")   # fixture|local .mtx|stand-in
    res = corpus.ingest_path("matrix.mtx")      # chunked parse, cached
    corpus.corpus_names()                       # manifest listing

`corpus://` names also resolve through `repro_torch.matrices.suite.get`,
so experiment specs consume the corpus like any synthetic matrix. The
learned tuner lives in `corpus.advisor` and is reached through
`plan(problem, probe="learned")`. Nothing is downloaded.

CLI: `python -m repro_torch.corpus {list,ingest,verify} [--trace PATH]`.
"""
from __future__ import annotations

from .artifact import (IngestResult, cache_dir, file_sha256, ingest_path,
                       load_csrz, save_csrz, structural_meta)
from .manifest import (CORPUS_PREFIX, CorpusEntry, corpus_names, ensure,
                       get_entry, load_manifest, resolve, verify_entry)
from .mtxstream import (DEFAULT_CHUNK_NNZ, MtxHeader, parse_mtx, read_header,
                        read_mtx)

__all__ = [
    "CORPUS_PREFIX", "CorpusEntry", "DEFAULT_CHUNK_NNZ", "IngestResult",
    "MtxHeader", "TuneAdvisor", "cache_dir", "corpus_names", "ensure",
    "file_sha256", "get_entry", "ingest_path", "load_csrz", "load_manifest",
    "parse_mtx", "read_header", "read_mtx", "resolve", "save_csrz",
    "structural_meta", "verify_entry",
]


def __getattr__(name):
    # TuneAdvisor pulls in the experiments layer; keep that import out of
    # the ingestion path (matrices/io.py imports this package).
    if name == "TuneAdvisor":
        from .advisor import TuneAdvisor
        return TuneAdvisor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
